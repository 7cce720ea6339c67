"""The routing decision (raytpu/render/route.py) and the routed frame with
the sweep forced (Pallas interpret mode) against the jnp frame."""

import dataclasses

import jax
import numpy as np
import pytest

from raytpu.core import scenes
from raytpu.core.types import LightingMode, RenderConfig
from raytpu.render import renderer, route
from raytpu.utils.image import FLIP_BUDGET, MEAN_DIFF_BUDGET, flip_stats

CFG = RenderConfig(width=64, height=32)


def _assert_same_frame(got, ref):
    """Winners and occlusion are exact (tests/test_sweep*.py); the shade
    tail is the same jnp code in another XLA fusion, so a pixel may move by
    one quantization step, and only FLIP_BUDGET of them by more."""
    flipped, mean_diff = flip_stats(np.asarray(got), np.asarray(ref))
    assert flipped <= FLIP_BUDGET and mean_diff <= MEAN_DIFF_BUDGET, (flipped, mean_diff)


@pytest.fixture
def on_backend(monkeypatch):
    """Pretend JAX's default backend is ``name`` for the routing decision."""

    def set_backend(name):
        monkeypatch.setattr(route.jax, "default_backend", lambda: name)

    return set_backend


def _with_triangles(n):
    """The bunny scene cut to its first ``n`` triangles."""
    scene = scenes.get("bunny").build()
    tris = jax.tree_util.tree_map(lambda x: x[:n], scene.triangles)
    return dataclasses.replace(scene, triangles=tris)


@pytest.mark.parametrize("delta,expect", [(-1, False), (0, True), (1, True)])
def test_gpu_threshold(on_backend, delta, expect):
    on_backend("gpu")
    n = route.SWEEP_MIN_TRIS + delta
    assert route.use_sweep(_with_triangles(n)) is expect
    assert route.kind(_with_triangles(n), CFG) == ("sweep" if expect else "jnp")


def test_cpu_takes_jnp(on_backend):
    on_backend("cpu")
    assert route.use_sweep(_with_triangles(route.SWEEP_MIN_TRIS)) is False


@pytest.mark.parametrize("forced", [True, False])
def test_forced_choice_wins(on_backend, forced):
    on_backend("cpu")
    assert route.use_sweep(scenes.get("reference").build(), sweep=forced) is forced


def test_unknown_backend_raises(on_backend):
    on_backend("metal")
    with pytest.raises(RuntimeError, match="gpu or cpu"):
        route.use_sweep(scenes.get("bunny").build())


def test_soft_shadow_frames_take_jnp(on_backend):
    on_backend("gpu")
    soft = dataclasses.replace(CFG, soft_shadows=True)
    assert route.kind(_with_triangles(route.SWEEP_MIN_TRIS), soft) == "jnp"


@pytest.mark.parametrize("mode", list(LightingMode))
@pytest.mark.parametrize("shadows", [True, False])
def test_sweep_frame_matches_jnp(mode, shadows):
    """The full routed frame with the sweep forced: closest hit with payload
    and all-lights any-hit on the sweep, the shade tail in jnp."""
    scene = scenes.get("bunny").build()
    cfg = dataclasses.replace(CFG, lighting_mode=mode, shadows=shadows)
    got = route.render_image(scene, cfg, sweep=True, interpret=True)
    _assert_same_frame(got, renderer.render_image(scene, cfg))


def test_sweep_frame_row_major_when_not_foldable():
    """48 rows are not a multiple of 32: rays stay in row-major order."""
    scene = scenes.get("optional").build()
    cfg = RenderConfig(width=64, height=48)
    got = route.render_image(scene, cfg, sweep=True, interpret=True)
    _assert_same_frame(got, renderer.render_image(scene, cfg))

"""Golden-image tests: the jitted JAX renderer must match the scalar NumPy
oracle on every course scene, in every lighting mode — the analog of the
reference's graded visual fixtures (SURVEY.md §4)."""

import numpy as np
import pytest

from raytpu.core import scenes
from raytpu.core.types import LightingMode, RenderConfig
from raytpu.oracle import render_oracle
from raytpu.render import render_image

W, H = 40, 30

_BUILT = {}


def _scene(name):
    if name not in _BUILT:
        _BUILT[name] = scenes.get(name).build()
    return _BUILT[name]


def _compare(scene, config, max_mismatch_frac=0.01):
    golden = render_oracle(scene, config)
    fast = np.asarray(render_image(scene, config))
    assert fast.shape == golden.shape == (config.height, config.width, 3)
    diff = fast.astype(int) - golden.astype(int)
    mismatched = (np.abs(diff) > 1).any(axis=-1)
    # fp reassociation can flip binary decisions (closest-hit ties, shadow
    # occlusion at the terminator) on isolated boundary pixels; those show up
    # as a uniform ~0.95^k scale or a silhouette edge.  Budget them, but
    # require the remaining image to match to 1 u8 step.
    frac = mismatched.mean()
    assert frac <= max_mismatch_frac, (
        f"{frac:.4%} pixels differ by >1 u8 step (max {np.abs(diff).max()})"
    )
    # a real formula bug shifts the whole image; boundary flips don't.
    # (no per-pixel max cap: a flipped closest-hit/shadow decision on a
    # boundary pixel legitimately changes that pixel arbitrarily)
    assert np.abs(diff).mean() <= 0.5, f"mean abs u8 diff too large: {np.abs(diff).mean():.3f}"


@pytest.mark.parametrize("name", ["w1", "w2", "w3_test", "w3", "reference"])
def test_scene_matches_oracle(name):
    scene = _scene(name)
    _compare(scene, RenderConfig(width=W, height=H))


def test_reference_scene_animated_matches_oracle():
    spec = scenes.get("reference")
    scene = spec.animate(spec.build(), 1.25)
    _compare(scene, RenderConfig(width=W, height=H))


@pytest.mark.parametrize(
    "mode",
    [LightingMode.OBSERVED_AREA, LightingMode.RADIANCE, LightingMode.BRDF],
)
def test_lighting_modes_match_oracle(mode):
    scene = _scene("reference")
    _compare(scene, RenderConfig(width=W, height=H, lighting_mode=mode))


def test_shadows_off_matches_oracle():
    scene = _scene("reference")
    _compare(scene, RenderConfig(width=W, height=H, shadows=False))


def test_mesh_scene_matches_oracle():
    # OBJ-loaded mesh with scale/translate transforms (w4 test scene)
    scene = _scene("w4_test")
    _compare(scene, RenderConfig(width=W, height=H))


def test_chunked_render_matches_unchunked():
    scene = _scene("reference")
    a = np.asarray(render_image(scene, RenderConfig(width=W, height=H, ray_chunk=256)))
    b = np.asarray(render_image(scene, RenderConfig(width=W, height=H)))
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["sphere", "phong"])
def test_baseline_config_scenes_match_oracle(name):
    _compare(_scene(name), RenderConfig(width=W, height=H))


def test_directional_light_matches_oracle():
    # the reference's directional branch is dead code with a latent bug
    # (reference: source/Utils.h:348); we implement it correctly and pin the
    # behavior with oracle parity
    from raytpu.core.types import SceneBuilder

    b = SceneBuilder()
    lam = b.add_lambert((0.8, 0.7, 0.6), 1.0)
    floor = b.add_lambert((0.4, 0.45, 0.5), 1.0)
    b.add_plane((0.0, -1.0, 0.0), (0.0, 1.0, 0.0), floor)
    b.add_sphere((0.0, 0.0, 4.0), 1.0, lam)
    b.add_directional_light((0.3, -1.0, 0.2), 2.5, (1.0, 0.95, 0.9))
    b.set_camera((0.0, 0.5, -2.0), fov_degrees=50.0)
    scene = b.build()
    _compare(scene, RenderConfig(width=W, height=H))
    # directional shadow: the sphere must darken the floor behind it
    img = np.asarray(render_image(scene, RenderConfig(width=64, height=48)))
    no_shadow = np.asarray(render_image(scene, RenderConfig(width=64, height=48, shadows=False)))
    assert (img.astype(int) < no_shadow.astype(int)).any()

"""The differentiable path with its detached winner search on the culled
sweep (interpret mode): same values and the same material, light and
geometry gradients as the all-jnp path; and no float32 dot on the path runs
at default matmul precision (TF32 on the GPU)."""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytpu.core import scenes
from raytpu.core.types import RenderConfig
from raytpu.grad import diff_render
from raytpu.grad.fast import detached_closest_hit
from raytpu.render import renderer, sweep

CFG = RenderConfig(width=64, height=32, soft_shadows=True, soft_beta=60.0)

PARAMS = {
    "material": (diff_render.material_params, diff_render.merge_material_params),
    "light": (diff_render.light_params, diff_render.merge_light_params),
    "geometry": (diff_render.geometry_params, diff_render.merge_geometry_params),
}


def test_detached_closest_hit_values_match():
    scene = scenes.get("bunny").build()
    ro, rd = renderer.generate_rays(scene.camera, CFG)
    ro = jnp.broadcast_to(ro, rd.shape)
    min_t = lambda s, a, b, t: sweep.min_t(s, a, b, t, interpret=True)
    got = jax.jit(lambda s: detached_closest_hit(s, ro, rd, CFG.ray_min, min_t_fn=min_t))(scene)
    ref = jax.jit(lambda s: detached_closest_hit(s, ro, rd, CFG.ray_min))(scene)
    for field in ("hit", "t", "point", "normal", "material"):
        np.testing.assert_array_equal(np.asarray(getattr(got, field)),
                                      np.asarray(getattr(ref, field)), err_msg=field)


@pytest.mark.parametrize("kind", sorted(PARAMS))
def test_sweep_grads_match_jnp(kind):
    param_fn, merge_fn = PARAMS[kind]
    scene = scenes.get("bunny").build()
    target = jnp.zeros((CFG.height, CFG.width, 3), jnp.float32)

    def loss(p, sweep_on):
        img = diff_render.render_soft_f32(merge_fn(scene, p), CFG, sweep=sweep_on,
                                          interpret=True)
        return jnp.mean((img - target) ** 2)

    p0 = param_fn(scene)
    l_s, g_s = jax.jit(jax.value_and_grad(lambda p: loss(p, True)))(p0)
    l_j, g_j = jax.jit(jax.value_and_grad(lambda p: loss(p, False)))(p0)
    np.testing.assert_allclose(float(l_s), float(l_j), rtol=1e-6)
    for a, b in zip(jax.tree_util.tree_leaves(g_s), jax.tree_util.tree_leaves(g_j)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-9)
        assert np.isfinite(np.asarray(a)).all()


def _dot_params(jaxpr_text):
    """(result dtype, params text) of every dot_general in a printed jaxpr,
    nested jaxprs (checkpoint, scan, pjit) included."""
    for m in re.finditer(r"(\w+)\[[\d,]*\] = dot_general\[(.*?)\n\s*\]", jaxpr_text, re.S):
        yield m.group(1), m.group(2)


@pytest.mark.parametrize("kind", ["material", "geometry"])
def test_no_default_precision_f32_dot(kind):
    """Every float32 dot on the fwd+bwd path asks for HIGHEST precision, so
    a GPU cannot run it in TF32."""
    param_fn, merge_fn = PARAMS[kind]
    scene = scenes.get("bunny").build()
    cfg = dataclasses.replace(CFG, ray_chunk=CFG.width * CFG.height)

    def loss(p):
        return jnp.sum(diff_render.render_soft_f32(merge_fn(scene, p), cfg))

    text = str(jax.make_jaxpr(jax.grad(loss))(param_fn(scene)))
    dots = list(_dot_params(text))
    assert dots, "expected the one-hot payload matmuls on the path"
    for dtype, params in dots:
        if dtype == "f32":
            assert "precision=(Precision.HIGHEST, Precision.HIGHEST)" in params, params

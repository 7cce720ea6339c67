"""The fast differentiable path (detached-hit closest intersection) must match
the plain jnp soft render in BOTH value and gradients: the argmin it detaches
carries zero gradient a.e. in the jnp path too, so agreement is exact up to fp
noise."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytpu.core import scenes
from raytpu.core.types import RenderConfig
from raytpu.grad import diff_render
from raytpu.grad.fast import detached_closest_hit
from raytpu.ops import intersect
from raytpu.render.renderer import render_image_f32

CFG = RenderConfig(width=32, height=24, soft_shadows=True, soft_beta=40.0)


@pytest.fixture(scope="module", params=["w3_test", "reference", "bunny"])
def scene(request):
    return scenes.get(request.param).build()


def test_forward_value_matches_jnp_soft(scene):
    fast = diff_render.render_soft_f32(scene, CFG)
    ref = render_image_f32(scene, CFG)
    np.testing.assert_allclose(np.asarray(fast), np.asarray(ref), atol=1e-5)


def test_detached_hit_records_match_closest_hit(scene):
    from raytpu.render.renderer import generate_rays

    ro, rd = generate_rays(scene.camera, CFG)
    ro_b = jnp.broadcast_to(ro, rd.shape)
    a = intersect.closest_hit(scene, ro_b, rd, CFG.ray_min)
    b = detached_closest_hit(scene, ro_b, rd, CFG.ray_min)
    hit = np.asarray(a.hit)
    np.testing.assert_array_equal(hit, np.asarray(b.hit))
    # miss-lane payload is a don't-care (shading masks by hit) — compare hits
    np.testing.assert_array_equal(np.asarray(a.material)[hit], np.asarray(b.material)[hit])
    np.testing.assert_allclose(np.asarray(a.t)[hit], np.asarray(b.t)[hit], rtol=1e-5)
    np.testing.assert_allclose(np.asarray(a.normal)[hit], np.asarray(b.normal)[hit], atol=1e-5)
    np.testing.assert_allclose(np.asarray(a.point)[hit], np.asarray(b.point)[hit], atol=1e-5)


def _grad_pair(scene, pick, merge):
    """(fast-path grad, jnp-path grad) of the same scalar loss."""

    def loss(render):
        def f(p):
            return jnp.sum(render(merge(scene, p), CFG))

        return f

    p0 = pick(scene)
    g_fast = jax.grad(loss(diff_render.render_soft_f32))(p0)
    g_ref = jax.grad(loss(render_image_f32))(p0)
    return g_fast, g_ref


def _assert_grads_close(g_fast, g_ref, rtol=2e-2, atol=3e-3):
    # both paths drop the same (zero-a.e.) argmin boundary terms; residual
    # disagreement is f32 graph-order noise, ~1e-3 of the gradient scale
    gf = np.asarray(g_fast, np.float64).ravel()
    gr = np.asarray(g_ref, np.float64).ravel()
    scale = np.abs(gr).max() + 1e-12
    np.testing.assert_allclose(gf, gr, rtol=rtol, atol=atol * scale + 1e-8)


def test_material_color_grads_match(scene):
    def merge(s, color):
        return dataclasses.replace(
            s, materials=dataclasses.replace(s.materials, color=color)
        )

    _assert_grads_close(*_grad_pair(scene, lambda s: s.materials.color, merge))


def test_light_position_grads_match(scene):
    def merge(s, position):
        return dataclasses.replace(
            s, lights=dataclasses.replace(s.lights, position=position)
        )

    _assert_grads_close(*_grad_pair(scene, lambda s: s.lights.position, merge))


def test_sphere_center_grads_match(scene):
    if not scene.spheres.count:
        pytest.skip("no spheres")

    def merge(s, center):
        return dataclasses.replace(
            s, spheres=dataclasses.replace(s.spheres, center=center)
        )

    _assert_grads_close(*_grad_pair(scene, lambda s: s.spheres.center, merge))


def test_mesh_vertex_grads_match(scene):
    if not scene.meshes.num_meshes:
        pytest.skip("no meshes")

    def merge(s, positions):
        return s.with_meshes(s.meshes.with_positions(positions))

    _assert_grads_close(
        *_grad_pair(scene, lambda s: s.meshes.positions, merge), rtol=1e-2
    )


def test_fast_grads_are_finite(scene):
    grads = jax.grad(
        lambda s: jnp.sum(diff_render.render_soft_f32(s, CFG)), allow_int=True
    )(scene)
    for leaf in jax.tree_util.tree_leaves(grads):
        if hasattr(leaf, "dtype") and jnp.issubdtype(leaf.dtype, jnp.floating):
            assert jnp.all(jnp.isfinite(leaf)), "non-finite gradient leaf"


def test_gather_cols_grouped_matches_single_onehot():
    """soa.gather_cols: the two-level grouped one-hot (big-N path) must equal
    the single one-hot gather in value AND table-gradient."""
    from raytpu.ops import soa

    rng = np.random.default_rng(0)
    N, K, R = 50, 5, 37
    table = jnp.asarray(rng.standard_normal((N, K)), jnp.float32)
    li = jnp.asarray(rng.integers(0, N, R), jnp.int32)
    mask = jnp.asarray(rng.random(R) > 0.3)
    g = jnp.asarray(rng.standard_normal((K, R)), jnp.float32)

    def run(onehot_max):
        def f(t):
            return jnp.sum(soa.gather_cols(t, li, mask, onehot_max) * g)
        return f(table), jax.grad(f)(table)

    v1, g1 = run(4096)   # single one-hot
    v2, g2 = run(7)      # grouped: G = ceil(50/7) = 8, H = 7
    v3, g3 = run(3)      # grouped with larger G = 17
    np.testing.assert_allclose(float(v1), float(v2), rtol=1e-6)
    np.testing.assert_allclose(float(v1), float(v3), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(g1), np.asarray(g2), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(np.asarray(g1), np.asarray(g3), rtol=1e-5, atol=1e-7)


def test_detached_hit_grouped_gather_matches(scene):
    """Force the grouped-gather path inside detached_closest_hit (small
    onehot_max) — hit records must be unchanged."""
    from raytpu.render.renderer import generate_rays

    ro, rd = generate_rays(scene.camera, CFG)
    ro_b = jnp.broadcast_to(ro, rd.shape)
    a = detached_closest_hit(scene, ro_b, rd, CFG.ray_min)
    b = detached_closest_hit(scene, ro_b, rd, CFG.ray_min, onehot_max=2)
    hit = np.asarray(a.hit)
    np.testing.assert_array_equal(hit, np.asarray(b.hit))
    np.testing.assert_array_equal(np.asarray(a.material)[hit], np.asarray(b.material)[hit])
    np.testing.assert_allclose(np.asarray(a.t)[hit], np.asarray(b.t)[hit], rtol=1e-5)
    np.testing.assert_allclose(
        np.asarray(a.normal)[hit], np.asarray(b.normal)[hit], rtol=1e-5, atol=1e-6
    )

"""Finite-difference verification of pixel gradients w.r.t. material, light,
and geometry parameters (BASELINE.md target: "finite-difference verified")."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import optax

from raytpu.core import scenes
from raytpu.core.types import RenderConfig
from raytpu.grad import diff_render
from raytpu.render.renderer import render_image_f32

CFG = RenderConfig(width=16, height=12, soft_shadows=True, soft_beta=40.0)


@pytest.fixture(scope="module")
def scene():
    return scenes.get("w3_test").build()


@pytest.fixture(scope="module")
def tri_scene():
    return scenes.get("reference").build()


def _fd_check(loss_fn, x0, picks, eps=2e-3, rtol=0.08, atol=1e-4):
    """Central-difference check of d loss / d x at selected flat indices."""
    g = np.asarray(jax.grad(loss_fn)(x0), np.float64).ravel()
    x0f = np.asarray(x0, np.float64)
    checked = 0
    for i in picks:
        d = np.zeros_like(x0f).ravel()
        d[i] = eps
        d = d.reshape(x0f.shape)
        lp = float(loss_fn(jnp.asarray(x0f + d, jnp.float32)))
        lm = float(loss_fn(jnp.asarray(x0f - d, jnp.float32)))
        fd = (lp - lm) / (2 * eps)
        if abs(fd) < 5e-3 and abs(g[i]) < 5e-3:
            continue  # both ~zero: uninformative
        np.testing.assert_allclose(g[i], fd, rtol=rtol, atol=atol + 0.02 * abs(fd)), i
        checked += 1
    assert checked >= 1, "no informative gradient components found"


def test_material_color_gradients(scene):
    def loss(color):
        mats = dataclasses.replace(scene.materials, color=color)
        s = dataclasses.replace(scene, materials=mats)
        return jnp.sum(render_image_f32(s, CFG))

    _fd_check(loss, scene.materials.color, picks=range(scene.materials.color.size))


def test_material_roughness_metalness_gradients(tri_scene):
    def loss(params):
        mats = dataclasses.replace(tri_scene.materials, params=params)
        s = dataclasses.replace(tri_scene, materials=mats)
        return jnp.sum(render_image_f32(s, CFG))

    # roughness entries of the CT materials (kind 3): params[:, 1].
    # larger eps: f32 loss evaluation noise (~loss*2^-23) swamps tiny steps
    n = tri_scene.materials.params.shape[0]
    picks = [i * 3 + 1 for i in range(n)]
    _fd_check(loss, tri_scene.materials.params, picks=picks, eps=3e-2, rtol=0.15)


def test_light_gradients(scene):
    def loss_pos(position):
        lights = dataclasses.replace(scene.lights, position=position)
        s = dataclasses.replace(scene, lights=lights)
        return jnp.sum(render_image_f32(s, CFG))

    def loss_intensity(intensity):
        lights = dataclasses.replace(scene.lights, intensity=intensity)
        s = dataclasses.replace(scene, lights=lights)
        return jnp.sum(render_image_f32(s, CFG))

    _fd_check(loss_pos, scene.lights.position, picks=range(scene.lights.position.size), eps=4e-3)
    _fd_check(loss_intensity, scene.lights.intensity, picks=range(scene.lights.intensity.size))


def test_sphere_geometry_gradients(scene):
    def loss(center):
        sph = dataclasses.replace(scene.spheres, center=center)
        s = dataclasses.replace(scene, spheres=sph)
        return jnp.sum(render_image_f32(s, CFG))

    _fd_check(loss, scene.spheres.center, picks=range(scene.spheres.center.size), eps=4e-3)


def test_mesh_vertex_gradients(tri_scene):
    def loss(positions):
        s = tri_scene.with_meshes(tri_scene.meshes.with_positions(positions))
        return jnp.sum(render_image_f32(s, CFG))

    _fd_check(loss, tri_scene.meshes.positions, picks=range(0, tri_scene.meshes.positions.size, 2), eps=4e-3)


def test_gradients_are_finite(tri_scene):
    # no NaN/inf anywhere in a full-scene gradient (double-where guards work).
    # 64x48 matters: it includes fully-black pixels (max_to_one guard);
    # ray_chunk=1024 forces the chunked lax.map path (edge padding)
    def loss(s):
        return jnp.sum(render_image_f32(
            s, RenderConfig(width=64, height=48, soft_shadows=True, ray_chunk=1024)))

    grads = jax.grad(loss, allow_int=True)(tri_scene)
    for leaf in jax.tree_util.tree_leaves(grads):
        if hasattr(leaf, "dtype") and jnp.issubdtype(leaf.dtype, jnp.floating):
            assert jnp.all(jnp.isfinite(leaf)), "non-finite gradient leaf"


def _occluder_scene(kind):
    from raytpu.core.types import CullMode, SceneBuilder

    b = SceneBuilder()
    m = b.add_lambert((1.0, 1.0, 1.0), 1.0)
    if kind == "sphere":
        b.add_sphere((0.0, 1.0, 0.0), 0.45, m)
    elif kind == "plane":
        b.add_plane((0.0, 1.0, 0.0), (0.0, -1.0, 0.0), m)
    else:  # triangle
        h = b.add_triangle_mesh(CullMode.NONE, m)
        h.set_geometry(
            np.array([[-0.6, 1.0, -0.6], [0.6, 1.0, -0.6], [0.0, 1.0, 0.8]], np.float32),
            np.array([0, 1, 2], np.int32),
        )
    b.add_point_light((0.0, 2.0, 0.0), 10.0, (1, 1, 1))
    b.set_camera((0.0, 0.0, -3.0))
    return b.build()


@pytest.mark.parametrize(
    "kind,p,L0,comp",
    [
        # receiver + light placed so the shadow segment sits near the
        # occluder's soft edge (margin ~ 0 -> strong sigmoid gradient)
        ("sphere", [0.42, 0.0, 0.0], [0.42, 2.0, 0.0], 0),
        ("triangle", [0.52, 0.0, -0.3], [0.52, 2.0, -0.3], 0),
        # plane edge = segment endpoint crossing the plane: light just past it
        ("plane", [0.0, 0.0, 0.0], [0.0, 1.08, 0.0], 1),
    ],
)
def test_shadow_edge_gradients_per_primitive_class(kind, p, L0, comp):
    """Soft shadow boundaries must carry FD-verified gradients w.r.t. the
    light position for every primitive class (planes once occluded
    binarily, with zero gradient)."""
    from raytpu.ops import intersect

    scene = _occluder_scene(kind)
    p = jnp.asarray([p], jnp.float32)

    def trans_of(L):
        d = L[None, :] - p
        mag = jnp.sqrt(jnp.sum(d * d, axis=-1))
        rd = d / mag[:, None]
        return intersect.soft_transmittance(scene, p, rd, 1e-3, mag, jnp.float32(20.0))[0]

    L0 = jnp.asarray(L0, jnp.float32)
    g = np.asarray(jax.grad(trans_of)(L0), np.float64)
    assert np.isfinite(g).all()
    assert abs(g[comp]) > 1e-3, f"no gradient through {kind} shadow edge: {g}"

    eps = 1e-3
    e = np.zeros(3)
    e[comp] = eps
    fd = (float(trans_of(L0 + jnp.asarray(e, jnp.float32)))
          - float(trans_of(L0 - jnp.asarray(e, jnp.float32)))) / (2 * eps)
    np.testing.assert_allclose(g[comp], fd, rtol=0.08, atol=1e-3)


def test_soft_visibility_converges_to_hard(tri_scene):
    hard = render_image_f32(tri_scene, RenderConfig(width=32, height=24))
    soft = render_image_f32(
        tri_scene, RenderConfig(width=32, height=24, soft_shadows=True, soft_beta=1e5)
    )
    # agree except at the (measure-zero-ish) shadow boundary pixels
    close = np.isclose(np.asarray(hard), np.asarray(soft), atol=0.02)
    assert close.mean() > 0.97


def test_inverse_rendering_recovers_albedo(scene):
    target = diff_render.render_soft(scene, CFG)
    # perturb material colors, then fit them back
    wrong = dataclasses.replace(
        scene.materials, color=jnp.clip(scene.materials.color + 0.3, 0.0, 1.0)
    )
    broken = dataclasses.replace(scene, materials=wrong)

    opt = optax.adam(5e-2)
    step = diff_render.make_train_step(
        CFG, opt, diff_render.material_params, diff_render.merge_material_params
    )
    params = diff_render.material_params(broken)
    opt_state = opt.init(params)
    loss0 = None
    for i in range(60):
        params, opt_state, loss = step(params, opt_state, broken, target)
        if loss0 is None:
            loss0 = float(loss)
    assert float(loss) < 0.2 * loss0, (loss0, float(loss))

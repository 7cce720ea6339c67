"""The culled sweep's all-lights shadow any-hit and its padding cases, in
Pallas interpret mode, against the dense jnp any-hit and closest hit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytpu.core import scenes
from raytpu.core.types import CullMode, RenderConfig, SceneBuilder
from raytpu.ops import intersect
from raytpu.render import renderer, sweep

CFG = RenderConfig(width=64, height=48)


def _shadow_inputs(scene, cfg=CFG):
    ro, rd = renderer.generate_rays(scene.camera, cfg)
    rec = intersect.closest_hit(scene, jnp.broadcast_to(ro, rd.shape), rd, cfg.ray_min)
    return renderer.shadow_query_inputs(scene, rec, cfg)


def _check_any_hit(scene, cfg=CFG):
    p, dirs, mags = _shadow_inputs(scene, cfg)
    got = jax.jit(lambda s, a, b, c: sweep.any_hit_lights(s, a, b, c, cfg.ray_min,
                                                          interpret=True))(scene, p, dirs, mags)
    ref = jax.jit(lambda s, a, b, c: jnp.stack([
        intersect.any_hit(s, a, b[i], cfg.ray_min, c[i]) for i in range(b.shape[0])]))(
        scene, p, dirs, mags)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))
    return np.asarray(ref)


def _both_closest(scene, ro, rd, tmin):
    """(sweep records, dense records), both jitted."""
    got = jax.jit(lambda s, a, b: sweep.closest_hit(s, a, b, tmin, interpret=True))(scene, ro, rd)
    ref = jax.jit(lambda s, a, b: intersect.closest_hit(s, a, b, tmin))(scene, ro, rd)
    return got, ref


def _mesh_scene(light: str, n_tris: int = 0):
    """Bunny-room lighting on a triangle fan of ``n_tris`` (0: the bunny)."""
    if not n_tris:
        b = SceneBuilder()
        white = b.add_lambert((1.0, 1.0, 1.0), 1.0)
        from raytpu.core import obj

        pos, nrm, idx = obj.parse_obj("lowpoly_bunny2.obj")
        m = b.add_triangle_mesh(CullMode.BACK_FACE, white)
        m.set_geometry(pos, idx, nrm)
        m.scale((2.0, 2.0, 2.0))
    else:
        b = SceneBuilder()
        white = b.add_lambert((1.0, 1.0, 1.0), 1.0)
        m = b.add_triangle_mesh(CullMode.NONE, white)
        for k in range(n_tris):
            x = -2.0 + 4.0 * k / n_tris
            m.append_triangle((x, 0.5, 0.0), (x + 0.3, 2.0, 0.0), (x, 2.0, 0.5))
    floor = b.add_lambert((0.5, 0.5, 0.5), 1.0)
    b.add_plane((0.0, 0.0, 0.0), (0.0, 1.0, 0.0), floor)
    if light == "point":
        b.add_point_light((0.0, 5.0, -5.0), 50.0, (1.0, 1.0, 1.0))
        b.add_point_light((2.5, 4.0, 2.0), 30.0, (1.0, 0.8, 0.6))
    else:
        b.add_directional_light((0.3, -1.0, 0.4), 2.0, (1.0, 1.0, 1.0))
    b.set_camera((0.0, 3.0, -9.0), fov_degrees=45.0)
    return b.build()


@pytest.mark.parametrize("name", ["phong", "w2", "w3", "reference", "bunny", "optional"])
def test_any_hit_matches_jnp_course_scenes(name):
    _check_any_hit(scenes.get(name).build())


@pytest.mark.parametrize("light", ["point", "directional"])
def test_any_hit_matches_jnp_light_kinds(light):
    occ = _check_any_hit(_mesh_scene(light))
    assert occ.any() and not occ.all()  # the case has both shadow and light


@pytest.mark.parametrize("size", [(37, 5), (50, 30)])
def test_ray_count_not_a_tile_multiple(size):
    """R = 185 / 1500 rays: the last tile is padded with direction-0 rays."""
    scene = scenes.get("bunny").build()
    cfg = RenderConfig(width=size[0], height=size[1])
    assert (size[0] * size[1]) % sweep.TILE
    ro, rd = renderer.generate_rays(scene.camera, cfg)
    ro = jnp.broadcast_to(ro, rd.shape)
    got, ref = _both_closest(scene, ro, rd, cfg.ray_min)
    np.testing.assert_array_equal(np.asarray(got.t), np.asarray(ref.t))
    _check_any_hit(scene, cfg)


@pytest.mark.parametrize("n_tris", [1, 13])
def test_triangle_count_not_a_group_multiple(n_tris):
    scene = _mesh_scene("point", n_tris)
    assert scene.triangles.count % sweep.GROUP
    ro, rd = renderer.generate_rays(scene.camera, CFG)
    ro = jnp.broadcast_to(ro, rd.shape)
    got, ref = _both_closest(scene, ro, rd, CFG.ray_min)
    np.testing.assert_array_equal(np.asarray(got.t), np.asarray(ref.t))
    np.testing.assert_array_equal(np.asarray(got.material), np.asarray(ref.material))
    _check_any_hit(scene)


def test_no_triangles():
    """Spheres and planes only: the worklists are empty by construction."""
    scene = scenes.get("phong").build()
    assert scene.triangles.count == 0
    assert _check_any_hit(scene).any()


def test_no_lights():
    scene = scenes.get("bunny").build()
    p, dirs, mags = _shadow_inputs(scene)
    occ = sweep.any_hit_lights(scene, p, dirs[:0], mags[:0], CFG.ray_min, interpret=True)
    assert occ.shape == (0, p.shape[0])


def test_empty_worklists():
    """A camera looking away from every triangle: each tile's worklist is
    empty and every ray misses the mesh."""
    import dataclasses

    scene = scenes.get("bunny").build()
    away = dataclasses.replace(scene, planes=dataclasses.replace(
        scene.planes, origin=scene.planes.origin[:0], normal=scene.planes.normal[:0],
        material=scene.planes.material[:0]))
    ro = jnp.zeros((512, 3), jnp.float32) + jnp.array([0.0, 3.0, -9.0])
    rd = jnp.broadcast_to(jnp.array([0.0, 0.0, -1.0]), (512, 3))
    t, idx = sweep.min_t(away, ro, rd, CFG.ray_min, interpret=True)
    assert np.isinf(np.asarray(t)).all() and (np.asarray(idx) == 0).all()

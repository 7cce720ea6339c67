"""Culling layer (raytpu/ops/accel.py): worklists against a brute-force
compaction, cull matrices against brute-force ray-triangle hits, and the
32x32-block ray order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytpu.core import scenes
from raytpu.core.types import LightKind, RenderConfig
from raytpu.ops import accel, intersect
from raytpu.render import renderer

CFG = RenderConfig(width=64, height=32)
TILE = 128


@pytest.mark.parametrize("shape,density", [((7, 13), 0.3), ((16, 64), 0.05), ((3, 40), 1.0),
                                           ((5, 9), 0.0)])
def test_chunk_worklist_matches_brute_force(shape, density):
    rng = np.random.default_rng(sum(shape))
    cull = (rng.random(shape) < density).astype(np.float32)
    wl, cnt = jax.jit(accel.chunk_worklist)(jnp.asarray(cull))
    wl, cnt = np.asarray(wl), np.asarray(cnt)
    for r in range(shape[0]):
        want = np.flatnonzero(cull[r])
        assert cnt[r] == len(want)
        np.testing.assert_array_equal(wl[r, : cnt[r]], want)  # ascending: tie order kept


def _hit_pairs(scene, ro, rd, tmax, shadow_pass, group):
    """(tiles, groups) bool: some ray of the tile hits some triangle of the
    group — brute force on the dense t-matrix."""
    tm = np.asarray(intersect.scene_t_matrix(
        _tris_only(scene), ro, rd,
        0.0001, tmax, shadow_pass))  # (R, T)
    R, T = tm.shape
    nt, ng = -(-R // TILE), -(-T // group)
    hits = np.isfinite(tm)
    hits = np.pad(hits, ((0, nt * TILE - R), (0, ng * group - T)))
    return hits.reshape(nt, TILE, ng, group).any(axis=(1, 3))


def _tris_only(scene):
    import dataclasses

    empty = lambda x: x[:0]
    return dataclasses.replace(
        scene,
        spheres=jax.tree_util.tree_map(empty, scene.spheres),
        planes=jax.tree_util.tree_map(empty, scene.planes))


@pytest.mark.parametrize("name", ["bunny", "optional"])
def test_primary_cull_is_conservative(name):
    scene = scenes.get(name).build()
    ro, rd = renderer.generate_rays(scene.camera, CFG)
    rd = accel.tile_fold(rd, CFG.height, CFG.width)
    ro = jnp.broadcast_to(ro, rd.shape)
    lo, hi = accel.chunk_bounds(scene.triangles, 8)
    cull = np.asarray(accel.cull_matrix(accel.ray_tile_bounds(ro, rd, jnp.inf, TILE), lo, hi,
                                        CFG.ray_min)) > 0
    hits = _hit_pairs(scene, ro, rd, jnp.inf, False, 8)
    assert hits.any()
    assert not (hits & ~cull).any(), "a hit (tile, group) pair was culled"
    assert cull.mean() < 0.5  # and it culls


@pytest.mark.parametrize("name", ["bunny", "optional"])
def test_shadow_cull_is_conservative(name):
    scene = scenes.get(name).build()
    ro, rd = renderer.generate_rays(scene.camera, CFG)
    rd = accel.tile_fold(rd, CFG.height, CFG.width)
    rec = intersect.closest_hit(scene, jnp.broadcast_to(ro, rd.shape), rd, CFG.ray_min)
    p, dirs, mags = renderer.shadow_query_inputs(scene, rec, CFG)
    lo, hi = accel.chunk_bounds(scene.triangles, 8)
    lights = scene.lights
    for li in range(dirs.shape[0]):
        cull = np.asarray(accel.shadow_cull_matrix(
            p, dirs[li], mags[li], lights.position[li], lights.kind[li] == LightKind.POINT,
            lo, hi, CFG.ray_min, tile=TILE)) > 0
        hits = _hit_pairs(scene, p, dirs[li], mags[li], True, 8)
        assert not (hits & ~cull).any(), f"light {li}: an occluding pair was culled"


@pytest.mark.parametrize("hw", [(32, 32), (64, 96), (96, 64)])
def test_tile_fold_round_trip(hw):
    h, w = hw
    x = jnp.arange(h * w * 3, dtype=jnp.float32).reshape(h * w, 3)
    f = accel.tile_fold(x, h, w)
    np.testing.assert_array_equal(np.asarray(accel.tile_unfold(f, h, w)), np.asarray(x))
    # the first 1024 rays are the top-left 32x32 block, row-major inside it
    rows = np.asarray(f[:1024, 0]).reshape(32, 32) / 3
    np.testing.assert_array_equal(rows, np.arange(32)[:, None] * w + np.arange(32)[None, :])


def test_tile_foldable():
    assert accel.tile_foldable(480, 640)
    assert not accel.tile_foldable(48, 64)

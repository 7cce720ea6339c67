"""Acceleration-structure layer: per-tile culled triangle groups.

The reference rebuilds a recursive SAH BVH per mesh per frame and walks it
per ray (reference: source/DataTypes.h:294-483, source/Utils.h:246-288).
Per-ray pointer chasing diverges across a warp, so the data-parallel
equivalent here is **group culling** (SURVEY.md §7.8b):

  * triangles are reordered once into the native binned-SAH builder's leaf
    order (Morton order as the fallback), so each group of ``SAH_LEAF``
    consecutive triangles is spatially coherent with a tight AABB;
  * per group, an AABB is computed (refreshed per frame in XLA — the analog
    of the reference's per-frame BVH rebuild, but O(T) data-parallel);
  * per (ray tile, group) pair a conservative slab/segment test decides
    whether the group can be hit, and each tile gets a worklist of the
    groups that pass (``chunk_worklist``).  The culled sweep
    (raytpu/render/sweep.py) then tests only those groups.

This keeps the divergence-free data-parallel shape while skipping most of
the O(rays x triangles) work for large meshes.
"""

from __future__ import annotations

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np

from raytpu.core.types import Scene, Triangles

SAH_LEAF = 8  # builder leaf size == the sweep's cull-group size, so every
#             group IS one SAH box (see PERF.md for its measurement)


def spatial_permutation(tri_verts: np.ndarray) -> np.ndarray:
    """Spatial-coherence permutation of a (T,3,3) triangle soup for chunking.

    Prefers the native binned-SAH builder's leaf order (measured 2.6x fewer
    passing chunks than Morton on the 3k-triangle scene: leaves follow the
    actual surface-area splits); falls back to Morton (native then numpy).
    """
    try:
        from raytpu.native import runtime as rt

        if rt.available():
            _, _, order = rt.build_bvh(tri_verts, leaf_size=SAH_LEAF, bins=8)
            return order
    except Exception:
        pass
    return morton_permutation(tri_verts)


def morton_permutation(tri_verts: np.ndarray) -> np.ndarray:
    """Morton-order permutation of (T,3,3) triangle soup (native or numpy)."""
    try:
        from raytpu.native import runtime as rt

        if rt.available():
            return rt.morton_order(tri_verts)
    except Exception:
        pass
    return _morton_numpy(tri_verts)


def _expand_bits10(v):
    v &= 0x3FF
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def _morton_numpy(tri_verts: np.ndarray) -> np.ndarray:
    tv = np.asarray(tri_verts, np.float32).reshape(-1, 3, 3)
    cent = tv.mean(axis=1)
    lo, hi = cent.min(axis=0), cent.max(axis=0)
    rng = np.where(hi > lo, hi - lo, 1.0)
    q = np.clip(((cent - lo) / rng * 1023.0), 0, 1023).astype(np.uint32)
    code = (
        (_expand_bits10(q[:, 0]) << 2)
        | (_expand_bits10(q[:, 1]) << 1)
        | _expand_bits10(q[:, 2])
    )
    return np.argsort(code, kind="stable").astype(np.int32)


def reorder_scene_triangles(scene: Scene) -> Scene:
    """Reorder the scene's triangle soup (and the mesh face tables that
    generate it) by spatial coherence, so kernel chunks see tight AABBs.

    The permutation is computed PER MESH (each mesh's faces stay contiguous):
    under rigid per-mesh animation a group's spatial coherence is then
    pose-invariant — the per-frame AABB refresh (chunk_bounds) keeps boxes
    tight for any yaw/translation, and no group's box can balloon from
    spanning two independently-moving meshes.  Counted: pass rates are flat
    over a full 2pi yaw on bunny/optional.  This is the data-parallel analog
    of the reference's per-frame BVH rebuild
    (reference: source/DataTypes.h:231-235) at zero per-frame cost.

    NOTE: reordering changes the reference's iteration-order tie-break for
    exactly-coincident surfaces; geometry and shading are otherwise
    unaffected.
    """
    tr = scene.triangles
    if tr.count == 0:
        return scene
    tv = np.stack([np.asarray(tr.v0), np.asarray(tr.v1), np.asarray(tr.v2)], axis=1)
    if scene.meshes.num_faces == tr.count and scene.meshes.num_meshes > 1:
        fm = np.asarray(scene.meshes.face_mesh)
        perm = np.empty(tr.count, np.int32)
        base = 0
        for mid in range(scene.meshes.num_meshes):
            sel = np.flatnonzero(fm == mid).astype(np.int32)
            sub = spatial_permutation(tv[sel])
            perm[base : base + len(sel)] = sel[sub]
            base += len(sel)
    else:
        perm = spatial_permutation(tv)
    perm_j = jnp.asarray(perm)
    tri2 = Triangles(
        v0=tr.v0[perm_j], v1=tr.v1[perm_j], v2=tr.v2[perm_j],
        normal=tr.normal[perm_j], cull=tr.cull[perm_j], material=tr.material[perm_j],
    )
    meshes = scene.meshes
    if meshes.num_faces == tr.count:
        meshes = dataclasses.replace(
            meshes,
            face_vertex=meshes.face_vertex[perm_j],
            face_normal=meshes.face_normal[perm_j],
            face_mesh=meshes.face_mesh[perm_j],
        )
    return dataclasses.replace(scene, triangles=tri2, meshes=meshes)


def chunk_bounds(tris: Triangles, chunk: int = SAH_LEAF):
    """Per-chunk AABBs (nc, 3)+(nc, 3), padding chunks with +/-inf-free
    degenerate bounds.  Pure jnp: recomputed per frame under jit (the
    data-parallel analog of the reference's per-frame BVH rebuild)."""
    T = tris.count
    nc = -(-T // chunk)
    pad = nc * chunk - T

    def padwith(x, v):
        return jnp.pad(x, ((0, pad), (0, 0)), constant_values=v)

    v0 = padwith(tris.v0, jnp.inf).reshape(nc, chunk, 3)
    v1 = padwith(tris.v1, jnp.inf).reshape(nc, chunk, 3)
    v2 = padwith(tris.v2, jnp.inf).reshape(nc, chunk, 3)
    lo = jnp.minimum(jnp.minimum(v0, v1), v2).min(axis=1)
    v0n = padwith(tris.v0, -jnp.inf).reshape(nc, chunk, 3)
    v1n = padwith(tris.v1, -jnp.inf).reshape(nc, chunk, 3)
    v2n = padwith(tris.v2, -jnp.inf).reshape(nc, chunk, 3)
    hi = jnp.maximum(jnp.maximum(v0n, v1n), v2n).max(axis=1)
    return lo, hi


def cull_matrix(rb, chunk_lo, chunk_hi, tmin):
    """(nr, nc) f32 matrix: 1.0 where ray tile i may hit chunk j, else 0.0.

    Computed fully in XLA, vectorized over all tile/chunk pairs.  Combines
    the interval slab test (strong for diverging primary tiles) with the
    segment-union AABB overlap (strong for shadow rays converging on one
    light); both conservative.  The eight slab candidates are folded with
    elementwise min/max so no (8, nr, nc, 3) intermediate is materialized.
    """
    omin, omax = rb[:, None, 0:3], rb[:, None, 3:6]  # (nr,1,3)
    dmin, dmax = rb[:, None, 6:9], rb[:, None, 9:12]
    tmax_t = rb[:, None, 12:13]
    seg_valid = rb[:, None, 13:14] > 0.0
    emin, emax = rb[:, None, 14:17], rb[:, None, 17:20]
    lo, hi = chunk_lo[None, :, :], chunk_hi[None, :, :]  # (1,nc,3)

    sign_safe = (dmin > 0.0) | (dmax < 0.0)
    inv1 = 1.0 / dmin
    inv2 = 1.0 / dmax
    cands = [(b - o) * inv for b in (lo, hi) for o in (omin, omax) for inv in (inv1, inv2)]
    ax_lo = jnp.where(sign_safe, functools.reduce(jnp.minimum, cands), -3.0e38)
    ax_hi = jnp.where(sign_safe, functools.reduce(jnp.maximum, cands), 3.0e38)
    t_lo = jnp.maximum(ax_lo.max(axis=-1), tmin)  # (nr, nc)
    t_hi = jnp.minimum(ax_hi.min(axis=-1), tmax_t[:, :, 0])
    slab_ok = t_hi >= t_lo

    s_lo = jnp.minimum(omin, emin)
    s_hi = jnp.maximum(omax, emax)
    seg_ok = ((s_lo <= hi) & (s_hi >= lo)).all(axis=-1) | ~seg_valid[:, :, 0]

    return (slab_ok & seg_ok).astype(jnp.float32)


def chunk_worklist(cull):
    """(nr, nc) cull matrix -> per-tile worklist of passing chunk ids.

    Returns ``(worklist (nr, nc) i32, count (nr,) i32)``: each row starts
    with its passing chunk ids in ascending order (so a strict-< min-fold
    over the worklist keeps the reference's iteration-order tie-break);
    entries past ``count`` are 0.  A prefix sum gives each passing chunk
    its slot and one scatter writes it — no sort.
    """
    passing = cull > 0.0
    count = jnp.sum(passing, axis=1, dtype=jnp.int32)
    nr, nc = cull.shape
    slot = jnp.cumsum(passing, axis=1, dtype=jnp.int32) - 1
    slot = jnp.where(passing, slot, nc)  # out of range: dropped
    rows = jnp.broadcast_to(jnp.arange(nr, dtype=jnp.int32)[:, None], (nr, nc))
    ids = jnp.broadcast_to(jnp.arange(nc, dtype=jnp.int32)[None, :], (nr, nc))
    worklist = jnp.zeros((nr, nc), jnp.int32).at[rows, slot].set(ids, mode="drop")
    return worklist, count


def shadow_cull_matrix(ro, ld, mag, light_pos, is_point, lo, hi, tmin,
                       tile: int):
    """Per-(tile, group) cull for the shadow rays toward ONE light.

    Combines the forward slab/segment test on the actual rays with — for
    point lights — a **light-anchored reversed slab test**: every shadow
    segment ends at the light, an exact point, so the interval slab on the
    reversed rays {light -> origin box, t in [0, 1]} carries no origin-box
    slack and is much tighter than the forward test, whose origin interval
    and direction interval decorrelate (counted at 1024-ray tiles: shadow
    group pass rate bunny 39.8 -> 29.6%, optional 31.1 -> 21.0%; a
    cone-vs-sphere test added almost nothing on top).  Both tests are
    conservative; the reversed one is skipped (all-pass) for directional
    lights, whose forward direction interval is already a single vector.
    """
    rb = ray_tile_bounds(ro, ld, mag, tile=tile)
    cull = cull_matrix(rb, lo, hi, tmin)
    rd_rev = ro - light_pos[None, :]
    rb_rev = ray_tile_bounds(
        jnp.broadcast_to(light_pos, ro.shape), rd_rev,
        jnp.ones_like(jnp.broadcast_to(mag, (ro.shape[0],))), tile=tile,
    )
    rev = cull_matrix(rb_rev, lo, hi, 0.0)
    return cull * jnp.where(is_point, rev, jnp.ones_like(rev))


def ray_tile_bounds(ro, rd, tmax, tile: int):
    """Per-ray-tile conservative bounds (nr, 20):
    [omin3, omax3, dmin3, dmax3, tmax_max, seg_valid, emin3, emax3]
    for the per-(tile, group) culling tests.

    Two complementary rejection tests are supported downstream:
      * interval slab test on [omin,omax] x [dmin,dmax] — strong for
        diverging primary rays (tight direction cones per pixel tile);
      * segment-union AABB [min(omin,emin), max(omax,emax)] vs chunk AABB —
        strong for shadow rays, which converge on one light: every segment
        ends at the light, so the union of segments lies inside the AABB of
        origins+endpoints.  ``seg_valid`` is 0 when endpoints are unbounded
        (primary rays / directional lights).
    """
    R = rd.shape[0]
    nr = -(-R // tile)
    pad = nr * tile - R

    def p3(x, v):
        return jnp.pad(x, ((0, pad), (0, 0)), constant_values=v).reshape(nr, tile, 3)

    ro_b = jnp.broadcast_to(ro, rd.shape)
    tmax_b = jnp.broadcast_to(tmax, (R,))
    omin = p3(ro_b, jnp.inf).min(axis=1)
    omax = p3(ro_b, -jnp.inf).max(axis=1)
    dmin = p3(rd, jnp.inf).min(axis=1)
    dmax = p3(rd, -jnp.inf).max(axis=1)
    tmx = jnp.pad(tmax_b, (0, pad), constant_values=0.0).reshape(nr, tile).max(axis=1)
    endpoint = ro_b + rd * jnp.minimum(tmax_b, 3.0e37)[:, None]
    emin = p3(endpoint, jnp.inf).min(axis=1)
    emax = p3(endpoint, -jnp.inf).max(axis=1)
    seg_valid = (
        jnp.isfinite(emin).all(axis=1)
        & jnp.isfinite(emax).all(axis=1)
        & (jnp.abs(emax).max(axis=1) < 1e30)
        & (jnp.abs(emin).max(axis=1) < 1e30)
    ).astype(jnp.float32)
    return jnp.concatenate(
        [omin, omax, dmin, dmax, tmx[:, None], seg_valid[:, None], emin, emax], axis=1
    )


def tile_fold(x, h: int, w: int):
    """Row-major (H*W, C) pixel rows -> 32x32-pixel-block order (blocks
    row-major, pixels row-major inside a block), so every run of 2^k <= 1024
    consecutive rays is a compact screen rectangle with a tight direction
    cone — what makes per-tile culling effective.  Pure reshape/transpose;
    needs H and W divisible by 32 (``tile_foldable``)."""
    c = x.shape[-1]
    return x.reshape(h // 32, 32, w // 32, 32, c).transpose(0, 2, 1, 3, 4).reshape(-1, c)


def tile_unfold(x, h: int, w: int):
    """Inverse of ``tile_fold`` for (H*W, C) arrays."""
    c = x.shape[-1]
    return x.reshape(h // 32, w // 32, 32, 32, c).transpose(0, 2, 1, 3, 4).reshape(h * w, c)


def tile_foldable(h: int, w: int) -> bool:
    return h % 32 == 0 and w % 32 == 0

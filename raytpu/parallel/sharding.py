"""Multi-device sharding: the replacement for the reference's CPU-thread
pixel fan-out (reference: source/Renderer.cpp:42-92).

Two composable axes over a ``jax.sharding.Mesh`` (SURVEY.md §2 parallelism
checklist):

  * ``px``  — data parallelism over the pixel/ray grid (the analog of
    PPL ``parallel_for`` chunking; each device shades a contiguous ray block)
  * ``prim`` — primitive-array sharding ("model parallel" axis): triangles
    are split across devices, each intersects its shard against the whole
    ray block, and per-shard closest-hit records are merged with an
    all-gather + lexicographic (t, priority) argmin — the ray-tracing cousin
    of tensor-parallel partial-sum reduction.

Shadow occlusion reduces with a boolean ``any`` (pmax) over the prim axis.
Everything runs under ``shard_map`` so collectives are explicit; XLA hands
them to NCCL on the GPU.  Each device runs the single-device route on its
shard: when ``route.kind`` picks the culled sweep for the scene, the sweep
serves every shard's closest hit and any-hit.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from raytpu.core import math3d
from raytpu.core.types import RenderConfig, Scene
from raytpu.ops import accel, intersect
from raytpu.render import route, sweep as sweep_mod
from raytpu.render.renderer import generate_rays, shade_rays


def make_mesh(px: Optional[int] = None, prim: int = 1, devices=None) -> Mesh:
    """Build a (px, prim) device mesh.  ``px`` defaults to all devices / prim."""
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if px is None:
        assert n % prim == 0, (n, prim)
        px = n // prim
    assert px * prim == n, f"px*prim must equal device count ({px}x{prim} != {n})"
    dev_grid = np.asarray(devices).reshape(px, prim)
    return Mesh(dev_grid, axis_names=("px", "prim"))


def _pad_rows(arr, multiple, value=0.0):
    pad = (-arr.shape[0]) % multiple
    if pad == 0:
        return arr
    widths = [(0, pad)] + [(0, 0)] * (arr.ndim - 1)
    return jnp.pad(arr, widths, constant_values=value)


def _pad_triangles(tris, multiple):
    """Pad with degenerate triangles (all-zero vertices fail the determinant
    test, zero normals fail the parallel test -> guaranteed miss)."""
    return dataclasses.replace(
        tris,
        v0=_pad_rows(tris.v0, multiple),
        v1=_pad_rows(tris.v1, multiple),
        v2=_pad_rows(tris.v2, multiple),
        normal=_pad_rows(tris.normal, multiple),
        cull=_pad_rows(tris.cull, multiple),
        material=_pad_rows(tris.material, multiple),
    )


# ---------------------------------------------------------------------------
# Sharded closest-hit: per-shard records + lexicographic merge
# ---------------------------------------------------------------------------


def _local_closest_hit(scene: Scene, ro, rd, tmin, tri_prio_offset, use_sweep: bool,
                       interpret: bool):
    """Closest hit over (all spheres, all planes, THIS shard's triangles),
    plus a global priority id so the merge reproduces the reference's
    iteration-order tie-break (sphere < plane < triangle, low index first).

    ``use_sweep`` runs the per-device query on the culled sweep, whose
    kernel emits the winner's payload from its own registers."""
    S, Pn = scene.spheres.count, scene.planes.count
    ro_b = jnp.broadcast_to(ro, rd.shape)
    if use_sweep:
        t, idx, vec, mat = sweep_mod.closest_payload(scene, ro_b, rd, tmin, interpret)
        rec = intersect.hit_records_from_payload(ro_b, rd, t, idx, vec, mat, S)
    else:
        # chunk rays so the (chunk, C) t-matrix stays bounded instead of
        # materializing the full O(R*C) matrix per shard
        R = rd.shape[0]
        C = max(scene.num_primitives, 1)
        chunk = max(1024, min(R, ((1 << 24) // C + 1023) // 1024 * 1024))
        ro_p = _pad_rows(ro_b, chunk).reshape(-1, chunk, 3)
        rd_p = _pad_rows(rd, chunk, value=1.0).reshape(-1, chunk, 3)

        def body(args):
            ro_k, rd_k = args
            tmat = intersect.scene_t_matrix(scene, ro_k, rd_k, tmin, jnp.inf,
                                            shadow_pass=False)
            return jnp.min(tmat, axis=1), jnp.argmin(tmat, axis=1)

        t_c, idx_c = jax.lax.map(body, (ro_p, rd_p))
        t, idx = t_c.reshape(-1)[:R], idx_c.reshape(-1)[:R]
        rec = intersect.assemble_hit_records(scene, ro_b, rd, t, idx)
    # triangles sit after all spheres+planes globally; shift this shard's ids
    prio = jnp.where(idx < S + Pn, idx, idx + tri_prio_offset)
    return rec, prio


def _merge_records(rec: intersect.HitRecords, prio, axis: str):
    """All-gather per-shard winners over ``axis`` and pick (min t, min prio)."""
    g = lambda x: jax.lax.all_gather(x, axis)  # (D, R, ...)
    t = g(rec.t)
    prio_g = g(prio)
    t_min = jnp.min(t, axis=0)
    big = jnp.iinfo(jnp.int32).max
    cand = jnp.where(t == t_min[None, :], prio_g, big)
    d_star = jnp.argmin(cand, axis=0)  # (R,)
    take = lambda x: jnp.take_along_axis(
        g(x), d_star[(None, ...) + (None,) * (x.ndim - 1)], axis=0
    )[0]
    return intersect.HitRecords(
        hit=jnp.isfinite(t_min),
        t=t_min,
        point=take(rec.point),
        normal=take(rec.normal),
        material=take(rec.material),
    )


# ---------------------------------------------------------------------------
# The sharded render pipeline
# ---------------------------------------------------------------------------


def _shade_rays_sharded(scene: Scene, ro, rd, config: RenderConfig, tri_prio_offset,
                        prim_axis: str, use_sweep: bool, interpret: bool):
    """shade_rays with the closest-hit/any-hit queries reduced over the
    triangle-shard axis: the single-device pipeline runs per device on the
    local triangle shard, and per-shard winners merge with all_gather/pmax
    collectives."""

    def closest_fn(s, ro_b, rd_b, tmin):
        rec_local, prio = _local_closest_hit(s, ro_b, rd_b, tmin, tri_prio_offset,
                                             use_sweep, interpret)
        return _merge_records(rec_local, prio, prim_axis)

    def any_fn(s, p, l, tmin, mag):
        occ_local = intersect.any_hit(s, p, l, tmin, mag)
        return jax.lax.pmax(occ_local.astype(jnp.int32), prim_axis) > 0

    def any_multi_fn(s, p, dirs, mags, tmin):
        occ_local = sweep_mod.any_hit_lights(s, p, dirs, mags, tmin, interpret)
        return jax.lax.pmax(occ_local.astype(jnp.int32), prim_axis) > 0

    return shade_rays(
        scene, ro, rd, config,
        closest_fn=closest_fn,
        any_fn=any_fn,
        any_multi_fn=any_multi_fn if use_sweep else None,
    )


def render_pixels_shard_map(scene: Scene, config: RenderConfig, mesh: Mesh,
                            sweep: bool | None = None, interpret: bool = False):
    """Full sharded forward pass: rays split over ``px``, triangles over
    ``prim``.  Returns the (H, W, 3) f32 image (replicated).

    Every device takes the route ``route.kind`` picks for the whole scene
    (``sweep`` forces it); soft-shadow frames take the jnp path, as on one
    device."""
    n_px = mesh.shape["px"]
    n_prim = mesh.shape["prim"]

    tris = _pad_triangles(scene.triangles, max(n_prim, 1)) if scene.triangles.count else scene.triangles
    shard_size = tris.count // n_prim if tris.count else 0
    scene_rest = dataclasses.replace(scene, triangles=None)
    use_sweep = route.kind(scene, config, sweep) == "sweep"

    ro, rd = generate_rays(scene.camera, config)
    num_rays = rd.shape[0]
    # sweep path: feed rays in 32x32-pixel-block order so each device's
    # sweep tiles get tight direction cones (pure permutation, inverted below)
    tiled = use_sweep and accel.tile_foldable(config.height, config.width)
    if tiled:
        rd = accel.tile_fold(rd, config.height, config.width)
    rd = _pad_rows(rd, n_px, value=1.0)

    rest_spec = jax.tree_util.tree_map(lambda _: P(), scene_rest)
    tri_spec = jax.tree_util.tree_map(lambda _: P("prim"), tris)

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(rest_spec, tri_spec, P("px", None)),
        out_specs=P("px", None),
        check_vma=False,
    )
    def kernel(scene_rest_l, tris_l, rd_l):
        scene_l = dataclasses.replace(scene_rest_l, triangles=tris_l)
        offset = jax.lax.axis_index("prim") * shard_size
        return _shade_rays_sharded(scene_l, ro, rd_l, config, offset, "prim",
                                   use_sweep, interpret)

    colors = kernel(scene_rest, tris, rd)[:num_rays]
    if tiled:
        colors = accel.tile_unfold(colors, config.height, config.width)
    return colors.reshape(config.height, config.width, 3)


@functools.partial(jax.jit, static_argnames=("config", "mesh", "sweep", "interpret"))
def _render_sharded_jit(scene, config, mesh, sweep=None, interpret=False):
    return render_pixels_shard_map(scene, config, mesh, sweep, interpret)


def render_image_sharded(scene: Scene, config: RenderConfig, mesh: Mesh,
                         sweep: bool | None = None, interpret: bool = False):
    """Jitted sharded render to uint8 (H, W, 3)."""
    return math3d.quantize_u8(_render_sharded_jit(scene, config, mesh, sweep, interpret))

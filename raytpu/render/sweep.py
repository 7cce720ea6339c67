"""The culled triangle sweep: closest hit and all-lights shadow any-hit as
Pallas kernels for the GPU, written through Triton.

The dense jnp path tests every ray against every primitive and materializes
(rays x primitives) t-matrices in HBM (raytpu/render/renderer.py).  Here one
program takes one tile of ``TILE`` rays, keeps its per-ray state in
registers, and tests only the triangle groups its tile's worklist names:

  * the worklists are built in XLA from per-(tile, group) conservative
    culls (``raytpu.ops.accel``): groups are ``GROUP`` consecutive
    triangles in SAH-leaf order, so each group is one tight box;
  * a program reads its worklist count and loops over that many group ids
    (a ``fori_loop`` with a dynamic bound), reading the group's triangle
    records from global memory — the table is small enough to stay in L2;
  * spheres and planes are looped over their tables, not unrolled;
  * the closest hit carries (min t, winner id, winner payload) in
    registers and writes only O(R) outputs; the payload is the winner's
    sphere center or plane/triangle normal plus its material id, the same
    table ``intersect.assemble_hit_records`` gathers, so the records match
    the jnp path;
  * the any-hit runs one program per (ray tile, light), each with that
    light's light-anchored worklist.

Ties: groups are visited in ascending order and the fold updates on a
strict ``<``, so the first primitive in sphere -> plane -> triangle order
wins, as ``jnp.argmin`` does on the dense path.

The arithmetic mirrors the jnp formulas in raytpu/ops/intersect.py term by
term; f32 FMA contraction may still differ between the two compilers, so
comparisons carry a boundary-flip budget (tests/test_sweep.py, chip_smoke.py).

``interpret=True`` runs the kernels in the Pallas interpreter on the CPU;
only tests pass it.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from raytpu.core.types import LightKind, Scene
from raytpu.ops import accel
from raytpu.ops.intersect import FLT_EPSILON, HitRecords, hit_records_from_payload

TILE = 128  #: rays per program (power of two; swept on the H100, see PERF.md)
GROUP = accel.SAH_LEAF  #: triangles per cull group
NUM_WARPS = 4
NUM_STAGES = 2

SPH_COLS = 8  #: sphere record: [cx cy cz r^2 material 0 0 0]
PLN_COLS = 8  #: plane record: [nx ny nz ox oy oz material 0]
TRI_COLS = 16  #: triangle record: [v0(3) e1(3) e2(3) n(3) cull material 0 0]

_INF = float("inf")


# ---------------------------------------------------------------------------
# Tables: flat f32 records, read by scalar loads inside the kernels
# ---------------------------------------------------------------------------


def _sphere_table(spheres):
    if not spheres.count:
        return jnp.zeros((SPH_COLS,), jnp.float32)
    r = spheres.radius
    cols = [spheres.center[:, 0], spheres.center[:, 1], spheres.center[:, 2], r * r,
            spheres.material.astype(jnp.float32)]
    return _flat(cols, SPH_COLS)


def _plane_table(planes):
    if not planes.count:
        return jnp.zeros((PLN_COLS,), jnp.float32)
    n, o = planes.normal, planes.origin
    cols = [n[:, 0], n[:, 1], n[:, 2], o[:, 0], o[:, 1], o[:, 2],
            planes.material.astype(jnp.float32)]
    return _flat(cols, PLN_COLS)


def _triangle_table(tris):
    """(ng * GROUP * TRI_COLS,) records; the pad triangles up to a whole
    group are all-zero, whose zero normal fails the parallel test: a miss."""
    if not tris.count:
        return jnp.zeros((GROUP * TRI_COLS,), jnp.float32)
    e1 = tris.v1 - tris.v0
    e2 = tris.v2 - tris.v0
    cols = [tris.v0[:, 0], tris.v0[:, 1], tris.v0[:, 2],
            e1[:, 0], e1[:, 1], e1[:, 2], e2[:, 0], e2[:, 1], e2[:, 2],
            tris.normal[:, 0], tris.normal[:, 1], tris.normal[:, 2],
            tris.cull.astype(jnp.float32), tris.material.astype(jnp.float32)]
    pad = (-tris.count) % GROUP
    return jnp.pad(_flat(cols, TRI_COLS).reshape(-1, TRI_COLS),
                   ((0, pad), (0, 0))).reshape(-1)


def _flat(cols, width):
    rec = jnp.stack(cols, axis=1)
    return jnp.pad(rec, ((0, 0), (0, width - rec.shape[1]))).reshape(-1)


def _tiles(x, n_tiles):
    """(R,) -> (n_tiles * TILE,), zero-padded: a pad ray has direction 0,
    which every primitive test rejects."""
    return jnp.pad(x, (0, n_tiles * TILE - x.shape[0]))


# ---------------------------------------------------------------------------
# Primitive tests on a tile of rays (o, d: component tuples of (TILE,))
# ---------------------------------------------------------------------------


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _cross(a, b):
    return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def _sub(a, b):
    return a[0] - b[0], a[1] - b[1], a[2] - b[2]


def _sphere_t(o, d, c, r2, tmin, tmax):
    """Near-root sphere test (intersect._sphere_t_T), with the squared
    center-to-ray distance taken from the perpendicular vector
    (intersect.sphere_perp2)."""
    L = _sub(c, o)
    proj = _dot(d, L)
    f = _sub(L, (d[0] * proj, d[1] * proj, d[2] * proj))
    perp2 = _dot(f, f)
    inside = r2 >= perp2
    t = proj - jnp.sqrt(jnp.where(inside, r2 - perp2, 1.0))
    return jnp.where(inside & (t >= tmin) & (t <= tmax), t, _INF)


def _plane_t(o, d, n, po, tmin, tmax):
    """Plane test on [tmin, tmax) (intersect._plane_t_T)."""
    denom = _dot(d, n)
    num = _dot(_sub(po, o), n)
    denom_nz = denom != 0.0
    t = num / jnp.where(denom_nz, denom, 1.0)
    return jnp.where(denom_nz & (t >= tmin) & (t < tmax), t, _INF)


def _triangle_t(o, d, rec, tmin, tmax, shadow: bool):
    """Möller–Trumbore with per-triangle cull modes; shadow rays swap front
    and back culling (intersect._triangle_t_T)."""
    v0, e1, e2, n = rec[0:3], rec[3:6], rec[6:9], rec[9:12]
    cull = rec[12]
    cull_dot = _dot(n, d)
    not_parallel = jnp.abs(cull_dot) >= FLT_EPSILON
    if shadow:
        cull = jnp.where(cull == 2.0, 2.0, 1.0 - cull)
    culled = ((cull == 0.0) & (cull_dot < 0.0)) | ((cull == 1.0) & (cull_dot > 0.0))
    h = _cross(d, e2)
    a = _dot(e1, h)
    det_ok = jnp.abs(a) >= FLT_EPSILON
    inv_a = 1.0 / jnp.where(det_ok, a, 1.0)
    s = _sub(o, v0)
    u = inv_a * _dot(s, h)
    q = _cross(s, e1)
    v = inv_a * _dot(d, q)
    t = inv_a * _dot(e2, q)
    bary_ok = (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
    valid = not_parallel & ~culled & det_ok & bary_ok & (t >= tmin) & (t < tmax)
    return jnp.where(valid, t, _INF)


def _record(ref, base, n):
    return [ref[base + c] for c in range(n)]


# ---------------------------------------------------------------------------
# Kernels
# ---------------------------------------------------------------------------


def _closest_kernel(cnt_ref, wl_ref, sph_ref, pln_ref, tri_ref,
                    ox_ref, oy_ref, oz_ref, dx_ref, dy_ref, dz_ref,
                    t_ref, id_ref, vx_ref, vy_ref, vz_ref, mat_ref,
                    *, n_sph, n_pln, n_groups, tmin):
    tile = pl.program_id(0)
    o = (ox_ref[...], oy_ref[...], oz_ref[...])
    d = (dx_ref[...], dy_ref[...], dz_ref[...])
    zero = jnp.zeros_like(o[0])
    acc = (jnp.full_like(zero, _INF), jnp.zeros(zero.shape, jnp.int32),
           zero, zero, zero, zero)

    def take(acc, tc, prim, payload):
        better = tc < acc[0]
        new = [jnp.where(better, tc, acc[0]), jnp.where(better, prim, acc[1])]
        return tuple(new + [jnp.where(better, p, a) for p, a in zip(payload, acc[2:])])

    def sphere(s, acc):
        rec = _record(sph_ref, s * SPH_COLS, 5)
        tc = _sphere_t(o, d, rec[0:3], rec[3], tmin, _INF)
        return take(acc, tc, s, (rec[0], rec[1], rec[2], rec[4]))

    def plane(p, acc):
        rec = _record(pln_ref, p * PLN_COLS, 7)
        tc = _plane_t(o, d, rec[0:3], rec[3:6], tmin, _INF)
        return take(acc, tc, n_sph + p, (rec[0], rec[1], rec[2], rec[6]))

    def group(j, acc):
        g = wl_ref[tile * n_groups + j]
        for k in range(GROUP):
            tri = g * GROUP + k
            rec = _record(tri_ref, tri * TRI_COLS, 14)
            tc = _triangle_t(o, d, rec, tmin, _INF, shadow=False)
            acc = take(acc, tc, n_sph + n_pln + tri, (rec[9], rec[10], rec[11], rec[13]))
        return acc

    if n_sph:
        acc = jax.lax.fori_loop(0, n_sph, sphere, acc)
    if n_pln:
        acc = jax.lax.fori_loop(0, n_pln, plane, acc)
    acc = jax.lax.fori_loop(0, cnt_ref[tile], group, acc)
    for ref, val in zip((t_ref, id_ref, vx_ref, vy_ref, vz_ref, mat_ref), acc):
        ref[...] = val


def _any_kernel(cnt_ref, wl_ref, sph_ref, pln_ref, tri_ref,
                px_ref, py_ref, pz_ref, lx_ref, ly_ref, lz_ref, mag_ref, occ_ref,
                *, n_sph, n_pln, n_groups, n_tiles, tmin):
    tile, light = pl.program_id(0), pl.program_id(1)
    o = (px_ref[...], py_ref[...], pz_ref[...])
    d = (lx_ref[...], ly_ref[...], lz_ref[...])
    mag = mag_ref[...]
    occ = jnp.zeros(mag.shape, jnp.int32)

    def hit(occ, tc):
        return jnp.where(tc < _INF, 1, occ)

    def sphere(s, occ):
        rec = _record(sph_ref, s * SPH_COLS, 4)
        return hit(occ, _sphere_t(o, d, rec[0:3], rec[3], tmin, mag))

    def plane(p, occ):
        rec = _record(pln_ref, p * PLN_COLS, 6)
        return hit(occ, _plane_t(o, d, rec[0:3], rec[3:6], tmin, mag))

    row = light * n_tiles + tile

    def group(j, occ):
        g = wl_ref[row * n_groups + j]
        for k in range(GROUP):
            rec = _record(tri_ref, (g * GROUP + k) * TRI_COLS, 13)
            occ = hit(occ, _triangle_t(o, d, rec, tmin, mag, shadow=True))
        return occ

    if n_sph:
        occ = jax.lax.fori_loop(0, n_sph, sphere, occ)
    if n_pln:
        occ = jax.lax.fori_loop(0, n_pln, plane, occ)
    occ_ref[...] = jax.lax.fori_loop(0, cnt_ref[row], group, occ)


_PARAMS = plgpu.CompilerParams(num_warps=NUM_WARPS, num_stages=NUM_STAGES)


def _ray_spec(grid_rank):
    if grid_rank == 1:
        return pl.BlockSpec((TILE,), lambda i: (i,))
    return pl.BlockSpec((TILE,), lambda i, l: (i,))


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def closest_hit(scene: Scene, ro, rd, tmin, interpret: bool = False) -> HitRecords:
    """Drop-in for ``intersect.closest_hit`` on the culled sweep (not
    differentiable: the detached path re-derives what it differentiates,
    raytpu/grad/fast.py).  ``ro`` (R, 3) or (3,), ``rd`` (R, 3)."""
    t, idx, vec, mat = closest_payload(scene, ro, rd, tmin, interpret)
    return hit_records_from_payload(jnp.broadcast_to(ro, rd.shape), rd, t, idx, vec, mat,
                                    scene.spheres.count)


def min_t(scene: Scene, ro, rd, tmin, interpret: bool = False):
    """``(t, global idx)`` winner search, the ``min_t_fn`` of
    ``grad.fast.detached_closest_hit``."""
    t, idx, _, _ = closest_payload(scene, ro, rd, tmin, interpret)
    return t, idx


def closest_payload(scene: Scene, ro, rd, tmin, interpret: bool = False):
    """Culled winner search.  Returns ``(t (R,), idx (R,) i32, vec (R, 3),
    mat (R,) f32)``: t is +inf on a miss; idx runs over spheres, planes,
    triangles; vec/mat are the winner's payload (see module docstring)."""
    R = rd.shape[0]
    nt = -(-R // TILE)
    ro_b = jnp.broadcast_to(ro, rd.shape)
    tmin = float(tmin)
    tris = scene.triangles
    if tris.count:
        lo, hi = accel.chunk_bounds(tris, GROUP)
        rb = accel.ray_tile_bounds(ro_b, rd, jnp.inf, tile=TILE)
        wl, cnt = accel.chunk_worklist(accel.cull_matrix(rb, lo, hi, tmin))
    else:
        wl, cnt = jnp.zeros((nt, 1), jnp.int32), jnp.zeros((nt,), jnp.int32)
    kernel = functools.partial(
        _closest_kernel, n_sph=scene.spheres.count, n_pln=scene.planes.count,
        n_groups=wl.shape[1], tmin=tmin)
    rays = [_tiles(x, nt) for x in (*ro_b.T, *rd.T)]
    f32 = jax.ShapeDtypeStruct((nt * TILE,), jnp.float32)
    i32 = jax.ShapeDtypeStruct((nt * TILE,), jnp.int32)
    outs = pl.pallas_call(
        kernel,
        grid=(nt,),
        in_specs=[pl.no_block_spec] * 5 + [_ray_spec(1)] * 6,
        out_specs=[_ray_spec(1)] * 6,
        out_shape=[f32, i32, f32, f32, f32, f32],
        backend="triton",
        compiler_params=_PARAMS,
        interpret=interpret,
        name="sweep_closest_hit",
    )(cnt, wl.reshape(-1), _sphere_table(scene.spheres), _plane_table(scene.planes),
      _triangle_table(tris), *rays)
    t, idx, vx, vy, vz, mat = (x[:R] for x in outs)
    return t, idx, jnp.stack([vx, vy, vz], axis=1), mat


def any_hit_lights(scene: Scene, p, dirs, mags, tmin, interpret: bool = False):
    """(L, R) bool shadow occlusion for every light — the ``any_multi_fn``
    of ``renderer.shade_from_records``.  ``p`` (R, 3) shadow origins,
    ``dirs`` (L, R, 3) unit directions to the lights, ``mags`` (L, R)
    segment lengths.  Shadow rays invert triangle front/back culling
    (reference: source/Utils.h:114-127)."""
    L, R = mags.shape
    if not L:
        return jnp.zeros((0, R), bool)
    nt = -(-R // TILE)
    tmin = float(tmin)
    tris = scene.triangles
    if tris.count:
        lo, hi = accel.chunk_bounds(tris, GROUP)
        lights = scene.lights
        culls = [accel.shadow_cull_matrix(
            p, dirs[li], mags[li], lights.position[li],
            lights.kind[li] == LightKind.POINT, lo, hi, tmin, tile=TILE)
            for li in range(L)]
        wl, cnt = accel.chunk_worklist(jnp.concatenate(culls, axis=0))  # (L*nt, ng)
    else:
        wl, cnt = jnp.zeros((L * nt, 1), jnp.int32), jnp.zeros((L * nt,), jnp.int32)
    kernel = functools.partial(
        _any_kernel, n_sph=scene.spheres.count, n_pln=scene.planes.count,
        n_groups=wl.shape[1], n_tiles=nt, tmin=tmin)
    per_light = pl.BlockSpec((None, TILE), lambda i, l: (l, i))
    lit = [jnp.pad(x, ((0, 0), (0, nt * TILE - R)))
           for x in (dirs[..., 0], dirs[..., 1], dirs[..., 2], mags)]
    occ = pl.pallas_call(
        kernel,
        grid=(nt, L),
        in_specs=[pl.no_block_spec] * 5 + [_ray_spec(2)] * 3 + [per_light] * 4,
        out_specs=per_light,
        out_shape=jax.ShapeDtypeStruct((L, nt * TILE), jnp.int32),
        backend="triton",
        compiler_params=_PARAMS,
        interpret=interpret,
        name="sweep_any_hit",
    )(cnt, wl.reshape(-1), _sphere_table(scene.spheres), _plane_table(scene.planes),
      _triangle_table(tris), *(_tiles(x, nt) for x in p.T), *lit)
    return occ[:, :R] > 0

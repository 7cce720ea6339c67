"""Batched ray-primitive intersection ops.

Every hit test from the reference (reference: source/Utils.h namespace
GeometryUtils) becomes a masked, vectorized formula over (rays x primitives);
``didHit`` booleans become masks, the ``t = FLT_MAX`` sentinel + first-argmin
replaces the sequential strict-< closest-hit update
(reference: source/Scene.cpp:29-66).

Layout: public APIs take/return (R, 3) ray arrays and (R, N) t-matrices, but
all internal math runs components-major — (R,) per-component ray arrays and
(N, R) primitive x ray matrices — so the minor (contiguous) dimension is the
ray axis instead of a 3- or N-wide one (see raytpu/ops/soa.py).

Conventions:
  * rays: ``ro`` (R,3) origins, ``rd`` (R,3) unit directions
  * a miss is encoded as ``t = +inf``
  * primitive order inside the flattened t-matrix is spheres, planes,
    triangles — jnp.argmin picks the first minimum, which reproduces the
    reference's iteration-order tie-break.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp

from raytpu.core.types import Scene
from raytpu.ops import soa

FLT_EPSILON = 1.1920929e-07
INF = jnp.inf
_OCC_MAX = 1.0 - 1e-6  # keep soft-occlusion factors away from exactly 1


def _dot(a, b):
    return jnp.sum(a * b, axis=-1)


def _row(x):
    """Per-ray (R,) or scalar -> broadcastable against (N, R)."""
    return x[None, :] if getattr(x, "ndim", 0) == 1 else x


# ---------------------------------------------------------------------------
# Per-class t computation, components-major: rays as c3 of (R,) ->  t (N, R)
# ---------------------------------------------------------------------------


def sphere_perp2(L, proj, rd):
    """Squared distance from a sphere's center to the ray, ``|L - proj d|^2``.

    The reference's ``L.L - proj^2`` (reference: source/Utils.h:52-71)
    subtracts two numbers of size |L|^2 that agree to within r^2, so most of
    its float32 digits cancel, and whether the compiler fuses the multiply
    into the subtraction (an FMA) moves the hit point by more than the
    shadow-ray offset: shadow acne whose pattern differs between CPU and
    GPU.  The perpendicular vector keeps the error at the size of r."""
    f = soa.sub(L, soa.scale(rd, proj))
    return soa.dot(f, f)


def _sphere_t_T(spheres, ro, rd, tmin, tmax):
    """Geometric sphere test, near root only — rays starting inside a sphere
    miss it, exactly like the reference (reference: source/Utils.h:52-71)."""
    c = soa.rows(spheres.center)  # (S,1) each
    r = spheres.radius[:, None]  # (S,1)
    L = soa.sub(c, ro)  # (S,R)
    proj = soa.dot(rd, L)
    perp2 = sphere_perp2(L, proj, rd)
    r2 = r * r
    inside = r2 >= perp2
    # double-where keeps sqrt's VJP finite on miss lanes without changing
    # any valid lane's forward value
    disc = jnp.where(inside, r2 - perp2, 1.0)
    t = proj - jnp.sqrt(disc)
    valid = inside & (t >= tmin) & (t <= _row(tmax))
    return jnp.where(valid, t, INF)


def _plane_t_T(planes, ro, rd, tmin, tmax):
    """``t = dot(po-ro, n)/dot(rd, n)``, valid on [tmin, tmax)
    (reference: source/Utils.h:82-98)."""
    n = soa.rows(planes.normal)  # (P,1)
    o = soa.rows(planes.origin)
    denom = soa.dot(rd, n)  # (P,R)
    num = soa.dot(soa.sub(o, ro), n)
    denom_nz = denom != 0.0  # exactly-parallel rays miss (reference: inf fails the range test)
    t = num / jnp.where(denom_nz, denom, 1.0)
    valid = denom_nz & (t >= tmin) & (t < _row(tmax))
    return jnp.where(valid, t, INF)


def _triangle_t_T(tris, ro, rd, tmin, tmax, shadow_pass: bool):
    """Möller–Trumbore with per-triangle cull modes; shadow rays swap
    front/back culling (reference: source/Utils.h:109-184).

    ``shadow_pass`` is a static flag.  Valid t range is [tmin, tmax).
    """
    v0 = soa.rows(tris.v0)  # (T,1)
    nrm = soa.rows(tris.normal)
    cull = tris.cull[:, None]  # (T,1)
    cull_dot = soa.dot(nrm, rd)  # (T,R)
    not_parallel = jnp.abs(cull_dot) >= FLT_EPSILON

    if shadow_pass:
        # FrontFaceCulling <-> BackFaceCulling; NoCulling unchanged
        cull_eff = jnp.where(cull == 2, 2, 1 - cull)
    else:
        cull_eff = cull
    culled = ((cull_eff == 0) & (cull_dot < 0)) | ((cull_eff == 1) & (cull_dot > 0))

    e1 = soa.sub(soa.rows(tris.v1), v0)  # (T,1)
    e2 = soa.sub(soa.rows(tris.v2), v0)
    h = soa.cross(rd, e2)  # (T,R)
    a = soa.dot(e1, h)
    det_ok = jnp.abs(a) >= FLT_EPSILON
    inv_a = 1.0 / jnp.where(det_ok, a, 1.0)
    s = soa.sub(ro, v0)  # (T,R)
    u = inv_a * soa.dot(s, h)
    q = soa.cross(s, e1)
    v = inv_a * soa.dot(rd, q)
    t = inv_a * soa.dot(e2, q)
    bary_ok = (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
    valid = not_parallel & ~culled & det_ok & bary_ok & (t >= tmin) & (t < _row(tmax))
    return jnp.where(valid, t, INF)


def _scene_t_matrix_T(scene: Scene, ro, rd, tmin, tmax, shadow_pass: bool):
    """All primitive t values as one (S+P+T, R) matrix (inf = miss).
    ``ro``/``rd`` are c3 tuples of (R,); ``tmax`` is scalar or (R,)."""
    rows = []
    if scene.spheres.count:
        rows.append(_sphere_t_T(scene.spheres, ro, rd, tmin, tmax))
    if scene.planes.count:
        rows.append(_plane_t_T(scene.planes, ro, rd, tmin, tmax))
    if scene.triangles.count:
        rows.append(_triangle_t_T(scene.triangles, ro, rd, tmin, tmax, shadow_pass))
    if not rows:
        return jnp.full((1, ro[0].shape[0]), INF, ro[0].dtype)
    return jnp.concatenate(rows, axis=0)


# ---------------------------------------------------------------------------
# Public per-class APIs in the (R, N) convention (kept for tests/tools)
# ---------------------------------------------------------------------------


def sphere_t(center, radius, ro, rd, tmin, tmax):
    """(R, S) sphere t-matrix (see ``_sphere_t_T`` for the math)."""
    from raytpu.core.types import Spheres

    sph = Spheres(center=center, radius=radius, material=jnp.zeros(center.shape[0], jnp.int32))
    return _sphere_t_T(sph, soa.comps(ro), soa.comps(rd), tmin, _colmax(tmax)).T


def plane_t(origin, normal, ro, rd, tmin, tmax):
    """(R, P) plane t-matrix (see ``_plane_t_T`` for the math)."""
    from raytpu.core.types import Planes

    pl = Planes(origin=origin, normal=normal, material=jnp.zeros(origin.shape[0], jnp.int32))
    return _plane_t_T(pl, soa.comps(ro), soa.comps(rd), tmin, _colmax(tmax)).T


def triangle_t(v0, v1, v2, normal, cull, ro, rd, tmin, tmax, shadow_pass: bool):
    """(R, T) triangle t-matrix (see ``_triangle_t_T`` for the math)."""
    from raytpu.core.types import Triangles

    tr = Triangles(
        v0=v0, v1=v1, v2=v2, normal=normal, cull=cull,
        material=jnp.zeros(v0.shape[0], jnp.int32),
    )
    return _triangle_t_T(tr, soa.comps(ro), soa.comps(rd), tmin, _colmax(tmax), shadow_pass).T


def _colmax(tmax):
    """Accept the legacy (R, 1) column/broadcast tmax as scalar-or-(R,)."""
    if getattr(tmax, "ndim", 0) == 2:
        return tmax[:, 0]
    return tmax


def scene_t_matrix(scene: Scene, ro, rd, tmin, tmax, shadow_pass: bool):
    """All primitive t values as one (R, S+P+T) matrix (inf = miss)."""
    return _scene_t_matrix_T(
        scene, soa.comps(ro), soa.comps(rd), tmin, _colmax(tmax), shadow_pass
    ).T


# ---------------------------------------------------------------------------
# Scene-level queries
# ---------------------------------------------------------------------------


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class HitRecords:
    """Batched HitRecord (reference: source/DataTypes.h:567-575)."""

    hit: jnp.ndarray  # (R,) bool
    t: jnp.ndarray  # (R,) f32, +inf on miss
    point: jnp.ndarray  # (R,3)
    normal: jnp.ndarray  # (R,3) unit
    material: jnp.ndarray  # (R,) i32


def closest_hit(scene: Scene, ro, rd, tmin) -> HitRecords:
    """First-argmin closest hit + payload gather for the winning primitive
    (replaces Scene::GetClosestHit, reference: source/Scene.cpp:29-66)."""
    ro_c, rd_c = soa.comps(ro), soa.comps(rd)
    tmat = _scene_t_matrix_T(scene, ro_c, rd_c, tmin, INF, shadow_pass=False)
    idx = jnp.argmin(tmat, axis=0)  # first minimum wins ties
    t = jnp.min(tmat, axis=0)  # the winning t IS the min: no gather needed
    return assemble_hit_records(scene, ro, rd, t, idx)


# one-hot payload matmuls must fit next to the t-matrix in HBM
_ONEHOT_MAX_ELEMS = 1 << 25


def assemble_hit_records(scene: Scene, ro, rd, t, idx) -> HitRecords:
    """Build HitRecords from a per-ray winning (t, global primitive index)
    where the index runs over the sphere→plane→triangle concatenation.

    The winning primitive's payload (center for spheres, normal for planes
    and triangles, plus the material id) is gathered with a masked one-hot
    matmul at HIGHEST precision against a packed (C, 4) table, laid out
    components-major — ``(4, C) @ (C, R)``.  Scenes whose (C, R) one-hot
    would exceed ``_ONEHOT_MAX_ELEMS`` gather through the grouped two-level
    one-hot instead (``soa.gather_cols``).  Whether a plain indexed gather
    is faster on the GPU is not measured yet (ROADMAP).
    """
    hit = jnp.isfinite(t)
    S, P = scene.spheres.count, scene.planes.count
    T = scene.triangles.count
    C = S + P + T

    if not C:
        ro_b = jnp.broadcast_to(ro, rd.shape)
        z = jnp.zeros_like(t)
        return hit_records_from_payload(ro_b, rd, t, idx, jnp.zeros_like(rd), z, 0)
    rows = []
    if S:  # sphere rows carry the CENTER (normal derived below)
        rows.append(
            jnp.concatenate(
                [scene.spheres.center, scene.spheres.material[:, None].astype(t.dtype)],
                axis=1,
            )
        )
    if P:
        rows.append(
            jnp.concatenate(
                [scene.planes.normal, scene.planes.material[:, None].astype(t.dtype)],
                axis=1,
            )
        )
    if T:
        tr = scene.triangles
        rows.append(
            jnp.concatenate([tr.normal, tr.material[:, None].astype(t.dtype)], axis=1)
        )
    table = jnp.concatenate(rows, axis=0)  # (C, 4)
    # single one-hot within the HBM cap; grouped two-level beyond it
    out = soa.gather_cols(
        table, idx, hit, max(1, _ONEHOT_MAX_ELEMS // max(t.shape[0], 1))
    )  # (4, R)
    return hit_records_from_payload(
        jnp.broadcast_to(ro, rd.shape), rd, t, idx, out[:3].T, out[3], S)


def hit_records_from_payload(ro_b, rd, t, idx, vec, mat, n_spheres: int) -> HitRecords:
    """HitRecords from a winner's (t, global id) and payload: ``vec`` (R, 3)
    is the sphere's center or the plane's/triangle's normal, ``mat`` (R,)
    the material id as f32.  The one place the payload becomes records —
    shared by ``assemble_hit_records`` and the culled sweep, which emits the
    same payload from its fold registers (raytpu/render/sweep.py)."""
    hit = jnp.isfinite(t)
    t_safe = jnp.where(hit, t, 0.0)
    ro_c, rd_c = soa.comps(ro_b), soa.comps(rd)
    p_c = soa.add(ro_c, soa.scale(rd_c, t_safe))
    v_c = soa.comps(vec)
    if n_spheres:
        in_s = (idx < n_spheres) & hit
        # normal normalized after selection (reference: source/Scene.cpp:40);
        # double-where: keep the unselected normalize argument away from 0
        d_c = soa.where(in_s, soa.sub(p_c, v_c), (1.0, 1.0, 1.0))
        n_c = soa.where(in_s, soa.normalize_safe(d_c), v_c)
    else:
        n_c = v_c
    # material ids are small ints: exact in f32
    return HitRecords(
        hit=hit, t=jnp.where(hit, t, INF), point=soa.pack(*p_c),
        normal=soa.pack(*n_c), material=jnp.round(mat).astype(jnp.int32),
    )


def soft_transmittance(scene: Scene, ro, rd, tmin, tmax, beta):
    """Differentiable visibility in [0, 1] for shadow rays.

    Replaces the binary ``DoesHit`` occlusion with a product over primitives
    of ``1 - occlusion_p``, where each occlusion is a sigmoid of a signed
    penetration margin (how solidly the shadow ray passes through the
    primitive).  Converges to ``1 - any_hit`` as ``beta -> inf``; gives the
    pixel gradients w.r.t. geometry/light positions that the hard visibility
    term zeroes out (SURVEY.md §7 "differentiability layered on").

    ``tmax`` is per-ray (R,).  Returns (R,) transmittance.

    Occlusions are clamped strictly below 1: jnp.prod's VJP divides by its
    factors, so an exactly-zero (1 - occ) factor would NaN the gradient.
    """
    ro_c, rd_c = soa.comps(ro), soa.comps(rd)
    trans = jnp.ones_like(ro[:, 0])
    tmax_r = _row(tmax)

    if scene.spheres.count:
        c = soa.rows(scene.spheres.center)  # (S,1)
        r = scene.spheres.radius[:, None]
        L = soa.sub(c, ro_c)  # (S,R)
        proj = soa.dot(rd_c, L)
        perp2 = sphere_perp2(L, proj, rd_c)
        r2 = r * r
        margin = (r2 - perp2) / r2  # >0 when the ray core passes inside
        inside = margin > 0.0
        t = proj - jnp.sqrt(jnp.where(inside, r2 - perp2, 1.0))
        gate = inside & (t >= tmin) & (t <= tmax_r)
        occ = jnp.minimum(jax.nn.sigmoid(beta * margin), _OCC_MAX) * gate
        trans = trans * jnp.prod(1.0 - occ, axis=0)

    if scene.planes.count:
        # Planes are infinite, so their shadow boundary in image space comes
        # from the segment ENDPOINTS crossing the plane (receiver or light
        # moving through it), not from a silhouette edge.  The signed margin
        # is the distance (in t units) by which the crossing sits inside
        # [tmin, tmax): gradients flow to plane origin/normal through t and
        # to light/receiver positions through t and tmax.
        n = soa.rows(scene.planes.normal)
        o = soa.rows(scene.planes.origin)
        denom = soa.dot(rd_c, n)  # (P,R)
        num = soa.dot(soa.sub(o, ro_c), n)
        denom_nz = jnp.abs(denom) > FLT_EPSILON
        t = num / jnp.where(denom_nz, denom, 1.0)
        margin = jnp.minimum(t - tmin, tmax_r - t)  # absolute t units
        gate = denom_nz & (margin > 0.0)
        occ = jnp.minimum(jax.nn.sigmoid(beta * margin), _OCC_MAX) * gate
        trans = trans * jnp.prod(1.0 - occ, axis=0)

    if scene.triangles.count:
        tr = scene.triangles
        v0 = soa.rows(tr.v0)
        nrm = soa.rows(tr.normal)
        cull = tr.cull[:, None]
        cull_dot = soa.dot(nrm, rd_c)  # (T,R)
        not_parallel = jnp.abs(cull_dot) >= FLT_EPSILON
        cull_eff = jnp.where(cull == 2, 2, 1 - cull)  # shadow pass inverts
        culled = ((cull_eff == 0) & (cull_dot < 0)) | ((cull_eff == 1) & (cull_dot > 0))
        e1 = soa.sub(soa.rows(tr.v1), v0)
        e2 = soa.sub(soa.rows(tr.v2), v0)
        h = soa.cross(rd_c, e2)
        a = soa.dot(e1, h)
        det_ok = jnp.abs(a) >= FLT_EPSILON
        inv_a = 1.0 / jnp.where(det_ok, a, 1.0)
        s = soa.sub(ro_c, v0)
        u = inv_a * soa.dot(s, h)
        q = soa.cross(s, e1)
        v = inv_a * soa.dot(rd_c, q)
        t = inv_a * soa.dot(e2, q)
        # signed distance to the triangle boundary in barycentric coords
        margin = jnp.minimum(jnp.minimum(u, v), 1.0 - u - v)
        gate = not_parallel & ~culled & det_ok & (t >= tmin) & (t < tmax_r)
        occ = jnp.minimum(jax.nn.sigmoid(beta * margin), _OCC_MAX) * gate
        trans = trans * jnp.prod(1.0 - occ, axis=0)

    return trans


def any_hit(scene: Scene, ro, rd, tmin, tmax):
    """Boolean occlusion query for shadow rays, with inverted triangle culling
    (replaces Scene::DoesHit, reference: source/Scene.cpp:68-96).

    ``tmax`` is per-ray (R,) — the distance to the light.
    """
    tmat = _scene_t_matrix_T(
        scene, soa.comps(ro), soa.comps(rd), tmin, tmax, shadow_pass=True
    )
    return jnp.any(jnp.isfinite(tmat), axis=0)

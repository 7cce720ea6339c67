"""Fast differentiable rendering: detached-hit closest intersection.

The closest-hit argmin over primitives is piecewise CONSTANT in the scene
parameters: except exactly at visibility boundaries (a measure-zero set),
moving a sphere center or a light does not change *which* primitive a pixel
sees.  So its gradient contribution is zero almost everywhere, and the
winning-primitive index can be computed entirely outside the autodiff graph.

``detached_closest_hit`` exploits this: the O(R*N) t-matrix + argmin runs
under ``stop_gradient`` (forward only — XLA saves no residuals and builds no
backward for it), then t, point, and normal are re-derived differentiably for
the ONE winning primitive per ray via index gathers — O(R) differentiated
work instead of O(R*N).  The value is the same math on the same winner as
:func:`raytpu.ops.intersect.closest_hit`, so the primal image is unchanged;
only the (exactly-zero-a.e.) boundary gradients are dropped.

Gathers of the winning primitive's parameters are expressed as one-hot
matmuls (at HIGHEST precision) with a detached one-hot matrix: the VJP of an
indexed gather is a scatter-add, while the matmul's transpose is another
matmul.  Whether a plain gather is faster on the GPU is not measured yet
(ROADMAP).

The expensive differentiable term that REMAINS O(R*N*L) is
``soft_transmittance`` — intentionally: its sigmoid shadow edges are the
gradients inverse rendering needs (every nearby occluder contributes, not
just an argmin), so they cannot be detached.

Replaces the gradient path through ``Scene::GetClosestHit`` (reference:
source/Scene.cpp:29-66) — the reference has no gradients at all; this is the
differentiability layer of SURVEY.md §7.4 made cheap.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from raytpu.ops import intersect, soa
from raytpu.ops.intersect import FLT_EPSILON, INF, HitRecords


# gather of a detached winner's table row: one-hot / grouped-one-hot matmuls
# whose VJP is a matmul; see raytpu.ops.soa.gather_cols
_gather_cols = soa.gather_cols


def detached_closest_hit(scene, ro, rd, tmin, onehot_max: int = 4096,
                         min_t_fn=None) -> HitRecords:
    """Drop-in for ``intersect.closest_hit`` with a detached argmin.

    Differentiable w.r.t. scene geometry through the winning primitive's
    re-derived t/normal; the winner selection itself carries no gradient
    (exact a.e. — see module docstring).  Classes with ``count <= onehot_max``
    gather via one-hot matmuls; larger tables fall back to indexed gathers.

    ``min_t_fn(scene, ro, rd, tmin) -> (t, global idx)`` overrides the dense
    jnp t-matrix for the (detached, forward-only) winner search — e.g. the
    culled sweep's ``raytpu.render.sweep.min_t`` on big meshes; because the
    search is under ``stop_gradient``, the override needs no VJP.
    """
    sg = jax.lax.stop_gradient
    ro_c, rd_c = soa.comps(ro), soa.comps(rd)
    if min_t_fn is not None:
        t_det, idx = min_t_fn(sg(scene), sg(ro), sg(rd), tmin)
        hit = jnp.isfinite(t_det)
    else:
        tmat = intersect._scene_t_matrix_T(
            sg(scene), soa.comps(sg(ro)), soa.comps(sg(rd)), tmin, INF, shadow_pass=False
        )
        idx = jnp.argmin(tmat, axis=0)  # first minimum wins ties
        hit = jnp.isfinite(jnp.min(tmat, axis=0))  # the winning t IS the min

    S, P, T = scene.spheres.count, scene.planes.count, scene.triangles.count
    R = rd.shape[0]
    # cap the one-hot's HBM footprint next to the t-matrix: classes past the
    # cap gather through the grouped two-level one-hot (soa.gather_cols)
    onehot_max = min(onehot_max, max(1, (1 << 25) // max(R, 1)))
    t = jnp.full((R,), INF, rd.dtype)
    n_c = (jnp.zeros((R,), rd.dtype),) * 3
    material = jnp.zeros((R,), jnp.int32)
    c_sph = None

    if S:
        in_s = (idx < S) & hit
        si = jnp.clip(idx, 0, S - 1)
        cr = _gather_cols(
            jnp.concatenate(
                [
                    scene.spheres.center,
                    scene.spheres.radius[:, None],
                    scene.spheres.material[:, None].astype(rd.dtype),
                ],
                axis=1,
            ),
            si, in_s, onehot_max,
        )
        c_sph, r = (cr[0], cr[1], cr[2]), cr[3]
        L = soa.sub(c_sph, ro_c)
        proj = soa.dot(rd_c, L)
        perp2 = intersect.sphere_perp2(L, proj, rd_c)
        # double-where: the sqrt argument of non-winning lanes is clamped so
        # its unbounded partial never enters the VJP (CLAUDE.md grad safety)
        arg = jnp.where(in_s, r * r - perp2, 1.0)
        t_s = proj - jnp.sqrt(jnp.maximum(arg, 1e-20))
        t = jnp.where(in_s, t_s, t)
        # material ids are small ints: exact through the f32 gather
        material = jnp.where(in_s, jnp.round(cr[4]).astype(jnp.int32), material)

    if P:
        in_p = (idx >= S) & (idx < S + P) & hit
        pi = jnp.clip(idx - S, 0, P - 1)
        no = _gather_cols(
            jnp.concatenate(
                [
                    scene.planes.normal,
                    scene.planes.origin,
                    scene.planes.material[:, None].astype(rd.dtype),
                ],
                axis=1,
            ),
            pi, in_p, onehot_max,
        )
        n_p, o_p = (no[0], no[1], no[2]), (no[3], no[4], no[5])
        denom = soa.dot(rd_c, n_p)
        denom = jnp.where(in_p & (jnp.abs(denom) > FLT_EPSILON), denom, 1.0)
        t_p = soa.dot(soa.sub(o_p, ro_c), n_p) / denom
        t = jnp.where(in_p, t_p, t)
        n_c = soa.where(in_p, n_p, n_c)
        material = jnp.where(in_p, jnp.round(no[6]).astype(jnp.int32), material)

    if T:
        in_t = (idx >= S + P) & hit
        ti = jnp.clip(idx - S - P, 0, T - 1)
        tr = scene.triangles
        rows = _gather_cols(
            jnp.concatenate(
                [tr.v0, tr.v1, tr.v2, tr.normal, tr.material[:, None].astype(rd.dtype)],
                axis=1,
            ),
            ti, in_t, onehot_max,
        )
        v0, n_t = (rows[0], rows[1], rows[2]), (rows[9], rows[10], rows[11])
        e1 = soa.sub((rows[3], rows[4], rows[5]), v0)
        e2 = soa.sub((rows[6], rows[7], rows[8]), v0)
        h = soa.cross(rd_c, e2)
        a = soa.dot(e1, h)
        a = jnp.where(in_t & (jnp.abs(a) >= FLT_EPSILON), a, 1.0)
        s = soa.sub(ro_c, v0)
        q = soa.cross(s, e1)
        t_t = soa.dot(e2, q) / a
        t = jnp.where(in_t, t_t, t)
        n_c = soa.where(in_t, n_t, n_c)
        material = jnp.where(in_t, jnp.round(rows[12]).astype(jnp.int32), material)

    t_safe = jnp.where(hit, t, 0.0)
    p_c = soa.add(ro_c, soa.scale(rd_c, t_safe))

    if S:
        # sphere normal normalized after selection (reference: source/Scene.cpp:40);
        # double-where: keep the unselected normalize argument away from 0
        in_s = (idx < S) & hit
        d_c = soa.where(in_s, soa.sub(p_c, c_sph), (1.0, 1.0, 1.0))
        n_c = soa.where(in_s, soa.normalize_safe(d_c), n_c)

    return HitRecords(
        hit=hit, t=jnp.where(hit, t, INF), point=soa.pack(*p_c),
        normal=soa.pack(*n_c), material=material,
    )

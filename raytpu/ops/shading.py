"""Batched BRDF library + material-table shading dispatch.

The reference's virtual ``Material::Shade`` (reference: source/Material.h:27)
becomes a data-parallel table lookup: per-ray material parameters are gathered
from the Materials table and all four material families are evaluated as
vectorized formulas, selected by ``jnp.where`` on the material kind.  Fully
differentiable by construction.

BRDF formulas transcribed from reference: source/BRDFs.h (including its
deliberate quirks: the clamped reflect inside Phong at :35, GGX with
alpha=roughness^2 at :62-68, and the k=(alpha+1)^2/8 geometry term at :81).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from raytpu.core import math3d
from raytpu.core.types import LightKind, Lights, Materials
from raytpu.ops import soa

PI = 3.14159265358979323846


def _dot(a, b):
    return jnp.sum(a * b, axis=-1)


def lambert(kd, cd):
    """``cd * kd / pi``; kd scalar (...,) or per-channel (...,3)
    (reference: source/BRDFs.h:14-22)."""
    if kd.ndim == cd.ndim - 1:
        kd = kd[..., None]
    return cd * kd / PI


def phong(ks, exp, l, v, n):
    """White specular lobe with the reference's clamped reflect
    (reference: source/BRDFs.h:33-40).

    ``cosa^exp`` is double-where guarded: at cosa==0 the power VJP is
    ``exp * cosa^(exp-1)`` which is 0*inf=NaN whenever exp<1 (e.g. the
    padded exp=0 rows of non-Phong materials in the dispatch table).
    Forward values match powf: pow(0, 0)=1, pow(0, e>0)=0.
    """
    refl = math3d.reflect(l, n)
    cosa = jnp.maximum(_dot(refl, v), 0.0)
    pos = cosa > 0.0
    powv = jnp.where(
        pos,
        jnp.power(jnp.where(pos, cosa, 1.0), exp),
        jnp.where(exp == 0.0, 1.0, 0.0),
    )
    return (ks * powv)[..., None] * jnp.ones(3, cosa.dtype)


def fresnel_schlick(h, v, f0):
    """(reference: source/BRDFs.h:49-53)."""
    return f0 + (1.0 - f0) * jnp.power(1.0 - jnp.maximum(_dot(h, v), 0.0), 5)[..., None]


def ggx_distribution(n, h, roughness):
    """Trowbridge-Reitz GGX with UE4 alpha = roughness^2
    (reference: source/BRDFs.h:62-68)."""
    a = roughness * roughness
    sqr_a = a * a
    ndh = jnp.maximum(_dot(n, h), 0.0)
    denom = ndh * ndh * (sqr_a - 1.0) + 1.0
    return sqr_a / (PI * denom * denom)


def schlick_ggx_geometry(n, x, roughness):
    """k = (alpha+1)^2/8 with alpha = roughness^2 — the reference's deviation
    from UE4's (roughness+1)^2/8 (reference: source/BRDFs.h:78-86)."""
    a = roughness * roughness
    k = (a + 1.0) * (a + 1.0) / 8.0
    cd = jnp.maximum(_dot(n, x), 0.0)
    return cd / (cd * (1.0 - k) + k)


def smith_geometry(n, v, l, roughness):
    """(reference: source/BRDFs.h:96-99)."""
    return schlick_ggx_geometry(n, v, roughness) * schlick_ggx_geometry(n, l, roughness)


def cook_torrance(albedo, metalness, roughness, n, l, v):
    """Microfacet specular + non-metal Lambert diffuse
    (reference: source/Material.h:107-123)."""
    h = math3d.normalize_safe(v + l)
    is_dielectric = (metalness == 0.0)[..., None]
    f0 = jnp.where(is_dielectric, jnp.full_like(albedo, 0.04), albedo)
    F = fresnel_schlick(h, v, f0)
    D = ggx_distribution(n, h, roughness)
    G = smith_geometry(n, v, l, roughness)
    denom = 4.0 * jnp.maximum(_dot(v, n), 1e-4) * jnp.maximum(_dot(l, n), 1e-4)
    specular = F * (D * G / denom)[..., None]
    kd = jnp.where(is_dielectric, 1.0 - F, jnp.zeros_like(F))
    diffuse = lambert(kd, albedo)
    return diffuse + specular


def shade(materials: Materials, mat_idx, n, l, v):
    """Table-dispatch shading: evaluate every family, select by kind.

    Args:
      materials: the scene material table.
      mat_idx: (R,) i32 per-ray material index.
      n, l, v: (R,3) unit normal, light and view directions.
    Returns (R,3) BRDF color.

    Internals run components-major (raytpu/ops/soa.py) — the same formulas
    as the reference-pinned array BRDFs above, on (R,)-shaped per-component
    arrays so the lane axis is the ray axis, not the 3-wide color axis.
    """
    # Per-ray material parameters via a (R, M) @ (M, 7) one-hot matmul
    # (M = material count, tiny) instead of a gather; whether a plain gather
    # is faster on the GPU is not measured yet (ROADMAP).
    M = materials.count
    table = jnp.concatenate(
        [materials.kind.astype(jnp.float32)[:, None], materials.color, materials.params],
        axis=1,
    )  # (M, 7)
    onehot = (mat_idx[:, None] == jnp.arange(M, dtype=mat_idx.dtype)[None, :]).astype(jnp.float32)
    # a one-hot contraction is a SELECT: force full precision so a TF32
    # matmul can't quantize material colors/params
    vals = jnp.matmul(onehot, table, precision=jax.lax.Precision.HIGHEST)  # (R, 7)
    kind = vals[:, 0]  # compared against float literals below
    cr, cg, cb = vals[:, 1], vals[:, 2], vals[:, 3]
    p0, p1, p2 = vals[:, 4], vals[:, 5], vals[:, 6]
    n_c, l_c, v_c = soa.comps(n), soa.comps(l), soa.comps(v)

    # Sanitize each family's parameters on the rows where it is NOT selected:
    # jnp.where protects forward values but not backward partials — e.g.
    # Cook-Torrance at roughness=0 (a Lambert row) has an infinite dD/ddenom
    # at ndh=1, and 0-cotangent * inf = NaN would leak into every gradient.
    is_ct = kind == 3
    rough_safe = jnp.where(is_ct, p1, 1.0)
    metal_safe = jnp.where(is_ct, p0, 1.0)
    is_lp = kind == 2
    exp_safe = jnp.where(is_lp, p2, 1.0)

    # Lambert: cd * kd / pi (reference: source/BRDFs.h:14-22)
    lam = p0 / PI
    c_lambert = (cr * lam, cg * lam, cb * lam)

    # Phong: white lobe with the clamped reflect (reference: source/BRDFs.h:33-40)
    refl = soa.sub(l_c, soa.scale(n_c, 2.0 * jnp.maximum(soa.dot(n_c, l_c), 0.0)))
    cosa = jnp.maximum(soa.dot(refl, v_c), 0.0)
    pos = cosa > 0.0
    powv = jnp.where(
        pos,
        jnp.power(jnp.where(pos, cosa, 1.0), exp_safe),
        jnp.where(exp_safe == 0.0, 1.0, 0.0),
    )
    w_ph = p1 * powv
    c_lp = (c_lambert[0] + w_ph, c_lambert[1] + w_ph, c_lambert[2] + w_ph)

    # Cook-Torrance (reference: source/Material.h:107-123, BRDFs.h:49-99)
    h = soa.normalize_safe(soa.add(v_c, l_c))
    is_diel = metal_safe == 0.0
    f0 = soa.where(is_diel, (jnp.full_like(cr, 0.04),) * 3, (cr, cg, cb))
    p5 = jnp.power(1.0 - jnp.maximum(soa.dot(h, v_c), 0.0), 5)
    F = (f0[0] + (1.0 - f0[0]) * p5, f0[1] + (1.0 - f0[1]) * p5, f0[2] + (1.0 - f0[2]) * p5)
    a = rough_safe * rough_safe
    sqr_a = a * a
    ndh = jnp.maximum(soa.dot(n_c, h), 0.0)
    denom_d = ndh * ndh * (sqr_a - 1.0) + 1.0
    D = sqr_a / (PI * denom_d * denom_d)
    k = (a + 1.0) * (a + 1.0) / 8.0
    cd_v = jnp.maximum(soa.dot(n_c, v_c), 0.0)
    cd_l = jnp.maximum(soa.dot(n_c, l_c), 0.0)
    G = (cd_v / (cd_v * (1.0 - k) + k)) * (cd_l / (cd_l * (1.0 - k) + k))
    denom = 4.0 * jnp.maximum(soa.dot(v_c, n_c), 1e-4) * jnp.maximum(soa.dot(l_c, n_c), 1e-4)
    spec_s = D * G / denom
    lam_inv = 1.0 / PI
    c_ct = tuple(
        jnp.where(is_diel, 1.0 - F[i], 0.0) * (cr, cg, cb)[i] * lam_inv + F[i] * spec_s
        for i in range(3)
    )

    out = soa.where(kind == 0, (cr, cg, cb), c_ct)
    out = soa.where(kind == 1, c_lambert, out)
    out = soa.where(kind == 2, c_lp, out)
    return soa.pack(*out)


def direction_to_light(lights: Lights, li: int, point):
    """Unit direction + distance from ``point`` to light ``li`` (branchless on
    the light kind so it works under jit with traced scenes).

    Point lights: toward light origin with its true distance
    (reference: source/Utils.h:341-353 + normalize at source/Renderer.cpp:131).
    Directional lights: ``-direction`` with infinite distance (implemented
    correctly; the reference's directional branch is dead code with a latent
    bug, reference: source/Utils.h:348).
    """
    is_point = lights.kind[li] == LightKind.POINT
    p_c = soa.comps(point)
    d = (lights.position[li, 0] - p_c[0], lights.position[li, 1] - p_c[1], lights.position[li, 2] - p_c[2])
    mag_pt = jnp.sqrt(soa.dot(d, d))
    l_pt = (d[0] / mag_pt, d[1] / mag_pt, d[2] / mag_pt)
    l_dir = tuple(-lights.direction[li, i] for i in range(3))
    flt_max = jnp.finfo(point.dtype).max
    l = soa.where(is_point, l_pt, tuple(jnp.broadcast_to(c, mag_pt.shape) for c in l_dir))
    mag = jnp.where(is_point, mag_pt, flt_max)
    return soa.pack(*l), mag


def radiance(lights: Lights, li: int, target):
    """Point: ``color * intensity / dist^2``; directional: ``color * intensity``
    (reference: source/Utils.h:355-369)."""
    is_point = lights.kind[li] == LightKind.POINT
    t_c = soa.comps(target)
    d = (lights.position[li, 0] - t_c[0], lights.position[li, 1] - t_c[1], lights.position[li, 2] - t_c[2])
    s_pt = lights.intensity[li] / soa.dot(d, d)  # (R,)
    r_pt = tuple(lights.color[li, i] * s_pt for i in range(3))
    r_dir = tuple(
        jnp.broadcast_to(lights.color[li, i] * lights.intensity[li], s_pt.shape)
        for i in range(3)
    )
    return soa.pack(*soa.where(is_point, r_pt, r_dir))

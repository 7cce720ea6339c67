"""Vector / matrix / color math matching the reference's conventions.

The reference math core (reference: source/Vector3.{h,cpp}, source/Matrix.{h,cpp},
source/ColorRGB.h, source/MathHelpers.h) uses a **row-vector** convention: a 4x4
matrix stores its basis axes as rows plus a translation row, and transforming is
``v_row @ M`` (reference: source/Matrix.cpp:35-56).  Here everything is a batched
jnp formula; the same functions work on numpy arrays for the oracle.

All math is float32 — parity with the reference requires fp32 semantics.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

PI = 3.14159265358979323846
PI_2 = 6.283185307179586476925
PI_DIV_2 = 1.57079632679489661923
TO_RADIANS = PI / 180.0
TO_DEGREES = 180.0 / PI

UNIT_X = (1.0, 0.0, 0.0)
UNIT_Y = (0.0, 1.0, 0.0)
UNIT_Z = (0.0, 0.0, 1.0)


def dot(a, b):
    """Batched 3-vector dot product over the last axis."""
    return jnp.sum(a * b, axis=-1)


def cross(a, b):
    return jnp.cross(a, b)


def sqr_magnitude(v):
    return dot(v, v)


def magnitude(v):
    return jnp.sqrt(sqr_magnitude(v))


def normalize(v):
    """Normalize over the last axis.  Matches ``Vector3::Normalize`` semantics
    (divide by the Euclidean norm; no epsilon guard — the reference has none)."""
    return v / magnitude(v)[..., None]


def normalize_safe(v, eps=1e-20):
    """Gradient-safe normalize: clamps the norm away from zero so the VJP of
    ``normalize`` at v≈0 does not produce NaNs (used on the grad path only)."""
    m = jnp.maximum(magnitude(v), eps)
    return v / m[..., None]


def reflect(l, n):
    """The reference Phong 'reflect' with its nonstandard clamp inside
    (reference: source/BRDFs.h:35): ``l - 2*max(dot(n,l),0)*n``."""
    return l - 2.0 * jnp.maximum(dot(n, l), 0.0)[..., None] * n


def project(v, onto):
    """Project v onto another vector (reference: Vector3::Project)."""
    return onto * (dot(v, onto) / dot(onto, onto))[..., None]


def reject(v, onto):
    """Component of v perpendicular to ``onto`` (reference: Vector3::Reject)."""
    return v - project(v, onto)


def lerp(a, b, factor):
    """Linear interpolation (reference: source/ColorRGB.h Lerp / MathHelpers Lerpf)."""
    return a + (b - a) * factor


# ---------------------------------------------------------------------------
# Row-vector 4x4 transforms.  M[i] is a basis row; points append an implicit 1.
# Every product asks for HIGHEST precision: a GPU would otherwise run these
# float32 matmuls in TF32 (~10 mantissa bits) and move the geometry.
# ---------------------------------------------------------------------------

HIGHEST = jax.lax.Precision.HIGHEST


def matmul(a, b):
    """Full-precision float32 ``a @ b``."""
    return jnp.matmul(a, b, precision=HIGHEST)


def transform_vector(m, v):
    """``v @ M[:3,:3]`` — rotate/scale only (reference: source/Matrix.cpp:35-42)."""
    return matmul(v, m[:3, :3])


def transform_point(m, p):
    """``p @ M[:3,:3] + M[3,:3]`` (reference: source/Matrix.cpp:49-56)."""
    return matmul(p, m[:3, :3]) + m[3, :3]


def mat_identity():
    return jnp.eye(4, dtype=jnp.float32)


def mat_translation(t):
    m = jnp.eye(4, dtype=jnp.float32)
    return m.at[3, :3].set(jnp.asarray(t, jnp.float32))


def mat_rotation_x(pitch):
    c, s = jnp.cos(pitch), jnp.sin(pitch)
    m = jnp.eye(4, dtype=jnp.float32)
    m = m.at[1, 1].set(c).at[1, 2].set(-s)
    m = m.at[2, 1].set(s).at[2, 2].set(c)
    return m


def mat_rotation_y(yaw):
    """Row-vector Y rotation (reference: source/Matrix.cpp:124-134):
    rows = {cos,0,-sin}, {0,1,0}, {sin,0,cos}."""
    c, s = jnp.cos(yaw), jnp.sin(yaw)
    m = jnp.eye(4, dtype=jnp.float32)
    m = m.at[0, 0].set(c).at[0, 2].set(-s)
    m = m.at[2, 0].set(s).at[2, 2].set(c)
    return m


def mat_rotation_z(roll):
    c, s = jnp.cos(roll), jnp.sin(roll)
    m = jnp.eye(4, dtype=jnp.float32)
    m = m.at[0, 0].set(c).at[0, 1].set(s)
    m = m.at[1, 0].set(-s).at[1, 1].set(c)
    return m


def mat_rotation(pitch, yaw, roll):
    """``Rx @ Ry @ Rz`` (reference: source/Matrix.cpp:150-155)."""
    return matmul(matmul(mat_rotation_x(pitch), mat_rotation_y(yaw)), mat_rotation_z(roll))


def mat_scale(s):
    s = jnp.asarray(s, jnp.float32)
    m = jnp.eye(4, dtype=jnp.float32)
    return m.at[0, 0].set(s[0]).at[1, 1].set(s[1]).at[2, 2].set(s[2])


def srt(scale_m, rot_m, trans_m):
    """Mesh final transform ``S @ R @ T`` — with row vectors this applies scale
    first, then rotation, then translation (reference: source/DataTypes.h:213)."""
    return matmul(matmul(scale_m, rot_m), trans_m)


# ---------------------------------------------------------------------------
# Color
# ---------------------------------------------------------------------------

def max_to_one(rgb):
    """Per-pixel tone map: divide by the max channel when it exceeds 1
    (reference: source/ColorRGB.h:12-17).  Batched over leading axes.

    Double-where on the denominator: on black pixels (m=0) the unselected
    division's partial is infinite and 0-cotangent * inf would NaN every
    gradient that sums over pixels."""
    m = jnp.max(rgb, axis=-1, keepdims=True)
    over = m > 1.0
    return jnp.where(over, rgb / jnp.where(over, m, 1.0), rgb)


def quantize_u8(rgb):
    """``static_cast<uint8_t>(c*255)`` truncation (reference: source/Renderer.cpp:178-181)."""
    return (rgb * 255.0).astype(jnp.uint8)

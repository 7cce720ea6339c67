"""Component-major (structure-of-arrays) helpers for the jnp hot path.

An op on an (R, 3) array puts the 3-wide vector axis in the minor
(contiguous) dimension, and an (R, N) ray x primitive matrix with small N
does the same: strided, narrow rows.  Running the same math on (R,)-shaped
per-component arrays and (N, R) matrices whose MINOR dim is the ray axis
keeps every elementwise op and reduction wide and contiguous.

Convention: a "c3" is a tuple (x, y, z) of same-shape arrays.  Public APIs
keep the (R, 3) array convention (pack/unpack pairs fuse away under jit);
internals compute on c3 tuples.

This is the XLA-level analog of the culled sweep's per-component ray
registers (raytpu/render/sweep.py), replacing the reference's per-pixel
scalar Vector3 math (reference: source/Vector3.cpp).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def comps(v):
    """(..., 3) array -> (x, y, z) component tuple."""
    return v[..., 0], v[..., 1], v[..., 2]


def pack(x, y, z):
    """Component tuple -> (..., 3) array (broadcasting components first)."""
    x, y, z = jnp.broadcast_arrays(x, y, z)
    return jnp.stack([x, y, z], axis=-1)


def dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def cross(a, b):
    return (
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    )


def sub(a, b):
    return a[0] - b[0], a[1] - b[1], a[2] - b[2]


def add(a, b):
    return a[0] + b[0], a[1] + b[1], a[2] + b[2]


def scale(a, s):
    return a[0] * s, a[1] * s, a[2] * s


def neg(a):
    return -a[0], -a[1], -a[2]


def norm(a):
    return jnp.sqrt(dot(a, a))


def normalize(a):
    n = norm(a)
    return a[0] / n, a[1] / n, a[2] / n


def normalize_safe(a, eps: float = 1e-20):
    n = jnp.sqrt(jnp.maximum(dot(a, a), eps))
    return a[0] / n, a[1] / n, a[2] / n


def where(pred, a, b):
    """Per-lane select on component tuples (pred broadcasts per component)."""
    return (
        jnp.where(pred, a[0], b[0]),
        jnp.where(pred, a[1], b[1]),
        jnp.where(pred, a[2], b[2]),
    )


def rows(table):
    """(N, 3) table -> ((N, 1), (N, 1), (N, 1)) column tuple, ready to
    broadcast against (R,) ray components into (N, R) matrices."""
    return table[:, 0:1], table[:, 1:2], table[:, 2:3]


def gather_cols(table, li, mask, onehot_max: int = 4096):
    """Differentiable ``table[li].T`` — a (K, R) components-major gather with
    columns zeroed where ``~mask``.  ``li`` is detached (winner indices);
    gradients flow to ``table``.

    An indexed row gather's VJP is a scatter-add, so the gather is
    expressed as detached one-hot matmuls (the VJP is the transposed
    matmul).  Whether a plain gather is faster on the GPU is not measured
    yet (ROADMAP):

      * ``N <= onehot_max``: one (K, N) @ (N, R) contraction.
      * larger N: TWO-LEVEL grouped one-hot — rows are grouped G at a time
        (G = ceil(N / onehot_max), min 8), a (G*K, H) @ (H, R) contraction
        gathers the winner's whole G-row group, and a detached (G, R) slot
        one-hot selects within it.  HBM traffic is ~G x less than the full
        one-hot, whose (N, R) matrix would otherwise dominate big-T scenes.
    """
    N, K = table.shape
    sg = jax.lax.stop_gradient
    # a one-hot contraction is a SELECT: it must not round the table through
    # a reduced-precision matmul (TF32 on the GPU keeps ~10 mantissa bits)
    hp = jax.lax.Precision.HIGHEST
    if N <= onehot_max:
        oh = ((jnp.arange(N)[:, None] == li[None, :]) & mask[None, :]).astype(
            table.dtype
        )
        return jnp.matmul(table.T, sg(oh), precision=hp)
    G = max(8, -(-N // onehot_max))
    H = -(-N // G)
    tbl = jnp.pad(table, ((0, H * G - N), (0, 0)))
    hi = li // G
    lo = li - hi * G
    oh_hi = ((jnp.arange(H)[:, None] == hi[None, :]) & mask[None, :]).astype(
        table.dtype
    )
    # (H, G*K).T @ (H, R): the winner's whole group, components-major
    big = jnp.matmul(tbl.reshape(H, G * K).T, sg(oh_hi), precision=hp)  # (G*K, R)
    oh_lo = ((jnp.arange(G)[:, None] == lo[None, :]) & mask[None, :]).astype(
        table.dtype
    )
    return jnp.einsum("gkr,gr->kr", big.reshape(G, K, -1), sg(oh_lo),
                      precision=hp)

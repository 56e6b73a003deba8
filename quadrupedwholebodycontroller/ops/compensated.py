"""Error-free-transformation (double-f32) arithmetic for residual evaluation.

The reference stack is all-double (whole_body_controller.cpp uses `double`
throughout); the accelerator chain runs in f32, and its precision lever is
COMPENSATED f32: every f32 multiply and add is correctly rounded, so
Dekker/Veltkamp error-free transformations
recover the exact rounding error of each operation and a Neumaier-compensated
reduction sums products to ~|result|*eps accuracy instead of ~eps*sum|terms|.

Used where f32 accuracy actually dies: the iterative-refinement residuals of
the active-set polish (r = b - K x suffers catastrophic cancellation when x
is already ~4 digits accurate and the terms are ~1e4 — a plain f32 matvec
leaves an absolute noise floor of eps * sum|terms| that caps the relative KKT
near 1e-3 on extreme scenarios).  The preconditioner applications stay plain
f32 matmuls — only residuals need the extra digits.

These are elementwise VPU ops + tiny fori reductions: they bypass the MXU
(and hence the bf16-pass matmul precision question) entirely.  XLA does not
reassociate floating-point arithmetic, so the transformations are exact.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

# Veltkamp splitting constant for binary32 (24-bit significand, s = 12)
_SPLIT = 4097.0  # 2**12 + 1


def _two_sum(a, b):
    """Knuth TwoSum: s + e == a + b exactly (s = fl(a+b))."""
    s = a + b
    bp = s - a
    e = (a - (s - bp)) + (b - bp)
    return s, e


def _split(a):
    c = _SPLIT * a
    h = c - (c - a)
    return h, a - h


def _two_prod(a, b):
    """Dekker TwoProd: p + e == a * b exactly (p = fl(a*b)); FMA-free."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def _comp_sum_last(P):
    """Compensated sum along the last axis via a TwoSum binary tree.

    Returns (s, c) with s + c accurate to O(eps^2 * n * sum|P|): each tree
    level is an ERROR-FREE TwoSum of vectorized halves (the per-pair
    rounding errors are recovered exactly and summed plainly — they are
    already O(eps * |pair|)).  Same accuracy class as a sequential
    Neumaier loop, but log2(n) fully-vectorized steps instead of n
    sequential extractions along the reduced axis."""
    c_tot = jnp.zeros(P.shape[:-1], P.dtype)
    while P.shape[-1] > 1:
        k = P.shape[-1]
        half = k // 2
        s, e = _two_sum(P[..., :half], P[..., half : 2 * half])
        c_tot = c_tot + jnp.sum(e, axis=-1)
        P = s if k % 2 == 0 else jnp.concatenate([s, P[..., -1:]], axis=-1)
    return P[..., 0], c_tot


def comp_matvec(M, v):
    """Compensated batched matvec: (..., m, n) @ (..., n) -> (..., m).

    Products via TwoProd, summation via the TwoSum-tree reduction
    (_comp_sum_last — exact to ~eps * |result| + O(eps^2 * sum|terms|));
    the product errors are summed plainly (they are already
    O(eps * |p_i|) each).  Cost is ~20x a plain matvec in VPU flops, all
    vectorized."""
    p, e = _two_prod(M, v[..., None, :])
    s, c = _comp_sum_last(p)
    return s + (c + jnp.sum(e, axis=-1))


def comp_residual_chain(bias, mat_terms=(), diag_terms=()):
    """r = bias - sum_i M_i @ x_i - sum_j d_j * v_j in ONE compensated chain.

    Block form of comp_residual for structured operators: the KKT residual
    r1 = -g - (H + reg I) x - B^T y needs the H-block and the B^T-block
    products summed in the SAME Neumaier accumulation (the cancellation at
    stationarity is *between* the blocks), but materializing the
    concatenated (B, n+m, n+m) KKT matrix costs an extra ~400 MB HBM round
    trip at B=8192.  Here each block's TwoProd partials are concatenated
    along the contraction axis only ((..., rows, sum_i n_i)) and reduced
    once.  mat_terms: iterable of (M (..., rows, n_i), x (..., n_i));
    diag_terms: iterable of (d (..., rows), v (..., rows)) elementwise
    products (diagonal operator blocks)."""
    ps, errs = [], []
    for M, x in mat_terms:
        p, e = _two_prod(M, x[..., None, :])
        ps.append(-p)
        errs.append(jnp.sum(e, axis=-1))
    for d, v in diag_terms:
        p, e = _two_prod(d, v)
        ps.append(-p[..., None])
        errs.append(e)
    bias_col = (bias * jnp.ones_like(ps[0][..., 0]))[..., None]
    P = jnp.concatenate([bias_col] + ps, axis=-1)
    s, c = _comp_sum_last(P)
    etot = errs[0]
    for e in errs[1:]:
        etot = etot + e
    return s + (c - etot)


def comp_residual(b, M, x, scale=1.0):
    """r = b - M x with compensated products/sums: the refinement residual.

    `b` may carry a scalar/broadcastable scale already applied; the
    subtraction of b enters the compensated chain exactly (TwoSum)."""
    mx_p, mx_e = _two_prod(M, x[..., None, :])
    bias_col = (b * jnp.ones_like(mx_p[..., 0]) * scale)[..., None]
    s, c = _comp_sum_last(jnp.concatenate([bias_col, -mx_p], axis=-1))
    return s + (c - jnp.sum(mx_e, axis=-1))

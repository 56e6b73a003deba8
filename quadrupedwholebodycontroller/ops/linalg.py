"""Matmul-only dense linear algebra for the hot path.

Everything here is built from batched matmuls and elementwise ops only (no
LAPACK-style factorization or triangular-solve custom calls; it fuses
cleanly and carries a warm start across control cycles).  Whether batched
Cholesky pays on the GPU is an open measurement (ROADMAP):

  * ns_inverse      — Jacobi-preconditioned Newton-Schulz SPD inverse
                      (X <- X(2I - A X); small eigenvalues double every
                      iteration, so iters ~ log2(n * cond) + margin)
  * spd_solve       — apply ns_inverse + iterative refinement
  * solve_kkt_schur — the active-set polish system via a Schur complement
                      with NS inverses (replaces the 112x112 LU)

Accuracy: an f32 NS inverse plateaus at ~cond * eps like any f32
factorization; the refinement loops recover the remaining digits.  In f64
(CPU test configuration) everything converges to ~1e-14.
"""
from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp

# Hot-path matmul precision.  "highest" = full f32.  A global reduced
# precision destroyed convergence when tried (the rescue fired on nearly
# every scenario): "highest" is load-bearing for the carried-inverse warm
# updates and the refinement floors; the only candidate reduced-precision
# surface is the cold-NS chain BODY (ns_inverse body_prec, config
# ns_cold_prec — see PERF.md).  The env override remains for experiments.
_MATMUL_PRECISION = os.environ.get("QWBC_MATMUL_PRECISION", "highest")


def full_precision(fn):
    """Trace `fn` with float32-accurate matmuls.

    Accelerators may run f32 matmuls at reduced precision by default (TF32
    on the GPU); Newton-Schulz and iterative refinement are meaningless at
    that accuracy, and the dynamics quantities feed a QP whose solution
    must be torque-accurate to 1e-3."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision(_MATMUL_PRECISION):
            return fn(*args, **kwargs)

    return wrapped


def _cold_init(A):
    """Safe NS start: Jacobi-scaled X0 with ||I - A X0|| < 1 guaranteed."""
    d = jax.lax.rsqrt(jnp.abs(jnp.diagonal(A, axis1=-2, axis2=-1)) + 1e-30)
    As = A * d[..., :, None] * d[..., None, :]
    r1 = jnp.max(jnp.sum(jnp.abs(As), axis=-1), axis=-1)  # inf-norm
    c1 = jnp.max(jnp.sum(jnp.abs(As), axis=-2), axis=-1)  # 1-norm
    # expressed in UNSCALED coordinates: inv(A) = d inv(As) d
    return As * (d[..., :, None] * d[..., None, :]) / (r1 * c1)[..., None, None]


@full_precision
def ns_inverse(A, iters: int = 30, warm=None, warm_iters: int = 12,
               body_prec: str | None = None, tail: int = 6):
    """Inverse of a batched SPD matrix (..., n, n) by Newton-Schulz.

    With `warm` (an approximate inverse from a nearby problem — the carried
    control-cycle hotstart), quadratic convergence needs only `warm_iters`
    iterations.  The caller is responsible for gating warm use across
    structural problem changes (contact switches); here only true blowups
    (non-finite or wildly divergent warm starts, ||I - A W||_inf >= 1e3)
    fall back to the cold start — an f32 plateau on an ill-conditioned
    matrix can legitimately show ||I - A W||_inf of a few, and NS still
    contracts in the dominant subspace.

    body_prec (cold starts only): run the first `iters - tail` iterations
    under this matmul precision (e.g. "bfloat16" = 1 MXU pass instead of
    the ambient "highest" 6) and only the last `tail` at full precision.
    The early iterations only need to CONTRACT (error ~1 -> the bf16
    floor ~1e-2); the full-precision tail then converges quadratically to
    the same f32 plateau.  The per-step cold sub-batch chains are
    serialized latency on the hot path, so cheaper body passes shorten
    the program's critical path."""
    n = A.shape[-1]
    eye2 = 2.0 * jnp.eye(n, dtype=A.dtype)
    X = _cold_init(A)
    if warm is not None:
        E = jnp.eye(n, dtype=A.dtype) - A @ warm
        err = jnp.max(jnp.sum(jnp.abs(E), axis=-1), axis=-1)
        ok = (jnp.isfinite(err) & (err < 1e3))[..., None, None]
        X = jnp.where(ok, warm, X)
        iters = warm_iters

    def body(_, X):
        return X @ (eye2 - A @ X)

    if warm is None and body_prec:
        nb = max(iters - max(tail, 0), 0)
        with jax.default_matmul_precision(body_prec):
            X = jax.lax.fori_loop(0, nb, body, X, unroll=True)
        iters = iters - nb
    X = jax.lax.fori_loop(0, iters, body, X, unroll=True)
    if warm is not None:
        # never let a blown-up iterate poison the carried cache
        finite = jnp.all(jnp.isfinite(X), axis=(-2, -1), keepdims=True)
        X = jnp.where(finite, X, _cold_init(A))
    return X


@full_precision
def ns_inverse_warm_shared(A, warm, warm_iters: int):
    """Warm Newton-Schulz update sharing A @ warm between the divergence
    check and the first iteration.

    ns_inverse's warm path spends one full batched matmul on the
    ||I - A W||_inf safeguard and then recomputes A @ W as iteration 1's
    A @ X (bitwise the same product when the warm start is accepted) plus
    a second _cold_init for the final guard; at B=4096 that is ~25 HBM
    passes over (B, 42, 42) padded arrays for a 4-matmul update.  Here the
    check rides the iteration-1 matmul and X0 is computed once: 2*wi
    matmuls total instead of 2*wi + 1.

    Semantics vs ns_inverse(A, warm=..., warm_iters=wi):
      * accepted warm starts (the steady state): BITWISE IDENTICAL — same
        matmul sequence, same reduction shapes.
      * rejected warm starts (non-finite or ||I - A W||_inf >= 1e3, a
        pathological safety net — batch-level contact-switch gating
        handles the systematic case): falls back to the UN-ITERATED
        Jacobi-scaled X0 instead of X0 refined by wi iterations.  The
        caller's downstream residual checks flag the affected scenarios
        either way.

    warm_iters must be >= 1 (use ns_inverse for 0)."""
    assert warm_iters >= 1
    n = A.shape[-1]
    eye = jnp.eye(n, dtype=A.dtype)
    X0 = _cold_init(A)
    M = A @ warm
    err = jnp.max(jnp.sum(jnp.abs(eye - M), axis=-1), axis=-1)
    ok = (jnp.isfinite(err) & (err < 1e3))[..., None, None]
    X = warm @ (2.0 * eye - M)
    for _ in range(warm_iters - 1):
        X = X @ (2.0 * eye - A @ X)
    X = jnp.where(ok, X, X0)
    # never let a blown-up iterate poison the carried cache
    finite = jnp.all(jnp.isfinite(X), axis=(-2, -1), keepdims=True)
    return jnp.where(finite, X, X0)


def _bm_mm(X, Y):
    """Batch-minor per-scenario matmul: (i, k, B), (k, j, B) -> (i, j, B).

    Batch-minor (n, n, B) arrays keep the scenario batch contiguous, so
    every elementwise op and reduction of the solve chain is coalesced
    along the batch (see ops/qp solve_layout)."""
    return jnp.einsum("ikB,kjB->ijB", X, Y)


def _bm_eye(n, dtype):
    i0 = jax.lax.broadcasted_iota(jnp.int32, (n, n, 1), 0)
    i1 = jax.lax.broadcasted_iota(jnp.int32, (n, n, 1), 1)
    return jnp.where(i0 == i1, 1.0, 0.0).astype(dtype)


def _cold_init_bm(A):
    """_cold_init in batch-minor (n, n, B) layout."""
    d = jax.lax.rsqrt(jnp.abs(jnp.einsum("iiB->iB", A)) + 1e-30)
    As = A * d[:, None, :] * d[None, :, :]
    r1 = jnp.max(jnp.sum(jnp.abs(As), axis=1), axis=0)  # (B,) inf-norm
    c1 = jnp.max(jnp.sum(jnp.abs(As), axis=0), axis=0)  # (B,) 1-norm
    return As * (d[:, None, :] * d[None, :, :]) / (r1 * c1)[None, None, :]


@full_precision
def ns_inverse_bm(A, iters: int = 30, body_prec: str | None = None,
                  tail: int = 6):
    """ns_inverse on batch-minor (n, n, B) arrays (cold start only).

    body_prec/tail: reduced-precision body iterations, see ns_inverse."""
    eye2 = 2.0 * _bm_eye(A.shape[0], A.dtype)
    X = _cold_init_bm(A)

    def body(_, X):
        return _bm_mm(X, eye2 - _bm_mm(A, X))

    if body_prec:
        nb = max(iters - max(tail, 0), 0)
        with jax.default_matmul_precision(body_prec):
            X = jax.lax.fori_loop(0, nb, body, X, unroll=True)
        iters = iters - nb
    return jax.lax.fori_loop(0, iters, body, X, unroll=True)


@full_precision
def ns_inverse_warm_shared_bm(A, warm, warm_iters: int):
    """ns_inverse_warm_shared on batch-minor (n, n, B) arrays.

    Same semantics: the ||I - A W||_inf check rides iteration 1's matmul;
    rejected warms fall back to the un-iterated Jacobi X0; a non-finite
    final iterate never poisons the carried cache."""
    assert warm_iters >= 1
    eye = _bm_eye(A.shape[0], A.dtype)
    X0 = _cold_init_bm(A)
    M = _bm_mm(A, warm)
    err = jnp.max(jnp.sum(jnp.abs(eye - M), axis=1), axis=0)  # (B,)
    ok = (jnp.isfinite(err) & (err < 1e3))[None, None, :]
    X = _bm_mm(warm, 2.0 * eye - M)
    for _ in range(warm_iters - 1):
        X = _bm_mm(X, 2.0 * eye - _bm_mm(A, X))
    X = jnp.where(ok, X, X0)
    finite = jnp.all(jnp.isfinite(X), axis=(0, 1), keepdims=True)
    return jnp.where(finite, X, X0)


@full_precision
def spd_solve(A, b, iters: int = 30, refine: int = 2):
    """Solve A x = b (A SPD, b (..., n) or (..., n, k)).

    On CPU (the test configuration) LAPACK Cholesky is fast and exact, so it
    is used directly; on accelerators the matmul-only Newton-Schulz path
    avoids the pathologically slow factorization custom calls."""
    vec = b.ndim == A.ndim - 1
    if vec:
        b = b[..., None]
    if jax.default_backend() == "cpu":
        c, low = jax.scipy.linalg.cho_factor(A) if A.ndim == 2 else (None, None)
        if c is not None:
            x = jax.scipy.linalg.cho_solve((c, low), b)
        else:
            x = jnp.linalg.solve(A, b)
        return x[..., 0] if vec else x
    Ainv = ns_inverse(A, iters)
    x = Ainv @ b
    for _ in range(refine):
        x = x + Ainv @ (b - A @ x)
    return x[..., 0] if vec else x


def inv3(A):
    """Closed-form inverse of batched (..., 3, 3) matrices (adjugate / det).

    Exact up to rounding — no iteration, ~10 fused elementwise ops; used for
    the tiny blocks where even a short Newton-Schulz loop is pure launch
    latency on the accelerator."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    co00 = e * i - f * h
    co01 = c * h - b * i
    co02 = b * f - c * e
    co10 = f * g - d * i
    co11 = a * i - c * g
    co12 = c * d - a * f
    co20 = d * h - e * g
    co21 = b * g - a * h
    co22 = a * e - b * d
    det = a * co00 + b * co10 + c * co20
    adj = jnp.stack(
        [
            jnp.stack([co00, co01, co02], axis=-1),
            jnp.stack([co10, co11, co12], axis=-1),
            jnp.stack([co20, co21, co22], axis=-1),
        ],
        axis=-2,
    )
    return adj / det[..., None, None]


@full_precision
def spd_inv6(M):
    """Closed-form inverse of batched SPD (..., 6, 6) via 3x3 block Schur.

        M = [[A, B], [B^T, C]],  S = C - B^T A^{-1} B
        M^{-1} = [[A^{-1} + W S^{-1} W^T, -W S^{-1}],
                  [-S^{-1} W^T,            S^{-1}]],   W = A^{-1} B

    Replaces a ~25-iteration Newton-Schulz on the centroidal base block
    (whose 50+ tiny sequential kernels are launch-latency-bound at any
    batch size) with ~15 fused ops."""
    A = M[..., :3, :3]
    B = M[..., :3, 3:]
    C = M[..., 3:, 3:]
    Ainv = inv3(A)
    W = Ainv @ B
    S = C - jnp.swapaxes(B, -1, -2) @ W
    Sinv = inv3(S)
    WS = W @ Sinv
    top_left = Ainv + WS @ jnp.swapaxes(W, -1, -2)
    top = jnp.concatenate([top_left, -WS], axis=-1)
    bot = jnp.concatenate([-jnp.swapaxes(WS, -1, -2), Sinv], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)


def _schur_inv(M, k, inv_top, inv_schur):
    """Block-Schur SPD inverse: M = [[A (k,k), B], [B^T, D]] with the two
    sub-inverses supplied (closed-form or recursive)."""
    A = M[..., :k, :k]
    B = M[..., :k, k:]
    D = M[..., k:, k:]
    Ainv = inv_top(A)
    W = Ainv @ B
    S = D - jnp.swapaxes(B, -1, -2) @ W
    Sinv = inv_schur(S)
    WS = W @ Sinv
    top = jnp.concatenate([Ainv + WS @ jnp.swapaxes(W, -1, -2), -WS], axis=-1)
    bot = jnp.concatenate([-jnp.swapaxes(WS, -1, -2), Sinv], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)


@full_precision
def spd_inv12(M):
    """Closed-form-composed inverse of batched SPD (..., 12, 12):
    6+6 block Schur over spd_inv6."""
    return _schur_inv(M, 6, spd_inv6, spd_inv6)


@full_precision
def spd_inv18(M, refine: int = 1):
    """Inverse of batched SPD (..., 18, 18) — the floating-base mass-matrix
    shape — via nested block Schur (6 + 12 with 12 = 6 + 6), all built on
    the closed-form 3x3 adjugate.  ~25 fused ops instead of a ~60-kernel
    Newton-Schulz chain; `refine` Newton steps (X <- X(2I - MX)) polish the
    nested-Schur rounding."""
    X = _schur_inv(M, 6, spd_inv6, spd_inv12)
    n = M.shape[-1]
    eye2 = 2.0 * jnp.eye(n, dtype=M.dtype)
    for _ in range(refine):
        X = X @ (eye2 - M @ X)
    return X


@full_precision
def solve_kkt_schur(H, B, da, g, b, reg: float = 1e-8,
                    iters: int = 30, refine: int = 2, Hinv=None,
                    sinv_fn=None, return_sinv: bool = False):
    """Solve the active-set KKT system matmul-only.

        (1)  H x + B^T y = -g
        (2)  B x + D y   = da * b,   D = diag(1-da) - reg*diag(da)

    (active row i, da_i=1: B_i x - reg y_i = b_i — dual-regularized active
    constraint; inactive row, da_i=0 and B_i = 0: y_i = 0.)
    B must already be the row-masked constraint matrix (da_i * A_i), so the
    active and inactive blocks decouple exactly.

    Eliminating x = H^{-1}(-g - B^T y) gives the SPD Schur system
        S y = -(da*b + B H^{-1} g),  S = B H^{-1} B^T + reg*diag(da) + diag(1-da)
    solved with Newton-Schulz inverses; coupled refinement passes knock the
    f32 residual of the full system down afterwards."""
    mv = lambda M, v: (M @ v[..., None])[..., 0]
    if Hinv is None:
        Hinv = ns_inverse(H, iters)
    Bt = jnp.swapaxes(B, -1, -2)
    eye_m = jnp.eye(B.shape[-2], dtype=B.dtype)
    diag_S = reg * da + (1.0 - da)
    S = B @ Hinv @ Bt + jnp.einsum("...i,ij->...ij", diag_S, eye_m)
    Sinv = sinv_fn(S) if sinv_fn is not None else ns_inverse(S, iters)
    D = (1.0 - da) - reg * da

    y = mv(Sinv, -(da * b + mv(B, mv(Hinv, g))))
    x = mv(Hinv, -g - mv(Bt, y))

    for _ in range(refine):
        r1 = -g - mv(H, x) - mv(Bt, y)
        r2 = da * b - mv(B, x) - D * y
        dy = mv(Sinv, mv(B, mv(Hinv, r1)) - r2)
        dx = mv(Hinv, r1 - mv(Bt, dy))
        x = x + dx
        y = y + dy
    if return_sinv:
        return x, y, Sinv
    return x, y

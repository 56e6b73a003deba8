"""The batched ADMM iteration loop and its residual epilogue.

The qpOASES replacement's hot loop (ops/qp.py) as functions of batch-minor
arrays ("structure of arrays"): every per-problem matrix/vector keeps its
own dims leading and the scenario batch as the LAST dim, so each scalar op
of the update equations is one elementwise op over the whole batch and the
matvecs are reductions of (rows, cols, B) products.  Equality/infinity
handling, Ruiz scaling and the active-set polish live in ops/qp.py — this
module is exactly the fixed-point loop plus the candidate's unscaled KKT
residuals.

Plain jnp, left to XLA.  A Pallas-Triton kernel that kept one scenario's
A and K^{-1} in registers across all iterations measured slower end to end
on the H100 than XLA's fused reductions of this code (PERF.md).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

_BIG = 1e20  # the qpOASES INFTY convention: finite clip for +-inf bounds


def _mv(M, v):
    """(p, q, B) x (q, B) -> (p, B)."""
    return jnp.sum(M * v[None, :, :], axis=1)


def _mvt(M, w):
    """(p, q, B)^T x (p, B) -> (q, B)."""
    return jnp.sum(M * w[:, None, :], axis=0)


def admm_loop(Kinv, A, g, l, u, rho, x0, z0, y0, *, iters, sigma, alpha):
    """`iters` ADMM iterations on the batch-minor scaled problem."""
    inv_rho = 1.0 / rho

    def body(_, st):
        x, z, y = st
        t = rho * z - y                                 # (m, B)
        x_t = _mv(Kinv, sigma * x - g + _mvt(A, t))     # (n, B)
        z_t = _mv(A, x_t)                               # (m, B)
        x_n = alpha * x_t + (1.0 - alpha) * x
        z_rel = alpha * z_t + (1.0 - alpha) * z
        z_n = jnp.clip(z_rel + y * inv_rho, l, u)
        y_n = y + rho * (z_rel - z_n)
        return (x_n, z_n, y_n)

    return jax.lax.fori_loop(0, iters, body, (x0, z0, y0))


def zy_loop(Kinv, A, g, l, u, rho, z0, y0, *, iters, alpha):
    """Constraint-space ADMM loop (sigma = 0).

    With sigma = 0 the x-update x~ = K^{-1}(A^T u - g), u = rho z - y, makes
    the (z, y) iteration closed:  z~ = A K^{-1} A^T u + c  with
    c = -A K^{-1} g.  A K^{-1} A^T is applied as three chained matvecs; no
    P matrix is built.  The relaxed x_K is recovered EXACTLY from the linear
    recursion
        x_{k+1} = (1-alpha) x_k + alpha (K^{-1}A^T u_k - K^{-1}g)
    via the accumulator V_{k+1} = (1-alpha) V_k + alpha u_k  (V_0 = 0):
        x_K = (1-alpha)^K x_0 + K^{-1}A^T V_K - (1 - (1-alpha)^K) K^{-1}g
    (zy_x below).  Same fixed point as the sigma > 0 iteration (the
    proximal term vanishes at convergence); sigma only changes the path.
    Returns (z, y, V)."""
    inv_rho = 1.0 / rho
    c = -_mv(A, _mv(Kinv, g))                            # (m, B)

    def body(_, st):
        z, y, V = st
        t = rho * z - y                                  # (m, B)
        z_t = _mv(A, _mv(Kinv, _mvt(A, t))) + c          # (m, B)
        z_rel = alpha * z_t + (1.0 - alpha) * z
        z_n = jnp.clip(z_rel + y * inv_rho, l, u)
        y_n = y + rho * (z_rel - z_n)
        V_n = (1.0 - alpha) * V + alpha * t
        return (z_n, y_n, V_n)

    return jax.lax.fori_loop(0, iters, body, (z0, y0, jnp.zeros_like(z0)))


def zy_x(Kinv, A, g, x0, V, *, iters, alpha):
    """x reconstruction from the zy loop's V accumulator."""
    w0 = (1.0 - alpha) ** iters
    return (w0 * x0 + _mv(Kinv, _mvt(A, V)) - (1.0 - w0) * _mv(Kinv, g))


def kkt_epilogue(A, Hs, g, x, y, lo, uo, d, e):
    """Unscaled relative KKT residuals and sign violation of a candidate.

    Scaled problem (A = e o A_orig o d, Hs = d o H o d); the unscaled
    quantities follow from A x = (As xs)/e, H x = (Hs xs)/d,
    A^T y = (As^T ys)/d, g = gs/d, scored against the UNSCALED bounds
    lo/uo (pre-clipped to +-1e20) — matching ops/qp.kkt_residual and
    ops/qp._sign_violation.  Returns (pr, du, sv), each (B,)."""
    ax = _mv(A, x) / e
    hx = _mv(Hs, x) / d
    aty = _mvt(A, y) / d
    gu = g / d
    fin_l = jnp.where(jnp.abs(lo) < 1e19, jnp.abs(lo), 0.0)
    fin_u = jnp.where(jnp.abs(uo) < 1e19, jnp.abs(uo), 0.0)
    finite_b = jnp.maximum(jnp.max(fin_l, axis=0), jnp.max(fin_u, axis=0))
    pscale = jnp.maximum(1.0, jnp.maximum(jnp.max(jnp.abs(ax), axis=0), finite_b))
    dscale = jnp.maximum(
        1.0,
        jnp.maximum(
            jnp.max(jnp.abs(hx), axis=0),
            jnp.maximum(jnp.max(jnp.abs(aty), axis=0),
                        jnp.max(jnp.abs(gu), axis=0)),
        ),
    )
    pr = jnp.max(jnp.abs(ax - jnp.clip(ax, lo, uo)), axis=0) / pscale
    du = jnp.max(jnp.abs(hx + gu + aty), axis=0) / dscale
    # sign/complementarity violation on the UNSCALED pair: y_unscaled =
    # e * ys; equality rows are sign-free; 1e19 is the finiteness test
    y_u = e * y
    eqr = (uo - lo) <= 1e-9
    d_up = jnp.where(jnp.abs(uo) < 1e19, jnp.maximum(uo - ax, 0.0), _BIG)
    d_lo = jnp.where(jnp.abs(lo) < 1e19, jnp.maximum(ax - lo, 0.0), _BIG)
    dist = jnp.where(eqr, 0.0, jnp.where(y_u > 0, d_up, d_lo))
    sv = jnp.max(
        jnp.minimum(jnp.abs(y_u) / dscale[None, :], dist / pscale[None, :]),
        axis=0,
    )
    return pr, du, sv


def _prob_minor(layout, *arrs):
    if layout == "minor":
        return arrs
    return tuple(jnp.moveaxis(a, 0, -1) for a in arrs)


def _clip_bounds(*bounds):
    return tuple(jnp.clip(b, -_BIG, _BIG) for b in bounds)


@functools.partial(
    jax.jit, static_argnames=("iters", "alpha", "layout")
)
def admm_zy_iterations_res(Kinv, A, g, l, u, rho, x0, z0, y0,
                           Hs, l_orig, u_orig, d, e,
                           *, iters: int, alpha: float,
                           layout: str = "major"):
    """Constraint-space (sigma = 0) ADMM + residual epilogue.

    Kinv (n,n) = K^{-1} in SCALED space; A/g/l/u/rho likewise scaled; Hs
    the scaled Hessian, l_orig/u_orig the ORIGINAL bounds and d, e the Ruiz
    scalings.  Warm starts x0/z0/y0 and the original bounds are batch-major
    (B, k); the scaled problem (Kinv, A, g, l, u, rho, Hs, d, e) is
    batch-major (B, ...) for layout="major" or batch-minor (..., B) for
    layout="minor" (straight from the batch-minor prepare and K-chain).
    Returns (x, z, y, pr, du, sv) batch-major: scaled iterates, unscaled
    relative residuals and sign violation."""
    l, u, l_orig, u_orig = _clip_bounds(l, u, l_orig, u_orig)
    Kinv, A, g, l, u, rho, Hs, d, e = _prob_minor(
        layout, Kinv, A, g, l, u, rho, Hs, d, e
    )
    x0, z0, y0, lo, uo = (
        jnp.moveaxis(a, 0, -1) for a in (x0, z0, y0, l_orig, u_orig)
    )
    z, y, V = zy_loop(Kinv, A, g, l, u, rho, z0, y0, iters=iters,
                      alpha=float(alpha))
    x = zy_x(Kinv, A, g, x0, V, iters=iters, alpha=float(alpha))
    outs = (x, z, y) + kkt_epilogue(A, Hs, g, x, y, lo, uo, d, e)
    return tuple(jnp.moveaxis(o, -1, 0) for o in outs)


@functools.partial(
    jax.jit, static_argnames=("iters", "sigma", "alpha", "layout")
)
def admm_iterations_res(Kinv, A, g, l, u, rho, x0, z0, y0,
                        Hs, l_orig, u_orig, d, e,
                        *, iters: int, sigma: float, alpha: float,
                        layout: str = "major"):
    """sigma > 0 ADMM iterations plus the candidate's unscaled relative KKT
    residuals (matches ops/qp.kkt_residual).  Same arguments, layouts and
    returns as admm_zy_iterations_res."""
    l, u, l_orig, u_orig = _clip_bounds(l, u, l_orig, u_orig)
    Kinv, A, g, l, u, rho, Hs, d, e = _prob_minor(
        layout, Kinv, A, g, l, u, rho, Hs, d, e
    )
    x0, z0, y0, lo, uo = (
        jnp.moveaxis(a, 0, -1) for a in (x0, z0, y0, l_orig, u_orig)
    )
    x, z, y = admm_loop(Kinv, A, g, l, u, rho, x0, z0, y0,
                        iters=iters, sigma=float(sigma), alpha=float(alpha))
    outs = (x, z, y) + kkt_epilogue(A, Hs, g, x, y, lo, uo, d, e)
    return tuple(jnp.moveaxis(o, -1, 0) for o in outs)

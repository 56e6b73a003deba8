"""The QP prepare stage: Ruiz equilibration + problem/warm-start scaling.

One pass over a batch-minor problem (every per-scenario array is
(dims..., B), the scenario batch last) that runs all equilibration sweeps
and writes the scaled problem, the scaled warm start, the per-row ADMM
penalty rho and the scalings (d, e).  Plain jnp: XLA fuses the
elementwise sweeps and the row/column max-reductions.  The K-matrix
formation and its Newton-Schulz inverse follow in ops/qp.py.

Matches ops/qp._ruiz_equilibrate + the scaling block of the single-sample
solve in exact arithmetic (same operation order per sweep).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def ruiz_scalings(H, A, sweeps: int):
    """Ruiz column/row scalings (d (n, B), e (m, B)) of the batch-minor
    problem H (n, n, B), A (m, n, B)."""
    absH = jnp.abs(H)
    absA = jnp.abs(A)
    d = jnp.ones_like(H[0])       # (n, B)
    e = jnp.ones_like(A[:, 0])    # (m, B)

    def sweep(_, de):
        d, e = de
        Hs = absH * d[None, :, :] * d[:, None, :]
        As = absA * e[:, None, :] * d[None, :, :]
        cx = jnp.maximum(jnp.max(Hs, axis=0), jnp.max(As, axis=0))  # (n, B)
        rz = jnp.max(As, axis=1)                                    # (m, B)
        d = d * jax.lax.rsqrt(jnp.maximum(cx, 1e-8))
        e = e * jax.lax.rsqrt(jnp.maximum(rz, 1e-8))
        return d, e

    return jax.lax.fori_loop(0, sweeps, sweep, (d, e), unroll=True)


def prepare_minor(H, A, g, l, u, wx, wz, wy,
                  *, sweeps: int, rho0: float, rho_eq_scale: float):
    """Batch-minor prepare.  Returns (sH, sA, sg, sl, su, rho, wxs, wzs,
    wys, d, e), all batch-minor."""
    d, e = ruiz_scalings(H, A, sweeps)
    # equality detection on the UNSCALED bounds: e > 0 preserves equality,
    # and scaled-space u - l = e*u - e*l can be contracted to an FMA whose
    # exact partial product makes an exactly-equal row look nonzero at ~1e-8
    eq = (u - l) <= 1e-9
    rho = jnp.where(eq, rho0 * rho_eq_scale, rho0).astype(A.dtype)
    return (
        H * d[None, :, :] * d[:, None, :],
        A * e[:, None, :] * d[None, :, :],
        d * g, e * l, e * u, rho,
        wx / d, wz * e, wy / e,
        d, e,
    )


def _to_minor(a):
    return jnp.moveaxis(a, 0, -1)


def _to_major(a):
    return jnp.moveaxis(a, -1, 0)


@functools.partial(jax.jit, static_argnames=("sweeps", "rho0", "rho_eq_scale"))
def prepare_scaled(H, A, g, l, u, wx, wz, wy,
                   *, sweeps: int, rho0: float, rho_eq_scale: float):
    """Batch-major wrapper of prepare_minor: inputs (B, ...), returns
    (sH, sA, sg, sl, su, rho, wxs, wzs, wys, d, e), all batch-major."""
    outs = prepare_minor(
        *(_to_minor(a) for a in (H, A, g, l, u, wx, wz, wy)),
        sweeps=sweeps, rho0=float(rho0), rho_eq_scale=float(rho_eq_scale),
    )
    return tuple(_to_major(o) for o in outs)

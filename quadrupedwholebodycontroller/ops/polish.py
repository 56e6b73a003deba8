"""The active-set polish solve + iterative refinement, batch-minor.

One cascade per polish round (ops/qp.py), on batch-minor arrays
(dims..., B):

    y  = Sinv (-(da*b + B Hinv g))          x = Hinv (-g - B^T y)
    refine passes (preconditioned Richardson on the coupled KKT system):
        r1 = -g - H x - B^T y               r2 = da*b - B x - D y
        dy = Sinv (B Hinv r1 - r2)          dx = Hinv (r1 - B^T dy)
    z  = clip(A x, l, u)
    relative KKT residuals (OSQP normalization, matching ops/qp.kkt_residual)

B (the active-masked constraint matrix da*A) is never materialized: row
masking commutes through the matvecs (B v = da * (A v), B^T w = A^T (da*w)).
Replaces reference qpOASES's implicit factorization-backsolve accuracy
(src/whole_body_controller.cpp:517-541) at f32.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from quadrupedwholebodycontroller.ops.admm import _mv, _mvt


def _blockdiag_apply(diag, blk, start, v):
    """(diag ⊕ blk) @ v for a block-diagonal matrix stored compactly.

    diag: (n, B) with ZEROS on the block rows; blk: (k, k, B) at rows
    start:start+k.  Bitwise equal to the dense matvec: the dense row sums
    only add exact zeros on top of these terms."""
    k = blk.shape[0]
    dv = diag * v
    vs = jax.lax.slice_in_dim(v, start, start + k, axis=0)   # (k, B)
    bv = jnp.sum(blk * vs[None, :, :], axis=1)
    top = jax.lax.slice_in_dim(dv, 0, start, axis=0)
    bot = jax.lax.slice_in_dim(dv, start + k, dv.shape[0], axis=0)
    return jnp.concatenate([top, bv, bot], axis=0)


def polish_minor(apply_H, apply_Hinv, Sinv, A, da, g, b, l, u,
                 *, refine: int, reg: float):
    """The polish cascade on batch-minor arrays; apply_H / apply_Hinv are
    the (regularized) Hessian and its inverse as matvec callables.
    Returns (x, y, z, pr, du, sv), batch-minor ((B,) for the last three)."""
    # active-masked constraint matvecs without materializing da*A
    bv = lambda v: da * _mv(A, v)          # B v
    btw = lambda w: _mvt(A, da * w)        # B^T w

    D = (1.0 - da) - reg * da
    dab = da * b
    y = _mv(Sinv, -(dab + bv(apply_Hinv(g))))
    x = apply_Hinv(-g - btw(y))
    for _ in range(refine):
        r1 = -g - apply_H(x) - btw(y)
        r2 = dab - bv(x) - D * y
        dy = _mv(Sinv, bv(apply_Hinv(r1)) - r2)
        dx = apply_Hinv(r1 - btw(dy))
        x = x + dx
        y = y + dy

    ax = _mv(A, x)
    z = jnp.clip(ax, l, u)
    # relative KKT residuals — must match ops/qp.kkt_residual exactly
    hx = apply_H(x)  # reg*1e-9 difference vs the unregularized H is below f32
    aty = _mvt(A, y)
    fin_l = jnp.where(jnp.abs(l) < 1e19, jnp.abs(l), 0.0)
    fin_u = jnp.where(jnp.abs(u) < 1e19, jnp.abs(u), 0.0)
    finite_b = jnp.maximum(jnp.max(fin_l, axis=0), jnp.max(fin_u, axis=0))
    pscale = jnp.maximum(1.0, jnp.maximum(jnp.max(jnp.abs(ax), axis=0), finite_b))
    dscale = jnp.maximum(
        1.0,
        jnp.maximum(
            jnp.max(jnp.abs(hx), axis=0),
            jnp.maximum(jnp.max(jnp.abs(aty), axis=0), jnp.max(jnp.abs(g), axis=0)),
        ),
    )
    pr = jnp.max(jnp.abs(ax - z), axis=0) / pscale
    du = jnp.max(jnp.abs(hx + g + aty), axis=0) / dscale
    # sign/complementarity violation (ops/qp._sign_violation): y > 0 must
    # push on a nearby finite upper bound, y < 0 on a lower one; equality
    # rows are sign-free.  Bounds arrive clipped to +-1e20 (polish_tiles),
    # so "finite" is |.| < 1e19 and 1e20 serves as the infinite distance.
    eqr = (u - l) <= 1e-9
    d_up = jnp.where(jnp.abs(u) < 1e19, jnp.maximum(u - ax, 0.0), 1e20)
    d_lo = jnp.where(jnp.abs(l) < 1e19, jnp.maximum(ax - l, 0.0), 1e20)
    dist = jnp.where(eqr, 0.0, jnp.where(y > 0, d_up, d_lo))
    sv = jnp.max(
        jnp.minimum(jnp.abs(y) / dscale[None, :], dist / pscale[None, :]),
        axis=0,
    )
    return x, y, z, pr, du, sv


def _to_minor(a):
    return jnp.moveaxis(a, 0, -1)


def polish_tiles(H, Hinv, A, g, l, u, pre_tiled=None):
    """Batch-minor copies of the polish-round-INVARIANT inputs.

    The iterated active-set polish (ops/qp.solve_batched) calls
    polish_solve once per round, but only (Sinv, da, b) change between
    rounds; moving (H, Hinv, A, g, l, u) to the batch-minor layout once per
    solve saves one HBM round trip per (B, 70, 42)-class array per extra
    round.

    H and Hinv may each be a dense (B, n, n) array or a compact
    block-diagonal (diag (B, n), blk (B, k, k), start) tuple — diag MUST
    be zero on the block rows.

    pre_tiled: optional dict with ALREADY batch-minor A (m, n, B) / g / l
    / u — straight from the setup stage's batch-minor outputs, skipping
    their transposes."""
    big = jnp.asarray(1e20, l.dtype)
    src = pre_tiled if pre_tiled is not None else dict(
        A=_to_minor(A), g=_to_minor(g), l=_to_minor(l), u=_to_minor(u)
    )
    tiles = dict(A=src["A"], g=src["g"], l=jnp.clip(src["l"], -big, big),
                 u=jnp.clip(src["u"], -big, big))
    compact = isinstance(H, tuple)
    assert compact == isinstance(Hinv, tuple), "H/Hinv forms must match"
    tiles["compact"] = compact
    if compact:
        hd, hblk, start = H
        hid, hiblk, istart = Hinv
        assert start == istart
        tiles.update(hd=_to_minor(hd), hblk=_to_minor(hblk),
                     hid=_to_minor(hid), hiblk=_to_minor(hiblk),
                     blk_start=start)
    else:
        tiles.update(H=_to_minor(H), Hinv=_to_minor(Hinv))
    return tiles


def _h_applies(tiles):
    """(apply_H, apply_Hinv) matvecs over the tiles' H / Hinv forms."""
    if tiles["compact"]:
        s = tiles["blk_start"]
        return (lambda v: _blockdiag_apply(tiles["hd"], tiles["hblk"], s, v),
                lambda v: _blockdiag_apply(tiles["hid"], tiles["hiblk"], s, v))
    return (lambda v: _mv(tiles["H"], v), lambda v: _mv(tiles["Hinv"], v))


def polish_solve(H, Hinv, Sinv, A, da, g, b, l, u,
                 *, refine: int, reg: float,
                 tiles=None, sinv_layout: str = "major"):
    """Batch-major wrapper: inputs (B, ...) -> (x, y, z, pr, du, sv)
    batch-major.

    H is the REGULARIZED polish Hessian (H + reg I); da the active-row mask;
    Sinv the (approximate) inverse of the polish Schur complement.  H and
    Hinv may be dense or compact block-diagonal tuples (see polish_tiles).

    tiles: optional invariants from polish_tiles (then H, Hinv, A, g, l, u
    may be None).

    sinv_layout="minor": Sinv is ALREADY batch-minor (m, m, B) — the carried
    cache of the batch-minor solve chain (ops/qp solve_layout) — so the
    (B, 70, 70) transpose is skipped."""
    if tiles is None:
        tiles = polish_tiles(H, Hinv, A, g, l, u)
    Sinv_m = Sinv if sinv_layout == "minor" else _to_minor(Sinv)
    outs = polish_minor(
        *_h_applies(tiles), Sinv_m, tiles["A"],
        _to_minor(da), tiles["g"], _to_minor(b), tiles["l"], tiles["u"],
        refine=refine, reg=reg,
    )
    return tuple(jnp.moveaxis(o, -1, 0) for o in outs)

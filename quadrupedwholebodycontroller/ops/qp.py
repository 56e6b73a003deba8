"""Batched dense convex QP solver (OSQP-style ADMM + active-set polish).

Replaces qpOASES' hot-started SQProblem (reference
src/whole_body_controller.cpp:517-541; 42 variables x 70 two-sided
constraints, hpp:31-32) with an accelerator-friendly batched design:

  * fixed iteration count (XLA-static control flow, lax.fori_loop),
  * one 42x42 SPD factorization per problem, then matmul-only iterations
    (batched einsum),
  * warm start carried across control cycles (the analogue of qpOASES
    hotstart: ADMM iterates (x, z, y) restart from the previous cycle's
    solution, and at 400 Hz consecutive problems differ slightly),
  * an active-set "polish" solve (OSQP-style) that recovers near-exact
    KKT-stationary solutions from the ADMM estimate of the active set,
  * per-problem status/KKT residuals instead of a global abort (the
    reference aborts the whole controller on QP failure, cpp:654-659; in a
    batched setting each scenario carries its own status).

Problem form:  min 1/2 x^T H x + g^T x   s.t.  l <= A x <= u
All functions are single-sample; batch via vmap.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from quadrupedwholebodycontroller.config import QPSolverParams
from quadrupedwholebodycontroller.ops import admm as admm_ops, prepare
from quadrupedwholebodycontroller.ops.linalg import full_precision as _full_precision
from quadrupedwholebodycontroller.ops.polish import polish_solve, polish_tiles


class QPData(NamedTuple):
    H: jax.Array  # (n, n) symmetric PD
    g: jax.Array  # (n,)
    A: jax.Array  # (m, n)
    l: jax.Array  # (m,)
    u: jax.Array  # (m,)


class QPState(NamedTuple):
    """Warm-startable iterate (the hotstart carry)."""

    x: jax.Array  # (n,)
    z: jax.Array  # (m,)
    y: jax.Array  # (m,)

    @classmethod
    def zeros(cls, n: int, m: int, dtype=jnp.float32) -> "QPState":
        return cls(
            x=jnp.zeros((n,), dtype), z=jnp.zeros((m,), dtype), y=jnp.zeros((m,), dtype)
        )


class QPInfo(NamedTuple):
    primal_residual: jax.Array  # max |clip(Ax) - Ax|
    dual_residual: jax.Array    # max |Hx + g + A^T y|
    kkt_residual: jax.Array     # max of the two
    polished: jax.Array         # bool: polish accepted


class QPCache(NamedTuple):
    """Carried factorization cache: the control-cycle hotstart extended to

    the matmul-only linear algebra.  Problems change slowly at 400 Hz, so
    Newton-Schulz restarted from last cycle's inverses converges in a few
    (quadratic) iterations instead of the cold ~30.  Valid only while the
    problem changes smoothly — invalidate across contact switches."""

    kinv: jax.Array  # (B, n, n) inverse of the scaled ADMM matrix K —
    #                  (n, n, B) batch-minor when solve_layout == "minor"
    hinv: jax.Array  # (B, n, n) inverse of the polish H + reg I
    sinv: jax.Array  # (B, m, m) inverse of the last polish Schur complement

    @classmethod
    def zeros(cls, B: int, n: int, m: int, dtype=jnp.float32,
              layout: str = "major") -> "QPCache":
        """layout="minor": kinv (n, n, B) and sinv (m, m, B) are stored
        batch-minor so the batch-minor solve chain (solve_layout="minor",
        the padded-HBM-traffic fix) warm-starts and polishes without
        boundary transposes.  Use make_cache(B, n, m, params, dtype) to
        match QPSolverParams."""
        if layout == "minor" and B in (n, m):
            # the solve chain detects layout by SHAPE: at B == n or B == m a
            # minor cache is indistinguishable from batch-major and a
            # non-zero minor cache would be silently misread.  make_cache
            # falls back to batch-major at these shapes; enforce it here so
            # no caller can construct the ambiguous case.
            raise ValueError(
                f"minor cache layout is shape-ambiguous at B={B} with "
                f"n={n}, m={m}; use make_cache (batch-major fallback)"
            )
        kshape = (n, n, B) if layout == "minor" else (B, n, n)
        sshape = (m, m, B) if layout == "minor" else (B, m, m)
        return cls(
            kinv=jnp.zeros(kshape, dtype),
            hinv=jnp.zeros((B, n, n), dtype),
            sinv=jnp.zeros(sshape, dtype),
        )


def make_cache(B: int, n: int, m: int, params: QPSolverParams,
               dtype=jnp.float32) -> QPCache:
    """QPCache.zeros with the kinv/sinv layout matching params.solve_layout.

    B == n or B == m would make the minor layout shape-ambiguous (the
    chain detects layout by shape), so fall back to batch-major there.
    Note the chain's transparent layout normalization relies on the shape
    detection; at the ambiguous shapes a genuinely minor non-zero cache
    would be MISREAD as batch-major (safeguarded to a cold init by the NS
    divergence check — extra iterations, not wrong answers).  Correctness
    therefore relies on never constructing a non-zero minor cache at these
    shapes: QPCache.zeros raises on the ambiguous combination, and the
    batch-major fallback here keeps the carried layout unambiguous."""
    layout = params.solve_layout
    if layout == "minor" and (B == n or B == m):
        layout = "major"
    return QPCache.zeros(B, n, m, dtype, layout=layout)


def _bound_finite(x):
    """A bound is "real" when |x| < 1e19 — handles both jnp.inf and the
    finite qpOASES-style INFTY = 1e20 (config.QP_INF) conventions."""
    return jnp.abs(x) < 1e19


def _sg(tree):
    """stop_gradient on the array leaves of a pytree (static leaves — e.g.
    the compact block-diagonal `start` index — pass through untouched)."""
    return jax.tree.map(
        lambda x: jax.lax.stop_gradient(x) if isinstance(x, jax.Array) else x,
        tree,
    )


def _ad_passthrough(before, after):
    """value = `after`, gradient = identity on `before`.

    The staged tail rescue runs in a lax.while_loop (one trace, re-fires
    until below threshold) which reverse-mode AD cannot transpose; and
    differentiating through a conditionally-fired reliability refinement is
    not meaningful anyway (it approximates the same implicit solution map).
    The rescue therefore runs entirely under stop_gradient and its result
    is merged value-only: downstream gradients flow through the pre-rescue
    iterate (the smooth ADMM+polish path), keeping end-to-end
    differentiability (tests/test_differentiability.py) with the rescue
    active."""
    def merge(a, b):
        if not jnp.issubdtype(jnp.asarray(a).dtype, jnp.floating):
            return b  # bool/int leaves (e.g. `polished`) carry no gradient
        return a + jax.lax.stop_gradient(b - a)

    return jax.tree.map(merge, before, after)


def _blockdiag_dense(compact):
    """Densify a compact block-diagonal (diag (B, n), blk (B, k, k), start)
    matrix (the hinv_fn closed-form protocol); diag is zero on the block
    rows."""
    diag, blk, start = compact
    k = blk.shape[-1]
    out = jax.vmap(jnp.diag)(diag)
    return out.at[:, start:start + k, start:start + k].set(blk)


def _rho_vec(data: QPData, params: QPSolverParams):
    eq = (data.u - data.l) <= 1e-9
    return jnp.where(eq, params.rho * params.rho_eq_scale, params.rho)


def kkt_residual(data: QPData, x, y):
    """Relative KKT primal/dual residuals of a primal/dual pair

    (solver-independent optimality certificate — the test oracle replacing
    an external QP library).  OSQP-style normalization: the WBC problem's
    data spans ~1 (acceleration rows) to ~1e4+ (stiff-gain wrench terms in
    extreme scenarios), so absolute residuals are not comparable across a
    scenario batch.  Complementary slackness is not scored: ADMM satisfies
    it exactly through the z-projection and the polish by active-set
    structure (OSQP's termination criterion makes the same choice)."""
    ax = data.A @ x
    hx = data.H @ x
    aty = data.A.T @ y
    finite_b = jnp.maximum(
        jnp.max(jnp.where(_bound_finite(data.l), jnp.abs(data.l), 0.0)),
        jnp.max(jnp.where(_bound_finite(data.u), jnp.abs(data.u), 0.0)),
    )
    primal_scale = jnp.maximum(1.0, jnp.maximum(jnp.max(jnp.abs(ax)), finite_b))
    dual_scale = jnp.maximum(
        1.0,
        jnp.maximum(
            jnp.max(jnp.abs(hx)),
            jnp.maximum(jnp.max(jnp.abs(aty)), jnp.max(jnp.abs(data.g))),
        ),
    )
    primal = jnp.max(jnp.abs(ax - jnp.clip(ax, data.l, data.u))) / primal_scale
    dual = jnp.max(jnp.abs(hx + data.g + aty)) / dual_scale
    return primal, dual


def _active_tols(data: QPData, ax):
    """Activation tolerances for the active-set estimate, RELATIVE to the
    problem scale (single-sample; callers vmap).

    The historical absolute tol = 1e-6 is sound in double precision
    (qpOASES/OSQP convention) but catastrophically loose for f32 duals on
    the WBC problem's ~1e4-magnitude data: ADMM dual noise there is
    ~1e-3..1e-1 ABSOLUTE, so |y| > 1e-6 "activations" fired on pure noise
    and the polish then solved a wrong active set to machine precision —
    a saddle the sign-blind KKT certificate cannot reject (measured: 0.25
    N·m torque error at 2.4e-8 relative KKT, tools/debug_compfinal.py).
    Scaling the thresholds by eps(dtype) * scale keeps the f64 behavior
    bit-identical in practice (the 1e-6 floor dominates there) and lifts
    the f32 thresholds above the noise floor."""
    dtype = ax.dtype
    eps = float(jnp.finfo(dtype).eps)
    finite_b = jnp.maximum(
        jnp.max(jnp.where(_bound_finite(data.l), jnp.abs(data.l), 0.0)),
        jnp.max(jnp.where(_bound_finite(data.u), jnp.abs(data.u), 0.0)),
    )
    primal_scale = jnp.maximum(
        1.0, jnp.maximum(jnp.max(jnp.abs(ax)), finite_b)
    )
    dual_scale = jnp.maximum(1.0, jnp.max(jnp.abs(data.g)))
    tol_p = jnp.maximum(1e-6, 256.0 * eps * primal_scale)
    tol_d = jnp.maximum(1e-6, 256.0 * eps * dual_scale)
    return tol_p, tol_d


def _polish(data: QPData, state: QPState, params: QPSolverParams, Hinv=None,
            sinv_fn=None, return_sinv: bool = False, banned=None,
            return_active: bool = False):
    """Active-set KKT solve from the ADMM active-set estimate.

    Unknowns (x, y); rows:  [H  A^T] [x]   [-g ]
                            [Da A  (I-Da)] [y] = [Da b]
    where Da selects active rows (b = u or l as flagged by the dual sign /
    projection), inactive rows force y_i = 0.  Fixed shape (n+m, n+m).

    Hinv (optional): precomputed inverse of H + reg*I — H is identical
    across polish rounds, so callers compute it once."""
    n = data.H.shape[0]
    m = data.A.shape[0]
    dtype = data.H.dtype
    ax = data.A @ state.x
    eq = (data.u - data.l) <= 1e-9
    tol_p, tol_d = _active_tols(data, ax)
    # a bound can only be active if it is finite (avoid 0*inf = NaN below)
    low_active = _bound_finite(data.l) & (
        (ax - data.l <= tol_p) | (state.y < -tol_d)
    )
    upp_active = _bound_finite(data.u) & (
        (data.u - ax <= tol_p) | (state.y > tol_d)
    )
    if banned is not None:
        low_active = low_active & ~banned
        upp_active = upp_active & ~banned
    # all-zero rows (contact-masked constraints) must be treated as inactive,
    # otherwise they contribute a zero row to the KKT system (singular)
    nonzero_row = jnp.sum(jnp.abs(data.A), axis=1) > 1e-12
    active = (eq | low_active | upp_active) & nonzero_row
    b = jnp.where(upp_active & ~low_active, data.u, data.l)
    b = jnp.where(eq, data.u, b)
    b = jnp.where(active, b, 0.0)
    da = active.astype(dtype)

    # matmul-only Schur solve (ops/linalg.py), no factorization custom calls
    from quadrupedwholebodycontroller.ops.linalg import solve_kkt_schur

    out = solve_kkt_schur(
        data.H + params.polish_reg * jnp.eye(n, dtype=dtype),
        da[:, None] * data.A,
        da,
        data.g,
        jnp.where(active, b, 0.0),
        reg=params.polish_reg,
        iters=params.ns_iters,
        refine=params.polish_refine,
        Hinv=Hinv,
        sinv_fn=sinv_fn,
        return_sinv=return_sinv,
    )
    if return_sinv:
        x, y, sinv = out
        st = QPState(x=x, z=jnp.clip(data.A @ x, data.l, data.u), y=y)
        return (st, sinv, active, b) if return_active else (st, sinv)
    x, y = out
    st = QPState(x=x, z=jnp.clip(data.A @ x, data.l, data.u), y=y)
    return (st, active, b) if return_active else st


def _polish_hinv(data: QPData, params: QPSolverParams):
    """The round-invariant H inverse for _polish."""
    from quadrupedwholebodycontroller.ops.linalg import ns_inverse

    n = data.H.shape[-1]
    return ns_inverse(
        data.H + params.polish_reg * jnp.eye(n, dtype=data.H.dtype),
        params.ns_iters,
    )


def _ruiz_equilibrate(data: QPData, iters: int):
    """Ruiz equilibration of the KKT matrix [[H, A^T], [A, 0]].

    Returns diagonal scalings (d (n,), e (m,)).  The WBC QP mixes wrench rows
    (~5e2 N) with acceleration rows (~1); equilibration is what lets a fixed
    small ADMM iteration count converge across gait phases."""
    n = data.H.shape[0]
    m = data.A.shape[0]
    d = jnp.ones((n,), data.H.dtype)
    e = jnp.ones((m,), data.H.dtype)

    def body(_, de):
        d, e = de
        Hs = jnp.abs(d[:, None] * data.H * d[None, :])
        As = jnp.abs(e[:, None] * data.A * d[None, :])
        cx = jnp.maximum(jnp.max(Hs, axis=0), jnp.max(As, axis=0))  # per-variable
        rz = jnp.max(As, axis=1)                                     # per-constraint
        d = d * jax.lax.rsqrt(jnp.maximum(cx, 1e-8))
        e = e * jax.lax.rsqrt(jnp.maximum(rz, 1e-8))
        return d, e

    return jax.lax.fori_loop(0, iters, body, (d, e))


@_full_precision
def solve(data: QPData, warm: QPState, params: QPSolverParams = QPSolverParams()):
    """Solve one QP; returns (QPState, QPInfo).

    Feed the returned state back as `warm` on the next control cycle for the
    hotstart behavior (reference cpp:529-533)."""
    n = data.H.shape[0]
    dtype = data.H.dtype

    # ---- scaling ----
    if params.scaling_iters > 0:
        d, e = _ruiz_equilibrate(data, params.scaling_iters)
    else:
        d = jnp.ones((n,), dtype)
        e = jnp.ones((data.A.shape[0],), dtype)
    sdata = QPData(
        H=d[:, None] * data.H * d[None, :],
        g=d * data.g,
        A=e[:, None] * data.A * d[None, :],
        l=e * data.l,
        u=e * data.u,
    )
    # warm start mapped into scaled space (x = d xs, y = e ys, z = zs / e)
    warm_s = QPState(x=warm.x / d, z=warm.z * e, y=warm.y / e)

    rho = _rho_vec(sdata, params)
    sigma = jnp.asarray(params.sigma, dtype)
    alpha = jnp.asarray(params.alpha, dtype)

    from quadrupedwholebodycontroller.ops.linalg import ns_inverse

    K = sdata.H + sigma * jnp.eye(n, dtype=dtype) + (sdata.A.T * rho) @ sdata.A
    # one matmul-only inverse per problem (no factorization custom calls,
    # no per-iteration triangular solves); iterations are then pure matmuls
    K_inv = ns_inverse(K, params.ns_iters)

    def body(_, st):
        x, z, y = st
        rhs = sigma * x - sdata.g + sdata.A.T @ (rho * z - y)
        x_t = K_inv @ rhs
        z_t = sdata.A @ x_t
        x_n = alpha * x_t + (1.0 - alpha) * x
        z_pre = alpha * z_t + (1.0 - alpha) * z + y / rho
        z_n = jnp.clip(z_pre, sdata.l, sdata.u)
        y_n = y + rho * (alpha * z_t + (1.0 - alpha) * z - z_n)
        return (x_n, z_n, y_n)

    x, z, y = jax.lax.fori_loop(
        0, params.iterations, body, (warm_s.x, warm_s.z, warm_s.y)
    )
    # cold start (all-zero warm state): spend the init iteration budget —
    # the qpOASES init/hotstart asymmetry (reference cpp:523-533)
    extra = max(0, params.cold_iterations - params.iterations)
    if extra:
        cold = ~(
            jnp.any(warm.x != 0) | jnp.any(warm.z != 0) | jnp.any(warm.y != 0)
        )
        x, z, y = jax.lax.cond(
            cold,
            lambda st: jax.lax.fori_loop(0, extra, body, st),
            lambda st: st,
            (x, z, y),
        )
    # back to the original space
    admm = QPState(x=d * x, z=z / e, y=e * y)

    def residuals(st):
        pr, du = kkt_residual(data, st.x, st.y)
        tot = jnp.maximum(pr, du)
        tot = jnp.where(jnp.isfinite(tot), tot, jnp.inf)
        return pr, du, tot

    best = admm
    pr_b, du_b, res_b = residuals(admm)
    polished = jnp.asarray(False)
    sv_b = _sign_violation(data, best.x, best.y)
    Hinv_polish = _polish_hinv(data, params) if params.polish else None
    # iterated active-set polish with the DROP rule: each round
    # re-estimates the active set from the working candidate chain
    # (through rejections — classical active-set pivoting), banning rows
    # whose candidate multiplier came out wrong-signed (a stale warm dual
    # otherwise pins a row at a bound it should be free of; see
    # _sign_violation / _active_tols)
    eq_rows1 = (data.u - data.l) <= 1e-9
    tol_drop1 = jnp.maximum(
        1e-6,
        256.0 * float(jnp.finfo(dtype).eps)
        * jnp.maximum(1.0, jnp.max(jnp.abs(data.g))),
    )
    banned1 = jnp.zeros_like(eq_rows1)
    w_pol = best
    for _ in range(params.polish_rounds if params.polish else 0):
        pol, act_r, b_r = _polish(
            data, w_pol, params, Hinv_polish, banned=banned1,
            return_active=True,
        )
        side_up = (b_r == data.u) & ~eq_rows1
        wrong = act_r & ~eq_rows1 & jnp.where(
            side_up, pol.y < -tol_drop1, pol.y > tol_drop1
        )
        banned1 = banned1 | wrong
        w_pol = pol
        pr_p, du_p, res_p = residuals(pol)
        # sign-augmented acceptance (see _accept_better)
        sv_p = _sign_violation(data, pol.x, pol.y)
        ok = jnp.maximum(res_p, sv_p) <= jnp.maximum(res_b, sv_b)
        best = jax.tree.map(lambda p, a: jnp.where(ok, p, a), pol, best)
        pr_b = jnp.where(ok, pr_p, pr_b)
        du_b = jnp.where(ok, du_p, du_b)
        res_b = jnp.where(ok, res_p, res_b)
        sv_b = jnp.where(ok, sv_p, sv_b)
        polished = polished | ok

    info = QPInfo(
        primal_residual=pr_b,
        dual_residual=du_b,
        kkt_residual=res_b,
        polished=polished,
    )
    if params.rescue_threshold > 0:
        rparams = _rescue_solver_params(params)
        data_sg = _sg(data)

        def do_rescue(ops):
            s, b, i, _ = ops
            st, ri = solve(data_sg, b, rparams)
            ok = ri.kkt_residual <= i.kkt_residual
            improved = ok & (ri.kkt_residual < i.kkt_residual)
            return (
                s + 1,
                jax.tree.map(lambda p, a: jnp.where(ok, p, a), st, b),
                QPInfo(
                    primal_residual=jnp.where(ok, ri.primal_residual, i.primal_residual),
                    dual_residual=jnp.where(ok, ri.dual_residual, i.dual_residual),
                    kkt_residual=jnp.where(ok, ri.kkt_residual, i.kkt_residual),
                    polished=i.polished | (ok & ri.polished),
                ),
                improved,
            )

        # re-fires until below threshold, the stage budget runs out, or a
        # stage improves nothing (single trace): each stage continues ADMM
        # from the improved iterate — the batched analogue lives in
        # solve_batched.  Runs under stop_gradient with a value-only merge
        # (_ad_passthrough)
        _, best_r, info_r, _ = jax.lax.while_loop(
            lambda ops: (ops[0] < params.rescue_stages)
            & (ops[2].kkt_residual > params.rescue_threshold)
            & ops[3],
            do_rescue,
            (jnp.zeros((), jnp.int32), _sg(best), _sg(info),
             jnp.asarray(True)),
        )
        best, info = _ad_passthrough((best, info), (best_r, info_r))
    return best, info


def _rescue_solver_params(params: QPSolverParams) -> QPSolverParams:
    """Solver settings for the guarded tail re-solve: more ADMM iterations,
    a second polish round, rescue disabled (no recursion)."""
    import dataclasses

    return dataclasses.replace(
        params,
        # exactly rescue_polish_rounds, matching the in-scope cached-chain rescue
        # (_rescue_core loops rescue_polish_rounds) — tuned rescue budgets
        # mean the same thing on every backend
        iterations=params.rescue_iterations,
        polish_rounds=params.rescue_polish_rounds,
        rescue_threshold=0.0,
    )


def _accept_better(best, pr_b, du_b, res_b, polished, cand, pr_c, du_c,
                   res_c, cand_polished=None, data=None, sv_cand=None):
    """Per-scenario merge: keep `cand` wherever its residual improves.

    With `data`, the comparison is SIGN-AUGMENTED: max(res, sign_violation)
    on both sides, so a wrong-active-set saddle (tiny primal/dual residual,
    wrong-signed multipliers — see _sign_violation) can never displace an
    honest iterate.  The carried pr/du/res stay the plain OSQP-convention
    certificates either way."""
    if data is None:
        ok = res_c <= res_b
    else:
        svc = (
            sv_cand if sv_cand is not None
            else _sign_violation(data, cand.x, cand.y)
        )
        ok = jnp.maximum(res_c, svc) <= jnp.maximum(
            res_b, _sign_violation(data, best.x, best.y)
        )
    oke = ok[:, None]
    merged = QPState(
        x=jnp.where(oke, cand.x, best.x),
        z=jnp.where(oke, cand.z, best.z),
        y=jnp.where(oke, cand.y, best.y),
    )
    pol = polished | ok if cand_polished is None else polished | (
        ok & cand_polished)
    return (merged, jnp.where(ok, pr_c, pr_b), jnp.where(ok, du_c, du_b),
            jnp.where(ok, res_c, res_b), pol)


def _polish_comp(data, state, params, Hinv=None, passes=None):
    """Compensated (double-f32) active-set polish candidate.

    The f32 chain's answer to the reference's all-double arithmetic
    (whole_body_controller.cpp uses `double` throughout): re-estimate the
    active set from `state`, solve
    the regularized KKT system with the plain-f32 Schur pipeline, then run
    `rescue_comp_refine` refinement passes whose residuals are computed
    with error-free transformations (ops/compensated.py) — once the
    iterate is a few digits accurate, a plain f32 residual r = rhs - K w
    is pure cancellation noise (~eps * sum|terms|, which at the WBC QP's
    ~1e4 data magnitudes is exactly the observed ~1e-3 relative-KKT
    plateau), while the compensated residual is exact to ~eps * |r|.
    Preconditioner applications stay plain f32 matmuls.  Returns
    (candidate, pr, du) with residuals from the standard f32 certificate
    for comparability."""
    from quadrupedwholebodycontroller.ops import compensated as comp
    from quadrupedwholebodycontroller.ops.linalg import ns_inverse

    dtype = data.H.dtype
    n = data.H.shape[-1]
    m = data.A.shape[-2]
    da, b = _assemble_active(data, state, dtype)
    Hreg = data.H + params.polish_reg * jnp.eye(n, dtype=dtype)
    Hinv_d = (
        _blockdiag_dense(Hinv) if isinstance(Hinv, tuple)
        else (ns_inverse(Hreg, params.ns_iters) if Hinv is None else Hinv)
    )
    Bm = da[:, :, None] * data.A
    Bt = jnp.swapaxes(Bm, -1, -2)
    diag_S = params.polish_reg * da + (1.0 - da)
    S = Bm @ Hinv_d @ Bt + jnp.einsum(
        "bi,ij->bij", diag_S, jnp.eye(m, dtype=dtype)
    )
    Sinv = ns_inverse(S, params.ns_iters)
    D = (1.0 - da) - params.polish_reg * da
    mv = lambda M, v: jnp.einsum("bij,bj->bi", M, v)
    y = mv(Sinv, -(da * b + mv(Bm, mv(Hinv_d, data.g))))
    x = mv(Hinv_d, -data.g - mv(Bt, y))
    # full KKT operator for the compensated residual: K w = rhs,
    # K = [[H+reg I, B^T], [B, diag(D)]], w = [x; y]
    Ktop = jnp.concatenate([Hreg, Bt], axis=-1)
    Kbot = jnp.concatenate([Bm, jax.vmap(jnp.diag)(D)], axis=-1)
    Kfull = jnp.concatenate([Ktop, Kbot], axis=-2)
    rhs = jnp.concatenate([-data.g, da * b], axis=-1)
    for _ in range(max(params.rescue_comp_refine, 1) if passes is None
                   else passes):
        w = jnp.concatenate([x, y], axis=-1)
        r = comp.comp_residual(rhs, Kfull, w)
        r1, r2 = r[..., :n], r[..., n:]
        dy = mv(Sinv, mv(Bm, mv(Hinv_d, r1)) - r2)
        dx = mv(Hinv_d, r1 - mv(Bt, dy))
        x = x + dx
        y = y + dy
    ax = mv(data.A, x)
    pol = QPState(x=x, z=jnp.clip(ax, data.l, data.u), y=y)

    def res_one(d, s):
        pr, du = kkt_residual(d, s.x, s.y)
        return pr, du

    pr, du = jax.vmap(res_one)(data, pol)
    return pol, pr, du


def _hinv_mv(Hinv, v):
    """Apply the polish H^{-1} (compact (diag, blk, start) or dense) as a
    batched matvec."""
    if isinstance(Hinv, tuple):
        hd, hblk, hstart = Hinv
        k = hblk.shape[-1]
        seg = jnp.einsum("bij,bj->bi", hblk, v[:, hstart:hstart + k])
        out = hd * v
        return out.at[:, hstart:hstart + k].set(seg)
    return jnp.einsum("bij,bj->bi", Hinv, v)


def _sign_violation(data, x, y):
    """Relative complementarity/sign residual of a primal/dual pair.

    kkt_residual deliberately does not score dual signs (OSQP's choice:
    ADMM's projection and the polish's active-set structure guarantee them
    by construction).  An active-set KKT *refinement*, however, can
    converge to the saddle of a WRONG active set — zero primal and dual
    residual, wrong-signed multipliers — which a sign-blind certificate
    cannot reject (observed: 0.4 N·m torque error at measured 1e-6 KKT).
    For each row: y_i > 0 must push on a nearby upper bound, y_i < 0 on a
    lower one; the violation is min(|y_i|/dual_scale, dist/primal_scale)
    — dimensionless, zero iff every multiplier is either negligible or
    complementary."""
    ax = jnp.einsum("...ij,...j->...i", data.A, x)
    d_up = jnp.where(_bound_finite(data.u),
                     jnp.maximum(data.u - ax, 0.0), jnp.inf)
    d_lo = jnp.where(_bound_finite(data.l),
                     jnp.maximum(ax - data.l, 0.0), jnp.inf)
    # equality rows: y is sign-free (both bounds coincide)
    eq = (data.u - data.l) <= 1e-9
    dist = jnp.where(eq, 0.0, jnp.where(y > 0, d_up, d_lo))
    finite_b = jnp.maximum(
        jnp.max(jnp.where(_bound_finite(data.l), jnp.abs(data.l), 0.0),
                axis=-1),
        jnp.max(jnp.where(_bound_finite(data.u), jnp.abs(data.u), 0.0),
                axis=-1),
    )
    primal_scale = jnp.maximum(
        1.0, jnp.maximum(jnp.max(jnp.abs(ax), axis=-1), finite_b)
    )
    hx = jnp.einsum("...ij,...j->...i", data.H, x)
    aty = jnp.einsum("...ji,...j->...i", data.A, y)
    dual_scale = jnp.maximum(
        1.0,
        jnp.maximum(
            jnp.max(jnp.abs(hx), axis=-1),
            jnp.maximum(jnp.max(jnp.abs(aty), axis=-1),
                        jnp.max(jnp.abs(data.g), axis=-1)),
        ),
    )
    v = jnp.minimum(
        jnp.abs(y) / dual_scale[..., None], dist / primal_scale[..., None]
    )
    return jnp.max(v, axis=-1)


def _comp_refine_final(data, state, params, Hinv, sinv):
    """Always-on compensated (double-f32) refinement of the FINAL iterate.

    The torque-parity closer (BASELINE <=1e-3 N.m vs the reference torque
    map, whole_body_controller.cpp:565-568): a ~6.7e-4 relative-KKT f32
    iterate on ~1e4-magnitude data still carries ~0.1 N of slack along the
    weakly-penalized (curvature ~1, R = I per cpp:474-477) stance-force
    split direction — an IMPROVABLE ill-conditioning residual, not a
    solution ambiguity (H >= I makes the minimizer unique).  The plain-f32
    polish refinement cannot push past it because its residual evaluation
    noise floor (eps * sum|terms| ~ 1e-2 absolute here) buries the weak
    direction's ~1e-1 residual after the first pass; the error-free-
    transformation residual (ops/compensated.py) is exact to ~eps * |r|,
    so each pass contracts the true error toward the f32 representation
    floor (~3e-5 N on ~500 N forces).

    Unlike _polish_comp (the rescue's from-scratch candidate) this reuses
    the preconditioners already in hand — the closed-form/carried polish
    H^{-1} and the last polish round's Schur inverse `sinv` (batch-major
    (B, m, m)) — so the marginal cost is EFT residual arithmetic plus two
    preconditioner matvecs per pass; no new Newton-Schulz inverses.  A
    stale preconditioner only slows contraction; acceptance is guarded by
    the caller on the standard f32 certificate."""
    from quadrupedwholebodycontroller.ops import compensated as comp

    dtype = data.H.dtype
    reg = jnp.full_like(state.x, params.polish_reg)
    mv = lambda M, v: jnp.einsum("bij,bj->bi", M, v)
    x, y = state.x, state.y
    for _ in range(params.comp_final_refine):
        # re-estimate the active set from the CURRENT iterate each pass:
        # a mis-classified row shows up as a wrong-signed multiplier after
        # one refinement, and the re-estimate drops it (the iterated-
        # active-set mechanism of _polish, at refinement cost)
        da, b = _assemble_active(data, QPState(x=x, z=state.z, y=y), dtype)
        Bm = da[:, :, None] * data.A
        Bt = jnp.swapaxes(Bm, -1, -2)
        D = (1.0 - da) - params.polish_reg * da
        # r1 = -g - (H + reg I) x - B^T y ; r2 = da*b - B x - D y, each in
        # one compensated accumulation (the H/B^T cancellation at
        # stationarity is BETWEEN blocks)
        r1 = comp.comp_residual_chain(
            -data.g, mat_terms=((data.H, x), (Bt, y)), diag_terms=((reg, x),)
        )
        r2 = comp.comp_residual_chain(
            da * b, mat_terms=((Bm, x),), diag_terms=((D, y),)
        )
        dy = mv(sinv, mv(Bm, _hinv_mv(Hinv, r1)) - r2)
        dx = _hinv_mv(Hinv, r1 - mv(Bt, dy))
        x = x + dx
        y = y + dy
    ax = mv(data.A, x)
    pol = QPState(x=x, z=jnp.clip(ax, data.l, data.u), y=y)
    pr, du = jax.vmap(lambda d, s: kkt_residual(d, s.x, s.y))(data, pol)
    return pol, pr, du


def _rescue_batched(data, best, info, params, backend, hinv_fn):
    """Per-scenario f32 tail rescue (the batched qpOASES-setToReliable
    analogue, reference cpp:519): while ANY scenario's relative KKT exceeds
    rescue_threshold (up to rescue_stages passes, lax.while_loop — one
    trace), re-solve the batch warm-started from the current best iterate
    with the rescue budget, add a compensated-refinement polish candidate,
    and accept per-scenario only where the residual improves.  On typical
    steps (no flagged scenario) the loop costs one scalar compare."""
    rparams = _rescue_solver_params(params)
    data_sg = _sg(data)

    def do_rescue(ops):
        s, b, i, _ = ops
        st, ri = solve_batched(data_sg, b, rparams, backend, hinv_fn=hinv_fn)
        merged, pr_b, du_b, res_b, pol = _accept_better(
            b, i.primal_residual, i.dual_residual, i.kkt_residual,
            i.polished, st, ri.primal_residual, ri.dual_residual,
            ri.kkt_residual, ri.polished, data=data_sg,
        )
        if params.rescue_comp_refine > 0 and params.polish:
            Hinv = (
                hinv_fn(data_sg.H, params.polish_reg)
                if hinv_fn is not None else None
            )
            cand, pr_c, du_c = _polish_comp(
                data_sg, QPState(merged.x, merged.z, merged.y), params, Hinv
            )
            res_c = jnp.maximum(pr_c, du_c)
            res_c = jnp.where(jnp.isfinite(res_c), res_c, jnp.inf)
            merged, pr_b, du_b, res_b, pol = _accept_better(
                merged, pr_b, du_b, res_b, pol, cand, pr_c, du_c, res_c,
                data=data_sg,
            )
        improved = jnp.any(res_b < i.kkt_residual)
        return s + 1, merged, QPInfo(pr_b, du_b, res_b, pol), improved

    # runs under stop_gradient with a value-only merge (_ad_passthrough);
    # a stage that improves nothing stops the re-fire (fixable floor)
    _, best_r, info_r, _ = jax.lax.while_loop(
        lambda ops: (ops[0] < params.rescue_stages)
        & jnp.any(ops[2].kkt_residual > params.rescue_threshold)
        & ops[3],
        do_rescue,
        (jnp.zeros((), jnp.int32), _sg(best), _sg(info), jnp.asarray(True)),
    )
    return _ad_passthrough((best, info), (best_r, info_r))


@_full_precision
def solve_batched(
    data: QPData,
    warm: QPState,
    params: QPSolverParams = QPSolverParams(),
    backend: str = "xla",
    cache: "QPCache | None" = None,
    use_warm=None,
    hinv_fn=None,
    prepared=None,
    prepared_layout: str = "major",
    prepared_tiles=None,
):
    """Batched solve over a leading batch axis on every leaf.

    backend="xla":    vmap of the single-sample solve.
    backend="cached": the cached batched chain — batch-minor Ruiz prepare
      (ops/prepare.py), K^{-1} by Newton-Schulz, the ADMM loop
      (ops/admm.py) and the active-set polish (ops/polish.py).

    cache / use_warm (cached backend): carried QPCache of last cycle's
    inverses and a batch-level scalar gate.  When use_warm is True the
    Newton-Schulz inverses restart from the cache with few iterations
    (per-element safeguard falls back to a cold start); pass False on the
    first cycle and whenever any scenario's contact set switched.  Returns
    (state, info, new_cache) when a cache is provided.

    hinv_fn (cached backend): optional callable (H (B, n, n), reg) ->
    COMPACT block-diagonal inverse (diag (B, n), blk (B, k, k), start) of
    the regularized polish Hessian — callers that know the problem's block
    structure (the WBC QP's H is block-diagonal, SURVEY §3.5) supply an
    exact closed form, skip the carried-NS update entirely, and the dense
    (B, n, n) regularized H / H⁻¹ are never materialized (the polish
    stage applies them in compact form).

    prepared (cached backend): optional (sH, sA, sg, sl, su, rho, wxs, wzs,
    wys, d, e) tuple from a caller that already ran the prepare stage —
    e.g. the fused setup (ops/setup_fused.setup_batched with qp_params)
    — skipping the standalone prepare stage.  Note the
    warm scaling in `prepared` must already include any switch masking;
    `warm` is still used for the unscaled cold-start detection.

    prepared_layout="minor": every `prepared` leaf is batch-minor
    (dims..., B) — setup_batched(prepared_layout="minor") — and the whole
    scaled solve chain (K build, warm-NS K^-1, ADMM inputs) stays
    batch-minor: no padded batch-major (B, 42, 42) HBM round trips, no
    boundary transposes (params.solve_layout documents the rationale).
    The cache's kinv/sinv must then be batch-minor too (make_cache).
    The unscaled problem (`data`) and the rescue stay batch-major (the
    rescue's transposes trace inside its fire branch only); the polish
    keeps its carried Schur inverse batch-minor end to end.

    prepared_tiles (cached backend): optional dict of ALREADY batch-minor
    unscaled A/g/l/u — the setup stage's batch-minor outputs
    (setup_batched "tiles_minor") — fed to polish_tiles so the polish's
    invariant inputs skip their transposes."""
    if backend == "xla":
        # the single-sample rescue cond would lower to a both-branches
        # select under vmap — disable it and rescue at batch level instead
        import dataclasses

        p_inner = (
            dataclasses.replace(params, rescue_threshold=0.0)
            if params.rescue_threshold > 0
            else params
        )
        st, inf = jax.vmap(lambda d, w: solve(d, w, p_inner))(data, warm)
        if params.comp_final_refine > 0 and params.polish:
            # always-on compensated final refinement (same order as the
            # cached path: before the rescue).  No carried inverses here —
            # _polish_comp re-derives them (the xla backend is the
            # reference/test path; cost is not the concern).
            Hinv_c = (
                hinv_fn(data.H, params.polish_reg)
                if hinv_fn is not None else None
            )
            pre_cf = (st, inf.primal_residual, inf.dual_residual,
                      inf.kkt_residual, inf.polished)
            data_sg = _sg(data)
            cand, pr_c, du_c = _polish_comp(
                data_sg, _sg(st), params, _sg(Hinv_c),
                passes=params.comp_final_refine,
            )
            res_c = jnp.maximum(pr_c, du_c)
            res_c = jnp.where(jnp.isfinite(res_c), res_c, jnp.inf)
            # sign-augmented acceptance (see the cached-path hook)
            sv_c = _sign_violation(data_sg, cand.x, cand.y)
            sv_b = _sign_violation(data_sg, _sg(st.x), _sg(st.y))
            ok_cf = (
                jnp.maximum(res_c, sv_c)
                <= jnp.maximum(_sg(inf.kkt_residual), sv_b)
            )
            oke_cf = ok_cf[:, None]
            st_sg, pr_sg, du_sg, res_sg, pol_sg = _sg(pre_cf)
            post_cf = (
                QPState(
                    x=jnp.where(oke_cf, cand.x, st_sg.x),
                    z=jnp.where(oke_cf, cand.z, st_sg.z),
                    y=jnp.where(oke_cf, cand.y, st_sg.y),
                ),
                jnp.where(ok_cf, pr_c, pr_sg),
                jnp.where(ok_cf, du_c, du_sg),
                jnp.where(ok_cf, res_c, res_sg),
                pol_sg | ok_cf,
            )
            st_m, pr_m, du_m, res_m, pol_m = _ad_passthrough(pre_cf, post_cf)
            st, inf = st_m, QPInfo(pr_m, du_m, res_m, pol_m)
        if params.rescue_threshold > 0:
            st, inf = _rescue_batched(data, st, inf, params, backend, hinv_fn)
        if cache is not None:
            return st, inf, cache  # xla path keeps no factorizations
        return st, inf
    if backend != "cached":
        raise ValueError(backend)

    n = data.H.shape[-1]
    dtype = data.H.dtype

    from quadrupedwholebodycontroller.ops.linalg import ns_inverse

    # Ruiz + scaling (ops/prepare.py, or already fused into the setup)
    if prepared is not None:
        sH, sA, sg, sl, su, rho, wxs, wzs, wys, dscale, escale = prepared
    else:
        sH, sA, sg, sl, su, rho, wxs, wzs, wys, dscale, escale = (
            prepare.prepare_scaled(
                data.H, data.A, data.g, data.l, data.u,
                warm.x, warm.z, warm.y,
                sweeps=params.scaling_iters, rho0=params.rho,
                rho_eq_scale=params.rho_eq_scale,
            )
        )
    minor = prepared is not None and prepared_layout == "minor"
    # normalize the carried kinv into THIS solve's chain layout (and store
    # the fresh inverse back in the CACHE's layout — scan carries need a
    # stable structure).  A mismatch arises in mixed/diagnostic
    # configurations only (e.g. setup_backend="xla" + a make_cache built
    # for the default minor layout: no `prepared`, so the chain runs
    # batch-major); the production path is consistent and pays nothing.
    # B == n is ambiguous and treated as batch-major (the original
    # convention) — don't use the minor layout at B == 42.
    cache_kinv_minor = (
        cache is not None
        and cache.kinv.shape[0] == n
        and cache.kinv.shape[0] != cache.kinv.shape[-1]
        and cache.kinv.shape[-1] == data.H.shape[0]
    )
    kinv_chain_in = cache.kinv if cache is not None else None
    if cache is not None and cache_kinv_minor != minor:
        kinv_chain_in = (
            jnp.transpose(cache.kinv, (2, 0, 1))
            if cache_kinv_minor
            else jnp.transpose(cache.kinv, (1, 2, 0))
        )
    with jax.named_scope("kchain"):
        if minor:
            # batch-minor K build: (n, n, B) pads only sublanes 42 -> 48 where
            # (B, n, n) pads 42 lanes to 128 (~3x the HBM bytes per pass)
            from quadrupedwholebodycontroller.ops.linalg import _bm_eye

            _tr_min = lambda a: jnp.transpose(
                a, (a.ndim - 1,) + tuple(range(a.ndim - 1))
            )
            K = (
                sH
                + params.sigma * _bm_eye(n, dtype)
                + jnp.einsum("mnB,mB,mkB->nkB", sA, rho, sA)
            )
            # vectors the batch-major tail (unscale, cold-start gate) needs
            dscale_mj, escale_mj = _tr_min(dscale), _tr_min(escale)
            warm_s = QPState(x=_tr_min(wxs), z=_tr_min(wzs), y=_tr_min(wys))
            sdata = None  # the rescue branch rebuilds batch-major lazily
        else:
            sdata = QPData(H=sH, g=sg, A=sA, l=sl, u=su)
            warm_s = QPState(x=wxs, z=wzs, y=wys)
            dscale_mj, escale_mj = dscale, escale
            K = (
                sH
                + params.sigma * jnp.eye(n, dtype=dtype)
                + jnp.einsum("bmn,bm,bmk->bnk", sA, rho, sA)
            )

        wi_polish = (
            params.ns_warm_iters_polish
            if params.ns_warm_iters_polish >= 0
            else params.ns_warm_iters
        )

        # ---- per-scenario warm-cache gating ----
        # use_warm may be a scalar (batch-level gate, the pre-round-3 behavior)
        # or a (B,) bool mask.  With a mask, warm updates run for the whole
        # batch and the (few) cold scenarios — contact switches — are
        # re-inverted on a compacted top-k sub-batch (gather -> cold NS ->
        # scatter), so ONE scenario's switch no longer cold-starts the whole
        # batch (qpOASES hotstart is per-problem, reference cpp:529-533).
        # More cold scenarios than cold_batch falls back to the full-batch
        # cold inverse (the old switch-step cost, but never worse).
        warm_mask = n_cold = cold_idx = None
        kcold = params.cold_batch
        if (
            cache is not None
            and use_warm is not None
            and getattr(use_warm, "ndim", 0) >= 1
        ):
            if 0 < kcold < use_warm.shape[0]:
                warm_mask = use_warm
                n_cold = jnp.sum(~warm_mask)
                cold_idx = jax.lax.top_k(
                    (~warm_mask).astype(jnp.float32), kcold
                )[1]
                use_warm = None  # the scalar-gate paths below are bypassed
            else:
                use_warm = jnp.all(use_warm)

        @jax.named_scope("cold_fix")
        def _compact_cold_fix(X, M_or_thunk, keep_warm):
            """Overwrite the cold scenarios' rows of X with fresh cold NS
            inverses computed on the gathered top-k sub-batch."""
            Mc = (
                M_or_thunk(cold_idx)
                if callable(M_or_thunk)
                else jnp.take(M_or_thunk, cold_idx, axis=0)
            )
            Xc = ns_inverse(Mc, params.ns_iters, body_prec=params.ns_cold_prec or None, tail=params.ns_cold_tail)
            if keep_warm:
                # top_k returns exactly kcold indices: when fewer scenarios
                # are cold the extras are warm ones — keep their rows
                sel = jnp.take(warm_mask, cold_idx)
                Xc = jnp.where(sel[:, None, None],
                               jnp.take(X, cold_idx, axis=0), Xc)
            return X.at[cold_idx].set(Xc)

        def make_inv(warm_arr, wi=None):
            """NS inverse gated on use_warm (scalar) or warm_mask (per-scenario)."""
            wi = params.ns_warm_iters if wi is None else wi
            if cache is None or (use_warm is None and warm_mask is None):
                return lambda M: ns_inverse(M, params.ns_iters)

            from quadrupedwholebodycontroller.ops.linalg import (
                ns_inverse_warm_shared,
            )

            def warm_update(M):
                # shared-matmul warm update: bitwise ns_inverse for
                # accepted warms, un-iterated X0 on the rare rejection
                return (
                    ns_inverse_warm_shared(M, warm_arr, wi)
                    if wi >= 1
                    else ns_inverse(
                        M, params.ns_iters, warm=warm_arr, warm_iters=wi,
                    )
                )

            if warm_mask is not None:
                def inv(M):
                    def full_cold(_):
                        return ns_inverse(M, params.ns_iters)

                    if params.cond_hoist == 1:
                        # see sinv_fn: only the (k, n, n) cold sub-block rides
                        # the fix cond; the full warm-updated inverse is
                        # scattered into outside it (bitwise-identical values)
                        def mixed(_):
                            X = warm_update(M)
                            keep = jnp.take(X, cold_idx, axis=0)

                            def fix(_):
                                Mc = (
                                    M(cold_idx) if callable(M)
                                    else jnp.take(M, cold_idx, axis=0)
                                )
                                Xc = ns_inverse(
                                    Mc, params.ns_iters, body_prec=params.ns_cold_prec or None, tail=params.ns_cold_tail,
                                )
                                sel = jnp.take(warm_mask, cold_idx)
                                return jnp.where(sel[:, None, None], keep, Xc)

                            Xc = jax.lax.cond(
                                n_cold > 0, fix, lambda _: keep, None
                            )
                            return X.at[cold_idx].set(Xc)
                    else:
                        def mixed(_):
                            return jax.lax.cond(
                                n_cold > 0,
                                lambda X: _compact_cold_fix(X, M, keep_warm=True),
                                lambda X: X,
                                warm_update(M),
                            )

                    return jax.lax.cond(n_cold > kcold, full_cold, mixed, None)

                return inv

            def inv(M):
                return jax.lax.cond(
                    use_warm,
                    lambda: warm_update(M),
                    lambda: ns_inverse(M, params.ns_iters),
                )

            return inv

        def make_inv_k_bm(warm_arr):
            """make_inv for the batch-minor (n, n, B) K chain: same gating
            (scalar / per-scenario compacted cold fix), bm NS kernels."""
            from quadrupedwholebodycontroller.ops.linalg import (
                _cold_init_bm,
                ns_inverse_bm,
                ns_inverse_warm_shared_bm,
            )

            wi = params.ns_warm_iters
            if cache is None or (use_warm is None and warm_mask is None):
                return lambda M: ns_inverse_bm(M, params.ns_iters)

            def warm_update(M):
                if wi >= 1:
                    return ns_inverse_warm_shared_bm(M, warm_arr, wi)
                # wi == 0: safeguarded pass-through of the carried inverse
                from quadrupedwholebodycontroller.ops.linalg import (
                    _bm_eye,
                    _bm_mm,
                )

                E = _bm_eye(M.shape[0], M.dtype) - _bm_mm(M, warm_arr)
                err = jnp.max(jnp.sum(jnp.abs(E), axis=1), axis=0)
                ok = (jnp.isfinite(err) & (err < 1e3))[None, None, :]
                return jnp.where(ok, warm_arr, _cold_init_bm(M))

            @jax.named_scope("cold_fix")
            def _compact_cold_fix_bm(X, M, keep_warm):
                Mc = jnp.take(M, cold_idx, axis=-1)
                Xc = ns_inverse_bm(Mc, params.ns_iters, body_prec=params.ns_cold_prec or None, tail=params.ns_cold_tail)
                if keep_warm:
                    sel = jnp.take(warm_mask, cold_idx)
                    Xc = jnp.where(sel[None, None, :],
                                   jnp.take(X, cold_idx, axis=-1), Xc)
                return X.at[..., cold_idx].set(Xc)

            if warm_mask is not None:
                def inv(M):
                    def full_cold(_):
                        return ns_inverse_bm(M, params.ns_iters)

                    if params.cond_hoist == 1:
                        # see sinv_fn: only the (n, n, k) cold sub-block rides
                        # the fix cond; the full warm-updated inverse is
                        # scattered into outside it (bitwise-identical values)
                        def mixed(_):
                            X = warm_update(M)
                            keep = jnp.take(X, cold_idx, axis=-1)

                            def fix(_):
                                Mc = jnp.take(M, cold_idx, axis=-1)
                                Xc = ns_inverse_bm(
                                    Mc, params.ns_iters, body_prec=params.ns_cold_prec or None, tail=params.ns_cold_tail,
                                )
                                sel = jnp.take(warm_mask, cold_idx)
                                return jnp.where(sel[None, None, :], keep, Xc)

                            Xc = jax.lax.cond(
                                n_cold > 0, fix, lambda _: keep, None
                            )
                            return X.at[..., cold_idx].set(Xc)
                    else:
                        def mixed(_):
                            return jax.lax.cond(
                                n_cold > 0,
                                lambda X: _compact_cold_fix_bm(
                                    X, M, keep_warm=True
                                ),
                                lambda X: X,
                                warm_update(M),
                            )

                    return jax.lax.cond(n_cold > kcold, full_cold, mixed, None)

                return inv

            def inv(M):
                return jax.lax.cond(
                    use_warm,
                    lambda: warm_update(M),
                    lambda: ns_inverse_bm(M, params.ns_iters),
                )

            return inv

        Kinv = (
            make_inv_k_bm(kinv_chain_in)(K)
            if minor
            else make_inv(kinv_chain_in)(K)
    )

    with jax.named_scope("admm"):
        if params.sigma == 0.0:
            # constraint-space iteration (ops/admm.zy_loop): with sigma = 0
            # the (z, y) recursion closes over A K^{-1} A^T, applied as chained
            # matvecs on (A, Kinv) — no P matrix is ever built
            def run_admm(x0, z0, y0, iters, Ki=None):
                return admm_ops.admm_zy_iterations_res(
                    Kinv if Ki is None else Ki,
                    sA, sg, sl, su, rho,
                    x0, z0, y0, sH, data.l, data.u, dscale, escale,
                    iters=iters, alpha=params.alpha,
                    layout="minor" if minor else "major",
                )
        else:
            def run_admm(x0, z0, y0, iters, Ki=None):
                # iterations + the candidate's unscaled relative KKT residuals
                # (ops/admm.admm_iterations_res)
                return admm_ops.admm_iterations_res(
                    Kinv if Ki is None else Ki,
                    sA, sg, sl, su, rho, x0, z0, y0,
                    sH, data.l, data.u, dscale, escale,
                    iters=iters, sigma=params.sigma, alpha=params.alpha,
                    layout="minor" if minor else "major",
                )

        x, z, y, pr_b, du_b, sv_b = run_admm(
            warm_s.x, warm_s.z, warm_s.y, params.iterations
        )
        # cold start (any scenario with an all-zero warm state): spend the init
        # budget batch-wide — the qpOASES init/hotstart asymmetry (cpp:523-533)
        extra = max(0, params.cold_iterations - params.iterations)
        if extra:
            per_cold = ~(
                jnp.any(warm.x != 0, axis=-1)
                | jnp.any(warm.z != 0, axis=-1)
                | jnp.any(warm.y != 0, axis=-1)
            )
            x, z, y, pr_b, du_b, sv_b = jax.lax.cond(
                jnp.any(per_cold),
                lambda st: run_admm(st[0], st[1], st[2], extra),
                lambda st: (st[0], st[1], st[2], pr_b, du_b, sv_b),
                (x, z, y),
            )
        admm = QPState(x=dscale_mj * x, z=z / escale_mj, y=escale_mj * y)

    with jax.named_scope("polish"):
        # polish at batch level so the cached inverses stay batched
        n_ = data.H.shape[-1]
        eye_n = jnp.eye(n_, dtype=dtype)
        H_reg = None
        H_polish = None  # what polish_tiles gets: dense H_reg or compact
        if params.polish:
            if hinv_fn is not None:
                # closed-form caller-supplied inverse, COMPACT block-diagonal
                # form (diag, blk, start): the dense (B, n, n) regularized H
                # and its inverse are never materialized
                Hinv_polish = hinv_fn(data.H, params.polish_reg)
                hd, hblk, hstart = Hinv_polish
                k_ = hblk.shape[-1]
                diag_reg = (
                    jnp.diagonal(data.H, axis1=-2, axis2=-1) + params.polish_reg
                )
                diag_reg = jnp.concatenate(
                    [diag_reg[:, :hstart],
                     jnp.zeros_like(diag_reg[:, :k_]),
                     diag_reg[:, hstart + k_:]], axis=1,
                )
                blk_reg = (
                    data.H[:, hstart:hstart + k_, hstart:hstart + k_]
                    + params.polish_reg * jnp.eye(k_, dtype=dtype)
                )
                H_polish = (diag_reg, blk_reg, hstart)
            else:
                H_reg = data.H + params.polish_reg * eye_n
                Hinv_polish = make_inv(
                    cache.hinv if cache is not None else None, wi=wi_polish
                )(H_reg)
                H_polish = H_reg
        else:
            Hinv_polish = None
        # ---- polish Schur-inverse chain layout ----
        # In the batch-minor solve chain the carried Sinv — the LARGEST tensor
        # the polish shuttles, (B, 70, 70) — stays batch-minor (m, m, B) end
        # to end: the pass-through warm path feeds the cache straight into the
        # polish kernel's native tile layout (polish_solve sinv_layout) with
        # NO boundary transpose; only the rare cold branches compute a
        # batch-major NS inverse and transpose it once.  Cache layout is
        # normalized like kinv above (mixed/diagnostic configs only).
        m_c = data.A.shape[-2]
        s_minor = minor and cache is not None and params.polish
        cache_sinv_minor = (
            cache is not None
            and cache.sinv.shape[0] == m_c
            and cache.sinv.shape[0] != cache.sinv.shape[-1]
            and cache.sinv.shape[-1] == data.H.shape[0]
        )
        sinv_chain_in = cache.sinv if cache is not None else None
        if cache is not None and cache_sinv_minor != s_minor:
            sinv_chain_in = (
                jnp.transpose(cache.sinv, (2, 0, 1))
                if cache_sinv_minor
                else jnp.transpose(cache.sinv, (1, 2, 0))
            )

        def _to_s_chain(X_major):
            return jnp.transpose(X_major, (1, 2, 0)) if s_minor else X_major

        @jax.named_scope("cold_fix")
        def _compact_cold_fix_s(X, S_thunk):
            """_compact_cold_fix for the polish Schur inverse, in the chain's
            layout: the (k, m, m) cold sub-batch NS inverse is computed
            batch-major either way and scattered into X's layout."""
            Xc = ns_inverse(S_thunk(cold_idx), params.ns_iters, body_prec=params.ns_cold_prec or None, tail=params.ns_cold_tail)
            sel = jnp.take(warm_mask, cold_idx)
            if s_minor:
                Xc = jnp.transpose(Xc, (1, 2, 0))
                Xc = jnp.where(sel[None, None, :],
                               jnp.take(X, cold_idx, axis=-1), Xc)
                return X.at[..., cold_idx].set(Xc)
            Xc = jnp.where(sel[:, None, None], jnp.take(X, cold_idx, axis=0), Xc)
            return X.at[cold_idx].set(Xc)

        # sinv_fn takes a THUNK that builds the polish Schur matrix, so the
        # warm fast path below never materializes it
        if not params.polish:
            sinv_fn = None
        elif wi_polish == 0 and cache is not None and warm_mask is not None:
            # per-scenario version of the pass-through fast path: warm
            # scenarios keep the carried inverse untouched (stale-but-finite
            # caught by the polish acceptance residuals); the cold scenarios'
            # Schur matrices are assembled COMPACTLY (S_thunk(idx)) and
            # re-inverted on the top-k sub-batch only
            def sinv_fn(S_thunk):
                def full_cold(_):
                    return _to_s_chain(ns_inverse(S_thunk(), params.ns_iters))

                if params.cond_hoist == 1:
                    # route only the gathered (k, m, m) cold sub-block through
                    # the fix cond and scatter OUTSIDE it: the carried
                    # (m, m, B) inverse never becomes a cond output, so the
                    # no-cold-scenario branch costs a (k, m, m) gather, not a
                    # potential full-tensor HBM copy.  Bitwise-identical to
                    # _compact_cold_fix_s on both paths (the identity path
                    # scatters the rows' own values back).
                    def mixed(_):
                        keep = (
                            jnp.take(sinv_chain_in, cold_idx, axis=-1)
                            if s_minor
                            else jnp.take(sinv_chain_in, cold_idx, axis=0)
                        )

                        def fix(_):
                            Xc = ns_inverse(
                                S_thunk(cold_idx), params.ns_iters, body_prec=params.ns_cold_prec or None, tail=params.ns_cold_tail,
                            )
                            sel = jnp.take(warm_mask, cold_idx)
                            if s_minor:
                                Xc = jnp.transpose(Xc, (1, 2, 0))
                                return jnp.where(sel[None, None, :], keep, Xc)
                            return jnp.where(sel[:, None, None], keep, Xc)

                        Xc = jax.lax.cond(n_cold > 0, fix, lambda _: keep, None)
                        if s_minor:
                            return sinv_chain_in.at[..., cold_idx].set(Xc)
                        return sinv_chain_in.at[cold_idx].set(Xc)
                else:
                    def mixed(_):
                        return jax.lax.cond(
                            n_cold > 0,
                            lambda X: _compact_cold_fix_s(X, S_thunk),
                            lambda X: X,
                            sinv_chain_in,
                        )

                return jax.lax.cond(n_cold > kcold, full_cold, mixed, None)
        elif wi_polish == 0 and cache is not None and use_warm is not None:
            # 0 warm NS iterations make the warm branch a pass-through of the
            # carried inverse; a stale-but-finite cache is caught downstream by
            # the polish ACCEPTANCE residuals (res_p <= res_b), so the
            # ||I - S W|| check matmul AND the Schur assembly (G2 matmuls +
            # masking) are skipped entirely on warm steps — they trace into the
            # cold cond branch only
            def sinv_fn(S_thunk):
                return jax.lax.cond(
                    use_warm,
                    lambda: sinv_chain_in,
                    lambda: _to_s_chain(ns_inverse(S_thunk(), params.ns_iters)),
                )
        else:
            _mk_sinv = make_inv(
                (
                    jnp.transpose(sinv_chain_in, (2, 0, 1))
                    if s_minor and sinv_chain_in is not None
                    else sinv_chain_in
                ),
                wi=wi_polish,
            )

            def sinv_fn(S_thunk):
                return _to_s_chain(_mk_sinv(S_thunk()))

        def residuals(d, s):
            pr, du = kkt_residual(d, s.x, s.y)
            tot = jnp.maximum(pr, du)
            return pr, du, jnp.where(jnp.isfinite(tot), tot, jnp.inf)

        # polish-round invariants, computed once per solve: the Schur matmuls
        # A Hinv Aᵀ (the da mask applies elementwise per round — bitwise equal,
        # see _polish_batched_kernel) and the batch-minor kernel input tiles.
        # On the wi_polish == 0 fast path G2 stays None: the Schur assembly is
        # only traced inside sinv_fn's cold cond branch.
        G2_pol = tiles_pol = None
        if cache is not None and params.polish:
            if not (
                wi_polish == 0
                and (use_warm is not None or warm_mask is not None)
            ):
                G2_pol = (
                    data.A @ _blockdiag_dense(Hinv_polish)
                    @ jnp.swapaxes(data.A, -1, -2)
                    if isinstance(Hinv_polish, tuple)
                    else data.A @ Hinv_polish @ jnp.swapaxes(data.A, -1, -2)
                )
            tiles_pol = polish_tiles(
                H_polish, Hinv_polish, data.A, data.g, data.l, data.u,
                pre_tiled=prepared_tiles,
            )

        best = admm
        # pr_b/du_b came from the kernel epilogue (same formula as residuals())
        res_b = jnp.maximum(pr_b, du_b)
        res_b = jnp.where(jnp.isfinite(res_b), res_b, jnp.inf)
        polished = jnp.zeros_like(res_b, dtype=bool)
        # sign-augmented acceptance (see _accept_better): sv_b arrives from
        # the ADMM kernel's epilogue (computed on the resident tiles — the
        # XLA _sign_violation call re-reads H and A from HBM); the ADMM
        # iterate's multipliers are complementary by projection, so it starts
        # ~0, and a polish candidate that solved a WRONG active set carries a
        # large violation and cannot displace it
        sinv_last = sinv_chain_in
        # active-set DROP rule across polish rounds (see _rescue_core): the
        # working iterate `w_pol` follows the candidate chain even through
        # rejections, and rows whose candidate multiplier came out
        # wrong-signed are banned from the next round's estimate.  A stale
        # warm-start dual (a row active in an earlier gait phase) otherwise
        # activates a row well off its bound and the polish pins it there —
        # round 2 with the ban solves the corrected set, and typical steps
        # (unchanged estimate) still skip round 2 via the `changed` cond.
        eq_rows = (data.u - data.l) <= 1e-9
        tol_drop = jnp.maximum(
            1e-6,
            256.0 * float(jnp.finfo(dtype).eps)
            * jnp.maximum(1.0, jnp.max(jnp.abs(data.g), axis=-1)),
        )[:, None]
        banned = jnp.zeros_like(eq_rows)
        w_pol = best
        ok_prev = wrong_any_prev = None  # round-1 outcomes, set at loop bottom
    for round_i in range(params.polish_rounds if params.polish else 0):
        with jax.named_scope("polish" if round_i == 0 else "drop_round"):
            if cache is not None:
                # compacted drop rounds (round 2+ with drop_batch > 0)
                # assemble the active-set estimate on the gathered sub-batch
                # INSIDE the fire cond — the full-batch assembly is an HBM
                # pass over A (~94 MB at B=8192) paid per step otherwise
                # (cond operands are computed eagerly; XLA does not sink
                # them into the branch)
                compact2 = (
                    round_i > 0
                    and 0 < params.drop_batch < data.g.shape[0]
                )
                if not compact2:
                    da, b = _assemble_active(data, w_pol, dtype)
                    da = da * (1.0 - banned.astype(dtype))
                    b = jnp.where(banned, 0.0, b)
                if round_i == 0:
                    pol, sinv_last, pr_p, du_p, sv_p = _polish_batched_kernel(
                        data, best, params, H_polish, Hinv_polish, sinv_fn,
                        da_b=(da, b), G2=G2_pol, tiles=tiles_pol,
                        sinv_layout="minor" if s_minor else "major",
                    )
                else:
                    # chain: round k warms from round k-1's inverse of THIS
                    # step's Schur matrix — a strictly fresher start than the
                    # cross-step cache, valid even on cold (use_warm=False)
                    # steps since it never crosses a contact switch
                    sinv_prev = sinv_last

                    if wi_polish == 0:
                        # this branch only traces inside the `changed` cond —
                        # the active set genuinely differs from round 1's
                        # (a drop fired or the re-estimate moved), so the
                        # carried inverse is an inverse of the WRONG Schur
                        # matrix: a pass-through preconditioner left the
                        # corrected-set solve unconverged and the drop round
                        # useless (round-4 torque-parity debugging).  Pay the
                        # cold inverse; unchanged steps never reach here.
                        def sinv_fn(S_thunk, w=sinv_prev):
                            return _to_s_chain(
                                ns_inverse(S_thunk(), params.ns_iters)
                            )
                    else:
                        def sinv_fn(S_thunk, w=sinv_prev):
                            wmaj = (
                                jnp.transpose(w, (2, 0, 1)) if s_minor else w
                            )
                            return _to_s_chain(ns_inverse(
                                S_thunk(), params.ns_iters,
                                warm=wmaj, warm_iters=wi_polish,
                            ))

                    # round 2+ runs only for the scenarios the PREVIOUS round
                    # failed: a drop fired (wrong-signed candidate multiplier
                    # — the mis-classified-set signature) or the candidate was
                    # rejected outright (e.g. a missed active row shows up as
                    # a large primal residual).  Cleanly-accepted sign-
                    # consistent candidates are KKT points of their claimed
                    # set and gain nothing from re-estimation — and an
                    # estimate-CHANGED trigger fired for >25% of the extreme
                    # sweep per step (the candidate-based re-estimate shifts
                    # routinely), costing 26% of sweep throughput in
                    # full-batch cold inverses.  With drop_batch > 0 the
                    # round is additionally COMPACTED per-scenario (gather /
                    # cold-invert / scatter the failed scenarios only).
                    changed_i = wrong_any_prev | ~ok_prev
                    if params.drop_fire_tol > 0:
                        # round-5 fire bar: only scenarios whose CURRENT best
                        # sign-augmented residual still threatens the torque
                        # bar enter the drop round.  A rejected candidate (or
                        # a wrong-signed row in a rejected candidate) with
                        # max(res_b, sv_b) already tiny means the solution in
                        # use is a certified KKT point of a consistent set —
                        # the round-4 "any failure" bar fired the compacted
                        # cold Schur inverse on essentially every step at
                        # B=8192 for scenarios the re-solve could not improve
                        changed_i = changed_i & (
                            jnp.maximum(res_b, sv_b) > params.drop_fire_tol
                        )
                    n_ch = jnp.sum(changed_i)
                    inf_r = jnp.full_like(pr_b, jnp.inf)

                    def full_round():
                        return _polish_batched_kernel(
                            data, best, params, H_polish, Hinv_polish, sinv_fn,
                            da_b=(da, b), G2=G2_pol, tiles=tiles_pol,
                            sinv_layout="minor" if s_minor else "major",
                        )

                    def skip_round():
                        return best, sinv_prev, inf_r, inf_r, inf_r

                    k2 = params.drop_batch
                    if 0 < k2 < changed_i.shape[0]:
                        def compact_round():
                            # rank the failed scenarios by severity and take
                            # the k2 worst — NO full-batch fallback: on the
                            # extreme sweep >25% of scenarios fail round 1
                            # every step (stiff-contact transients), and the
                            # full-batch cold inverse cost 26% of throughput.
                            # Scenarios beyond the cap keep round-1 results;
                            # the staged rescue remains the guarantee.
                            score = jnp.where(
                                changed_i, jnp.maximum(res_b, sv_b), -jnp.inf
                            )
                            if params.drop_approx_rank:
                                # partial-reduction ranking (approximate;
                                # ~0.95 recall of the exact worst-k) — the
                                # cap is a heuristic, the staged rescue the
                                # guarantee
                                idx2 = jax.lax.approx_max_k(score, k2)[1]
                            else:
                                idx2 = jax.lax.top_k(score, k2)[1]
                            take2 = lambda a: jnp.take(a, idx2, axis=0)
                            take_c = lambda t: (
                                (take2(t[0]), take2(t[1]), t[2])
                                if isinstance(t, tuple) else take2(t)
                            )
                            data_c = QPData(*(take2(leaf) for leaf in data))
                            w_c = QPState(
                                x=take2(w_pol.x), z=take2(w_pol.z),
                                y=take2(w_pol.y),
                            )
                            # active-set estimate on the gathered rows only
                            # (assembly commutes with the gather bitwise —
                            # it is per-scenario elementwise)
                            banned_c = take2(banned)
                            da_c, b_c = _assemble_active(data_c, w_c, dtype)
                            da_c = da_c * (1.0 - banned_c.astype(dtype))
                            b_c = jnp.where(banned_c, 0.0, b_c)
                            if params.drop_warm_iters > 0:
                                # warm the compacted inverse from the carried
                                # round-1 rows: a drop changes the active set
                                # by a few rows — a low-rank Schur update well
                                # inside warm-NS range (ns_inverse's
                                # ||I - S W|| guard falls back to the Jacobi
                                # cold start on a genuinely changed matrix).
                                # The round-4 comment's "wrong Schur matrix"
                                # argument bans only the wi=0 PASS-THROUGH
                                # (which skipped the re-solve entirely), not
                                # a guarded warm restart; the acceptance
                                # residuals + sign violation still certify
                                # the candidate either way.
                                warm_c = (
                                    jnp.transpose(
                                        jnp.take(sinv_prev, idx2, axis=-1),
                                        (2, 0, 1),
                                    )
                                    if s_minor
                                    else jnp.take(sinv_prev, idx2, axis=0)
                                )

                                def sinv_fn_c(S_thunk, w=warm_c):
                                    return ns_inverse(
                                        S_thunk(), params.ns_iters,
                                        warm=w,
                                        warm_iters=params.drop_warm_iters,
                                    )
                            else:
                                def sinv_fn_c(S_thunk):
                                    return ns_inverse(
                                        S_thunk(),
                                        params.drop_ns_iters
                                        or params.ns_iters,
                                        body_prec=params.ns_cold_prec or None,
                                        tail=params.ns_cold_tail,
                                    )
                            pol_c, sinv_c, pr_c, du_c, sv_c = (
                                _polish_batched_kernel(
                                    data_c, w_c, params,
                                    take_c(H_polish), take_c(Hinv_polish),
                                    sinv_fn_c,
                                    da_b=(da_c, b_c),
                                )
                            )
                            # top_k pads with unchanged rows when fewer than
                            # k2 scenarios changed — mask their candidates out
                            sel = take2(changed_i)
                            pr_c = jnp.where(sel, pr_c, jnp.inf)
                            du_c = jnp.where(sel, du_c, jnp.inf)
                            sv_c = jnp.where(sel, sv_c, jnp.inf)
                            pol_full = QPState(
                                x=best.x.at[idx2].set(pol_c.x),
                                z=best.z.at[idx2].set(pol_c.z),
                                y=best.y.at[idx2].set(pol_c.y),
                            )
                            # refresh the carried Schur inverse for the
                            # re-solved scenarios (chain layout preserved).
                            # drop_sinv_refresh=0 skips it: in the minor
                            # layout this is a lane-axis gather + scatter
                            # over the whole (m, m, B) carried tensor —
                            # ~2 HBM passes over 160 MB at B=8192 on every
                            # fired step — while the carried round-1 rows
                            # are warm-gated and acceptance-guarded anyway
                            if not params.drop_sinv_refresh:
                                sinv_new = sinv_prev
                            elif s_minor:
                                sinv_new = sinv_prev.at[..., idx2].set(
                                    jnp.where(
                                        sel[None, None, :],
                                        jnp.transpose(sinv_c, (1, 2, 0)),
                                        jnp.take(sinv_prev, idx2, axis=-1),
                                    )
                                )
                            else:
                                sinv_new = sinv_prev.at[idx2].set(
                                    jnp.where(
                                        sel[:, None, None], sinv_c,
                                        jnp.take(sinv_prev, idx2, axis=0),
                                    )
                                )
                            # wrong-signed candidate multipliers (next
                            # round's drops) on the sub-batch, scattered:
                            # scenarios not re-solved produced no new
                            # candidate this round, so they mark nothing
                            eqr_c = take2(eq_rows)
                            tol_c = take2(tol_drop)
                            side_up_c = (b_c == data_c.u) & ~eqr_c
                            wrong_c = sel[:, None] & (da_c > 0.5) & ~eqr_c \
                                & jnp.where(
                                    side_up_c,
                                    pol_c.y < -tol_c, pol_c.y > tol_c,
                                )
                            banned_new = banned.at[idx2].set(
                                banned_c | wrong_c
                            )
                            wrong_any_new = jnp.zeros(
                                banned.shape[0], bool
                            ).at[idx2].set(jnp.any(wrong_c, axis=-1))
                            out = (pol_full,
                                   inf_r.at[idx2].set(pr_c),
                                   inf_r.at[idx2].set(du_c),
                                   inf_r.at[idx2].set(sv_c),
                                   banned_new, wrong_any_new)
                            # cond_hoist: with the refresh off, sinv_new IS
                            # sinv_prev in both branches — keep the (m, m, B)
                            # carried inverse out of the cond's outputs so the
                            # skip branch never implies an HBM copy of it
                            if hoist_sinv:
                                return out
                            return out[:1] + (sinv_new,) + out[1:]

                        def skip_round_c():
                            out = (best, inf_r, inf_r, inf_r, banned,
                                   jnp.zeros(banned.shape[0], bool))
                            if hoist_sinv:
                                return out
                            return out[:1] + (sinv_prev,) + out[1:]

                        hoist_sinv = (
                            params.cond_hoist in (1, 2)
                            and not params.drop_sinv_refresh
                        )
                        outs = jax.lax.cond(
                            n_ch > 0, compact_round, skip_round_c
                        )
                        if hoist_sinv:
                            (pol, pr_p, du_p, sv_p, banned,
                             wrong_any_prev) = outs
                            sinv_last = sinv_prev
                        else:
                            (pol, sinv_last, pr_p, du_p, sv_p, banned,
                             wrong_any_prev) = outs
                    else:
                        pol, sinv_last, pr_p, du_p, sv_p = jax.lax.cond(
                            n_ch > 0, full_round, skip_round
                        )
                if not compact2:
                    # wrong-signed candidate multipliers mark next round's
                    # drops (the compacted branch computes these on the
                    # gathered sub-batch inside the cond)
                    side_up = (b == data.u) & ~eq_rows
                    wrong = (da > 0.5) & ~eq_rows & jnp.where(
                        side_up, pol.y < -tol_drop, pol.y > tol_drop
                    )
                    banned = banned | wrong
                    wrong_any_prev = jnp.any(wrong, axis=-1)
                w_pol = pol
                res_p = jnp.maximum(pr_p, du_p)
                res_p = jnp.where(jnp.isfinite(res_p), res_p, jnp.inf)
            else:
                Hinv_dense = (
                    _blockdiag_dense(Hinv_polish)
                    if isinstance(Hinv_polish, tuple) else Hinv_polish
                )
                pol = jax.vmap(lambda d, s, hv: _polish(d, s, params, hv))(
                    data, best, Hinv_dense
                )
                pr_p, du_p, res_p = jax.vmap(residuals)(data, pol)
                sv_p = _sign_violation(data, pol.x, pol.y)
            ok = jnp.maximum(res_p, sv_p) <= jnp.maximum(res_b, sv_b)
            oke = ok[:, None]
            best = QPState(
                x=jnp.where(oke, pol.x, best.x),
                z=jnp.where(oke, pol.z, best.z),
                y=jnp.where(oke, pol.y, best.y),
            )
            pr_b = jnp.where(ok, pr_p, pr_b)
            du_b = jnp.where(ok, du_p, du_b)
            res_b = jnp.where(ok, res_p, res_b)
            sv_b = jnp.where(ok, sv_p, sv_b)
            polished = polished | ok
            ok_prev = ok
    if (
        params.comp_final_refine > 0
        and params.polish
        and Hinv_polish is not None
        and sinv_last is not None
    ):
        # always-on compensated final refinement (the torque-parity lever —
        # see _comp_refine_final).  Runs BEFORE the rescue so tightened
        # scenarios drop below rescue_threshold and the rescue fires less.
        # Value-only merge (_ad_passthrough): gradients keep flowing
        # through the smooth ADMM+polish path (the EFT arithmetic is exact
        # in value but its branchy splitting is hostile to AD).
        pre_cf = (best, pr_b, du_b, res_b, polished)
        sinv_mj = (
            jnp.transpose(sinv_last, (2, 0, 1)) if s_minor else sinv_last
        )
        data_sg = _sg(data)
        cand_cf, pr_cf, du_cf = _comp_refine_final(
            data_sg, _sg(best), params, _sg(Hinv_polish), _sg(sinv_mj)
        )
        res_cf = jnp.maximum(pr_cf, du_cf)
        res_cf = jnp.where(jnp.isfinite(res_cf), res_cf, jnp.inf)
        # acceptance compares the SIGN-AUGMENTED residuals: an active-set
        # refinement can converge to the saddle of a wrong active set
        # (zero primal/dual residual, wrong-signed y) which max(pr, du)
        # cannot reject — _sign_violation can.  The reported kkt_residual
        # stays max(pr, du) (the OSQP convention).
        sv_c = _sign_violation(data_sg, cand_cf.x, cand_cf.y)
        sv_b = _sign_violation(data_sg, _sg(best.x), _sg(best.y))
        ok_cf = jnp.maximum(res_cf, sv_c) <= jnp.maximum(_sg(res_b), sv_b)
        oke_cf = ok_cf[:, None]
        best_sg, pr_sg, du_sg, resb_sg, pol_sg = _sg(pre_cf)
        post_cf = (
            QPState(
                x=jnp.where(oke_cf, cand_cf.x, best_sg.x),
                z=jnp.where(oke_cf, cand_cf.z, best_sg.z),
                y=jnp.where(oke_cf, cand_cf.y, best_sg.y),
            ),
            jnp.where(ok_cf, pr_cf, pr_sg),
            jnp.where(ok_cf, du_cf, du_sg),
            jnp.where(ok_cf, res_cf, resb_sg),
            pol_sg | ok_cf,
        )
        best, pr_b, du_b, res_b, polished = _ad_passthrough(pre_cf, post_cf)
    with jax.named_scope("rescue"):
        if params.rescue_threshold > 0:
            # in-scope tail rescue (the cached-path form of _rescue_batched):
            # the flagged problem is ALREADY scaled, so the rescue skips the
            # prepare stage entirely, recomputes ONLY a cold K^-1, continues
            # the ADMM recursion from the best iterate, and re-polishes with a
            # cold Schur inverse (the generic nested re-solve cost ~2x a full
            # step).  Fires via a batch-level lax.cond.  With rescue_batch > 0
            # the whole rescue runs on a COMPACTED sub-batch of the top-k worst
            # scenarios (gather -> rescue -> scatter), so the fire cost is O(k)
            # instead of O(B) — only the k worst can be flagged anyway when k
            # exceeds the flagged count.
            def _rescue_core(best, pr_b, du_b, res_b, polished,
                             K_, sA_, sg_, sl_, su_, rho_, sH_, lo_, uo_,
                             d_, e_, data_, H_pol, Hinv_pol,
                             G2=None, tiles=None):
                # COLD K^-1: a flagged scenario is often flagged precisely
                # because the carried warm K^-1 went stale (tune_sweep exposed
                # this: reusing the warm inverse left the extreme tail at
                # 1.7e-2 where the cold one reaches ~3e-3)
                # NOTE: the rescue chains stay at FULL precision (no
                # ns_cold_prec body): the rescue is the tail GUARANTEE, and
                # the diverse bench at a "high"-body rescue left one scenario
                # flagged at 3.10e-3 (> the 3e-3 threshold) where the
                # full-precision rescue holds flagged_max 0 (PERF.md r5b)
                Kinv_cold = ns_inverse(K_, params.ns_iters)
                if params.sigma == 0.0:
                    x, z, y, pr_c, du_c, sv_c = admm_ops.admm_zy_iterations_res(
                        Kinv_cold, sA_, sg_, sl_, su_, rho_,
                        best.x / d_, best.z * e_, best.y / e_,
                        sH_, lo_, uo_, d_, e_,
                        iters=params.rescue_iterations, alpha=params.alpha,
                    )
                else:
                    x, z, y, pr_c, du_c, sv_c = admm_ops.admm_iterations_res(
                        Kinv_cold, sA_, sg_, sl_, su_, rho_,
                        best.x / d_, best.z * e_, best.y / e_,
                        sH_, lo_, uo_, d_, e_,
                        iters=params.rescue_iterations, sigma=params.sigma,
                        alpha=params.alpha,
                    )
                cand = QPState(x=d_ * x, z=z / e_, y=e_ * y)
                res_c = jnp.maximum(pr_c, du_c)
                res_c = jnp.where(jnp.isfinite(res_c), res_c, jnp.inf)
                best, pr_b, du_b, res_b, polished = _accept_better(
                    best, pr_b, du_b, res_b, polished,
                    cand, pr_c, du_c, res_c, cand_polished=jnp.zeros_like(
                        polished), data=data_, sv_cand=sv_c,
                )
                if params.polish:
                    def sinv_cold(S_thunk):
                        return ns_inverse(S_thunk(), params.ns_iters)

                    # iterated polish WITH THE ACTIVE-SET DROP RULE: a stale
                    # warm-start dual can activate a row that sits well off its
                    # bound (observed: |y| = 14 carried from a previous cycle's
                    # genuinely-active phase, row 0.1 inside the bound) and the
                    # polish then pins it there — a wrong-set saddle whose
                    # wrong-signed multipliers the sign-augmented acceptance
                    # rejects but cannot FIX.  Classic active-set resolution:
                    # rows whose CANDIDATE multiplier comes out wrong-signed
                    # (regardless of acceptance) are banned from the next
                    # round's estimate, so round k+1 solves the corrected set
                    # with its own cold Schur inverse (already budgeted here).
                    dtype_ = data_.H.dtype
                    eqr = (data_.u - data_.l) <= 1e-9
                    tol_dr = jnp.maximum(
                        1e-6,
                        256.0 * float(jnp.finfo(dtype_).eps)
                        * jnp.maximum(1.0, jnp.max(jnp.abs(data_.g), axis=-1)),
                    )[:, None]
                    banned = jnp.zeros_like(eqr)
                    # the working iterate `w` follows the CANDIDATE chain even
                    # through rejections (classical active-set pivoting walks
                    # candidate to candidate; `best` only collects certified
                    # improvements).  Round k re-estimates from w, minus the
                    # accumulated bans.
                    w = best
                    nB = res_b.shape[0]
                    k3 = params.rescue_round2_batch
                    for r_i in range(params.rescue_polish_rounds):
                        if r_i == 0 or not (0 < k3 < nB):
                            da_r, b_r = _assemble_active(data_, w, dtype_)
                            da_r = da_r * (1.0 - banned.astype(dtype_))
                            b_r = jnp.where(banned, 0.0, b_r)
                            pol, _, pr_p, du_p, sv_pp = _polish_batched_kernel(
                                data_, w, params, H_pol, Hinv_pol,
                                sinv_cold, da_b=(da_r, b_r), G2=G2, tiles=tiles,
                            )
                            # wrong-signed candidate multipliers mark the
                            # drops: forced at the upper bound needs
                            # y >= -tol, at the lower bound y <= tol
                            # (equality rows are sign-free)
                            side_up = (b_r == data_.u) & ~eqr
                            wrong = (da_r > 0.5) & ~eqr & jnp.where(
                                side_up, pol.y < -tol_dr, pol.y > tol_dr
                            )
                            banned = banned | wrong
                            w = pol
                            res_p = jnp.maximum(pr_p, du_p)
                            res_p = jnp.where(
                                jnp.isfinite(res_p), res_p, jnp.inf
                            )
                            best, pr_b, du_b, res_b, polished = _accept_better(
                                best, pr_b, du_b, res_b, polished,
                                pol, pr_p, du_p, res_p, data=data_,
                                sv_cand=sv_pp,
                            )
                            continue
                        # COMPACTED round 2+: the
                        # second cold-Schur polish round is what buys the
                        # sub-1.3e-3 sweep tail, but only the scenarios STILL
                        # above rescue_threshold after round 1 need it — run
                        # it on the top-k3 worst of those (gather ->
                        # cold-Schur polish -> scatter, the drop_batch
                        # pattern) instead of the whole rescue sub-batch.
                        flag_now = jnp.maximum(
                            res_b, _sign_violation(data_, best.x, best.y)
                        )
                        still = flag_now > params.rescue_threshold
                        n_still = jnp.sum(still)

                        def round_compact(ops):
                            best, pr_b, du_b, res_b, polished, w, banned = ops
                            score = jnp.where(still, flag_now, -jnp.inf)
                            idx3 = jax.lax.top_k(score, k3)[1]
                            tk = lambda a: jnp.take(a, idx3, axis=0)
                            tk_pol = lambda t: (
                                None if t is None
                                else ((tk(t[0]), tk(t[1]), t[2])
                                      if isinstance(t, tuple) else tk(t))
                            )
                            data_s = QPData(*(tk(leaf) for leaf in data_))
                            w_s = QPState(x=tk(w.x), z=tk(w.z), y=tk(w.y))
                            banned_s = tk(banned)
                            eqr_s, tol_s = tk(eqr), tk(tol_dr)
                            da_r, b_r = _assemble_active(data_s, w_s, dtype_)
                            da_r = da_r * (1.0 - banned_s.astype(dtype_))
                            b_r = jnp.where(banned_s, 0.0, b_r)
                            # G2/tiles are full-batch invariants — the compact
                            # polish re-derives lazily from the gathered rows
                            pol_s, _, pr_s, du_s, sv_s = _polish_batched_kernel(
                                data_s, w_s, params, tk_pol(H_pol),
                                tk_pol(Hinv_pol), sinv_cold,
                                da_b=(da_r, b_r),
                            )
                            # top_k pads with below-threshold rows when fewer
                            # than k3 are still flagged — mask their
                            # candidates out
                            sel = tk(still)
                            pr_s = jnp.where(sel, pr_s, jnp.inf)
                            du_s = jnp.where(sel, du_s, jnp.inf)
                            sv_s = jnp.where(sel, sv_s, jnp.inf)
                            side_up = (b_r == data_s.u) & ~eqr_s
                            wrong_s = sel[:, None] & (da_r > 0.5) & ~eqr_s \
                                & jnp.where(
                                    side_up, pol_s.y < -tol_s, pol_s.y > tol_s
                                )
                            res_s = jnp.maximum(pr_s, du_s)
                            res_s = jnp.where(
                                jnp.isfinite(res_s), res_s, jnp.inf
                            )
                            best_s, prb_s, dub_s, resb_s, pols_s = (
                                _accept_better(
                                    QPState(x=tk(best.x), z=tk(best.z),
                                            y=tk(best.y)),
                                    tk(pr_b), tk(du_b), tk(res_b),
                                    tk(polished),
                                    pol_s, pr_s, du_s, res_s, data=data_s,
                                    sv_cand=sv_s,
                                )
                            )
                            selc = sel[:, None]
                            w2 = QPState(
                                x=w.x.at[idx3].set(
                                    jnp.where(selc, pol_s.x, w_s.x)),
                                z=w.z.at[idx3].set(
                                    jnp.where(selc, pol_s.z, w_s.z)),
                                y=w.y.at[idx3].set(
                                    jnp.where(selc, pol_s.y, w_s.y)),
                            )
                            return (
                                QPState(
                                    x=best.x.at[idx3].set(best_s.x),
                                    z=best.z.at[idx3].set(best_s.z),
                                    y=best.y.at[idx3].set(best_s.y),
                                ),
                                pr_b.at[idx3].set(prb_s),
                                du_b.at[idx3].set(dub_s),
                                res_b.at[idx3].set(resb_s),
                                polished.at[idx3].set(pols_s),
                                w2,
                                banned.at[idx3].set(banned_s | wrong_s),
                            )

                        ops = (best, pr_b, du_b, res_b, polished, w, banned)
                        best, pr_b, du_b, res_b, polished, w, banned = (
                            jax.lax.cond(
                                n_still > 0, round_compact, lambda o: o, ops
                            )
                        )
                    if params.rescue_comp_refine > 0:
                        # compensated (double-f32) refinement candidate: the
                        # precision lever once the plain-f32 polish plateaus
                        cand, pr_c, du_c = _polish_comp(
                            data_, best, params, Hinv_pol
                        )
                        res_c = jnp.maximum(pr_c, du_c)
                        res_c = jnp.where(jnp.isfinite(res_c), res_c, jnp.inf)
                        best, pr_b, du_b, res_b, polished = _accept_better(
                            best, pr_b, du_b, res_b, polished,
                            cand, pr_c, du_c, res_c, data=data_,
                        )
                return best, pr_b, du_b, res_b, polished

            kres = params.rescue_batch
            compact_rescue = 0 < kres < res_b.shape[0]
            # the rescue runs under stop_gradient (see _ad_passthrough): sg'd
            # copies of every closed-over array keep the while_loop free of
            # differentiable inputs so reverse AD never has to transpose it
            if minor:
                # batch-minor solve chain: sg the minor arrays; the batch-major
                # views the (batch-major) rescue needs are built INSIDE the
                # fire path, so their transposes cost nothing on clean steps
                K_mn, sH_mn, sA_mn, sg_mn, sl_mn, su_mn, rho_mn, d_mn, e_mn = (
                    _sg((K, sH, sA, sg, sl, su, rho, dscale, escale))
                )
                data_g = _sg(data)
            else:
                K_g, sdata_g, rho_g, data_g, d_g, e_g = _sg(
                    (K, sdata, rho, data, dscale, escale)
                )
            Hp_g, Hip_g, G2_g, tiles_g = _sg(
                (H_polish, Hinv_polish, G2_pol, tiles_pol)
            )

            _back_minor = lambda a: jnp.transpose(
                a, (a.ndim - 1,) + tuple(range(a.ndim - 1))
            )

            def _rescue(args):
                best, pr_b, du_b, res_b, polished, flag = args
                if not compact_rescue:
                    if minor:
                        Kr = _back_minor(K_mn)
                        sdatar = QPData(H=_back_minor(sH_mn), g=_back_minor(sg_mn),
                                        A=_back_minor(sA_mn), l=_back_minor(sl_mn),
                                        u=_back_minor(su_mn))
                        rhor, dr, er = (_back_minor(rho_mn), _back_minor(d_mn),
                                        _back_minor(e_mn))
                    else:
                        Kr, sdatar, rhor, dr, er = (K_g, sdata_g, rho_g, d_g,
                                                    e_g)
                    best, pr_b, du_b, res_b, polished = _rescue_core(
                        best, pr_b, du_b, res_b, polished,
                        Kr, sdatar.A, sdatar.g, sdatar.l, sdatar.u, rhor,
                        sdatar.H, data_g.l, data_g.u, dr, er,
                        data_g, Hp_g, Hip_g,
                        G2=G2_g, tiles=tiles_g,
                    )
                    flag = jnp.maximum(
                        res_b, _sign_violation(data_g, best.x, best.y)
                    )
                    return best, pr_b, du_b, res_b, polished, flag
                _, idx = jax.lax.top_k(flag, kres)

                def take(a):
                    return jnp.take(a, idx, axis=0)

                if minor:
                    # gather the k worst on the LANE axis first, then transpose
                    # only the (k, ...) sub-batch to batch-major for the rescue
                    def take_s(a):
                        return _back_minor(jnp.take(a, idx, axis=-1))
                else:
                    take_s = None

                def take_pol(t):
                    if t is None:
                        return None
                    if isinstance(t, tuple):  # compact (diag, blk, start)
                        return (take(t[0]), take(t[1]), t[2])
                    return take(t)

                best_c = QPState(x=take(best.x), z=take(best.z), y=take(best.y))
                data_c = QPData(H=take(data_g.H), g=take(data_g.g),
                                A=take(data_g.A), l=take(data_g.l),
                                u=take(data_g.u))
                if minor:
                    scaled_c = (take_s(K_mn), take_s(sA_mn), take_s(sg_mn),
                                take_s(sl_mn), take_s(su_mn), take_s(rho_mn),
                                take_s(sH_mn), take_s(d_mn), take_s(e_mn))
                else:
                    scaled_c = (take(K_g), take(sdata_g.A), take(sdata_g.g),
                                take(sdata_g.l), take(sdata_g.u), take(rho_g),
                                take(sdata_g.H), take(d_g), take(e_g))
                (K_c, sA_c, sg_c, sl_c, su_c, rho_c, sH_c, d_c, e_c) = scaled_c
                # G2/tiles are full-batch invariants — the compact polish
                # re-derives them from the gathered data (cheap at k rows)
                best_c, pr_c, du_c, res_c, pol_c = _rescue_core(
                    best_c, take(pr_b), take(du_b), take(res_b), take(polished),
                    K_c, sA_c, sg_c, sl_c, su_c, rho_c, sH_c,
                    take(data_g.l), take(data_g.u), d_c, e_c,
                    data_c, take_pol(Hp_g), take_pol(Hip_g),
                )
                best = QPState(
                    x=best.x.at[idx].set(best_c.x),
                    z=best.z.at[idx].set(best_c.z),
                    y=best.y.at[idx].set(best_c.y),
                )
                flag_c = jnp.maximum(
                    res_c, _sign_violation(data_c, best_c.x, best_c.y)
                )
                return (best, pr_b.at[idx].set(pr_c), du_b.at[idx].set(du_c),
                        res_b.at[idx].set(res_c), polished.at[idx].set(pol_c),
                        flag.at[idx].set(flag_c))

            # staged rescue (lax.while_loop — one trace): re-fires until no
            # scenario exceeds the threshold or rescue_stages passes ran.  Each
            # stage continues the ADMM recursion from the improved iterate and
            # re-estimates the active set from a closer point, so scenarios a
            # single pass leaves marginally above threshold converge on the
            # next.
            def _rescue_staged(ops):
                s, args, _ = ops
                out = _rescue(args)
                # a stage that improves NO scenario's flag has hit this step's
                # fixable floor (e.g. genuinely hard transients whose sign
                # violation no re-solve clears) — re-firing the remaining
                # stages would burn 2x the rescue cost for bitwise-identical
                # results, EVERY step, as long as such a scenario exists in
                # the batch
                improved = jnp.any(out[5] < args[5])
                return s + 1, out, improved

            # the fire flag is SIGN-AUGMENTED: max(res, sign_violation) — a
            # scenario whose certificate looks converged but whose multipliers
            # are wrong-signed (a mis-classified active set, see
            # _sign_violation) is exactly a scenario the drop-rule rescue can
            # fix, so it must be flagged even when res alone is under
            # threshold
            pre = (best, pr_b, du_b, res_b, polished,
                   jnp.maximum(res_b, sv_b))
            _, post, _ = jax.lax.while_loop(
                lambda ops: (ops[0] < params.rescue_stages)
                & jnp.any(ops[1][5] > params.rescue_threshold)
                & ops[2],
                _rescue_staged,
                (jnp.zeros((), jnp.int32), _sg(pre), jnp.asarray(True)),
            )
            best, pr_b, du_b, res_b, polished, _ = _ad_passthrough(pre, post)
    info = QPInfo(pr_b, du_b, res_b, polished)
    if cache is not None:
        kinv_store = Kinv
        if cache_kinv_minor != minor:
            # back to the CACHE's layout (stable carry structure)
            kinv_store = (
                jnp.transpose(Kinv, (1, 2, 0))
                if cache_kinv_minor
                else jnp.transpose(Kinv, (2, 0, 1))
            )
        new_cache = QPCache(
            kinv=kinv_store,
            # the compact closed-form inverse is recomputed per step and
            # never read back from the cache — carry the slot through
            hinv=(
                cache.hinv
                if Hinv_polish is None or isinstance(Hinv_polish, tuple)
                else Hinv_polish
            ),
            sinv=(
                cache.sinv if sinv_last is None else (
                    sinv_last if cache_sinv_minor == s_minor else (
                        jnp.transpose(sinv_last, (1, 2, 0))
                        if cache_sinv_minor
                        else jnp.transpose(sinv_last, (2, 0, 1))
                    )
                )
            ),
        )
        return best, info, new_cache
    return best, info


def _assemble_active(data, state, dtype):
    """Active-set estimate + active-bound vector (vmapped elementwise)."""

    def assemble(d, s):
        ax = d.A @ s.x
        eq = (d.u - d.l) <= 1e-9
        tol_p, tol_d = _active_tols(d, ax)
        low = _bound_finite(d.l) & ((ax - d.l <= tol_p) | (s.y < -tol_d))
        upp = _bound_finite(d.u) & ((d.u - ax <= tol_p) | (s.y > tol_d))
        nz = jnp.sum(jnp.abs(d.A), axis=1) > 1e-12
        active = (eq | low | upp) & nz
        b = jnp.where(upp & ~low, d.u, d.l)
        b = jnp.where(eq, d.u, b)
        b = jnp.where(active, b, 0.0)
        return active.astype(dtype), b

    return jax.vmap(assemble)(data, state)


def _polish_batched(data, state, params, Hinv, sinv_fn):
    """Batch-level polish: vmapped active-set assembly around the (already

    batched) Schur solve, so the cached S inverse threads through."""
    n = data.H.shape[-1]
    dtype = data.H.dtype
    da, b = _assemble_active(data, state, dtype)
    from quadrupedwholebodycontroller.ops.linalg import solve_kkt_schur

    x, y, sinv = solve_kkt_schur(
        data.H + params.polish_reg * jnp.eye(n, dtype=dtype),
        da[:, :, None] * data.A,
        da,
        data.g,
        b,
        reg=params.polish_reg,
        iters=params.ns_iters,
        refine=params.polish_refine,
        Hinv=Hinv,
        sinv_fn=sinv_fn,
        return_sinv=True,
    )
    ax = jnp.einsum("bij,bj->bi", data.A, x)
    pol = QPState(x=x, z=jnp.clip(ax, data.l, data.u), y=y)
    return pol, sinv


def _polish_batched_kernel(data, state, params, H_reg, Hinv, sinv_fn,
                           da_b=None, G2=None, tiles=None,
                           sinv_layout="major"):
    """Batched polish: the active-set assembly, the Schur matmuls and the
    Newton-Schulz inverse, then the whole solve + refinement + residual
    cascade on batch-minor arrays (ops/polish.py).  Returns (pol, sinv,
    pr, du, sv) — sv is the cascade's sign/complementarity violation
    (acceptance side-
    channel; an XLA _sign_violation call re-reads H and A from HBM).

    sinv_fn receives a THUNK that assembles the polish Schur matrix, so
    pass-through/warm implementations can skip the assembly entirely.

    da_b: optional pre-computed (da, b) from _assemble_active.
    G2: optional pre-computed A @ Hinv @ Aᵀ — round-invariant, and since
    da is a 0/1 mask, Bm @ Hinv @ Bmᵀ == (da ⊗ da) * G2 BITWISE (masking
    commutes out of the contraction exactly), so the two Schur matmuls
    run once per solve instead of once per polish round.  None = assemble
    lazily inside the thunk (the wi_polish == 0 fast path, where the
    thunk only traces into the cold cond branch).
    tiles: optional round-invariant batch-minor inputs
    (ops/polish.polish_tiles)."""
    dtype = data.H.dtype
    m = data.A.shape[-2]
    da, b = _assemble_active(data, state, dtype) if da_b is None else da_b

    def S_thunk(idx=None):
        # idx: optional (k,) scenario indices — assemble the Schur matrix
        # for that compacted sub-batch only (the per-scenario warm gate's
        # cold fix), never materializing the full (B, m, m) S
        if idx is None:
            da_, A_, Hinv_, G2v = da, data.A, Hinv, G2
        else:
            take = lambda a: jnp.take(a, idx, axis=0)
            da_, A_ = take(da), take(data.A)
            Hinv_ = (
                (take(Hinv[0]), take(Hinv[1]), Hinv[2])
                if isinstance(Hinv, tuple) else take(Hinv)
            )
            G2v = take(G2) if G2 is not None else None
        diag_S = params.polish_reg * da_ + (1.0 - da_)
        if G2v is None:
            Hinv_d = (
                _blockdiag_dense(Hinv_) if isinstance(Hinv_, tuple) else Hinv_
            )
            G2v = A_ @ Hinv_d @ jnp.swapaxes(A_, -1, -2)
        return da_[:, :, None] * da_[:, None, :] * G2v + jnp.einsum(
            "bi,ij->bij", diag_S, jnp.eye(m, dtype=dtype)
        )

    sinv = sinv_fn(S_thunk)
    x, y, z, pr, du, sv = polish_solve(
        H_reg, Hinv, sinv, data.A, da, data.g, b, data.l, data.u,
        refine=params.polish_refine, reg=params.polish_reg, tiles=tiles,
        sinv_layout=sinv_layout,
    )
    return QPState(x=x, z=z, y=y), sinv, pr, du, sv

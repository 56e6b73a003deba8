import jax
import jax.numpy as jnp
import numpy as np
import pytest

from quadrupedwholebodycontroller.config import QPSolverParams
from quadrupedwholebodycontroller.ops import qp


def random_qp(rng, n=8, m=12, n_eq=2, dtype=jnp.float64):
    L = rng.normal(size=(n, n))
    H = L @ L.T + n * np.eye(n)
    g = rng.normal(size=n)
    A = rng.normal(size=(m, n))
    x_feas = rng.normal(size=n) * 0.3
    ax = A @ x_feas
    l = ax - rng.uniform(0.1, 1.0, size=m)
    u = ax + rng.uniform(0.1, 1.0, size=m)
    # first n_eq rows become equalities
    l[:n_eq] = ax[:n_eq]
    u[:n_eq] = ax[:n_eq]
    arr = lambda x: jnp.asarray(x, dtype)
    return qp.QPData(H=arr(H), g=arr(g), A=arr(A), l=arr(l), u=arr(u))


def scipy_solution(data):
    """Independent oracle: scipy SLSQP on the same QP."""
    from scipy.optimize import minimize

    H = np.asarray(data.H); g = np.asarray(data.g)
    A = np.asarray(data.A); l = np.asarray(data.l); u = np.asarray(data.u)
    eq = (u - l) <= 1e-9
    cons = []
    if eq.any():
        cons.append(dict(type="eq", fun=lambda x: A[eq] @ x - u[eq], jac=lambda x: A[eq]))
    ineq = ~eq
    cons.append(dict(type="ineq", fun=lambda x: u[ineq] - A[ineq] @ x, jac=lambda x: -A[ineq]))
    cons.append(dict(type="ineq", fun=lambda x: A[ineq] @ x - l[ineq], jac=lambda x: A[ineq]))
    res = minimize(
        lambda x: 0.5 * x @ H @ x + g @ x,
        np.zeros(len(g)),
        jac=lambda x: H @ x + g,
        constraints=cons,
        method="SLSQP",
        options=dict(maxiter=500, ftol=1e-12),
    )
    assert res.success, res.message
    return res.x


def test_unconstrained():
    H = jnp.eye(4, dtype=jnp.float64) * 2.0
    g = jnp.arange(4, dtype=jnp.float64)
    A = jnp.zeros((1, 4), dtype=jnp.float64)
    data = qp.QPData(H=H, g=g, A=A, l=jnp.array([-1e20]), u=jnp.array([1e20]))
    state, info = qp.solve(data, qp.QPState.zeros(4, 1, jnp.float64),
                           QPSolverParams(iterations=100))
    assert np.allclose(np.asarray(state.x), -np.arange(4) / 2.0, atol=1e-8)
    assert float(info.kkt_residual) < 1e-8


def test_equality_constrained_closed_form(rng):
    n, me = 6, 3
    L = rng.normal(size=(n, n))
    H = L @ L.T + n * np.eye(n)
    g = rng.normal(size=n)
    A = rng.normal(size=(me, n))
    b = rng.normal(size=me)
    kkt = np.block([[H, A.T], [A, np.zeros((me, me))]])
    sol = np.linalg.solve(kkt, np.concatenate([-g, b]))
    data = qp.QPData(
        H=jnp.asarray(H), g=jnp.asarray(g), A=jnp.asarray(A),
        l=jnp.asarray(b), u=jnp.asarray(b),
    )
    state, info = qp.solve(data, qp.QPState.zeros(n, me, jnp.float64),
                           QPSolverParams(iterations=200))
    assert np.allclose(np.asarray(state.x), sol[:n], atol=1e-7)
    assert float(info.kkt_residual) < 1e-7


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_random_qp_kkt_and_scipy(seed):
    rng = np.random.default_rng(seed)
    data = random_qp(rng)
    state, info = qp.solve(data, qp.QPState.zeros(8, 12, jnp.float64),
                           QPSolverParams(iterations=200))
    assert float(info.kkt_residual) < 1e-6, float(info.kkt_residual)
    x_ref = scipy_solution(data)
    obj = lambda x: 0.5 * x @ np.asarray(data.H) @ x + np.asarray(data.g) @ x
    assert obj(np.asarray(state.x)) <= obj(x_ref) + 1e-6
    assert np.allclose(np.asarray(state.x), x_ref, atol=1e-4)


def test_warm_start_improves(rng):
    """A warm start from a nearby problem's solution must reach a better KKT

    residual than a cold start at few iterations (hotstart analogue)."""
    data = random_qp(rng, n=12, m=20, n_eq=4)
    params = QPSolverParams(iterations=300)
    state, _ = qp.solve(data, qp.QPState.zeros(12, 20, jnp.float64), params)

    # perturb the problem slightly (the 400 Hz next-cycle situation)
    data2 = qp.QPData(
        H=data.H, g=data.g + 0.01, A=data.A, l=data.l + 0.005, u=data.u + 0.005
    )
    # pin cold_iterations too: the point is warm-vs-cold at EQUAL budget
    # (by default a cold start gets the qpOASES-style init boost, and a
    # bad residual would trigger the tail rescue)
    few = QPSolverParams(
        iterations=15, cold_iterations=15, polish=False, rescue_threshold=0.0
    )
    warm, info_w = qp.solve(data2, state, few)
    cold, info_c = qp.solve(data2, qp.QPState.zeros(12, 20, jnp.float64), few)
    assert float(info_w.kkt_residual) < float(info_c.kkt_residual)


def test_batched_solve(rng):
    datas = [random_qp(np.random.default_rng(s), n=8, m=12) for s in range(5)]
    batch = jax.tree.map(lambda *xs: jnp.stack(xs), *datas)
    warm = jax.tree.map(
        lambda x: jnp.stack([x] * 5), qp.QPState.zeros(8, 12, jnp.float64)
    )
    params = QPSolverParams(iterations=200)
    states, infos = qp.solve_batched(batch, warm, params)
    for i in range(5):
        single, _ = qp.solve(datas[i], qp.QPState.zeros(8, 12, jnp.float64), params)
        assert np.allclose(np.asarray(states.x[i]), np.asarray(single.x), atol=1e-8)
    assert np.all(np.asarray(infos.kkt_residual) < 1e-6)


def test_infeasible_flagged(rng):
    """Contradictory constraints: the per-problem status must expose a large

    primal residual (no global abort — SURVEY.md §5 failure-detection note)."""
    n = 4
    H = jnp.eye(n, dtype=jnp.float64)
    g = jnp.zeros(n, dtype=jnp.float64)
    A = jnp.asarray(np.array([[1.0, 0, 0, 0], [1.0, 0, 0, 0]]))
    l = jnp.asarray(np.array([1.0, -2.0]))
    u = jnp.asarray(np.array([2.0, -1.0]))  # x0>=1 and x0<=-1: infeasible
    data = qp.QPData(H=H, g=g, A=A, l=l, u=u)
    _, info = qp.solve(data, qp.QPState.zeros(n, 2, jnp.float64),
                       QPSolverParams(iterations=100))
    assert float(info.primal_residual) > 0.1


def test_rescue_recovers_tail(rng):
    """The f32-tail rescue (the batched qpOASES-setToReliable analogue,
    reference cpp:519): an under-budgeted solve whose residual exceeds
    rescue_threshold must be recovered by the guarded re-solve, per
    scenario, in both single-sample and batched paths."""
    datas = [random_qp(np.random.default_rng(s), n=10, m=16) for s in range(6)]
    data = jax.tree.map(lambda *xs: jnp.stack(xs), *datas)
    warm = jax.vmap(lambda _: qp.QPState.zeros(10, 16, jnp.float64))(jnp.arange(6))
    # starve the main solve so its tail is bad, then let the rescue run
    starved = QPSolverParams(
        iterations=3, cold_iterations=3, polish=False, rescue_threshold=0.0
    )
    st0, info0 = qp.solve_batched(data, warm, starved)
    assert float(jnp.max(info0.kkt_residual)) > 1e-3  # genuinely bad tail

    rescued = QPSolverParams(
        iterations=3, cold_iterations=3, polish=False,
        rescue_threshold=1e-3, rescue_iterations=150,
    )
    st1, info1 = qp.solve_batched(data, warm, rescued)
    assert float(jnp.max(info1.kkt_residual)) <= float(jnp.max(info0.kkt_residual))
    assert float(jnp.max(info1.kkt_residual)) < 1e-3
    # acceptance is monotone per scenario
    assert bool(jnp.all(info1.kkt_residual <= info0.kkt_residual + 1e-12))

    # single-sample path: same guarded re-solve semantics
    st2, info2 = qp.solve(datas[0], qp.QPState.zeros(10, 16, jnp.float64), rescued)
    assert float(info2.kkt_residual) < 1e-3

    # below-threshold batches must take the no-op branch (identical result)
    good = QPSolverParams(rescue_threshold=1e-3)
    no_rescue = QPSolverParams(rescue_threshold=0.0)
    sa, ia = qp.solve_batched(data, warm, good)
    sb, ib = qp.solve_batched(data, warm, no_rescue)
    assert float(jnp.max(ib.kkt_residual)) < 1e-3  # default budget is enough
    np.testing.assert_allclose(np.asarray(sa.x), np.asarray(sb.x), rtol=0, atol=0)


def test_stale_dual_drop_rule(rng):
    """A stale warm-start dual (|y| far above noise on a row the optimum
    leaves inactive — the carry of an earlier phase where it WAS active)
    must not survive to the solution: the polish drop rule (round 2 bans
    wrong-signed candidate multipliers) plus the sign-augmented acceptance
    recover the true active set.  This is the f32 torque-parity mechanism
    (0.25 N.m errors at "converged" certificates came exactly from such
    pinned rows, tools/debug_compfinal.py)."""
    dtype = jnp.float32
    data64_raw = random_qp(rng, n=8, m=12, n_eq=2, dtype=jnp.float64)
    # scale the data up to WBC-like magnitudes so absolute-tol
    # classification would be hopeless.  Scaling H and g by the SAME
    # constant preserves the minimizer, so the scipy truth is computed on
    # the well-conditioned raw problem.
    scale = 1e3
    data64 = qp.QPData(H=data64_raw.H * scale, g=data64_raw.g * scale,
                       A=data64_raw.A, l=data64_raw.l, u=data64_raw.u)
    data = jax.tree.map(lambda a: a.astype(dtype), data64)

    # f64 truth from the scipy oracle (NOT the jax solver: this box's XLA
    # CPU compiler silently degrades under accumulated in-process compile
    # state — the same pathology as the documented conftest crashes — and
    # full-suite-order-dependent runs left the f64 jax solve plateaued at
    # ~2.5e-6 relative where standalone runs reach 1e-9; scipy is immune)
    x_star = scipy_solution(data64_raw)
    st64_x = jnp.asarray(x_star)
    # recover the duals from a jax solve started AT the scipy optimum
    # (only used for picking an inactive row below; quality non-critical)
    st64, _ = qp.solve(
        data64,
        qp.QPState(x=st64_x,
                   z=jnp.clip(data64.A @ st64_x, data64.l, data64.u),
                   y=jnp.zeros((12,), jnp.float64)),
        QPSolverParams(iterations=200, rescue_threshold=0.0),
    )
    st64 = st64._replace(x=st64_x)

    # find a genuinely inactive, finite-bounded row and poison its dual
    y64 = np.asarray(st64.y)
    ax64 = np.asarray(data64.A) @ np.asarray(st64.x)
    inactive = [
        i for i in range(12)
        if abs(y64[i]) < 1e-10
        and ax64[i] - float(data64.l[i]) > 0.05
        and float(data64.u[i]) - ax64[i] > 0.05
    ]
    assert inactive, "fixture must have an inactive row"
    row = inactive[0]
    warm = qp.QPState(
        x=jnp.asarray(st64.x, dtype),
        z=jnp.asarray(np.clip(ax64, data64.l, data64.u), dtype),
        y=jnp.zeros((12,), dtype).at[row].set(50.0 * scale / 100.0),
    )
    st, info = qp.solve(data, warm, QPSolverParams(rescue_threshold=0.0))
    # the solution must match the f64 truth (the stale dual dropped), not
    # a wrong-set saddle
    assert float(info.kkt_residual) < 1e-5
    x_err = float(jnp.max(jnp.abs(st.x - jnp.asarray(st64.x, dtype))))
    assert x_err < 1e-2 * scale * 1e-3, x_err
    sv = qp._sign_violation(
        jax.tree.map(lambda a: a[None], data), st.x[None], st.y[None]
    )
    assert float(sv[0]) < 1e-5


def test_compact_drop_round_matches_full(rng):
    """drop_batch > 0 compacts the polish drop round (round 2) to the
    scenarios whose active-set estimate changed; results must match the
    full-batch round wherever a candidate was produced, and leave
    unchanged scenarios bitwise alone."""
    import dataclasses

    from quadrupedwholebodycontroller.control.wbc import _wbc_polish_hinv

    dtype = jnp.float32
    B, n, m = 8, 8, 12
    datas = [random_qp(rng, n=n, m=m, n_eq=2, dtype=jnp.float64)
             for _ in range(B)]
    data = jax.tree.map(lambda *xs: jnp.stack(xs).astype(dtype), *datas)
    warm = jax.tree.map(
        lambda x: jnp.stack([x] * B), qp.QPState.zeros(n, m, dtype)
    )
    # poison two scenarios' warm duals so their round-1 polish solves a
    # wrong set and the drop round fires for exactly those
    warm = warm._replace(
        y=warm.y.at[2, 5].set(300.0).at[6, 7].set(-250.0)
    )
    base = QPSolverParams(rescue_threshold=0.0)
    full = dataclasses.replace(base, drop_batch=0)
    comp = dataclasses.replace(base, drop_batch=3)
    cache_f = qp.make_cache(B, n, m, full, dtype)
    cache_c = qp.make_cache(B, n, m, comp, dtype)
    st_f, inf_f, _ = qp.solve_batched(
        data, warm, full, backend="cached", cache=cache_f, use_warm=False
    )
    st_c, inf_c, _ = qp.solve_batched(
        data, warm, comp, backend="cached", cache=cache_c, use_warm=False
    )
    np.testing.assert_allclose(
        np.asarray(st_c.x), np.asarray(st_f.x), atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(inf_c.kkt_residual), np.asarray(inf_f.kkt_residual),
        atol=1e-5,
    )
    # both runs end sign-clean (the poisoned duals were dropped)
    sv_c = qp._sign_violation(data, st_c.x, st_c.y)
    assert float(jnp.max(sv_c)) < 1e-4, float(jnp.max(sv_c))


def _poisoned_batch(rng, B=8, n=8, m=12, dtype=jnp.float32):
    """B random QPs with two scenarios' warm duals poisoned so their
    round-1 polish solves a wrong active set and the drop round fires."""
    datas = [random_qp(rng, n=n, m=m, n_eq=2, dtype=jnp.float64)
             for _ in range(B)]
    data = jax.tree.map(lambda *xs: jnp.stack(xs).astype(dtype), *datas)
    warm = jax.tree.map(
        lambda x: jnp.stack([x] * B), qp.QPState.zeros(n, m, dtype)
    )
    warm = warm._replace(
        y=warm.y.at[2, 5].set(300.0).at[6, 7].set(-250.0)
    )
    return data, warm


def test_drop_fire_tol_semantics(rng):
    """drop_fire_tol gates the drop round on the CURRENT best residual:
    (a) poisoned scenarios (large sign violation) still cross a meaningful
    bar and get fixed; (b) an unreachably high bar makes the drop round a
    no-op, bitwise equal to polish_rounds=1 (the skip branch)."""
    import dataclasses

    dtype = jnp.float32
    B, n, m = 8, 8, 12
    data, warm = _poisoned_batch(rng, B, n, m, dtype)
    base = QPSolverParams(rescue_threshold=0.0, drop_batch=3)

    def run(p):
        cache = qp.make_cache(B, n, m, p, dtype)
        return qp.solve_batched(
            data, warm, p, backend="cached", cache=cache, use_warm=False
        )

    st0, inf0, _ = run(base)  # fire bar off (round-4 behavior)
    st1, inf1, _ = run(dataclasses.replace(base, drop_fire_tol=1e-5))
    # (a) the poisoned scenarios sit far above 1e-5 sign-augmented
    # residual after round 1, so the gated drop round still fires and
    # the result is sign-clean and matches the ungated run
    sv1 = qp._sign_violation(data, st1.x, st1.y)
    assert float(jnp.max(sv1)) < 1e-4, float(jnp.max(sv1))
    np.testing.assert_allclose(
        np.asarray(st1.x), np.asarray(st0.x), atol=1e-5
    )
    # (b) an unreachable bar == no drop round == polish_rounds=1, bitwise
    st2, inf2, _ = run(dataclasses.replace(base, drop_fire_tol=1e9))
    st3, inf3, _ = run(dataclasses.replace(base, polish_rounds=1))
    np.testing.assert_array_equal(np.asarray(st2.x), np.asarray(st3.x))
    np.testing.assert_array_equal(
        np.asarray(inf2.kkt_residual), np.asarray(inf3.kkt_residual)
    )


def test_cond_hoist_bitwise(rng):
    """cond_hoist=1 (default) reroutes the carried (m, m, B)/(n, n, B)
    inverses OUT of the cold-fix / drop-round lax.cond outputs (only the
    gathered sub-blocks ride the conds; scatters happen outside).  It is
    a pure buffer-routing change: every output — states, infos, and the
    carried cache — must be BITWISE identical to the round-4/5 cond
    structure (cond_hoist=0) across a cold step AND a mixed per-scenario
    warm/cold step that fires both the compact cold fixes and the
    compacted drop round."""
    import dataclasses

    dtype = jnp.float32
    B, n, m = 8, 8, 12
    data, warm = _poisoned_batch(rng, B, n, m, dtype)
    base = QPSolverParams(rescue_threshold=0.0, drop_batch=3, cold_batch=3)
    uw = jnp.array([True, True, False, True, True, False, True, True])
    outs = {}
    for ch in (0, 1, 2):
        p = dataclasses.replace(base, cond_hoist=ch)
        cache = qp.make_cache(B, n, m, p, dtype)
        st1, inf1, cache = qp.solve_batched(
            data, warm, p, backend="cached", cache=cache, use_warm=False
        )
        st2, inf2, cache2 = qp.solve_batched(
            data, st1, p, backend="cached", cache=cache, use_warm=uw
        )
        outs[ch] = (st1, inf1, st2, inf2, cache2)
    for ch in (1, 2):
        for a, b in zip(jax.tree.leaves(outs[0]), jax.tree.leaves(outs[ch])):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_drop_warm_iters_is_guarded_not_equivalent():
    """drop_warm_iters > 0 is PARITY-UNSAFE and ships 0 (config.py,
    PERF.md round-5): a drop changes the active set, and the warm NS
    start can blow past its convergence radius while staying under the
    1e3 divergence guard — the resulting garbage candidate is then
    REJECTED by the sign-augmented acceptance, so the correction is
    lost but the carried iterate is never displaced.  This test pins
    exactly that contract: (a) the cold drop round fixes the poisoned
    scenarios; (b) the warm variant, whatever it fixes or misses, is
    per-scenario NEVER WORSE than skipping the drop round entirely
    (acceptance monotonicity in the sign-augmented metric).

    Fixed local seed (not the shared session rng): the warm variant's
    fix-or-miss outcome is draw-dependent by design, and an
    order-dependent draw made the old equivalence assertion flake."""
    import dataclasses

    dtype = jnp.float32
    B, n, m = 8, 8, 12
    data, warm = _poisoned_batch(
        np.random.default_rng(1234), B, n, m, dtype
    )
    base = QPSolverParams(rescue_threshold=0.0, drop_batch=3)
    warmed = dataclasses.replace(base, drop_warm_iters=8)
    round1 = dataclasses.replace(base, polish_rounds=1)

    def run(p):
        cache = qp.make_cache(B, n, m, p, dtype)
        return qp.solve_batched(
            data, warm, p, backend="cached", cache=cache, use_warm=False
        )

    st_c, inf_c, _ = run(base)
    st_w, inf_w, _ = run(warmed)
    st_1, inf_1, _ = run(round1)
    # (a) cold drop round recovers the poisoned scenarios
    sv_c = qp._sign_violation(data, st_c.x, st_c.y)
    assert float(jnp.max(sv_c)) < 1e-4, float(jnp.max(sv_c))
    # (b) warm variant is never worse than no drop round at all
    aug_w = jnp.maximum(
        inf_w.kkt_residual, qp._sign_violation(data, st_w.x, st_w.y)
    )
    aug_1 = jnp.maximum(
        inf_1.kkt_residual, qp._sign_violation(data, st_1.x, st_1.y)
    )
    assert bool(jnp.all(aug_w <= aug_1 + 1e-5)), (aug_w, aug_1)


def test_rescue_round2_compact_holds_threshold(rng):
    """rescue_round2_batch > 0 compacts the rescue's polish rounds >= 2 to
    the still-flagged scenarios; the guarantee (max KKT under threshold on
    a recoverable batch) must hold as with the full round, and clean
    batches must take the identical no-op branch."""
    import dataclasses

    dtype = jnp.float32
    B, n, m = 8, 10, 16
    datas = [random_qp(np.random.default_rng(s), n=n, m=m,
                       dtype=jnp.float64) for s in range(B)]
    data = jax.tree.map(lambda *xs: jnp.stack(xs).astype(dtype), *datas)
    warm = jax.tree.map(
        lambda x: jnp.stack([x] * B), qp.QPState.zeros(n, m, dtype)
    )
    # starve the main solve so the rescue must do the work
    base = QPSolverParams(
        iterations=3, cold_iterations=3,
        rescue_threshold=1e-3, rescue_iterations=150,
        rescue_polish_rounds=2,
    )
    full = dataclasses.replace(base, rescue_round2_batch=0)
    comp = dataclasses.replace(base, rescue_round2_batch=3)

    def run(p):
        cache = qp.make_cache(B, n, m, p, dtype)
        return qp.solve_batched(
            data, warm, p, backend="cached", cache=cache, use_warm=False
        )

    st_f, inf_f, _ = run(full)
    st_c, inf_c, _ = run(comp)
    thr = 1e-3
    assert float(jnp.max(inf_f.kkt_residual)) < thr
    assert float(jnp.max(inf_c.kkt_residual)) < thr
    sv_c = qp._sign_violation(data, st_c.x, st_c.y)
    assert float(jnp.max(sv_c)) < 1e-3, float(jnp.max(sv_c))
    # a clean batch (default budget) never enters the rescue: compaction
    # config cannot change the result
    clean_f = QPSolverParams(rescue_polish_rounds=2, rescue_round2_batch=0)
    clean_c = dataclasses.replace(clean_f, rescue_round2_batch=3)
    st0, _, _ = run(clean_f)
    st1, _, _ = run(clean_c)
    np.testing.assert_array_equal(np.asarray(st0.x), np.asarray(st1.x))

"""The cached batched chain's stages (ops/admm.py, ops/prepare.py,
ops/polish.py — batch-minor jnp) vs the per-sample reference solver."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from quadrupedwholebodycontroller.config import QPSolverParams
from quadrupedwholebodycontroller.ops import qp as qpm
from quadrupedwholebodycontroller.ops import polish as pk
from quadrupedwholebodycontroller.ops import prepare as prk
from quadrupedwholebodycontroller.ops.admm import (
    admm_iterations_res,
    admm_zy_iterations_res,
)


def admm_iterations(Kinv, A, g, l, u, rho, x0, z0, y0, *, iters, sigma,
                    alpha):
    """The sigma > 0 stage's iterates alone (unit scalings, the problem's
    own H and bounds for the ignored residual epilogue)."""
    B, m, n = A.shape
    one = lambda k: jnp.ones((B, k), A.dtype)
    H = jnp.broadcast_to(jnp.eye(n, dtype=A.dtype), (B, n, n))
    return admm_iterations_res(
        Kinv, A, g, l, u, rho, x0, z0, y0, H, l, u, one(n), one(m),
        iters=iters, sigma=sigma, alpha=alpha,
    )[:3]


def make_batch(rng, B=4, n=8, m=12, dtype=jnp.float32):
    datas = []
    for _ in range(B):
        L = rng.normal(size=(n, n))
        H = L @ L.T + n * np.eye(n)
        g = rng.normal(size=n)
        A = rng.normal(size=(m, n))
        x0 = rng.normal(size=n) * 0.3
        ax = A @ x0
        l = ax - rng.uniform(0.1, 1.0, size=m)
        u = ax + rng.uniform(0.1, 1.0, size=m)
        l[:2] = ax[:2]; u[:2] = ax[:2]
        l[2] = -np.inf; u[3] = np.inf
        datas.append(qpm.QPData(*[jnp.asarray(v, dtype) for v in (H, g, A, l, u)]))
    return jax.tree.map(lambda *xs: jnp.stack(xs), *datas)


def xla_admm(data, warm, iters, sigma, alpha, rho_b):
    def one(d, w, rho):
        n = d.H.shape[0]
        K = d.H + sigma * jnp.eye(n, dtype=d.H.dtype) + (d.A.T * rho) @ d.A
        Kinv = jnp.linalg.inv(K)

        def body(_, st):
            x, z, y = st
            rhs = sigma * x - d.g + d.A.T @ (rho * z - y)
            x_t = Kinv @ rhs
            z_t = d.A @ x_t
            x_n = alpha * x_t + (1 - alpha) * x
            z_rel = alpha * z_t + (1 - alpha) * z
            z_n = jnp.clip(z_rel + y / rho, d.l, d.u)
            y_n = y + rho * (z_rel - z_n)
            return (x_n, z_n, y_n)

        return jax.lax.fori_loop(0, iters, body, (w.x, w.z, w.y))

    return jax.vmap(one)(data, warm, rho_b)


def test_kernel_matches_xla(rng):
    B, n, m = 4, 8, 12
    data = make_batch(rng, B, n, m)
    warm = jax.tree.map(
        lambda x: jnp.stack([x] * B), qpm.QPState.zeros(n, m, jnp.float32)
    )
    iters, sigma, alpha = 50, 1e-6, 1.6
    rho_b = jax.vmap(lambda d: qpm._rho_vec(d, QPSolverParams()))(data)

    x_ref, z_ref, y_ref = xla_admm(data, warm, iters, sigma, alpha, rho_b)

    K = jax.vmap(
        lambda d, r: d.H + sigma * jnp.eye(n, dtype=jnp.float32) + (d.A.T * r) @ d.A
    )(data, rho_b)
    Kinv = jnp.linalg.inv(K)
    x_p, z_p, y_p = admm_iterations(
        Kinv, data.A, data.g, data.l, data.u, rho_b,
        warm.x, warm.z, warm.y,
        iters=iters, sigma=sigma, alpha=alpha,
    )
    # f32 accumulation order differs between the stage's reductions and
    # XLA's matmuls; iterates agree to ~1e-3 relative after 50 iterations
    assert np.allclose(np.asarray(x_p), np.asarray(x_ref), atol=5e-3), (
        np.abs(np.asarray(x_p) - np.asarray(x_ref)).max()
    )
    assert np.allclose(np.asarray(z_p), np.asarray(z_ref), atol=5e-3)
    assert np.allclose(np.asarray(y_p), np.asarray(y_ref), atol=2e-2)


def test_zy_kernel_matches_xla_sigma0(rng):
    """The constraint-space (sigma = 0) loop reproduces the x-space ADMM
    recursion at sigma = 0 exactly (same iterates, x recovered from the
    linear accumulator), including the residual epilogue."""
    B, n, m = 4, 8, 12
    data = make_batch(rng, B, n, m)
    warm = qpm.QPState(
        x=jnp.asarray(rng.normal(size=(B, n)) * 0.1, jnp.float32),
        z=jnp.asarray(rng.normal(size=(B, m)) * 0.1, jnp.float32),
        y=jnp.asarray(rng.normal(size=(B, m)) * 0.1, jnp.float32),
    )
    iters, alpha = 50, 1.6
    rho_b = jax.vmap(lambda d: qpm._rho_vec(d, QPSolverParams()))(data)

    x_ref, z_ref, y_ref = xla_admm(data, warm, iters, 0.0, alpha, rho_b)

    K = jax.vmap(lambda d, r: d.H + (d.A.T * r) @ d.A)(data, rho_b)
    Kinv = jnp.linalg.inv(K)
    ones_n = jnp.ones((B, n), jnp.float32)
    ones_m = jnp.ones((B, m), jnp.float32)
    x_p, z_p, y_p, pr, du, _sv = admm_zy_iterations_res(
        Kinv, data.A, data.g, data.l, data.u, rho_b,
        warm.x, warm.z, warm.y, data.H, data.l, data.u, ones_n, ones_m,
        iters=iters, alpha=alpha,
    )
    assert np.allclose(np.asarray(x_p), np.asarray(x_ref), atol=5e-3), (
        np.abs(np.asarray(x_p) - np.asarray(x_ref)).max()
    )
    assert np.allclose(np.asarray(z_p), np.asarray(z_ref), atol=5e-3)
    assert np.allclose(np.asarray(y_p), np.asarray(y_ref), atol=2e-2)
    # epilogue matches the reference residual formula
    for b in range(B):
        d = jax.tree.map(lambda v: v[b], data)
        pr_ref, du_ref = qpm.kkt_residual(d, x_p[b], y_p[b])
        assert abs(float(pr[b]) - float(pr_ref)) < 5e-4
        assert abs(float(du[b]) - float(du_ref)) < 5e-4


def test_cached_batched_step_zy_interpret(rng):
    """The full cached step with sigma = 0 (the constraint-space
    loop in solve_batched) stays KKT-clean over repeated cycles."""
    from quadrupedwholebodycontroller.config import ControllerParams
    from quadrupedwholebodycontroller.control import wbc
    from quadrupedwholebodycontroller.models import anymal_d_model
    from quadrupedwholebodycontroller.models.anymal import INITIAL_JOINT_POS

    dtype = jnp.float32
    model = anymal_d_model(dtype=dtype)
    cp = ControllerParams()
    params = QPSolverParams(sigma=0.0)
    B = 3
    key = jax.random.PRNGKey(3)
    obs = wbc.RobotObservation(
        base_R=jnp.broadcast_to(jnp.eye(3, dtype=dtype), (B, 3, 3)),
        base_p=jnp.tile(jnp.array([0.0, 0.0, 0.55], dtype), (B, 1))
        + 0.01 * jax.random.normal(key, (B, 3), dtype),
        base_vel=jnp.zeros((B, 6), dtype),
        q=jnp.tile(jnp.asarray(INITIAL_JOINT_POS, dtype), (B, 1)),
        qd=jnp.zeros((B, 12), dtype),
    )
    ref = jax.tree.map(lambda x: jnp.stack([x] * B), wbc.Reference.standing(cp, dtype))
    carry = jax.tree.map(lambda x: jnp.stack([x] * B), wbc.init_carry(dtype))
    cache = qpm.make_cache(B, 42, 70, params, dtype)
    valid = False
    for _ in range(4):
        out, carry, cache = wbc.wbc_step_batched(
            model, cp, params, obs, ref, carry, True,
            "cached", cache, valid,
        )
        valid = True
        assert float(jnp.max(out.qp_info.kkt_residual)) < 1e-3


def test_kernel_convergence_on_wbc_sized_problem(rng):
    """42x70 problems (the WBC shape): the batched iterations reach a small

    KKT residual with the production settings."""
    B, n, m = 3, 42, 70
    data = make_batch(rng, B, n, m)
    params = QPSolverParams()
    rho_b = jax.vmap(lambda d: qpm._rho_vec(d, params))(data)
    K = jax.vmap(
        lambda d, r: d.H + params.sigma * jnp.eye(n, dtype=jnp.float32) + (d.A.T * r) @ d.A
    )(data, rho_b)
    Kinv = jnp.linalg.inv(K)
    warm = jax.tree.map(
        lambda x: jnp.stack([x] * B), qpm.QPState.zeros(n, m, jnp.float32)
    )
    x, z, y = admm_iterations(
        Kinv, data.A, data.g, data.l, data.u, rho_b,
        warm.x, warm.z, warm.y,
        iters=300, sigma=params.sigma, alpha=params.alpha,
    )
    for b in range(B):
        d = jax.tree.map(lambda v: v[b], data)
        pr, du = qpm.kkt_residual(d, x[b], y[b])
        assert float(pr) < 1e-2 and float(du) < 1e-1, (b, float(pr), float(du))


def test_cached_batched_step_interpret(rng):
    """The QPCache warm path (cached batched chain) stays

    KKT-clean over repeated cycles and matches the uncached result."""
    from quadrupedwholebodycontroller.config import ControllerParams
    from quadrupedwholebodycontroller.control import wbc
    from quadrupedwholebodycontroller.models import anymal_d_model
    from quadrupedwholebodycontroller.models.anymal import INITIAL_JOINT_POS

    dtype = jnp.float32
    model = anymal_d_model(dtype=dtype)
    cp = ControllerParams()
    B = 3
    key = jax.random.PRNGKey(3)
    obs = wbc.RobotObservation(
        base_R=jnp.broadcast_to(jnp.eye(3, dtype=dtype), (B, 3, 3)),
        base_p=jnp.tile(jnp.array([0.0, 0.0, 0.55], dtype), (B, 1))
        + 0.01 * jax.random.normal(key, (B, 3), dtype),
        base_vel=jnp.zeros((B, 6), dtype),
        q=jnp.tile(jnp.asarray(INITIAL_JOINT_POS, dtype), (B, 1)),
        qd=jnp.zeros((B, 12), dtype),
    )
    ref = jax.tree.map(lambda x: jnp.stack([x] * B), wbc.Reference.standing(cp, dtype))
    carry = jax.tree.map(lambda x: jnp.stack([x] * B), wbc.init_carry(dtype))
    cache = qpm.QPCache.zeros(B, 42, 70, dtype)
    valid = False
    # sigma > 0 pins the x-space loop (the default sigma = 0 selects the
    # constraint-space loop, covered by test_cached_batched_step_zy_interpret
    # above); polish_rounds=2 keeps the round-2 chained-sinv path covered
    for _ in range(4):
        out, carry, cache = wbc.wbc_step_batched(
            model, cp, QPSolverParams(sigma=1e-6, polish_rounds=2),
            obs, ref, carry, True,
            "cached", cache, valid,
        )
        valid = True
        assert float(jnp.max(out.qp_info.kkt_residual)) < 1e-3


def test_polish_kernel_matches_xla(rng):
    """The batch-minor polish cascade reproduces the per-sample Schur
    polish: same solution, same residuals, same returned Sinv."""
    from quadrupedwholebodycontroller.ops.linalg import ns_inverse
    from tests.test_qp import random_qp

    B, n, m = 4, 12, 20
    datas = [random_qp(np.random.default_rng(s), n=n, m=m, n_eq=3) for s in range(B)]
    data = jax.tree.map(lambda *xs: jnp.stack([jnp.asarray(x, jnp.float32) for x in xs]), *datas)
    params = QPSolverParams(iterations=200)
    # ADMM point to polish from
    states = [qpm.solve(jax.tree.map(lambda v: v[b], data),
                        qpm.QPState.zeros(n, m, jnp.float32),
                        QPSolverParams(iterations=200, polish=False))[0]
              for b in range(B)]
    state = jax.tree.map(lambda *xs: jnp.stack(xs), *states)

    H_reg = data.H + params.polish_reg * jnp.eye(n, dtype=jnp.float32)
    Hinv = ns_inverse(H_reg, params.ns_iters)
    sinv_fn = lambda M: ns_inverse(M, params.ns_iters)

    pol_x, sinv_x = qpm._polish_batched(data, state, params, Hinv, sinv_fn)
    pol_k, sinv_k, pr_k, du_k, sv_k = qpm._polish_batched_kernel(
        data, state, params, H_reg, Hinv,
        lambda S_thunk: sinv_fn(S_thunk()),
    )
    assert np.allclose(np.asarray(pol_k.x), np.asarray(pol_x.x), atol=1e-4)
    assert np.allclose(np.asarray(pol_k.y), np.asarray(pol_x.y), atol=1e-4)
    assert np.allclose(np.asarray(sinv_k), np.asarray(sinv_x), atol=1e-5)
    # cascade residuals agree with the reference residual computation
    for b in range(B):
        d = jax.tree.map(lambda v: v[b], data)
        pr, du = qpm.kkt_residual(d, pol_k.x[b], pol_k.y[b])
        assert abs(float(pr) - float(pr_k[b])) < 1e-5
        assert abs(float(du) - float(du_k[b])) < 1e-5
    # the cascade's sign violation matches the per-sample computation
    sv_ref = qpm._sign_violation(data, pol_k.x, pol_k.y)
    assert np.allclose(np.asarray(sv_k), np.asarray(sv_ref), atol=1e-5)


def test_prepare_kernel_matches_xla(rng):
    """The batch-minor Ruiz/scaling stage reproduces the per-sample prepare
    exactly."""
    from tests.test_qp import random_qp

    B, n, m = 3, 12, 20
    datas = [random_qp(np.random.default_rng(s), n=n, m=m, n_eq=3) for s in range(B)]
    data = jax.tree.map(lambda *xs: jnp.stack([jnp.asarray(x, jnp.float32) for x in xs]), *datas)
    params = QPSolverParams()
    key = jax.random.PRNGKey(0)
    warm = qpm.QPState(
        x=jax.random.normal(key, (B, n), jnp.float32),
        z=jax.random.normal(key, (B, m), jnp.float32),
        y=jax.random.normal(key, (B, m), jnp.float32),
    )

    def xla_prepare(d, w):
        dd, e = qpm._ruiz_equilibrate(d, params.scaling_iters)
        sd = qpm.QPData(
            H=dd[:, None] * d.H * dd[None, :], g=dd * d.g,
            A=e[:, None] * d.A * dd[None, :], l=e * d.l, u=e * d.u,
        )
        ws = qpm.QPState(x=w.x / dd, z=w.z * e, y=w.y / e)
        rho = qpm._rho_vec(sd, params)
        return sd, ws, rho, dd, e

    sd_x, ws_x, rho_x, d_x, e_x = jax.vmap(xla_prepare)(data, warm)
    out = prk.prepare_scaled(
        data.H, data.A, data.g, data.l, data.u, warm.x, warm.z, warm.y,
        sweeps=params.scaling_iters, rho0=params.rho,
        rho_eq_scale=params.rho_eq_scale,
    )
    sH, sA, sg, sl, su, rho, wxs, wzs, wys, dd, ee = out
    for a, b, name in [
        (sH, sd_x.H, "H"), (sA, sd_x.A, "A"), (sg, sd_x.g, "g"),
        (sl, sd_x.l, "l"), (su, sd_x.u, "u"), (rho, rho_x, "rho"),
        (wxs, ws_x.x, "wx"), (wzs, ws_x.z, "wz"), (wys, ws_x.y, "wy"),
        (dd, d_x, "d"), (ee, e_x, "e"),
    ]:
        assert np.allclose(np.asarray(a), np.asarray(b), atol=1e-6), name


def test_polish_kernel_compact_matches_dense(rng):
    """The compact block-diagonal H/Hinv polish variant equals the dense
    variant bitwise-tight (the dense matvec only adds exact zeros)."""
    from quadrupedwholebodycontroller.ops.linalg import ns_inverse
    from quadrupedwholebodycontroller.ops.qp import _blockdiag_dense
    from tests.test_qp import random_qp

    B, n, m, k, start = 5, 42, 70, 12, 18
    dtype = jnp.float64
    # WBC-structured H: I(18) ⊕ SPD 12x12 ⊕ w·I(12)
    M = rng.normal(size=(B, k, 6))
    blk = jnp.asarray(M @ np.swapaxes(M, 1, 2) + np.eye(k), dtype)
    diag = jnp.concatenate(
        [jnp.ones((B, start), dtype), jnp.zeros((B, k), dtype),
         1000.0 * jnp.ones((B, n - start - k), dtype)], axis=1)
    H = _blockdiag_dense((diag, blk, start))
    A = jnp.asarray(rng.normal(size=(B, m, n)), dtype)
    g = jnp.asarray(rng.normal(size=(B, n)), dtype)
    b = jnp.asarray(rng.normal(size=(B, m)), dtype)
    l = b - 1.0
    u = b + jnp.asarray(rng.uniform(0.0, 2.0, size=(B, m)), dtype)
    da = jnp.asarray(rng.random((B, m)) < 0.4, dtype)
    reg = 1e-9
    H_reg = H + reg * jnp.eye(n, dtype=dtype)
    Hinv = ns_inverse(H_reg, 40)
    Bm = da[:, :, None] * A
    S = Bm @ Hinv @ jnp.swapaxes(Bm, -1, -2) + jax.vmap(jnp.diag)(
        reg * da + (1.0 - da))
    Sinv = ns_inverse(S, 40)

    dense = pk.polish_solve(H_reg, Hinv, Sinv, A, da, g, b, l, u,
                            refine=3, reg=reg)
    # compact form: diag carries the regularization on the non-block rows
    diag_reg = jnp.where(diag != 0.0, diag + reg, 0.0)
    blk_reg = blk + reg * jnp.eye(k, dtype=dtype)
    hi_diag = jnp.where(diag_reg != 0.0, 1.0 / diag_reg, 0.0)
    hi_blk = jnp.linalg.inv(blk_reg)
    compact = pk.polish_solve(
        (diag_reg, blk_reg, start), (hi_diag, hi_blk, start),
        Sinv, A, da, g, b, l, u, refine=3, reg=reg)
    # Hinv differs (NS vs exact inverse) at ~1e-12; everything else exact
    for name, a_, b_ in zip("xyz", dense[:3], compact[:3]):
        err = float(jnp.max(jnp.abs(a_ - b_)))
        assert err < 1e-6, (name, err)


def test_compact_rescue_matches_full(rng):
    """rescue_batch > 0 gathers the top-k worst scenarios, rescues them the
    same way the full-batch rescue does, and leaves every other scenario's
    result untouched (ops/qp.py cached-path compact rescue)."""
    import dataclasses

    B, n, m = 8, 8, 12
    k = 3
    data = make_batch(rng, B, n, m)
    warm = jax.tree.map(
        lambda x: jnp.stack([x] * B), qpm.QPState.zeros(n, m, jnp.float32)
    )
    # weak main solve so the rescue has room to improve
    off = QPSolverParams(sigma=0.0, iterations=8, cold_iterations=8,
                         rescue_threshold=0.0)
    st0, inf0 = qpm.solve_batched(data, warm, off, backend="cached")
    # threshold below every residual -> the rescue cond always fires;
    # with rescue_batch=k only the k worst scenarios are gathered
    # rescue_stages=1 pins the single-fire contract: with re-firing
    # stages the compact rescue legitimately gathers a NEW top-k per
    # stage (the flag updates), so "rest untouched" only holds for one
    # stage
    full = dataclasses.replace(
        off, rescue_threshold=1e-12, rescue_iterations=60,
        rescue_polish_rounds=1, rescue_batch=0, rescue_stages=1)
    comp = dataclasses.replace(full, rescue_batch=k)
    st_f, inf_f = qpm.solve_batched(data, warm, full, backend="cached")
    st_c, inf_c = qpm.solve_batched(data, warm, comp, backend="cached")

    res0 = np.asarray(inf0.kkt_residual)
    # the compact rescue selects by the SIGN-AUGMENTED flag
    # max(res, sign_violation) — a wrong-set scenario is rescueable
    # even when its plain residual looks converged
    flag0 = np.maximum(
        res0, np.asarray(qpm._sign_violation(data, st0.x, st0.y))
    )
    order = np.argsort(-flag0)
    top, rest = order[:k], order[k:]
    # gathered rows reproduce the full-batch rescue (per-scenario math is
    # batch-independent in the kernels; tolerance covers fusion order)
    assert np.allclose(np.asarray(st_c.x)[top], np.asarray(st_f.x)[top],
                       atol=1e-5)
    assert np.allclose(np.asarray(inf_c.kkt_residual)[top],
                       np.asarray(inf_f.kkt_residual)[top], atol=1e-6)
    # non-gathered rows keep the rescue-off result
    assert np.allclose(np.asarray(st_c.x)[rest], np.asarray(st0.x)[rest],
                       atol=1e-7)
    assert np.allclose(np.asarray(inf_c.kkt_residual)[rest], res0[rest],
                       atol=1e-7)
    # acceptance stays monotone everywhere
    assert np.all(np.asarray(inf_c.kkt_residual) <= res0 + 1e-6)


def test_compact_rescue_blockdiag_hinv(rng):
    """The compact rescue gathers the compact block-diagonal (diag, blk,
    start) polish operands correctly (the hinv_fn path wbc uses)."""
    import dataclasses

    from quadrupedwholebodycontroller.ops.qp import _blockdiag_dense

    B, n, m, kb, start = 8, 8, 12, 3, 2
    k = 3
    dtype = jnp.float32
    rows = []
    for _ in range(B):
        dvec = rng.uniform(1.0, 3.0, size=n)
        L = rng.normal(size=(kb, kb))
        blk = L @ L.T + kb * np.eye(kb)
        H = np.diag(dvec)
        H[start:start + kb, start:start + kb] = blk
        g = rng.normal(size=n)
        A = rng.normal(size=(m, n))
        x0 = rng.normal(size=n) * 0.3
        ax = A @ x0
        low = ax - rng.uniform(0.1, 1.0, size=m)
        upp = ax + rng.uniform(0.1, 1.0, size=m)
        low[:2] = ax[:2]; upp[:2] = ax[:2]
        rows.append(qpm.QPData(*[jnp.asarray(v, dtype)
                                 for v in (H, g, A, low, upp)]))
    data = jax.tree.map(lambda *xs: jnp.stack(xs), *rows)
    warm = jax.tree.map(
        lambda x: jnp.stack([x] * B), qpm.QPState.zeros(n, m, dtype)
    )

    def hinv_fn(H, reg):
        diag = jnp.diagonal(H, axis1=-2, axis2=-1) + reg
        dinv = (1.0 / diag).at[:, start:start + kb].set(0.0)
        blk = (H[:, start:start + kb, start:start + kb]
               + reg * jnp.eye(kb, dtype=H.dtype))
        return (dinv, jnp.linalg.inv(blk), start)

    off = QPSolverParams(sigma=0.0, iterations=8, cold_iterations=8,
                         rescue_threshold=0.0)
    st0, inf0 = qpm.solve_batched(data, warm, off, backend="cached",
                                  hinv_fn=hinv_fn)
    comp = dataclasses.replace(
        off, rescue_threshold=1e-12, rescue_iterations=60,
        rescue_polish_rounds=1, rescue_batch=k, rescue_stages=1)
    st_c, inf_c = qpm.solve_batched(data, warm, comp, backend="cached",
                                    hinv_fn=hinv_fn)
    res0 = np.asarray(inf0.kkt_residual)
    # selection is by the sign-augmented flag (one stage pinned above)
    flag0 = np.maximum(
        res0, np.asarray(qpm._sign_violation(data, st0.x, st0.y))
    )
    order = np.argsort(-flag0)
    top, rest = order[:k], order[k:]
    # acceptance monotone; untouched rows identical
    assert np.all(np.asarray(inf_c.kkt_residual) <= res0 + 1e-6)
    assert np.allclose(np.asarray(st_c.x)[rest], np.asarray(st0.x)[rest],
                       atol=1e-7)
    # the rescued rows still satisfy their own KKT system (sanity that
    # the gathered compact operands belong to the right scenarios)
    for b in top:
        d = jax.tree.map(lambda v: v[int(b)], data)
        pr, du = qpm.kkt_residual(d, st_c.x[int(b)], st_c.y[int(b)])
        assert float(jnp.maximum(pr, du)) <= res0[int(b)] + 1e-6


@pytest.mark.parametrize("pset", ["sigma0", "sigma_prox", "cold2"])
def test_solve_layout_minor_matches_major(pset):
    """The batch-minor solve chain (solve_layout="minor": prepared tensors
    stay batch-minor, K build + warm-NS K^-1 run as trailing-batch einsums,
    the ADMM loop consumes them directly) must reproduce the batch-major
    chain.  f64: the only difference is einsum expression order, so the
    full cached step agrees to ~1e-9; includes a contact-switch step so the
    per-scenario compacted cold fix traces in both layouts (pset "cold2")
    and both ADMM loops run (pset "sigma_prox").

    Runs in a SUBPROCESS (tests/layout_equiv_worker.py) because the XLA CPU
    compiler has segfaulted intermittently under heavy accumulated
    in-process compile load at this suite position."""
    import json
    import os
    import subprocess
    import sys

    env = dict(os.environ, JAX_PLATFORMS="cpu")
    worker = os.path.join(os.path.dirname(__file__), "layout_equiv_worker.py")
    out = subprocess.run(
        [sys.executable, worker, pset],
        capture_output=True, text=True, timeout=1200, env=env,
        cwd=os.path.join(os.path.dirname(__file__), ".."),
    )
    assert out.returncode == 0, (out.stdout[-2000:], out.stderr[-2000:])
    errs = json.loads(out.stdout.strip().splitlines()[-1])
    assert errs["tau"] < 1e-7, errs
    assert errs["grf"] < 1e-7, errs
    assert errs["kkt"] < 1e-7, errs

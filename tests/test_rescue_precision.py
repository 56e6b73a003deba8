"""Round-3 QP tail machinery: staged rescue, compensated (double-f32)
refinement, and per-scenario warm-cache gating.

The reference analogues: qpOASES `setToReliable` (the rescue,
whole_body_controller.cpp:519), all-double arithmetic (the compensated
refinement — error-free f32 transformations are the precision lever at
the accelerator's working precision), and per-problem hotstart
(the per-scenario gate, cpp:529-533)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from quadrupedwholebodycontroller.config import QPSolverParams
from quadrupedwholebodycontroller.ops import compensated as comp
from quadrupedwholebodycontroller.ops import qp as qpm

from tests.test_pallas_qp import make_batch


def test_comp_residual_beats_plain_f32(rng):
    """comp_residual recovers the true residual where plain f32 evaluation
    is pure cancellation noise (magnitudes ~1e4, residual ~1e-2)."""
    M64 = rng.normal(size=(4, 70, 112)) * 1e4
    x64 = rng.normal(size=(4, 112))
    b64 = np.einsum("bij,bj->bi", M64, x64)
    M32 = jnp.asarray(M64, jnp.float32)
    x32 = jnp.asarray(x64, jnp.float32)
    b32 = jnp.asarray(b64, jnp.float32)
    # f64 truth OF THE F32 DATA (what an exact evaluator would return)
    r_true = np.asarray(b32, np.float64) - np.einsum(
        "bij,bj->bi", np.asarray(M32, np.float64), np.asarray(x32, np.float64)
    )
    r_plain = np.asarray(b32 - jnp.einsum("bij,bj->bi", M32, x32))
    r_comp = np.asarray(comp.comp_residual(b32, M32, x32))
    err_plain = np.abs(r_plain - r_true).max()
    err_comp = np.abs(r_comp - r_true).max()
    assert err_comp < 1e-6 * np.abs(r_true).max() + 1e-8
    assert err_comp < err_plain * 1e-3  # >= 3 orders recovered


def test_comp_matvec_matches_f64(rng):
    M = rng.normal(size=(3, 12, 20)) * 1e3
    v = rng.normal(size=(3, 20))
    M32, v32 = jnp.asarray(M, jnp.float32), jnp.asarray(v, jnp.float32)
    truth = np.einsum(
        "bij,bj->bi", np.asarray(M32, np.float64), np.asarray(v32, np.float64)
    )
    got = np.asarray(comp.comp_matvec(M32, v32), np.float64)
    assert np.abs(got - truth).max() < 1e-6 * np.abs(truth).max()


def test_staged_rescue_monotone_and_no_worse(rng):
    """More rescue stages never worsen any scenario (acceptance is
    per-scenario monotone), and the staged run matches or beats one stage."""
    B, n, m = 8, 42, 70
    data = make_batch(rng, B, n, m, dtype=jnp.float32)
    warm = jax.tree.map(
        lambda x: jnp.stack([x] * B), qpm.QPState.zeros(n, m, jnp.float32)
    )
    base = QPSolverParams(
        iterations=10, cold_iterations=10, rescue_threshold=1e-9,
        rescue_iterations=40, rescue_polish_rounds=1, rescue_batch=0,
        rescue_comp_refine=0,
    )
    st1, inf1 = qpm.solve_batched(
        data, warm, dataclasses.replace(base, rescue_stages=1), backend="xla"
    )
    st3, inf3 = qpm.solve_batched(
        data, warm, dataclasses.replace(base, rescue_stages=3), backend="xla"
    )
    r1 = np.asarray(inf1.kkt_residual)
    r3 = np.asarray(inf3.kkt_residual)
    assert np.all(r3 <= r1 + 1e-7), (r1, r3)
    # off-switch sanity: the weak main solve left room, stages improved
    off = qpm.solve_batched(
        data, warm, dataclasses.replace(base, rescue_threshold=0.0),
        backend="xla",
    )[1]
    assert np.max(r3) <= np.max(np.asarray(off.kkt_residual))


def test_polish_comp_candidate_never_worse(rng):
    """The compensated polish candidate is accepted per-scenario only where
    it improves — final residuals never regress vs comp off."""
    B, n, m = 8, 42, 70
    data = make_batch(rng, B, n, m, dtype=jnp.float32)
    warm = jax.tree.map(
        lambda x: jnp.stack([x] * B), qpm.QPState.zeros(n, m, jnp.float32)
    )
    base = QPSolverParams(
        iterations=10, cold_iterations=10, rescue_threshold=1e-9,
        rescue_iterations=40, rescue_polish_rounds=1, rescue_batch=0,
        rescue_stages=1,
    )
    inf_off = qpm.solve_batched(
        data, warm, dataclasses.replace(base, rescue_comp_refine=0),
        backend="xla",
    )[1]
    inf_on = qpm.solve_batched(
        data, warm, dataclasses.replace(base, rescue_comp_refine=2),
        backend="xla",
    )[1]
    assert np.all(
        np.asarray(inf_on.kkt_residual)
        <= np.asarray(inf_off.kkt_residual) + 1e-7
    )


def test_polish_comp_solves_kkt_f64(rng):
    """In f64 the compensated polish candidate solves the active-set KKT
    system to near machine precision (correctness of the assembled system
    and the refinement recursion)."""
    from tests.test_qp import random_qp

    B, n, m = 4, 12, 20
    datas = [random_qp(np.random.default_rng(s), n=n, m=m, n_eq=3)
             for s in range(B)]
    data = jax.tree.map(
        lambda *xs: jnp.stack([jnp.asarray(x, jnp.float64) for x in xs]),
        *datas,
    )
    params = QPSolverParams(iterations=300, rescue_comp_refine=2)
    sts = [qpm.solve(jax.tree.map(lambda v: v[b], data),
                     qpm.QPState.zeros(n, m, jnp.float64),
                     QPSolverParams(iterations=300, polish=False,
                                    rescue_threshold=0.0))[0]
           for b in range(B)]
    state = jax.tree.map(lambda *xs: jnp.stack(xs), *sts)
    cand, pr, du = qpm._polish_comp(data, state, params)
    # floor = the polish_reg=1e-9 dual regularization, not refinement error
    assert float(jnp.max(jnp.maximum(pr, du))) < 1e-8


def test_per_scenario_warm_gate_matches_scalar_paths(rng):
    """Mixed warm mask == scalar-warm result on warm rows and scalar-cold
    result on cold rows (the per-scenario gate composes exactly from the
    two batch-level paths; kernels are per-scenario independent)."""
    B, n, m = 8, 8, 12
    dtype = jnp.float32
    data = make_batch(rng, B, n, m)
    warm0 = jax.tree.map(
        lambda x: jnp.stack([x] * B), qpm.QPState.zeros(n, m, dtype)
    )
    p = QPSolverParams(
        sigma=0.0, iterations=30, cold_iterations=60,
        rescue_threshold=0.0, cold_batch=3, ns_warm_iters=2,
        ns_warm_iters_polish=0,
    )
    cache0 = qpm.QPCache.zeros(B, n, m, dtype)
    # fill the cache with a cold pass
    st0, _, cache = qpm.solve_batched(
        data, warm0, p, backend="cached", cache=cache0,
        use_warm=jnp.zeros((B,), bool),
    )
    # drift the problems slightly (the 400 Hz shape)
    data2 = data._replace(
        g=data.g * 1.001, l=data.l * 0.999, u=data.u * 1.001
    )
    cold_rows = jnp.zeros((B,), bool).at[2].set(True).at[5].set(True)
    mask = ~cold_rows
    st_mix, inf_mix, cache_mix = qpm.solve_batched(
        data2, st0, p, backend="cached", cache=cache, use_warm=mask
    )
    st_warm, _, cache_warm = qpm.solve_batched(
        data2, st0, p, backend="cached", cache=cache, use_warm=True
    )
    st_cold, _, cache_cold = qpm.solve_batched(
        data2, st0, p, backend="cached", cache=cache, use_warm=False
    )
    wr = np.asarray(~cold_rows)
    assert np.allclose(np.asarray(st_mix.x)[wr],
                       np.asarray(st_warm.x)[wr], atol=1e-6)
    assert np.allclose(np.asarray(st_mix.x)[~wr],
                       np.asarray(st_cold.x)[~wr], atol=1e-5)
    # the updated cache rows follow the same split
    assert np.allclose(np.asarray(cache_mix.kinv)[wr],
                       np.asarray(cache_warm.kinv)[wr], atol=1e-6)
    assert np.allclose(np.asarray(cache_mix.kinv)[~wr],
                       np.asarray(cache_cold.kinv)[~wr], atol=1e-5)
    # overflow: more cold rows than cold_batch -> full-batch cold
    many_cold = jnp.ones((B,), bool).at[0].set(False).at[1].set(False) \
        .at[2].set(False).at[3].set(False)
    st_of, _, _ = qpm.solve_batched(
        data2, st0, p, backend="cached", cache=cache, use_warm=~many_cold
    )
    assert np.allclose(np.asarray(st_of.x), np.asarray(st_cold.x),
                       atol=1e-6)


def test_cold_batch_zero_restores_batch_gate(rng):
    """cold_batch=0 with a per-scenario mask reduces to the scalar
    all-of-batch gate (the pre-round-3 behavior)."""
    B, n, m = 6, 8, 12
    dtype = jnp.float32
    data = make_batch(rng, B, n, m)
    warm0 = jax.tree.map(
        lambda x: jnp.stack([x] * B), qpm.QPState.zeros(n, m, dtype)
    )
    p = QPSolverParams(sigma=0.0, iterations=20, cold_iterations=40,
                       rescue_threshold=0.0, cold_batch=0)
    cache = qpm.QPCache.zeros(B, n, m, dtype)
    st0, _, cache = qpm.solve_batched(
        data, warm0, p, backend="cached", cache=cache,
        use_warm=jnp.zeros((B,), bool),
    )
    mask = jnp.ones((B,), bool).at[1].set(False)  # any False -> all cold
    st_m, _, _ = qpm.solve_batched(
        data, st0, p, backend="cached", cache=cache, use_warm=mask
    )
    st_c, _, _ = qpm.solve_batched(
        data, st0, p, backend="cached", cache=cache, use_warm=False
    )
    assert np.allclose(np.asarray(st_m.x), np.asarray(st_c.x), atol=0)


def test_cache_gate_fires_on_switch_edge_only(rng, monkeypatch):
    """The warm-cache gate keys on the switch EDGE (contacts changed at
    this publish tick), not the held switch_flag: held steps after the
    edge reuse the (already re-inverted) cache.  The held flag still
    drives the FD-derivative zeroing (reference semantics)."""
    import jax
    import jax.numpy as jnp

    from quadrupedwholebodycontroller.config import ControllerParams
    from quadrupedwholebodycontroller.control import wbc
    from quadrupedwholebodycontroller.models import anymal_d_model
    from quadrupedwholebodycontroller.models.anymal import (
        INITIAL_JOINT_POS,
    )

    captured = []
    orig = qpm.solve_batched

    def spy(data, warm, params=QPSolverParams(), backend="xla", cache=None,
            use_warm=None, **kw):
        captured.append(np.asarray(use_warm))
        return orig(data, warm, params, backend, cache=cache,
                    use_warm=use_warm, **kw)

    monkeypatch.setattr(wbc.qp, "solve_batched", spy)
    dtype = jnp.float32
    model = anymal_d_model(dtype=dtype)
    cp = ControllerParams()
    p = QPSolverParams(sigma=0.0, cold_batch=2, rescue_threshold=0.0)
    B = 3
    obs = wbc.RobotObservation(
        base_R=jnp.broadcast_to(jnp.eye(3, dtype=dtype), (B, 3, 3)),
        base_p=jnp.tile(jnp.array([0.0, 0.0, 0.55], dtype), (B, 1)),
        base_vel=jnp.zeros((B, 6), dtype),
        q=jnp.tile(jnp.asarray(INITIAL_JOINT_POS, dtype), (B, 1)),
        qd=jnp.zeros((B, 12), dtype),
    )
    ref = jax.tree.map(
        lambda x: jnp.stack([x] * B), wbc.Reference.standing(cp, dtype)
    )
    carry = jax.tree.map(lambda x: jnp.stack([x] * B),
                         wbc.init_carry(dtype))
    cache = qpm.make_cache(B, 42, 70, p, dtype)
    # step 1: cold (cache invalid)
    _, carry, cache = wbc.wbc_step_batched(
        model, cp, p, obs, ref, carry, True, "cached", cache, False)
    # step 2: warm everywhere
    _, carry, cache = wbc.wbc_step_batched(
        model, cp, p, obs, ref, carry, True, "cached", cache, True)
    # step 3: scenario 0 lifts a leg (switch EDGE, new reference)
    ref_sw = ref._replace(
        contacts=ref.contacts.at[0, 1].set(0.0))
    _, carry, cache = wbc.wbc_step_batched(
        model, cp, p, obs, ref_sw, carry, True, "cached", cache, True)
    # step 4: no new reference (held switch_flag, no edge)
    _, carry, cache = wbc.wbc_step_batched(
        model, cp, p, obs, ref_sw, carry, False, "cached", cache, True)
    assert not captured[0].any()                      # all cold
    assert captured[1].all()                          # all warm
    assert list(captured[2]) == [False, True, True]   # edge only
    assert captured[3].all()                          # held != edge
    # the held flag is still up for scenario 0 at step 4 (FD zeroing)
    assert bool(carry.switch_flag[0])

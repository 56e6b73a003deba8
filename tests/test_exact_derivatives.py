"""Beyond-reference option: analytic centroidal derivatives (jvp) vs the

reference's finite differences."""
import jax
import jax.numpy as jnp
import numpy as np

from quadrupedwholebodycontroller.config import (
    ControllerParams,
    PlannerParams,
    QPSolverParams,
)
from quadrupedwholebodycontroller.models import anymal_d_model
from quadrupedwholebodycontroller.sim import SimParams, closed_loop_rollout
from quadrupedwholebodycontroller.sim.rollout import init_rollout_carry


def run(cp, T=500):
    dtype = jnp.float64
    model = anymal_d_model(dtype=dtype)
    pp, sp = PlannerParams(), SimParams()
    qp = QPSolverParams()
    carry = init_rollout_carry(model, cp, pp, dtype=dtype)
    cmds = jnp.zeros((T, 3), dtype).at[100:, 0].set(0.5)
    _, tr = jax.jit(
        lambda c, x: closed_loop_rollout(model, cp, pp, qp, sp, c, x)
    )(carry, cmds)
    return jax.tree.map(np.asarray, tr)


def test_exact_derivatives_walk():
    """Exact-derivative walking is stable, QP-clean, and tracks at least as

    well as the reference-faithful FD mode."""
    tr_fd = run(ControllerParams())
    tr_ex = run(ControllerParams(exact_derivatives=True))

    for tr in (tr_fd, tr_ex):
        assert np.all(np.isfinite(tr.com_pos))
        assert tr.com_pos[:, 2].min() > 0.4
        assert tr.qp_kkt.max() < 1e-3

    def track_err(tr):
        e = tr.com_pose[100:, :3] - tr.ref_com_pose[100:, :3]
        return float(np.sqrt((e**2).mean()))

    err_fd, err_ex = track_err(tr_fd), track_err(tr_ex)
    # exact derivatives must not be worse than FD by more than 20%
    assert err_ex <= err_fd * 1.2, (err_fd, err_ex)


def test_exact_epilogue_matches_xla_setup(rng):
    """The fused-setup exact mode via the epilogue (fused FD setup +
    jvp-exact patch, control/wbc._exact_epilogue_batched) reproduces the
    vmapped XLA exact wbc_setup: same QP bounds, h_c, and carried tdot_inv
    (f64)."""
    import quadrupedwholebodycontroller.ops.setup_fused as sku
    from quadrupedwholebodycontroller.control import wbc
    from quadrupedwholebodycontroller.models.anymal import (
        INITIAL_JOINT_POS,
    )

    dtype = jnp.float64
    model = anymal_d_model(dtype=dtype)
    cp = ControllerParams(exact_derivatives=True)
    B = 3
    key = jax.random.PRNGKey(5)
    k1, k2, k3, k4 = jax.random.split(key, 4)
    obs = wbc.RobotObservation(
        base_R=jnp.broadcast_to(jnp.eye(3, dtype=dtype), (B, 3, 3)),
        base_p=jnp.tile(jnp.array([0.0, 0.0, 0.55], dtype), (B, 1))
        + 0.01 * jax.random.normal(k1, (B, 3), dtype),
        base_vel=0.1 * jax.random.normal(k2, (B, 6), dtype),
        q=jnp.tile(jnp.asarray(INITIAL_JOINT_POS, dtype), (B, 1))
        + 0.05 * jax.random.normal(k3, (B, 12), dtype),
        qd=0.2 * jax.random.normal(k4, (B, 12), dtype),
    )
    ref = jax.tree.map(
        lambda x: jnp.stack([x] * B), wbc.Reference.standing(cp, dtype)
    )
    # one leg swinging + a warmed carry (non-trivial FD history and a
    # non-zero stale tdot_inv so the exact-vs-stale delta is exercised)
    ref = ref._replace(
        contacts=ref.contacts.at[:, 1].set(0.0),
        swing_pos=0.1 * jax.random.normal(key, (B, 12), dtype),
    )
    carry0 = jax.tree.map(lambda x: jnp.stack([x] * B), wbc.init_carry(dtype))
    setup_warm = jax.vmap(
        lambda o, r, c: wbc.wbc_setup(model, ControllerParams(), o, r, c, True)
    )(obs, ref, carry0)
    carry = jax.vmap(lambda cu, q: wbc.WBCCarry(qp_warm=q, **cu))(
        setup_warm.carry_updates,
        jax.tree.map(lambda x: jnp.stack([x] * B),
                     wbc.init_carry(dtype)).qp_warm,
    )

    want = jax.vmap(
        lambda o, r, c: wbc.wbc_setup(model, cp, o, r, c, True)
    )(obs, ref, carry)

    out, _ = wbc.wbc_step_batched(
        model, cp, QPSolverParams(), obs, ref, carry, True,
        qp_backend="xla", setup_backend="fused",
    )
    # reproduce the patched setup for the assertions
    sk = sku.setup_batched(model, cp, obs, ref, carry,
                           jnp.ones((B,), bool))
    from quadrupedwholebodycontroller.ops import qp as qpm_

    setup = wbc.WBCSetup(
        qp_data=qpm_.QPData(H=sk["H"], g=sk["g"], A=sk["A"],
                            l=sk["l"], u=sk["u"]),
        h_c=sk["h_c"], Mc_jj=sk["Mc_jj"], Jc_st_j=sk["Jc_st_j"],
        com=sk["com"], current_pose=sk["current_pose"],
        foot_pos=sk["foot_pos"], carry_updates=sk["carry_updates"],
    )
    got, _ = wbc._exact_epilogue_batched(model, cp, obs, carry, setup,
                                         None)

    tol = 1e-8
    finite = np.abs(np.asarray(want.qp_data.l)) < 1e19
    assert np.allclose(np.asarray(got.qp_data.l)[finite],
                       np.asarray(want.qp_data.l)[finite], atol=tol)
    finite = np.abs(np.asarray(want.qp_data.u)) < 1e19
    assert np.allclose(np.asarray(got.qp_data.u)[finite],
                       np.asarray(want.qp_data.u)[finite], atol=tol)
    assert np.allclose(np.asarray(got.h_c), np.asarray(want.h_c), atol=tol)
    assert np.allclose(np.asarray(got.carry_updates["tdot_inv"]),
                       np.asarray(want.carry_updates["tdot_inv"]), atol=tol)


def test_kernel_exact_mode_matches_xla_setup(rng):
    """The fused setup's own exact mode (ops/setup_fused exact_mode=True —
    the tangent propagation carried through the generated unrolled
    recursion) reproduces the vmapped XLA exact wbc_setup: QP bounds, A,
    g, h_c, and the carried tdot_inv (f64)."""
    import quadrupedwholebodycontroller.ops.setup_fused as sku
    from quadrupedwholebodycontroller.control import wbc
    from quadrupedwholebodycontroller.models.anymal import (
        INITIAL_JOINT_POS,
    )

    dtype = jnp.float64
    model = anymal_d_model(dtype=dtype)
    cp = ControllerParams(exact_derivatives=True)
    B = 3
    key = jax.random.PRNGKey(7)
    k1, k2, k3, k4 = jax.random.split(key, 4)
    obs = wbc.RobotObservation(
        base_R=jnp.broadcast_to(jnp.eye(3, dtype=dtype), (B, 3, 3)),
        base_p=jnp.tile(jnp.array([0.0, 0.0, 0.55], dtype), (B, 1))
        + 0.01 * jax.random.normal(k1, (B, 3), dtype),
        base_vel=0.1 * jax.random.normal(k2, (B, 6), dtype),
        q=jnp.tile(jnp.asarray(INITIAL_JOINT_POS, dtype), (B, 1))
        + 0.05 * jax.random.normal(k3, (B, 12), dtype),
        qd=0.2 * jax.random.normal(k4, (B, 12), dtype),
    )
    ref = jax.tree.map(
        lambda x: jnp.stack([x] * B), wbc.Reference.standing(cp, dtype)
    )
    ref = ref._replace(
        contacts=ref.contacts.at[:, 1].set(0.0),
        swing_pos=0.1 * jax.random.normal(key, (B, 12), dtype),
    )
    carry0 = jax.tree.map(lambda x: jnp.stack([x] * B), wbc.init_carry(dtype))
    setup_warm = jax.vmap(
        lambda o, r, c: wbc.wbc_setup(model, ControllerParams(), o, r, c, True)
    )(obs, ref, carry0)
    carry = jax.vmap(lambda cu, q: wbc.WBCCarry(qp_warm=q, **cu))(
        setup_warm.carry_updates, carry0.qp_warm
    )

    want = jax.vmap(
        lambda o, r, c: wbc.wbc_setup(model, cp, o, r, c, True)
    )(obs, ref, carry)
    sk = sku.setup_batched(
        model, cp, obs, ref, carry, jnp.ones((B,), bool), exact_mode=True,
    )

    tol = 1e-8
    pairs = [
        (sk["l"], want.qp_data.l),
        (sk["u"], want.qp_data.u),
        (sk["h_c"], want.h_c),
        (sk["carry_updates"]["tdot_inv"], want.carry_updates["tdot_inv"]),
        (sk["A"], want.qp_data.A),
        (sk["g"], want.qp_data.g),
    ]
    for got, w in pairs:
        got, w = np.asarray(got), np.asarray(w)
        finite = np.abs(w) < 1e19
        assert np.allclose(got[finite], w[finite], atol=tol)

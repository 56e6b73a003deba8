"""Closed-loop integration tests — the framework's analogue of the

reference's de-facto validation (run Gazebo + controller, robot must stand
and walk, QP must never fail; SURVEY.md §4)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from quadrupedwholebodycontroller.config import (
    GRAVITY,
    ControllerParams,
    PlannerParams,
    QPSolverParams,
)
from quadrupedwholebodycontroller.models import anymal_d_model
from quadrupedwholebodycontroller.sim import SimParams, closed_loop_rollout
from quadrupedwholebodycontroller.sim.rollout import init_rollout_carry


def run(dtype, T, walk_after=None, iters=100):
    model = anymal_d_model(dtype=dtype)
    cp, pp, sp = ControllerParams(), PlannerParams(), SimParams()
    qp = QPSolverParams(iterations=iters)
    carry = init_rollout_carry(model, cp, pp, dtype=dtype)
    cmds = jnp.zeros((T, 3), dtype)
    if walk_after is not None:
        cmds = cmds.at[walk_after:, 0].set(0.5)
    fn = jax.jit(lambda c, x: closed_loop_rollout(model, cp, pp, qp, sp, c, x))
    carry, trace = fn(carry, cmds)
    return jax.tree.map(np.asarray, trace)


def test_standing_regulation_f64():
    """Stand for 0.75 s: CoM regulates toward the reference pose, QP solves

    stay tight, GRFs carry the weight (reference success criterion)."""
    tr = run(jnp.float64, 300)
    assert np.all(np.isfinite(tr.com_pos))
    assert tr.qp_kkt.max() < 1e-4
    # CoM rises from the dropped pose toward the 0.5 m reference
    assert tr.com_pos[-1, 2] > tr.com_pos[0, 2]
    assert 0.47 < tr.com_pos[-1, 2] < 0.51
    # pose error shrinking monotonically-ish
    err0 = abs(tr.com_pose[10, 2] - tr.ref_com_pose[10, 2])
    err1 = abs(tr.com_pose[-1, 2] - tr.ref_com_pose[-1, 2])
    assert err1 < err0
    weight = 51.63574 * GRAVITY
    grf_z = tr.grf[-1].reshape(4, 3)[:, 2].sum()
    assert np.isclose(grf_z, weight, rtol=0.05)
    assert np.abs(tr.tau).max() <= 80.0 + 1e-3


def test_walking_f64():
    """Walk 2 s: stays upright, advances, respects torque limits, QP healthy."""
    tr = run(jnp.float64, 800, walk_after=100)
    assert np.all(np.isfinite(tr.com_pos))
    assert tr.qp_kkt.max() < 1e-3
    assert tr.com_pos[:, 2].min() > 0.4      # never collapses
    assert tr.com_pos[-1, 0] > 0.01          # makes forward progress
    assert np.abs(tr.tau).max() <= 80.0 + 1e-3
    # contact schedule reached swing phases
    assert tr.contacts.min() == 0.0


def test_standing_f32():
    """The accelerator dtype: f32 closed loop must remain stable and
    regulated."""
    tr = run(jnp.float32, 300)
    assert np.all(np.isfinite(tr.com_pos))
    assert 0.46 < tr.com_pos[-1, 2] < 0.52
    assert np.abs(tr.tau).max() <= 80.0 + 1e-3
    assert tr.qp_kkt.max() < 1e-1


def test_batched_scenarios():
    """vmapped rollout: one standing and one walking scenario in a batch

    evolve exactly like their single-scenario runs."""
    dtype = jnp.float64
    model = anymal_d_model(dtype=dtype)
    cp, pp, sp = ControllerParams(), PlannerParams(), SimParams()
    qp = QPSolverParams()
    T = 120
    carry = init_rollout_carry(model, cp, pp, dtype=dtype)
    bcarry = jax.tree.map(lambda x: jnp.stack([x, x]), carry)
    cmd_stand = jnp.zeros((T, 3), dtype)
    cmd_walk = cmd_stand.at[40:, 0].set(0.5)
    bcmds = jnp.stack([cmd_stand, cmd_walk])
    bfn = jax.jit(
        jax.vmap(lambda c, x: closed_loop_rollout(model, cp, pp, qp, sp, c, x))
    )
    _, btr = bfn(bcarry, bcmds)
    fn = jax.jit(lambda c, x: closed_loop_rollout(model, cp, pp, qp, sp, c, x))
    _, tr_stand = fn(carry, cmd_stand)
    _, tr_walk = fn(carry, cmd_walk)
    assert np.allclose(np.asarray(btr.com_pos[0]), np.asarray(tr_stand.com_pos), atol=1e-9)
    assert np.allclose(np.asarray(btr.com_pos[1]), np.asarray(tr_walk.com_pos), atol=1e-9)


def test_batched_rollout_matches_vmapped():
    """batched_rollout (xla QP backend) must reproduce vmap(closed_loop_rollout)."""
    from quadrupedwholebodycontroller.planner import gait
    from quadrupedwholebodycontroller.sim.rollout import batched_rollout

    dtype = jnp.float64
    model = anymal_d_model(dtype=dtype)
    cp, pp, sp = ControllerParams(), PlannerParams(), SimParams()
    qp = QPSolverParams()
    B, T = 2, 60
    carry = init_rollout_carry(model, cp, pp, dtype=dtype)
    bcarry = jax.tree.map(lambda x: jnp.stack([x] * B), carry)
    cmds = jnp.zeros((B, T, 3), dtype).at[1, 20:, 0].set(0.5)
    ratio = int(round(cp.loop_rate * pp.dt))

    _, tr_b = jax.jit(
        lambda c, x: batched_rollout(
            model, cp, qp, sp,
            lambda s, cc: gait.planner_step(pp, s, cc),
            ratio, c, x, qp_backend="xla",
        )
    )(bcarry, cmds)
    _, tr_v = jax.jit(
        jax.vmap(lambda c, x: closed_loop_rollout(model, cp, pp, qp, sp, c, x))
    )(bcarry, cmds)
    assert np.allclose(np.asarray(tr_b.com_pos), np.asarray(tr_v.com_pos), atol=1e-9)
    assert np.allclose(np.asarray(tr_b.tau), np.asarray(tr_v.tau), atol=1e-7)

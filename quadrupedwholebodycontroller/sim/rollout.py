"""Closed-loop rollout: planner -> WBC -> physics fused in one lax.scan.

This is the whole reference process graph (motion_planner node + controller
node + Gazebo, launch/whole_body_controller.launch:9-25) collapsed into a
single XLA program: no topic hops, no threads, no races — the asynchronous
400 Hz / 100 Hz coupling is reproduced by ticking the planner every
`control_rate * planner_dt` control steps with zero-order-held references
(last-writer-wins, exactly the ROS queue-size semantics of cpp:49).

The planner is pluggable (static walk — planner/gait.py; trot —
planner/trot.py); vmap over the leading axis of (carry, commands) runs a
scenario batch; shard the batch over a Mesh for multi-chip sweeps
(parallel/).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import jax
import jax.numpy as jnp

from quadrupedwholebodycontroller.config import (
    ControllerParams,
    PlannerParams,
    QPSolverParams,
)
from quadrupedwholebodycontroller.control import wbc
from quadrupedwholebodycontroller.models.robot_model import RobotModel
from quadrupedwholebodycontroller.planner import gait
from quadrupedwholebodycontroller.sim import world


class RolloutCarry(NamedTuple):
    sim: world.SimState
    wbc: wbc.WBCCarry
    planner: Any               # planner-specific state pytree
    ref: wbc.Reference


class RolloutTrace(NamedTuple):
    """Per-control-step log — the rosbag record analogue

    (launch/whole_body_controller.launch:27-35 records joint_states, com,
    command torques, desired GRFs; we record the same signals as arrays)."""

    com_pos: jax.Array     # (T, 3)
    com_pose: jax.Array    # (T, 6)
    base_p: jax.Array      # (T, 3)
    q: jax.Array           # (T, 12)
    tau: jax.Array         # (T, 12)
    grf: jax.Array         # (T, 12)
    foot_pos: jax.Array    # (T, 12)
    ref_com_pose: jax.Array  # (T, 6)
    ref_swing_pos: jax.Array  # (T, 12) planner swing-foot targets (the
                              # marker_publisher.cpp:12-39 sphere channel)
    contacts: jax.Array    # (T, 4)
    qp_kkt: jax.Array      # (T,)


def init_rollout_carry(
    model: RobotModel,
    cparams: ControllerParams,
    pparams: PlannerParams | None = None,
    dtype=jnp.float32,
    z_offset: float = 0.05,
    planner_state: Any = None,
) -> RolloutCarry:
    """Start from the reference's reset pose: hard-coded joint angles, base at

    the reference z + offset, zero velocity (resetRobotSimState, cpp:579-606).
    Pass planner_state to use a non-default planner (e.g. trot)."""
    from quadrupedwholebodycontroller.models.anymal import INITIAL_JOINT_POS

    base_p = jnp.asarray(
        [
            cparams.initial_reference_pose[0],
            cparams.initial_reference_pose[1],
            cparams.initial_reference_pose[2] + z_offset,
        ],
        dtype,
    )
    if planner_state is None:
        planner_state = gait.init_planner_state(pparams or PlannerParams(), dtype)
    return RolloutCarry(
        sim=world.init_sim_state(model, base_p, jnp.asarray(INITIAL_JOINT_POS, dtype), dtype),
        wbc=wbc.init_carry(dtype),
        planner=planner_state,
        ref=wbc.Reference.standing(cparams, dtype),
    )


def rollout(
    model: RobotModel,
    cparams: ControllerParams,
    qparams: QPSolverParams,
    sparams: world.SimParams,
    planner_fn: Callable,  # (state, cmd) -> (state, Reference, published)
    planner_ratio: int,    # control steps per planner tick
    carry: RolloutCarry,
    commands,              # (T, 3) [vx, vy, yaw_rate] per control step
    scenario=None,         # sim/scenario.py Scenario (world perturbations)
    sim_model: RobotModel | None = None,  # perturbed model for the PHYSICS
):
    """Run T control steps with an arbitrary ticked planner.

    The controller always uses the nominal `model`; pass `sim_model` (e.g.
    with a payload, scenario.apply_payload) to simulate model mismatch."""
    if sim_model is None:
        sim_model = model
    friction = scenario.sim_friction if scenario is not None else None

    def step(carry: RolloutCarry, xs):
        k, cmd, push = xs
        tick = (k % planner_ratio) == 0

        def do_tick(args):
            pstate, ref = args
            pstate, new_ref, published = planner_fn(pstate, cmd)
            ref = jax.tree.map(lambda n, o: jnp.where(published, n, o), new_ref, ref)
            return pstate, ref, published

        def no_tick(args):
            pstate, ref = args
            return pstate, ref, jnp.asarray(False)

        pstate, ref, ref_is_new = jax.lax.cond(
            tick, do_tick, no_tick, (carry.planner, carry.ref)
        )

        obs = world.observe(carry.sim)
        out, wcarry = wbc.wbc_step(
            model, cparams, qparams, obs, ref, carry.wbc, ref_is_new
        )
        sim = world.sim_control_period(
            sim_model, carry.sim, out.tau, sparams, friction, push
        )

        trace = RolloutTrace(
            com_pos=out.com_pos,
            com_pose=out.com_pose,
            base_p=carry.sim.base_p,
            q=carry.sim.q,
            tau=out.tau,
            grf=out.grf,
            foot_pos=out.foot_pos,
            ref_com_pose=ref.com_pose,
            ref_swing_pos=ref.swing_pos,
            contacts=ref.contacts,
            qp_kkt=out.qp_info.kkt_residual,
        )
        return RolloutCarry(sim=sim, wbc=wcarry, planner=pstate, ref=ref), trace

    T = commands.shape[0]
    ks = jnp.arange(T, dtype=jnp.int32)
    pushes = (
        scenario.push_wrench
        if scenario is not None
        else jnp.zeros((T, 6), commands.dtype)
    )
    return jax.lax.scan(step, carry, (ks, commands, pushes))


def batched_rollout(
    model: RobotModel,
    cparams: ControllerParams,
    qparams: QPSolverParams,
    sparams: world.SimParams,
    planner_fn: Callable,
    planner_ratio: int,
    carry: RolloutCarry,      # batched (leading axis B on every leaf)
    commands,                 # (B, T, 3)
    scenario=None,            # batched Scenario or None
    sim_model: RobotModel | None = None,  # batched arrays or None
    qp_backend: str = "cached",
):
    """Batch-axis-inside rollout: one lax.scan over time, with the QP solved

    batch-level each step (wbc_step_batched) so the cached chain and the
    carried factorization cache apply — the fast path for scenario sweeps.
    Returns (carry, trace) with trace leaves shaped (B, T, ...)."""
    from quadrupedwholebodycontroller.ops.qp import make_cache
    from quadrupedwholebodycontroller.config import (
        QP_NUM_CONSTRAINTS,
        QP_NUM_VARS,
    )

    B, T = commands.shape[0], commands.shape[1]
    dtype = commands.dtype
    if sim_model is None:
        sim_arrays = None
    else:
        sim_arrays = sim_model
    friction = scenario.sim_friction if scenario is not None else None
    pushes_tm = (
        jnp.swapaxes(scenario.push_wrench, 0, 1)
        if scenario is not None
        else jnp.zeros((T, B, 6), dtype)
    )
    commands_tm = jnp.swapaxes(commands, 0, 1)
    # make_cache (not QPCache.zeros) so the B == n / B == m layout-ambiguity
    # guard applies here like every other caller
    cache0 = make_cache(B, QP_NUM_VARS, QP_NUM_CONSTRAINTS, qparams, dtype)

    def step(sc, xs):
        carry, cache, cache_valid, alive = sc
        k, cmd, push = xs
        tick = (k % planner_ratio) == 0

        def do_tick(args):
            pstate, ref = args
            pstate, new_ref, published = jax.vmap(planner_fn)(pstate, cmd)
            ref = jax.tree.map(
                lambda n, o: jnp.where(
                    published.reshape((-1,) + (1,) * (n.ndim - 1)), n, o
                ),
                new_ref, ref,
            )
            return pstate, ref, published

        def no_tick(args):
            pstate, ref = args
            return pstate, ref, jnp.zeros((B,), bool)

        pstate, ref, ref_is_new = jax.lax.cond(
            tick, do_tick, no_tick, (carry.planner, carry.ref)
        )

        obs = jax.vmap(world.observe)(carry.sim)
        out, wcarry, cache = wbc.wbc_step_batched(
            model, cparams, qparams, obs, ref, carry.wbc, ref_is_new,
            qp_backend, cache, cache_valid,
        )
        fric_arr = (
            friction if friction is not None
            else jnp.full((B,), sparams.friction, dtype)
        )
        if sim_arrays is None:
            sim = jax.vmap(
                lambda s, t, f, p: world.sim_control_period(
                    model, s, t, sparams, f, p
                )
            )(carry.sim, out.tau, fric_arr, push)
        else:
            sim = jax.vmap(
                lambda m, s, t, f, p: world.sim_control_period(
                    m, s, t, sparams, f, p
                )
            )(sim_arrays, carry.sim, out.tau, fric_arr, push)

        # scenario termination: once a robot has fallen (or its state went
        # non-finite — there is no body-ground collision model) freeze it so
        # it cannot NaN-poison the batch (the per-scenario analogue of the
        # reference's QP-failure abort, but without killing the batch)
        finite = jnp.all(jnp.isfinite(sim.u), axis=-1) & jnp.all(
            jnp.isfinite(sim.base_p), axis=-1
        )
        sane = (
            (out.com_pos[:, 2] > 0.2)
            & (out.com_pos[:, 2] < 2.0)          # launched airborne = diverged
            & (jnp.max(jnp.abs(sim.u), axis=-1) < 50.0)
        )
        alive_new = alive & sane & finite

        def freeze(new, old):
            mask = alive_new.reshape((-1,) + (1,) * (new.ndim - 1))
            return jnp.where(mask, new, old)

        sim = jax.tree.map(freeze, sim, carry.sim)
        wcarry = jax.tree.map(freeze, wcarry, carry.wbc)

        trace = RolloutTrace(
            com_pos=out.com_pos,
            com_pose=out.com_pose,
            base_p=carry.sim.base_p,
            q=carry.sim.q,
            tau=jnp.where(alive_new[:, None], out.tau, 0.0),
            grf=out.grf,
            foot_pos=out.foot_pos,
            ref_com_pose=ref.com_pose,
            ref_swing_pos=ref.swing_pos,
            contacts=ref.contacts,
            qp_kkt=jnp.where(alive_new, out.qp_info.kkt_residual, 0.0),
        )
        new_c = RolloutCarry(sim=sim, wbc=wcarry, planner=pstate, ref=ref)
        return (new_c, cache, jnp.asarray(True), alive_new), trace

    ks = jnp.arange(T, dtype=jnp.int32)
    alive0 = jnp.ones((B,), bool)
    (carry, _, _, alive), trace_tm = jax.lax.scan(
        step,
        (carry, cache0, jnp.asarray(False), alive0),
        (ks, commands_tm, pushes_tm),
    )
    trace = jax.tree.map(lambda x: jnp.swapaxes(x, 0, 1), trace_tm)
    return carry, trace


def closed_loop_rollout(
    model: RobotModel,
    cparams: ControllerParams,
    pparams: PlannerParams,
    qparams: QPSolverParams,
    sparams: world.SimParams,
    carry: RolloutCarry,
    commands,
    scenario=None,
    sim_model: RobotModel | None = None,
):
    """Static-walk closed loop (the reference's configuration)."""
    ratio = int(round(cparams.loop_rate * pparams.dt))
    return rollout(
        model, cparams, qparams, sparams,
        lambda s, c: gait.planner_step(pparams, s, c),
        ratio, carry, commands, scenario, sim_model,
    )


def trot_rollout(
    model: RobotModel,
    cparams: ControllerParams,
    tparams,  # planner.trot.TrotParams
    qparams: QPSolverParams,
    sparams: world.SimParams,
    carry: RolloutCarry,
    commands,
    scenario=None,
    sim_model: RobotModel | None = None,
):
    """Trot closed loop (planner ticked every control step)."""
    from quadrupedwholebodycontroller.planner import trot

    ratio = max(1, int(round(cparams.loop_rate * tparams.dt)))
    return rollout(
        model, cparams, qparams, sparams,
        lambda s, c: trot.trot_step(tparams, s, c),
        ratio, carry, commands, scenario, sim_model,
    )

"""Trotting gait generator: alternating diagonal-pair 2-contact phases.

The reference ships only a static walk (src/motion_planner.cpp); trot is the
second gait family required of the framework (BASELINE.json configs:
"Trotting gait: alternating 2-contact QPs with base pose + CoM tracking at
full control rate").  Built from the same primitives as the walk (cubic
Bezier swing splines with quintic time scaling — planner/gait.py) arranged
as a two-beat gait:

  phase A: LF + RH swing  (legs 1, 3 in LH,LF,RF,RH order)
  phase B: LH + RF swing  (legs 0, 2)

with a Raibert-style foothold: the swing target leads the nominal hip
position by v * T_step / 2 (+ a yaw-rotation correction), so the gait
tracks velocity commands without integrating foot drift.  The body
reference advances continuously at the commanded velocity (no per-cycle
lag like the static walk).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp

from quadrupedwholebodycontroller.control.wbc import Reference
from quadrupedwholebodycontroller.planner.gait import (
    _bezier,
    _quintic,
    _quintic_eval,
    _rotz,
)

# diagonal pairs: phase 0 swings (LF, RH); phase 1 swings (LH, RF)
PAIR_MASKS = (
    (1.0, 0.0, 1.0, 0.0),  # contacts during phase 0
    (0.0, 1.0, 0.0, 1.0),  # contacts during phase 1
)


@dataclasses.dataclass(frozen=True)
class TrotParams:
    step_duration: float = 0.25     # one swing phase
    height_control_point: float = 0.08
    x_offset: float = 0.36          # nominal foot x (tighter than walk stance)
    y_offset: float = 0.28
    body_height: float = 0.50
    dt: float = 0.0025              # planner ticked at the control rate
    stand_ticks: int = 40           # initial double-stance settle ticks


class TrotState(NamedTuple):
    tick: jax.Array       # () int32 global tick
    phase: jax.Array      # () int32 0/1
    phase_tick: jax.Array  # () int32 tick within phase
    yaw: jax.Array        # ()
    body_xy: jax.Array    # (2,) integrated body position
    foot_ground: jax.Array  # (4, 3) current stance location of each foot
    pi_foot: jax.Array    # (4, 3) swing start points
    pf_foot: jax.Array    # (4, 3) swing targets
    ref: Reference


def _nominal_feet(params: TrotParams, dtype):
    x, y = params.x_offset, params.y_offset
    return jnp.asarray(
        [[-x, y, 0.0], [x, y, 0.0], [x, -y, 0.0], [-x, -y, 0.0]], dtype
    )  # LH, LF, RF, RH


def init_trot_state(params: TrotParams, dtype=jnp.float32) -> TrotState:
    feet = _nominal_feet(params, dtype)
    z = jnp.zeros
    ref = Reference(
        com_pose=jnp.array([0, 0, params.body_height, 0, 0, 0], dtype),
        com_vel=z(6, dtype), com_acc=z(6, dtype),
        swing_pos=feet.reshape(12), swing_vel=z(12, dtype), swing_acc=z(12, dtype),
        contacts=jnp.ones(4, dtype),
    )
    i32 = lambda v: jnp.asarray(v, jnp.int32)
    return TrotState(
        tick=i32(0), phase=i32(0), phase_tick=i32(0),
        yaw=jnp.zeros((), dtype), body_xy=z(2, dtype),
        foot_ground=feet, pi_foot=feet, pf_foot=feet, ref=ref,
    )


def trot_step(params: TrotParams, state: TrotState, cmd):
    """One planner tick at params.dt.  cmd: (3,) [vx, vy, yaw_rate].

    Returns (new_state, Reference, published=True)."""
    dtype = state.yaw.dtype
    steps_per_phase = int(round(params.step_duration / params.dt))
    active = jnp.any(cmd != 0.0)
    standing_done = state.tick >= params.stand_ticks

    v_cmd = jnp.array([cmd[0], cmd[1], 0.0], dtype)
    v_world = _rotz(state.yaw) @ v_cmd
    yaw_rate = cmd[2].astype(dtype)

    # ---- phase bookkeeping ----
    trotting = active & standing_done
    phase_tick = state.phase_tick
    phase = state.phase
    boundary = trotting & (phase_tick >= steps_per_phase)

    def new_targets(st):
        """At a phase boundary: the pair that just swung lands at its target;

        the new swing pair starts from its recorded ground position and aims
        at a Raibert foothold around the predicted mid-stance body pose."""
        old_swing = 1.0 - jnp.asarray(PAIR_MASKS, dtype)[st.phase]  # (4,)
        ground = jnp.where(old_swing[:, None] > 0, st.pf_foot, st.foot_ground)
        nom = _nominal_feet(params, dtype)
        rot = _rotz(st.yaw)
        lead = (rot @ v_cmd) * params.step_duration
        body_next = jnp.concatenate(
            [st.body_xy + v_world[:2] * params.step_duration, jnp.zeros(1, dtype)]
        )
        targets = (
            body_next[None, :]
            + jnp.einsum("ij,fj->fi", rot, nom)
            + lead[None, :] * 0.5
        ).at[:, 2].set(0.0)
        return st._replace(foot_ground=ground, pi_foot=ground, pf_foot=targets)

    state = jax.lax.cond(boundary, new_targets, lambda s: s, state)
    phase = jnp.where(boundary, 1 - phase, phase)
    phase_tick = jnp.where(boundary, 0, phase_tick)

    # ---- swing trajectories ----
    t_phase = phase_tick.astype(dtype) * params.dt
    poly = _quintic(params.step_duration, 0.0, 0.0, dtype)
    s, sd, sdd = _quintic_eval(poly, t_phase)
    pos, d1, d2 = _bezier(s, state.pi_foot, state.pf_foot, params.height_control_point)
    vel = d1 * sd
    acc = d2 * sd * sd + d1 * sdd

    contacts = jnp.where(
        trotting, jnp.asarray(PAIR_MASKS, dtype)[phase], jnp.ones(4, dtype)
    )
    swing_mask = jnp.repeat(1.0 - contacts, 3)
    swing_pos = jnp.where(swing_mask > 0, pos.reshape(12), state.ref.swing_pos)
    swing_vel = jnp.where(swing_mask > 0, vel.reshape(12), 0.0)
    swing_acc = jnp.where(swing_mask > 0, acc.reshape(12), 0.0)

    # ---- body reference: continuous velocity tracking ----
    body_xy = jnp.where(trotting, state.body_xy + v_world[:2] * params.dt, state.body_xy)
    yaw = jnp.where(trotting, state.yaw + yaw_rate * params.dt, state.yaw)
    com_pose = jnp.concatenate(
        [body_xy, jnp.asarray([params.body_height], dtype), jnp.zeros(2, dtype), yaw[None]]
    )
    com_vel = jnp.where(
        trotting,
        jnp.concatenate([v_world, jnp.zeros(2, dtype), yaw_rate[None]]),
        jnp.zeros(6, dtype),
    )

    ref = Reference(
        com_pose=com_pose, com_vel=com_vel, com_acc=jnp.zeros(6, dtype),
        swing_pos=swing_pos, swing_vel=swing_vel, swing_acc=swing_acc,
        contacts=contacts,
    )
    new_state = TrotState(
        tick=state.tick + 1,
        phase=phase,
        phase_tick=jnp.where(trotting, phase_tick + 1, phase_tick),
        yaw=yaw, body_xy=body_xy,
        foot_ground=state.foot_ground,
        pi_foot=state.pi_foot, pf_foot=state.pf_foot,
        ref=ref,
    )
    return new_state, ref, jnp.asarray(True)

"""Static-walk gait / reference generator.

Re-designs the reference motion_planner node (src/motion_planner.cpp) as a
pure per-tick state machine: cubic Bezier swing-foot splines with quintic
time scaling, a linear body path, and the LH -> RH -> LF -> RF step cycle.
The blocking two-level loop of the reference (outer cycle loop + inner
4-phase loop, cpp:180-376) becomes an explicit 3-mode machine so one tick ==
one 100 Hz planner period, including the reference's non-publishing ticks
(phase transitions consume one tick, cpp:348-352; the cycle boundary consumes
one extra outer-loop tick, cpp:356-374) — so reference message timing is
reproduced exactly.

Everything is traced JAX (lax.switch over modes); vmap over scenarios gives
per-scenario independent gaits.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from quadrupedwholebodycontroller.config import PlannerParams
from quadrupedwholebodycontroller.control.wbc import Reference

# modes
IDLE = 0      # standing still (publishes stand reference, cpp:369-372)
WALKING = 1   # inside a 4-phase cycle
CYCLE_GAP = 2  # the outer-loop tick between cycles (no publish)

# step phase -> swinging leg index in LH,LF,RF,RH order
# (phase order LH, RH, LF, RF — cpp:184,248-300)
PHASE_LEG = (0, 3, 1, 2)
# contact masks per phase (cpp:259,272,285,298)
PHASE_CONTACTS = (
    (0.0, 1.0, 1.0, 1.0),
    (1.0, 1.0, 1.0, 0.0),
    (1.0, 0.0, 1.0, 1.0),
    (1.0, 1.0, 0.0, 1.0),
)


class PlannerState(NamedTuple):
    mode: jax.Array           # () int32
    phase: jax.Array          # () int32 0..3
    step_ticks: jax.Array     # () int32 publishes so far in this phase
    cycle_ticks: jax.Array    # () int32 publishes so far in this cycle
    cycle_counter: jax.Array  # () int32
    yaw: jax.Array            # ()
    v_rot: jax.Array          # (3,) rotated velocity captured at cycle start
    pi_body: jax.Array        # (3,)
    pf_body: jax.Array        # (3,)
    pi_foot: jax.Array        # (4, 3) LH, LF, RF, RH
    pf_foot: jax.Array        # (4, 3)
    ref: Reference            # persistent message contents (cpp ref_msg_)


def _quintic(T, vi, vf, dtype):
    """Coefficients (a0..a5) of the reference's quintic time scaling

    s(0)=0, s(T)=1, s'(0)=vi, s'(T)=vf, s''(0)=s''(T)=0
    (generateQuinticPolynomial, cpp:76-97)."""
    T = jnp.asarray(T, dtype)
    a3 = (10.0 - 4.0 * vf * T - 6.0 * vi * T) / T**3
    a4 = (-15.0 + 7.0 * vf * T + 8.0 * vi * T) / T**4
    a5 = (6.0 - 3.0 * vf * T - 3.0 * vi * T) / T**5
    return (
        jnp.zeros((), dtype), jnp.asarray(vi, dtype), jnp.zeros((), dtype),
        a3, a4, a5,
    )


def _quintic_eval(coeffs, t):
    a0, a1, a2, a3, a4, a5 = coeffs
    s = a0 + a1 * t + a2 * t**2 + a3 * t**3 + a4 * t**4 + a5 * t**5
    sd = a1 + 2 * a2 * t + 3 * a3 * t**2 + 4 * a4 * t**3 + 5 * a5 * t**4
    sdd = 2 * a2 + 6 * a3 * t + 12 * a4 * t**2 + 20 * a5 * t**3
    return s, sd, sdd


def _bezier(s, pi, pf, h):
    """Cubic Bezier with control points (pi, pi+h z, pf+h z, pf) and its s-

    derivatives (cpp:4-52).  pi/pf: (..., 3)."""
    vert = jnp.zeros_like(pi).at[..., 2].set(h)
    p0, p1, p2, p3 = pi, pi + vert, pf + vert, pf
    om = 1.0 - s
    pos = om**3 * p0 + 3 * om**2 * s * p1 + 3 * om * s**2 * p2 + s**3 * p3
    d1 = 3.0 * (om**2 * (p1 - p0) + 2 * om * s * (p2 - p1) + s**2 * (p3 - p2))
    d2 = 6.0 * (om * (p2 - 2 * p1 + p0) + s * (p3 - 2 * p2 + p1))
    return pos, d1, d2


def _rotz(a):
    c, s = jnp.cos(a), jnp.sin(a)
    z, o = jnp.zeros_like(a), jnp.ones_like(a)
    return jnp.stack(
        [
            jnp.stack([c, -s, z], -1),
            jnp.stack([s, c, z], -1),
            jnp.stack([z, z, o], -1),
        ],
        -2,
    )


def init_planner_state(params: PlannerParams, dtype=jnp.float32) -> PlannerState:
    """Initial state mirroring the MotionPlanner constructor (cpp:129-177)."""
    pi_body = jnp.array([0.0, 0.0, params.body_height], dtype)
    lh = jnp.array([-params.x_offset, params.y_offset, 0.0], dtype)
    lf = lh + jnp.array([2 * params.x_offset, 0.0, 0.0], dtype)
    rf = lh + jnp.array([2 * params.x_offset, -2 * params.y_offset, 0.0], dtype)
    rh = lh + jnp.array([0.0, -2 * params.y_offset, 0.0], dtype)
    feet = jnp.stack([lh, lf, rf, rh])
    z = jnp.zeros
    ref = Reference(
        com_pose=jnp.array([0, 0, params.body_height, 0, 0, 0], dtype),
        com_vel=z(6, dtype), com_acc=z(6, dtype),
        swing_pos=z(12, dtype), swing_vel=z(12, dtype), swing_acc=z(12, dtype),
        contacts=jnp.ones(4, dtype),
    )
    i32 = lambda v: jnp.asarray(v, jnp.int32)
    return PlannerState(
        mode=i32(IDLE), phase=i32(0), step_ticks=i32(0), cycle_ticks=i32(0),
        cycle_counter=i32(0), yaw=jnp.zeros((), dtype),
        v_rot=z(3, dtype), pi_body=pi_body, pf_body=pi_body,
        pi_foot=feet, pf_foot=feet, ref=ref,
    )


def _cycle_start(state: PlannerState, cmd, params: PlannerParams) -> PlannerState:
    """Beginning-of-cycle foot-target advance (cpp:201-224)."""
    dtype = state.yaw.dtype
    v_cmd = jnp.array([cmd[0], cmd[1], 0.0], dtype)
    v_rot = _rotz(state.yaw) @ v_cmd
    delta_yaw = cmd[2] * params.cycle_duration
    rot_d = _rotz(jnp.asarray(delta_yaw, dtype))
    vec = (state.pi_foot - state.pi_body) * jnp.array([1.0, 1.0, 0.0], dtype)
    direction_new = (rot_d @ vec[..., None])[..., 0] - vec
    pf_foot = state.pf_foot + v_rot * params.step_length + direction_new
    return state._replace(
        v_rot=v_rot, pf_foot=pf_foot,
        phase=jnp.asarray(0, jnp.int32),
        step_ticks=jnp.asarray(0, jnp.int32),
        cycle_ticks=jnp.asarray(0, jnp.int32),
        mode=jnp.asarray(WALKING, jnp.int32),
    )


def _publish_tick(state: PlannerState, cmd, params: PlannerParams):
    """One publishing tick inside a step phase (cpp:227-347)."""
    dtype = state.yaw.dtype
    t_step = state.step_ticks.astype(dtype) * params.dt
    t_cycle = state.cycle_ticks.astype(dtype) * params.dt

    foot_poly = _quintic(params.step_duration, 0.0, 0.0, dtype)
    s, sd, sdd = _quintic_eval(foot_poly, t_step)

    # all four bezier curves (cpp:231-246); only the active leg's slots update
    pos, d1, d2 = _bezier(s, state.pi_foot, state.pf_foot, params.height_control_point)
    vel = d1 * sd
    acc = d2 * sd * sd + d1 * sdd

    leg = jnp.asarray(PHASE_LEG, jnp.int32)[state.phase]
    leg_mask = (jnp.arange(4) == leg).astype(dtype)  # (4,)
    m12 = jnp.repeat(leg_mask, 3)
    swing_pos = jnp.where(m12 > 0, pos.reshape(12), state.ref.swing_pos)
    swing_vel = jnp.where(m12 > 0, vel.reshape(12), state.ref.swing_vel)
    swing_acc = jnp.where(m12 > 0, acc.reshape(12), state.ref.swing_acc)
    contacts = jnp.asarray(PHASE_CONTACTS, dtype)[state.phase]

    # body reference (cpp:306-341)
    start_poly = _quintic(params.cycle_duration, 0.0, params.body_final_velocity, dtype)
    cont_poly = _quintic(
        params.cycle_duration, params.body_final_velocity, params.body_final_velocity, dtype
    )
    first = state.cycle_counter == 0
    sb, sbd, sbdd = jax.tree.map(
        lambda a, b: jnp.where(first, a, b),
        _quintic_eval(start_poly, t_cycle),
        _quintic_eval(cont_poly, t_cycle),
    )
    seg = state.pf_body - state.pi_body
    body_pos = state.pi_body + sb * seg
    body_vel = seg * sbd
    body_acc = seg * sbdd

    yaw_rate = cmd[2].astype(dtype)
    ref = Reference(
        com_pose=jnp.concatenate(
            [body_pos, jnp.zeros(2, dtype), state.yaw[None]]
        ),
        com_vel=jnp.concatenate([body_vel, jnp.zeros(2, dtype), yaw_rate[None]]),
        com_acc=jnp.concatenate([body_acc, jnp.zeros(3, dtype)]),
        swing_pos=swing_pos, swing_vel=swing_vel, swing_acc=swing_acc,
        contacts=contacts,
    )
    new_state = state._replace(
        ref=ref,
        yaw=state.yaw + yaw_rate * params.dt,
        step_ticks=state.step_ticks + 1,
        cycle_ticks=state.cycle_ticks + 1,
    )
    return new_state, jnp.asarray(True)


def _transition_tick(state: PlannerState, params: PlannerParams):
    """Non-publishing phase-advance tick (cpp:348-352) and cycle end

    (cpp:356-367)."""
    phase = state.phase + 1
    done = phase >= 4

    def end_cycle(st):
        return st._replace(
            cycle_counter=st.cycle_counter + 1,
            phase=jnp.asarray(0, jnp.int32),
            cycle_ticks=jnp.asarray(0, jnp.int32),
            pi_body=st.pf_body,
            pf_body=st.pf_body + st.v_rot * params.step_length,
            pi_foot=st.pf_foot,
            mode=jnp.asarray(CYCLE_GAP, jnp.int32),
        )

    state = state._replace(phase=jnp.where(done, state.phase, phase),
                           step_ticks=jnp.asarray(0, jnp.int32))
    state = jax.lax.cond(done, end_cycle, lambda s: s, state)
    return state, jnp.asarray(False)


def planner_step(params: PlannerParams, state: PlannerState, cmd):
    """One 100 Hz planner tick.

    cmd: (3,) [vx, vy, yaw_rate] (the /cmd_vel Twist, cpp:122-127).
    Returns (new_state, Reference, published: bool) — `published` mirrors
    whether the reference node emitted a message this tick."""
    active = jnp.any(cmd != 0.0)

    def idle(st):
        def start(s):
            s2 = _cycle_start(s, cmd, params)
            return _publish_tick(s2, cmd, params)

        def stand(s):
            ref = s.ref._replace(contacts=jnp.ones(4, s.yaw.dtype))
            s = s._replace(ref=ref)
            return s, jnp.asarray(True)

        return jax.lax.cond(active, start, stand, st)

    def walking(st):
        steps_per_phase = int(round(params.step_duration / params.dt))
        return jax.lax.cond(
            st.step_ticks < steps_per_phase,
            lambda s: _publish_tick(s, cmd, params),
            lambda s: _transition_tick(s, params),
            st,
        )

    def gap(st):
        # the outer-loop tick after a cycle: no publish; next tick either
        # starts a new cycle or returns to standing
        return st._replace(mode=jnp.asarray(IDLE, jnp.int32)), jnp.asarray(False)

    state, published = jax.lax.switch(state.mode, [idle, walking, gap], state)
    return state, state.ref, published

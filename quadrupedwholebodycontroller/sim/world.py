"""On-device physics: floating-base forward dynamics + ground contact.

Replaces Gazebo + ros_control (reference launch/spawn.launch:32-72,
config/controllers.yaml) as the closed-loop scenario simulator: the same
dynamics engine used by the controller, run forward with a penalty-based
ground contact model and a semi-implicit Euler integrator, entirely inside
one XLA program (lax.scan over substeps).  vmap gives batched worlds.

Contact model: per-foot spring-damper normal force plus *anchored-spring*
tangential friction — each foot in contact drags a tangential anchor point;
the spring to the anchor provides true static friction, and the anchor is
re-projected onto the friction cone when sliding (the classic ODE/Gazebo
stick-slip formulation).  A velocity-regularized Coulomb force is NOT used:
its effective damping mu*Fz/eps is orders of magnitude too stiff for an
explicit integrator at these time steps.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp

from quadrupedwholebodycontroller.config import NUM_JOINTS
from quadrupedwholebodycontroller.models.robot_model import RobotModel
from quadrupedwholebodycontroller.ops import dynamics as D
from quadrupedwholebodycontroller.ops import kinematics as K
from quadrupedwholebodycontroller.ops import spatial
from quadrupedwholebodycontroller.ops.linalg import full_precision as _full_precision


@dataclasses.dataclass(frozen=True)
class SimParams:
    substeps: int = 8           # physics substeps per control period
    control_dt: float = 1.0 / 400.0
    contact_stiffness: float = 40000.0   # N/m, normal penalty spring
    contact_damping: float = 1500.0      # N s/m, normal damper
    tangential_stiffness: float = 20000.0  # N/m, anchor spring
    tangential_damping: float = 300.0      # N s/m
    friction: float = 1.0       # matches config/params_controller.yaml:2
    joint_damping: float = 0.1  # N m s/rad, actuator back-EMF proxy

    @property
    def dt(self) -> float:
        return self.control_dt / self.substeps


class SimState(NamedTuple):
    base_R: jax.Array  # (3, 3)
    base_p: jax.Array  # (3,)
    q: jax.Array       # (12,)
    u: jax.Array       # (18,) mixed velocity [v_base; omega; qdot]
    anchor: jax.Array  # (4, 2) tangential friction anchors (world xy)


def init_sim_state(model: RobotModel, base_p, q, dtype=jnp.float32) -> SimState:
    kin = K.forward_kinematics(
        model, jnp.eye(3, dtype=dtype), jnp.asarray(base_p, dtype), jnp.asarray(q, dtype)
    )
    return SimState(
        base_R=jnp.eye(3, dtype=dtype),
        base_p=jnp.asarray(base_p, dtype),
        q=jnp.asarray(q, dtype),
        u=jnp.zeros(6 + NUM_JOINTS, dtype),
        anchor=kin.frame_p[:, :2],
    )


def observe(state: SimState):
    """SimState -> RobotObservation (the model_states/joint_states feed)."""
    from quadrupedwholebodycontroller.control.wbc import RobotObservation

    return RobotObservation(
        base_R=state.base_R,
        base_p=state.base_p,
        base_vel=state.u[:6],
        q=state.q,
        qd=state.u[6:],
    )


def _contact_forces(model, kin, u, anchor, params: SimParams, friction=None):
    """Returns ((4,3) world GRFs at the feet, (4,2) updated anchors)."""
    if friction is None:
        friction = params.friction
    foot_p = kin.frame_p                       # (4, 3)
    foot_v = K.frame_velocities(model, kin, u)[:, :3]
    pen = -foot_p[:, 2]                        # penetration depth (>0 below ground)
    in_contact = pen > 0.0
    fz = params.contact_stiffness * pen - params.contact_damping * foot_v[:, 2]
    fz = jnp.where(in_contact, jnp.maximum(fz, 0.0), 0.0)

    xy = foot_p[:, :2]
    raw = -params.tangential_stiffness * (xy - anchor) - params.tangential_damping * foot_v[:, :2]
    cap = friction * fz
    raw_norm = jnp.sqrt(jnp.sum(raw * raw, axis=1) + 1e-12)
    scale = jnp.minimum(1.0, cap / raw_norm)
    ft = raw * scale[:, None] * in_contact[:, None]
    # anchor update: out of contact -> follow the foot; sliding -> re-project
    # so the spring term alone equals the capped force
    slip_anchor = xy + (ft + params.tangential_damping * foot_v[:, :2]) / params.tangential_stiffness
    new_anchor = jnp.where(
        in_contact[:, None],
        jnp.where((scale < 1.0)[:, None], slip_anchor, anchor),
        xy,
    )
    return jnp.concatenate([ft, fz[:, None]], axis=1), new_anchor


def _substep(model, state: SimState, tau, params: SimParams, friction=None,
             push_wrench=None, minv=None):
    kin = K.forward_kinematics(model, state.base_R, state.base_p, state.q)
    J_feet = K.frame_jacobians(model, kin)[:, :3, :]   # (4, 3, 18)
    f, anchor = _contact_forces(model, kin, state.u, state.anchor, params, friction)
    tau_contact = jnp.einsum("fij,fi->j", J_feet, f)
    # actuator saturation at the URDF effort limits — the Gazebo effort
    # interface clamps commands the same way (urdf/anymal.urdf +-80 N m)
    tau = jnp.clip(tau, -model.joint_effort, model.joint_effort)
    tau_gen = jnp.concatenate(
        [jnp.zeros(6, tau.dtype), tau - params.joint_damping * state.u[6:]]
    )
    if push_wrench is not None:
        # external wrench applied at the base origin (mixed coordinates:
        # its generalized force is just the first six entries)
        tau_gen = tau_gen.at[:6].add(push_wrench)
    udot = D.forward_dynamics(
        model, state.base_R, state.base_p, state.q, state.u,
        tau_gen + tau_contact, minv=minv,
    )
    # semi-implicit Euler: update velocity first, integrate pose with new u
    u_new = state.u + params.dt * udot
    Rdot, pdot, qdot = K.state_flow(state.base_R, state.base_p, state.q, u_new)
    base_R = spatial.orthonormalize(state.base_R + params.dt * Rdot)
    return SimState(
        base_R=base_R,
        base_p=state.base_p + params.dt * pdot,
        q=state.q + params.dt * qdot,
        u=u_new,
        anchor=anchor,
    )


@_full_precision
def sim_control_period(model: RobotModel, state: SimState, tau, params: SimParams,
                       friction=None, push_wrench=None):
    """Advance one control period (ZOH torque) with `substeps` physics steps.

    friction / push_wrench are optional traced per-scenario perturbations
    (sim/scenario.py).

    On accelerators the mass-matrix inverse is computed once per control
    period (2.5 ms — M barely moves) and applied with per-substep iterative
    refinement against the current M, amortizing the matmul-only inverse
    over the substeps; on CPU the exact LAPACK solve is cheap per substep."""
    if jax.default_backend() == "cpu":
        minv = None
    else:
        from quadrupedwholebodycontroller.ops import dynamics as _D
        from quadrupedwholebodycontroller.ops.linalg import spd_inv18

        kin0 = K.forward_kinematics(model, state.base_R, state.base_p, state.q)
        # nested block-Schur closed-form inverse (~25 fused ops) instead of
        # a 30-iteration Newton-Schulz chain; the per-substep refinement in
        # forward_dynamics cleans up the remaining rounding
        minv = spd_inv18(_D.mass_matrix(model, kin0))

    def body(st, _):
        return _substep(model, st, tau, params, friction, push_wrench, minv), None

    state, _ = jax.lax.scan(body, state, None, length=params.substeps)
    return state

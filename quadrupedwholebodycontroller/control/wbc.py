"""The whole-body controller: one pure control step.

Re-designs the reference's 400 Hz control loop (updateState -> solveQP ->
computeJointTorques, src/whole_body_controller.cpp:637-676) as a single
jittable function

    wbc_step : (obs, ref, carry) -> (output, carry)

with every cross-thread mutable member of the C++ class (old jacobians for
finite differences, integral error, QP hotstart memory, contact-switch flag)
made explicit in an immutable WBCCarry.  vmap over a leading axis gives the
scenario batch; lax.scan over control steps gives the rollout.

QP contract (must match reference exactly — SURVEY.md §3.5):
  x = [u_dot_com (6); qddot (12); F (12); s (12)]  (42 vars, hpp:31)
  rows 0-5    equality   M_c,b u_dot_com - J_st,com^T F = -w_gravity
  rows 6-17   equality   J_st,com u_dot_com + J_st,j qddot = -Jdot_st v_c
  rows 18-33  inequality D_fr F <= 0 (friction pyramid, contact-masked)
  rows 34-45  two-sided  -tau_max - h_j <= M_c,jj qddot - J_st,j^T F <= tau_max - h_j
  rows 46-69  swing tracking with slacks s  (cpp:486-515)
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from quadrupedwholebodycontroller.config import (
    GRAVITY,
    NUM_JOINTS,
    NUM_LEGS,
    NV,
    QP_INF,
    QP_NUM_CONSTRAINTS,
    QP_NUM_VARS,
    ControllerParams,
    QPSolverParams,
)
from quadrupedwholebodycontroller.models.robot_model import RobotModel
from quadrupedwholebodycontroller.ops import centroidal as C
from quadrupedwholebodycontroller.ops import dynamics as D
from quadrupedwholebodycontroller.ops import kinematics as K
from quadrupedwholebodycontroller.ops import qp
from quadrupedwholebodycontroller.ops import spatial
from quadrupedwholebodycontroller.ops.linalg import full_precision as _full_precision


class RobotObservation(NamedTuple):
    """State intake — replaces the Gazebo model_states / joint_states

    callbacks (reference cpp:187-254)."""

    base_R: jax.Array    # (3, 3)
    base_p: jax.Array    # (3,)
    base_vel: jax.Array  # (6,) [linear; angular], world frame
    q: jax.Array         # (12,)
    qd: jax.Array        # (12,)


class Reference(NamedTuple):
    """Planner reference — the WbcReferenceMsg contract (msg/WbcReferenceMsg.msg).

    Leg order LH, LF, RF, RH everywhere."""

    com_pose: jax.Array   # (6,) [xyz, rpy]
    com_vel: jax.Array    # (6,)
    com_acc: jax.Array    # (6,)
    swing_pos: jax.Array  # (12,)
    swing_vel: jax.Array  # (12,)
    swing_acc: jax.Array  # (12,)
    contacts: jax.Array   # (4,) float 0/1

    @classmethod
    def standing(cls, params: ControllerParams, dtype=jnp.float32) -> "Reference":
        pose = jnp.asarray(params.initial_reference_pose, dtype)
        z = jnp.zeros
        return cls(
            com_pose=pose, com_vel=z(6, dtype), com_acc=z(6, dtype),
            swing_pos=z(12, dtype), swing_vel=z(12, dtype), swing_acc=z(12, dtype),
            contacts=jnp.ones(4, dtype),
        )


class WBCCarry(NamedTuple):
    """All cross-cycle state of the reference C++ class, made explicit."""

    old_T: jax.Array        # (18, 18) previous transformation matrix
    old_J_st: jax.Array     # (12, 18) previous centroidal stance jacobian
    old_J_sw: jax.Array     # (12, 18)
    tdot_inv: jax.Array     # (18, 18) stale d(T^-1)/dt (cpp:289 vs 293 ordering)
    integral_error: jax.Array  # (6,)
    prev_contacts: jax.Array   # (4,)
    switch_flag: jax.Array     # () bool — held between reference updates
    deriv_valid: jax.Array     # () bool — False on the first cycle
    qp_warm: qp.QPState        # hotstart memory (42, 70)


class WBCOutput(NamedTuple):
    tau: jax.Array        # (12,) joint torques (the command)
    grf: jax.Array        # (12,) desired ground reaction forces
    qp_x: jax.Array       # (42,) full QP solution
    qp_info: qp.QPInfo
    com_pos: jax.Array    # (3,)
    com_pose: jax.Array   # (6,) [com xyz, base rpy]
    foot_pos: jax.Array   # (12,) world foot positions (LH,LF,RF,RH)


def init_carry(dtype=jnp.float32) -> WBCCarry:
    eye = jnp.eye(NV, dtype=dtype)
    return WBCCarry(
        old_T=eye,
        old_J_st=jnp.zeros((3 * NUM_LEGS, NV), dtype),
        old_J_sw=jnp.zeros((3 * NUM_LEGS, NV), dtype),
        tdot_inv=jnp.zeros((NV, NV), dtype),
        integral_error=jnp.zeros(6, dtype),
        prev_contacts=jnp.ones(NUM_LEGS, dtype),
        switch_flag=jnp.asarray(False),
        deriv_valid=jnp.asarray(False),
        qp_warm=qp.QPState.zeros(QP_NUM_VARS, QP_NUM_CONSTRAINTS, dtype),
    )


def _friction_pyramid(friction, contacts, dtype):
    """D_fr (16, 12): 4 one-sided rows per leg, D = +-(t_i - mu n), contact-

    masked (reference computeNonSlidingConstraints, cpp:404-424)."""
    mu = friction
    D = jnp.asarray(
        [
            [1.0, 0.0, -mu],
            [-1.0, 0.0, -mu],
            [0.0, 1.0, -mu],
            [0.0, -1.0, -mu],
        ],
        dtype,
    )
    blocks = [D * contacts[i] for i in range(NUM_LEGS)]
    return jax.scipy.linalg.block_diag(*blocks)


class WBCSetup(NamedTuple):
    """Everything wbc_step computes before/after the QP solve — exposed so

    benches and the cached batch path can assemble QPs separately."""

    qp_data: qp.QPData
    h_c: jax.Array
    Mc_jj: jax.Array
    Jc_st_j: jax.Array
    com: jax.Array
    current_pose: jax.Array
    foot_pos: jax.Array
    carry_updates: dict  # fields of WBCCarry computed pre-solve


@_full_precision
def wbc_setup(
    model: RobotModel,
    params: ControllerParams,
    obs: RobotObservation,
    ref: Reference,
    carry: WBCCarry,
    ref_is_new=True,
) -> WBCSetup:
    """State update + QP assembly (updateState/solveQP-assembly halves of the

    reference control cycle, cpp:256-515)."""
    dtype = obs.base_p.dtype
    nj, nl = NUM_JOINTS, NUM_LEGS
    dt = 1.0 / params.loop_rate
    u = jnp.concatenate([obs.base_vel, obs.qd])

    # ---- contact bookkeeping (referenceCallback, cpp:176-184) ----
    ref_is_new = jnp.asarray(ref_is_new)
    changed = jnp.any(ref.contacts != carry.prev_contacts)
    switch = jnp.where(ref_is_new, changed, carry.switch_flag)
    prev_contacts = jnp.where(ref_is_new, ref.contacts, carry.prev_contacts)
    contacts = jnp.where(ref_is_new, ref.contacts, carry.prev_contacts)

    # ---- updateState (cpp:256-294) ----
    # one pass computes the Coriolis bias AND the primal kinematics
    # (FK + Jacobian PARTS + body velocities) it needs anyway — everything
    # else reuses them; the (nb, 6, 18) Jacobian stack is never materialized
    # (its padded layout would dominate the step's memory traffic)
    h_cor, kin, parts, v_bodies = D.coriolis_bias_full(
        model, obs.base_R, obs.base_p, obs.q, u
    )
    com = K.robot_com(model, kin)
    com_lin_vel = jnp.einsum("b,ba->a", model.mass, v_bodies) / model.total_mass
    com_vel6 = jnp.concatenate([com_lin_vel, obs.base_vel[3:6]])
    current_pose = jnp.concatenate([com, spatial.matrix_to_rpy(obs.base_R)])

    M = D.mass_matrix_from_parts(model, kin, parts)
    tf = C.centroidal_transform(M, com, obs.base_p)
    Mc = C.centroidal_mass_matrix(M, tf)
    Mc_base = Mc[:6, :6]
    Mc_jj = Mc[6:, 6:]

    J_feet = K.frame_jacobians(model, kin)[:, :3, :]           # (4, 3, 18)
    J_st = (J_feet * contacts[:, None, None]).reshape(3 * nl, NV)
    J_sw = (J_feet * (1.0 - contacts)[:, None, None]).reshape(3 * nl, NV)
    Jc_st = C.project_jacobian(J_st, tf)
    Jc_sw = C.project_jacobian(J_sw, tf)
    Jc_st_com, Jc_st_j = Jc_st[:, :6], Jc_st[:, 6:]
    Jc_sw_com, Jc_sw_j = Jc_sw[:, :6], Jc_sw[:, 6:]

    if params.exact_derivatives:
        # ---- beyond-reference option: analytic Tdot / Jdot via jvp along
        # the state flow (no finite-difference lag, no contact-switch
        # zeroing needed — contacts are constant within the linearization),
        # and the centroidal bias uses the FRESH Tdot^-1
        def mats(R, p, qq):
            kin_ = K.forward_kinematics(model, R, p, qq)
            M_ = D.mass_matrix(model, kin_)
            com_ = K.robot_com(model, kin_)
            tf_ = C.centroidal_transform(M_, com_, p)
            Jf_ = K.frame_jacobians(model, kin_)[:, :3, :]
            Jst_ = (Jf_ * contacts[:, None, None]).reshape(3 * nl, NV) @ tf_.T_inv
            Jsw_ = (Jf_ * (1.0 - contacts)[:, None, None]).reshape(3 * nl, NV) @ tf_.T_inv
            return tf_.T, Jst_, Jsw_

        flow = K.state_flow(obs.base_R, obs.base_p, obs.q, u)
        _, (T_dot, Jd_st, Jd_sw) = jax.jvp(
            mats, (obs.base_R, obs.base_p, obs.q), flow
        )
        new_tdot_inv = C.tdot_inverse(tf, T_dot)
        h_c = C.centroidal_bias(h_cor, M, new_tdot_inv, u, tf)
    else:
        # centroidal bias uses the STALE Tdot_inv (cpp:289 reads the member
        # written at cpp:293 of the previous cycle)
        h_c = C.centroidal_bias(h_cor, M, carry.tdot_inv, u, tf)

        # finite-difference derivatives (computeDerivatives, cpp:384-402);
        # zeroed on contact switch AND on the first cycle (the reference's
        # first cycle differences against an identity placeholder — we use
        # zero, a documented one-step deviation)
        gate = jnp.where(switch | ~carry.deriv_valid, 0.0, 1.0).astype(dtype)
        T_dot = gate * (tf.T - carry.old_T) / dt
        Jd_st = gate * (Jc_st - carry.old_J_st) / dt
        Jd_sw = gate * (Jc_sw - carry.old_J_sw) / dt
        new_tdot_inv = C.tdot_inverse(tf, T_dot)

    # ---- desired wrench (computeDesiredWrench, cpp:426-445) ----
    kp_diag = jnp.full((6,), params.kp, dtype).at[2].set(params.kp_z)
    m_tot = model.total_mass
    gravity_wrench = jnp.zeros(6, dtype).at[2].set(m_tot * GRAVITY)
    pose_err = current_pose - ref.com_pose
    w_des = (
        -kp_diag * pose_err
        - params.kd * (com_vel6 - ref.com_vel)
        - params.ki * carry.integral_error
        + gravity_wrench
        + Mc_base @ ref.com_acc
    )
    integral_error = carry.integral_error + pose_err / params.loop_rate

    # ---- swing commanded accelerations (cpp:447-464) ----
    foot_pos = kin.frame_p.reshape(3 * nl)
    foot_vel = jnp.einsum("fij,j->fi", J_feet, u).reshape(3 * nl)  # reuse J_feet
    a_cmd = (
        ref.swing_acc
        + params.kd_swing * (ref.swing_vel - foot_vel)
        + params.kp_swing * (ref.swing_pos - foot_pos)
    )
    a_cmd = (a_cmd.reshape(nl, 3) * (1.0 - contacts)[:, None]).reshape(3 * nl)

    # ---- QP assembly (solveQP, cpp:466-515) ----
    n, m = QP_NUM_VARS, QP_NUM_CONSTRAINTS
    # H = S_F^T J_st,com Q J_st,com^T S_F + R   (Q = I6)
    H = jnp.zeros((n, n), dtype)
    H = H.at[18:30, 18:30].set(Jc_st_com @ Jc_st_com.T)
    R_diag = jnp.ones(n, dtype).at[30:42].set(params.slack_weight)
    H = H + jnp.diag(R_diag)
    g = jnp.zeros(n, dtype).at[18:30].set(-(Jc_st_com @ w_des))

    Dfr = _friction_pyramid(params.friction, contacts, dtype)
    z6x12 = jnp.zeros((6, nj), dtype)
    z12x12 = jnp.zeros((3 * nl, 3 * nl), dtype)
    z16x6 = jnp.zeros((4 * nl, 6), dtype)
    z16x12 = jnp.zeros((4 * nl, nj), dtype)
    z12x6 = jnp.zeros((nj, 6), dtype)
    eye12 = jnp.eye(3 * nl, dtype=dtype)
    A = jnp.concatenate(
        [
            jnp.concatenate([Mc_base, z6x12, -Jc_st_com.T, jnp.zeros((6, 3 * nl), dtype)], axis=1),
            jnp.concatenate([Jc_st_com, Jc_st_j, z12x12, z12x12], axis=1),
            jnp.concatenate([z16x6, z16x12, Dfr, jnp.zeros((4 * nl, 3 * nl), dtype)], axis=1),
            jnp.concatenate([z12x6, Mc_jj, -Jc_st_j.T, z12x12], axis=1),
            jnp.concatenate([Jc_sw_com, Jc_sw_j, z12x12, -eye12], axis=1),
            jnp.concatenate([Jc_sw_com, Jc_sw_j, z12x12, eye12], axis=1),
        ],
        axis=0,
    )

    vel_c = jnp.concatenate([com_vel6, obs.qd])  # centroidal-coordinates velocity
    stance_rhs = -(Jd_st @ vel_c)
    swing_rhs = a_cmd - Jd_sw @ vel_c
    tau_max = jnp.full((nj,), params.max_torque, dtype)
    inf = jnp.asarray(QP_INF, dtype)
    ub = jnp.concatenate(
        [
            -gravity_wrench,
            stance_rhs,
            jnp.zeros(4 * nl, dtype),
            tau_max - h_c[6:],
            swing_rhs,
            jnp.full((3 * nl,), inf, dtype),
        ]
    )
    lb = jnp.concatenate(
        [
            -gravity_wrench,
            stance_rhs,
            jnp.full((4 * nl,), -inf, dtype),
            -tau_max - h_c[6:],
            jnp.full((3 * nl,), -inf, dtype),
            swing_rhs,
        ]
    )

    data = qp.QPData(H=H, g=g, A=A, l=lb, u=ub)
    return WBCSetup(
        qp_data=data,
        h_c=h_c,
        Mc_jj=Mc_jj,
        Jc_st_j=Jc_st_j,
        com=com,
        current_pose=current_pose,
        foot_pos=foot_pos,
        carry_updates=dict(
            old_T=tf.T,
            old_J_st=Jc_st,
            old_J_sw=Jc_sw,
            tdot_inv=new_tdot_inv,
            integral_error=integral_error,
            prev_contacts=prev_contacts,
            switch_flag=switch,
            deriv_valid=jnp.asarray(True),
        ),
    )


def _finish_step(setup: WBCSetup, qp_state, qp_info, carry: WBCCarry):
    """Torque mapping + carry assembly (computeJointTorques, cpp:553-577)."""
    qdd = qp_state.x[6:18]
    grf = qp_state.x[18:30]
    tau = setup.Mc_jj @ qdd + setup.h_c[6:] - setup.Jc_st_j.T @ grf
    out = WBCOutput(
        tau=tau, grf=grf, qp_x=qp_state.x, qp_info=qp_info,
        com_pos=setup.com, com_pose=setup.current_pose, foot_pos=setup.foot_pos,
    )
    new_carry = WBCCarry(qp_warm=qp_state, **setup.carry_updates)
    return out, new_carry


def _wbc_polish_hinv(H, reg):
    """Exact closed-form inverse of the regularized WBC polish Hessian,
    in the COMPACT (diag, blk, start) form of ops/qp's hinv_fn protocol.

    Per the QP layout (SURVEY §3.5, reference cpp:471-484) H is block
    diagonal: identity on the [u_dot_com; qddot] vars, I + J_c,com J_c,com^T
    on the GRF block (rows 18:30), slack_weight I on the slacks — so the
    inverse is two reciprocal diagonals plus one 12x12 SPD closed-form
    block inverse (rank-6 + identity; ops/linalg.spd_inv12 + one Newton
    polish step).  Replaces the (B, 42, 42) carried Newton-Schulz update;
    the dense inverse is never materialized on the hot path."""
    from quadrupedwholebodycontroller.ops.linalg import spd_inv12

    dtype = H.dtype
    B = H.shape[0]
    blk = H[:, 18:30, 18:30] + reg * jnp.eye(12, dtype=dtype)
    blk_inv = spd_inv12(blk)
    eye2 = 2.0 * jnp.eye(12, dtype=dtype)
    blk_inv = blk_inv @ (eye2 - blk @ blk_inv)  # one Newton step on rounding
    diag = jnp.concatenate(
        [
            jnp.broadcast_to(1.0 / (H[:, 0:1, 0] + reg), (B, 18)),
            jnp.zeros((B, 12), dtype),
            jnp.broadcast_to(1.0 / (H[:, 30:31, 30] + reg), (B, 12)),
        ],
        axis=1,
    )
    return diag, blk_inv, 18


def _exact_correction(model, params, obs, contacts, carry, switch):
    """Per-sample jvp-exact Tdot/Jdot corrections over the FD setup.

    The fused setup (ops/setup_fused.py) implements the reference-faithful
    finite-difference derivative path (cpp:384-402).  exact_derivatives
    replaces FD with jvp-exact derivatives along the state flow; rather
    than forfeiting the fused setup, this computes only the DELTAS the
    exact mode changes — the QP rows that depend on Jdot/Tdot and the
    centroidal bias — and the caller patches them over its outputs:

      rows 6-17  (stance):  -(Jd_st_exact - Jd_st_fd) @ vel_c
      rows 34-45 (torque):  -(h_c_exact - h_c_fd)[6:]
      rows 46-69 (swing):   -(Jd_sw_exact - Jd_sw_fd) @ vel_c
      h_c_exact - h_c_fd = T^{-T} M ((Tdinv_exact - Tdinv_stale) @ u)
        (centroidal_bias is linear in tdot_inv, so the exact-vs-stale
         difference needs no Coriolis recomputation)

    Returns (d_st (12,), d_sw (12,), dh (18,), tdot_inv_exact)."""
    dtype = obs.base_p.dtype
    nl = NUM_LEGS
    dt = 1.0 / params.loop_rate
    u = jnp.concatenate([obs.base_vel, obs.qd])

    def mats(R, p, qq):
        kin_ = K.forward_kinematics(model, R, p, qq)
        M_ = D.mass_matrix(model, kin_)
        com_ = K.robot_com(model, kin_)
        tf_ = C.centroidal_transform(M_, com_, p)
        Jf_ = K.frame_jacobians(model, kin_)[:, :3, :]
        Jst_ = (Jf_ * contacts[:, None, None]).reshape(3 * nl, NV) @ tf_.T_inv
        Jsw_ = (
            (Jf_ * (1.0 - contacts)[:, None, None]).reshape(3 * nl, NV)
            @ tf_.T_inv
        )
        return (tf_.T, Jst_, Jsw_), (M_, tf_)

    flow = K.state_flow(obs.base_R, obs.base_p, obs.q, u)
    (T, Jst, Jsw), (T_dot, Jd_st, Jd_sw), (M, tf) = jax.jvp(
        mats, (obs.base_R, obs.base_p, obs.q), flow, has_aux=True
    )
    tdot_inv_exact = C.tdot_inverse(tf, T_dot)
    dh = tf.T_inv.T @ (M @ ((tdot_inv_exact - carry.tdot_inv) @ u))
    # reference velocity convention: CoM linear velocity + BASE angular
    # velocity (cpp:260-264) — NOT the centroidal average angular velocity
    vel_c = jnp.concatenate([(T @ u)[:3], obs.base_vel[3:6], obs.qd])
    gate = jnp.where(switch | ~carry.deriv_valid, 0.0, 1.0).astype(dtype)
    Jd_st_fd = gate * (Jst - carry.old_J_st) / dt
    Jd_sw_fd = gate * (Jsw - carry.old_J_sw) / dt
    d_st = -((Jd_st - Jd_st_fd) @ vel_c)
    d_sw = -((Jd_sw - Jd_sw_fd) @ vel_c)
    return d_st, d_sw, dh, tdot_inv_exact


def _exact_epilogue_batched(model, params, obs, carry, setup, prepared,
                            prepared_layout="major"):
    """Patch the fused FD setup into the exact-derivatives setup.
    Returns (setup, prepared) with the Jdot/Tdot-
    dependent QP bound rows, h_c, and the carried tdot_inv replaced by
    their jvp-exact values; the scaled `prepared` bounds are re-patched
    through the (linear) Ruiz row scaling.  f64 equivalence vs the
    vmapped XLA exact wbc_setup: tests/test_exact_derivatives.py."""
    contacts = setup.carry_updates["prev_contacts"]
    switch = setup.carry_updates["switch_flag"]
    d_st, d_sw, dh, tdot_exact = jax.vmap(
        lambda o, c, cr, sw: _exact_correction(model, params, o, c, cr, sw)
    )(obs, contacts, carry, switch)
    B = d_st.shape[0]
    dtype = d_st.dtype
    dl = jnp.zeros((B, QP_NUM_CONSTRAINTS), dtype)
    dl = dl.at[:, 6:18].add(d_st).at[:, 34:46].add(-dh[:, 6:])
    du = dl.at[:, 46:58].add(d_sw)
    dl = dl.at[:, 58:70].add(d_sw)
    data = setup.qp_data
    new_carry_updates = dict(setup.carry_updates, tdot_inv=tdot_exact)
    setup = setup._replace(
        qp_data=data._replace(l=data.l + dl, u=data.u + du),
        h_c=setup.h_c + dh,
        carry_updates=new_carry_updates,
    )
    if prepared is not None:
        sH, sA, sg, sl, su, rho, wxs, wzs, wys, dscale, escale = prepared
        if prepared_layout == "minor":
            # batch-minor (m, B) scaled bounds: transpose the (B, m)
            # patches once (cheap vectors)
            dl_t, du_t = jnp.transpose(dl, (1, 0)), jnp.transpose(du, (1, 0))
            prepared = (sH, sA, sg, sl + escale * dl_t, su + escale * du_t,
                        rho, wxs, wzs, wys, dscale, escale)
        else:
            prepared = (sH, sA, sg, sl + escale * dl, su + escale * du,
                        rho, wxs, wzs, wys, dscale, escale)
    return setup, prepared


def _switch_masked_warm(carry: WBCCarry, switch):
    """On a contact switch the carried duals refer to re-masked constraint

    rows (a different problem); keep the primal warm start but drop z/y."""
    return qp.QPState(
        x=carry.qp_warm.x,
        z=jnp.where(switch, jnp.zeros_like(carry.qp_warm.z), carry.qp_warm.z),
        y=jnp.where(switch, jnp.zeros_like(carry.qp_warm.y), carry.qp_warm.y),
    )


def wbc_step_batched(
    model: RobotModel,
    params: ControllerParams,
    qp_params: QPSolverParams,
    obs: RobotObservation,
    ref: Reference,
    carry: WBCCarry,
    ref_is_new=True,
    qp_backend: str = "xla",
    qp_cache: "qp.QPCache | None" = None,
    cache_valid=False,
    setup_backend: str = "auto",
):
    """Batched control cycle: vmapped state update / assembly around a

    batch-level QP solve, so the solver backend ("cached": the batch-minor
    chain of ops/qp.py with its carried factorizations) sees the whole
    scenario batch at once.

    qp_cache: optional carried factorization cache (qp.QPCache) — the
    hotstart extended to the matmul-only inverses.  cache_valid is a scalar
    gate (False on the first cycle); contact switches inside the batch
    disable the warm path automatically.  Returns (out, carry, cache) when
    a cache is passed.

    setup_backend: "xla" (vmapped wbc_setup), "fused" (the generated
    batch-minor setup, ops/setup_fused.py), or "auto" — fused whenever
    the QP backend is "cached".  With exact_derivatives the fused path runs
    the tangent propagation in the generated body (setup_fused exact_mode —
    analytic Tdot/Jdot through the same unrolled recursion);
    params.exact_epilogue forces the older jvp-exact XLA epilogue
    (_exact_epilogue_batched) instead, kept as the independent oracle.

    ref_is_new may be a scalar or a per-scenario (B,) array."""
    B = obs.q.shape[0]
    ref_is_new_b = jnp.broadcast_to(jnp.asarray(ref_is_new), (B,))
    if setup_backend == "auto":
        setup_backend = "fused" if qp_backend == "cached" else "xla"
    prepared = None
    prepared_tiles = None
    prep_layout = "major"
    with jax.named_scope("setup"):
        if setup_backend == "fused":
            from quadrupedwholebodycontroller.ops import setup_fused

            # on the cached QP path the prepare stage (Ruiz + scaling) fuses
            # into the generated setup (carry.qp_warm is scaled there,
            # switch-masked exactly like _switch_masked_warm below)
            if qp_backend == "cached":
                prep_layout = qp_params.solve_layout
            kernel_exact = params.exact_derivatives and not params.exact_epilogue
            sk = setup_fused.setup_batched(
                model, params, obs, ref, carry, ref_is_new_b,
                qp_params=qp_params if qp_backend == "cached" else None,
                prepared_layout=prep_layout,
                exact_mode=kernel_exact,
            )
            prepared = sk["prepared"]
            prepared_tiles = sk.get("tiles_minor")
            setup = WBCSetup(
                qp_data=qp.QPData(
                    H=sk["H"], g=sk["g"], A=sk["A"], l=sk["l"], u=sk["u"]
                ),
                h_c=sk["h_c"],
                Mc_jj=sk["Mc_jj"],
                Jc_st_j=sk["Jc_st_j"],
                com=sk["com"],
                current_pose=sk["current_pose"],
                foot_pos=sk["foot_pos"],
                carry_updates=sk["carry_updates"],
            )
            if params.exact_derivatives and params.exact_epilogue:
                # forced XLA jvp epilogue over the kernel's FD setup (the
                # round-3 mechanism, kept as the independent oracle; the
                # default exact path runs the tangents in the generated setup,
                # ops/setup_fused exact_mode)
                setup, prepared = _exact_epilogue_batched(
                    model, params, obs, carry, setup, prepared,
                    prepared_layout=prep_layout,
                )
                # the epilogue patched data.l/u; the raw batch-minor l/u
                # copies are stale FD values — fall back to transposing the
                # patched batch-major bounds in the polish
                prepared_tiles = None
        else:
            setup = jax.vmap(
                lambda o, r, c, rn: wbc_setup(model, params, o, r, c, rn)
            )(obs, ref, carry, ref_is_new_b)
    switch = setup.carry_updates["switch_flag"]
    warm = jax.vmap(_switch_masked_warm)(carry, switch)
    hinv_fn = _wbc_polish_hinv if qp_backend == "cached" else None
    if qp_cache is not None:
        # cache invalidation keys on the switch EDGE (contacts changed at
        # THIS publish tick), not the held switch_flag: the flag stays up
        # until the next planner message (reference semantics, kept for
        # the FD-derivative zeroing), but the cached inverses match the
        # new contact set after ONE cold re-inverse — re-colding through
        # the whole held window would quadruple the cold load under
        # desynchronized gaits
        switch_edge = jnp.broadcast_to(jnp.asarray(ref_is_new), (B,)) & (
            jnp.any(ref.contacts != carry.prev_contacts, axis=-1)
        )
        if qp_params.cold_batch > 0:
            # per-scenario warm gate: a contact switch cold-restarts only
            # that scenario's cached inverses (compacted top-k cold fix,
            # ops/qp.py) — desynchronized gaits keep the cache alive.
            # qpOASES hotstart is likewise per-problem (cpp:529-533).
            use_warm = (
                jnp.broadcast_to(jnp.asarray(cache_valid), (B,))
                & ~switch_edge
            )
        else:
            use_warm = jnp.asarray(cache_valid) & ~jnp.any(switch_edge)
        qp_state, qp_info, new_cache = qp.solve_batched(
            setup.qp_data, warm, qp_params, qp_backend,
            cache=qp_cache, use_warm=use_warm, hinv_fn=hinv_fn,
            prepared=prepared, prepared_layout=prep_layout,
            prepared_tiles=prepared_tiles,
        )
        with jax.named_scope("finish"):
            out, new_carry = jax.vmap(_finish_step)(
                setup, qp_state, qp_info, carry
            )
        return out, new_carry, new_cache
    qp_state, qp_info = qp.solve_batched(
        setup.qp_data, warm, qp_params, qp_backend, hinv_fn=hinv_fn,
        prepared=prepared, prepared_layout=prep_layout,
        prepared_tiles=prepared_tiles,
    )
    return jax.vmap(_finish_step)(setup, qp_state, qp_info, carry)


def wbc_step(
    model: RobotModel,
    params: ControllerParams,
    qp_params: QPSolverParams,
    obs: RobotObservation,
    ref: Reference,
    carry: WBCCarry,
    ref_is_new=True,
):
    """One 400 Hz control cycle.  ref_is_new mirrors the arrival of a planner

    message (the contact-switch flag is only re-evaluated then, matching the
    referenceCallback semantics at cpp:176-184)."""
    setup = wbc_setup(model, params, obs, ref, carry, ref_is_new)
    warm = _switch_masked_warm(carry, setup.carry_updates["switch_flag"])
    qp_state, qp_info = qp.solve(setup.qp_data, warm, qp_params)
    return _finish_step(setup, qp_state, qp_info, carry)

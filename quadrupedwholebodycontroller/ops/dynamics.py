"""Floating-base rigid-body dynamics: mass matrix, Coriolis bias, energies.

Replaces the dynamic half of iDynTree KinDynComputations as consumed by the
reference controller:
  * getFreeFloatingMassMatrix (18x18 CRBA)  — src/whole_body_controller.cpp:266
  * generalizedBiasForces - generalizedGravityForces (Coriolis-only bias)
                                            — src/whole_body_controller.cpp:544-551

Design (batch-first, autodiff-native — not a Featherstone port):
  * M(q) = sum_b  m_b J_cb^T J_cb  +  J_wb^T I_b^w J_wb   over the 13 lumped
    bodies, with mixed-representation CoM-point Jacobians.  Exact (kinetic
    energy identity), and it maps to one batched einsum.
  * Coriolis bias via the principle of virtual work in world frame:
        h_C = sum_b J_cb^T (m_b a_cb) + J_wb^T (I_b^w alpha_b + w_b x I_b^w w_b)
    where (a_cb, alpha_b) are the velocity-product accelerations (u_dot = 0),
    obtained EXACTLY as one jax.jvp of the body-velocity map along the state
    flow — no hand-derived Christoffel symbols, valid in the anholonomic
    mixed basis because virtual work is basis-agnostic.

All single-sample; batch via vmap.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

import numpy as np

from quadrupedwholebodycontroller.models.robot_model import RobotModel
from quadrupedwholebodycontroller.ops import kinematics as K


def world_inertias(model: RobotModel, kin: K.KinState) -> jax.Array:
    """(nb, 3, 3) body inertias about their CoM in world axes."""
    return jnp.einsum("bij,bjk,blk->bil", kin.body_R, model.inertia, kin.body_R)


def mass_matrix(model: RobotModel, kin: K.KinState, J=None) -> jax.Array:
    """(nv, nv) free-floating mass matrix, mixed representation.

    Matches iDynTree getFreeFloatingMassMatrix (u = [v_base; omega; qdot]).
    Pass J (body CoM Jacobians) to reuse an already-computed stack; without
    one, the matrix is block-assembled from Jacobian PARTS (r, jq, jw) —
    the (nb, 6, nv) stack is never materialized, which removes a padded
    (B, nb, 6, 18) round trip through device memory."""
    if J is not None:
        Jv, Jw = J[:, :3, :], J[:, 3:, :]
        Iw = world_inertias(model, kin)
        M = jnp.einsum("b,bik,bil->kl", model.mass, Jv, Jv)
        M = M + jnp.einsum("bik,bij,bjl->kl", Jw, Iw, Jw)
        return M
    return mass_matrix_from_parts(
        model, kin, K.body_com_jacobian_parts(model, kin)
    )


def mass_matrix_from_parts(model: RobotModel, kin: K.KinState,
                           parts: "K.JacobianParts") -> jax.Array:
    """Block assembly of M = sum_b m_b Jv^T Jv + Jw^T Iw Jw with

        Jv_b = [I | -S(r_b) | jq_b],  Jw_b = [0 | I | jw_b]:

      M[0:3,0:3] = m_tot I
      M[0:3,3:6] = -S(sum m_b r_b)
      M[0:3,6:]  = sum m_b jq_b
      M[3:6,3:6] = sum m_b (|r|^2 I - r r^T) + sum Iw_b
      M[3:6,6:]  = sum m_b r_b x jq_b + sum Iw_b jw_b
      M[6:,6:]   = sum m_b jq^T jq + jw^T Iw jw
    """
    from quadrupedwholebodycontroller.ops.spatial import skew

    m = model.mass
    r, jq, jw = parts.r, parts.jq, parts.jw
    Iw = world_inertias(model, kin)
    dtype = r.dtype
    eye3 = jnp.eye(3, dtype=dtype)

    m_tot = model.total_mass
    top_mid = -skew(jnp.einsum("b,ba->a", m, r))
    top_right = jnp.einsum("b,bja->aj", m, jq)                     # (3, nj)
    rot = (
        jnp.einsum("b,b->", m, jnp.sum(r * r, axis=-1)) * eye3
        - jnp.einsum("b,ba,bc->ac", m, r, r)
        + jnp.sum(Iw, axis=0)
    )
    rxjq = jnp.cross(r[:, None, :], jq)                            # (nb, nj, 3)
    mid_right = (
        jnp.einsum("b,bja->aj", m, rxjq)
        + jnp.einsum("bac,bjc->aj", Iw, jw)
    )
    jj = jnp.einsum("b,bja,bka->jk", m, jq, jq) + jnp.einsum(
        "bja,bac,bkc->jk", jw, Iw, jw
    )
    top = jnp.concatenate([m_tot * eye3, top_mid, top_right], axis=1)
    mid = jnp.concatenate([top_mid.T, rot, mid_right], axis=1)
    bot = jnp.concatenate([top_right.T, mid_right.T, jj], axis=1)
    return jnp.concatenate([top, mid, bot], axis=0)


def project_forces_from_parts(parts: "K.JacobianParts", F, N):
    """h = sum_b Jv_b^T F_b + Jw_b^T N_b assembled block-wise:

        h[0:3] = sum F,  h[3:6] = sum r x F + sum N,
        h[6:]  = sum jq^T F + jw^T N.
    """
    h_lin = jnp.sum(F, axis=0)
    h_ang = jnp.sum(jnp.cross(parts.r, F), axis=0) + jnp.sum(N, axis=0)
    h_j = jnp.einsum("bja,ba->j", parts.jq, F) + jnp.einsum(
        "bja,ba->j", parts.jw, N
    )
    return jnp.concatenate([h_lin, h_ang, h_j])


def velocity_product_kinematics(model: RobotModel, kin: K.KinState, u):
    """Per-body angular velocity, angular acceleration, and CoM linear
    acceleration under u_dot = 0 (velocity-product terms only).

    Closed-form level recursion instead of a jvp tangent pass — half the op
    count in a batched setup made of many small operations.  Per level, with
    the child body origin a material
    point of the parent and the joint axis fixed in the parent frame:

        w_c     = w_p + qdot a_w
        alpha_c = alpha_p + qdot (w_p x a_w)
        a_oc    = a_op + alpha_p x r + w_p x (w_p x r),  r = p_c - p_p

    and per body CoM (material point of its own body, d = c_w - p_b):

        a_com = a_o + alpha x d + w x (w x d).

    In the MIXED representation the base seeds are w = u[3:6],
    alpha = a_o = 0 (u constant along the flow).  Returns
    (w (nb,3), alpha (nb,3), a_com (nb,3))."""
    nb = model.num_bodies
    dtype = u.dtype
    zero3 = jnp.zeros(3, dtype)
    w_list = [None] * nb
    al_list = [None] * nb
    ao_list = [None] * nb
    w_list[0] = u[3:6]
    al_list[0] = zero3
    ao_list[0] = zero3
    qd = u[6:]

    for bodies, parents in K._levels(model.parent):
        jidx = np.asarray([b - 1 for b in bodies])
        bidx = np.asarray(bodies)
        pidx = np.asarray(parents)
        wp = jnp.stack([w_list[p] for p in parents])      # (L, 3)
        alp = jnp.stack([al_list[p] for p in parents])
        aop = jnp.stack([ao_list[p] for p in parents])
        r = kin.body_p[bidx] - kin.body_p[pidx]
        ax = kin.joint_axis_w[jidx]
        qdj = qd[jidx][:, None]
        a_o = aop + jnp.cross(alp, r) + jnp.cross(wp, jnp.cross(wp, r))
        w_c = wp + qdj * ax
        al_c = alp + qdj * jnp.cross(wp, ax)
        for i, b in enumerate(bodies):
            w_list[b] = w_c[i]
            al_list[b] = al_c[i]
            ao_list[b] = a_o[i]

    w = jnp.stack(w_list)
    alpha = jnp.stack(al_list)
    a_o = jnp.stack(ao_list)
    d = kin.body_com_w - kin.body_p
    a_com = a_o + jnp.cross(alpha, d) + jnp.cross(w, jnp.cross(w, d))
    return w, alpha, a_com


def coriolis_bias_full(model: RobotModel, base_R, base_p, q, u):
    """Coriolis bias plus the primal kinematics it computes along the way.

    Returns (h_C (nv,), kin, parts (K.JacobianParts), v_com (nb,3)) —
    callers (the WBC setup) reuse kin/parts/body-velocities instead of
    recomputing FK.  The (nb, 6, nv) Jacobian stack is never materialized
    (see K.JacobianParts).  Velocity-product accelerations come from the
    closed-form recursion (velocity_product_kinematics); the jvp route is
    kept as coriolis_bias_full_jvp for cross-validation."""
    kin = K.forward_kinematics(model, base_R, base_p, q)
    parts = K.body_com_jacobian_parts(model, kin)
    v_c, _ = K.parts_velocities(parts, u)
    w, alpha, a_c = velocity_product_kinematics(model, kin, u)
    Iw = world_inertias(model, kin)
    F = model.mass[:, None] * a_c                              # (nb, 3)
    N = jnp.einsum("bij,bj->bi", Iw, alpha) + jnp.cross(
        w, jnp.einsum("bij,bj->bi", Iw, w)
    )
    h = project_forces_from_parts(parts, F, N)
    return h, kin, parts, v_c


def coriolis_bias_full_jvp(model: RobotModel, base_R, base_p, q, u):
    """jvp-based reference implementation of coriolis_bias_full (the
    principle-of-virtual-work derivation, exact by construction) — used to
    validate the closed-form recursion."""
    flow = K.state_flow(base_R, base_p, q, u)

    def f(R, p, qq):
        kin = K.forward_kinematics(model, R, p, qq)
        parts = K.body_com_jacobian_parts(model, kin)
        v, w = K.parts_velocities(parts, u)
        return v, w, kin, parts

    (v_c, w, kin, parts), (a_c, alpha, _, _) = jax.jvp(
        f, (base_R, base_p, q), flow
    )
    Iw = world_inertias(model, kin)
    F = model.mass[:, None] * a_c                              # (nb, 3)
    N = jnp.einsum("bij,bj->bi", Iw, alpha) + jnp.cross(
        w, jnp.einsum("bij,bj->bi", Iw, w)
    )
    h = project_forces_from_parts(parts, F, N)
    return h, kin, parts, v_c


def coriolis_bias(model: RobotModel, base_R, base_p, q, u) -> jax.Array:
    """(nv,) Coriolis/centrifugal generalized force C(q,u)u (gravity-free).

    Matches the reference's computeCoriolisBias (generalizedBiasForces minus
    generalizedGravityForces, src/whole_body_controller.cpp:544-551)."""
    h, _, _, _ = coriolis_bias_full(model, base_R, base_p, q, u)
    return h


def gravity_force(model: RobotModel, kin: K.KinState, g_vec) -> jax.Array:
    """(nv,) generalized gravity force for gravity acceleration g_vec (3,).

    With iDynTree's convention, generalizedGravityForces returns the
    generalized force that gravity must be *balanced against*; the reference
    passes g_vec = (0, 0, +9.81) (src/whole_body_controller.cpp:78) and only
    ever uses bias - gravity, so the sign convention cancels.  Here we return
    sum_b J_cb^T m_b g_vec (the generalized force of a +g_vec acceleration
    field), which under the centroidal transform maps to [m*g_vec; 0; 0]."""
    parts = K.body_com_jacobian_parts(model, kin)
    F = model.mass[:, None] * jnp.asarray(g_vec, parts.r.dtype)[None, :]
    return project_forces_from_parts(parts, F, jnp.zeros_like(F))


def kinetic_energy(model: RobotModel, kin: K.KinState, u) -> jax.Array:
    """Scalar kinetic energy computed directly from body velocities

    (independent path used to validate mass_matrix)."""
    J = K.body_com_jacobians(model, kin)
    vel6 = jnp.einsum("bij,j->bi", J, u)
    v_c, w = vel6[:, :3], vel6[:, 3:]
    Iw = world_inertias(model, kin)
    ke_lin = 0.5 * jnp.sum(model.mass * jnp.sum(v_c * v_c, axis=-1))
    ke_ang = 0.5 * jnp.einsum("bi,bij,bj->", w, Iw, w)
    return ke_lin + ke_ang


def potential_energy(model: RobotModel, kin: K.KinState, g: float = 9.81) -> jax.Array:
    """Scalar gravitational PE with gravity pulling along -z."""
    return g * jnp.einsum("b,b->", model.mass, kin.body_com_w[:, 2])


def forward_dynamics(model: RobotModel, base_R, base_p, q, u, tau_gen,
                     minv=None) -> jax.Array:
    """(nv,) u_dot = M^{-1} (tau_gen - h_C - g_gen) with gravity pulling -z.

    tau_gen is the full generalized applied force (e.g. S^T tau + J_c^T f).
    Used by the on-device simulator (the Gazebo/C5 replacement).

    minv: optional slightly-stale M^{-1} (e.g. computed once per control
    period) — applied with iterative refinement against the CURRENT M, so
    the solve stays accurate while the expensive inverse is amortized over
    the physics substeps."""
    kin = K.forward_kinematics(model, base_R, base_p, q)
    M = mass_matrix(model, kin)
    h = coriolis_bias(model, base_R, base_p, q, u)
    # applied gravity generalized force (field acceleration -9.81 z)
    grav = gravity_force(model, kin, jnp.array([0.0, 0.0, -9.81], dtype=u.dtype))
    rhs = tau_gen - h + grav
    if minv is not None:
        x = minv @ rhs
        for _ in range(2):
            x = x + minv @ (rhs - M @ x)
        return x
    # M is SPD: matmul-only solve off the CPU (see ops/linalg.spd_solve)
    from quadrupedwholebodycontroller.ops.linalg import spd_solve

    return spd_solve(M, rhs, iters=30, refine=2)

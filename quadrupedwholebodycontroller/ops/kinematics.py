"""Floating-base forward kinematics and geometric Jacobians.

Replaces the kinematic half of iDynTree KinDynComputations as consumed by the
reference controller (src/whole_body_controller.cpp:256-294,322-382):
  * world poses of every body and named frame  (getWorldTransform)
  * robot CoM position / velocity              (getCenterOfMassPosition/Velocity)
  * mixed-representation frame Jacobians       (getFrameFreeFloatingJacobian)
  * frame velocities                           (getFrameVel)

Conventions (iDynTree MIXED representation, matching the reference's use):
  * generalized velocity u = [v_base_world (3); omega_world (3); qdot (12)]
    - linear first, base-origin linear velocity in world coordinates
  * a frame Jacobian maps u -> [v_frame_origin_world; omega_frame_world]

Batch-first structure: the tree is processed by *depth level* (all four
legs' hips in one batched op, then thighs, then shanks) and every Jacobian
is assembled by one fused masked-cross-product einsum over all joints and
all target points at once — so a vmapped call lowers to a handful of wide
XLA ops instead of hundreds of (3,3)-sized kernels.  Tree topology is
static Python, resolved at trace time.
"""
from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from quadrupedwholebodycontroller.models.robot_model import RobotModel
from quadrupedwholebodycontroller.ops import spatial


class KinState(NamedTuple):
    """World-frame kinematic quantities for one configuration."""

    body_R: jax.Array        # (nb, 3, 3)
    body_p: jax.Array        # (nb, 3)   body frame origins
    body_com_w: jax.Array    # (nb, 3)   body CoM positions
    joint_axis_w: jax.Array  # (nj, 3)   world joint axes
    joint_origin_w: jax.Array  # (nj, 3) world joint origins
    frame_R: jax.Array       # (nf, 3, 3)
    frame_p: jax.Array       # (nf, 3)


@lru_cache(maxsize=None)
def _levels(parent: tuple) -> tuple:
    """Static depth-level schedule: tuple of (body_indices, parent_indices)."""
    nb = len(parent)
    depth = [0] * nb
    for b in range(1, nb):
        depth[b] = depth[parent[b]] + 1
    out = []
    for d in range(1, max(depth) + 1):
        bodies = tuple(b for b in range(1, nb) if depth[b] == d)
        parents = tuple(parent[b] for b in bodies)
        out.append((bodies, parents))
    return tuple(out)


def forward_kinematics(model: RobotModel, base_R, base_p, q) -> KinState:
    """FK over the whole tree, one batched op-set per depth level.

    base_R: (3,3), base_p: (3,), q: (nj,)."""
    nb = model.num_bodies
    R_list = [None] * nb
    p_list = [None] * nb
    R_list[0] = base_R
    p_list[0] = base_p
    axis_w_list = [None] * (nb - 1)
    org_w_list = [None] * (nb - 1)

    for bodies, parents in _levels(model.parent):
        jidx = np.asarray([b - 1 for b in bodies])
        Rp = jnp.stack([R_list[p] for p in parents])   # (L, 3, 3)
        pp = jnp.stack([p_list[p] for p in parents])   # (L, 3)
        jR = model.joint_R[jidx]
        jp = model.joint_p[jidx]
        ax = model.joint_axis[jidx]
        R_jf = Rp @ jR                                  # joint frames, world
        p_j = pp + jnp.einsum("lij,lj->li", Rp, jp)
        ax_w = jnp.einsum("lij,lj->li", R_jf, ax)
        R_b = R_jf @ spatial.axis_angle_to_matrix(ax, q[jidx])
        for i, b in enumerate(bodies):
            R_list[b] = R_b[i]
            p_list[b] = p_j[i]
            axis_w_list[b - 1] = ax_w[i]
            org_w_list[b - 1] = p_j[i]

    body_R = jnp.stack(R_list)
    body_p = jnp.stack(p_list)
    body_com_w = body_p + jnp.einsum("bij,bj->bi", body_R, model.com)
    if model.frame_R.shape[0]:
        fb = np.asarray(model.frame_body)
        frame_R = body_R[fb] @ model.frame_R
        frame_p = body_p[fb] + jnp.einsum("fij,fj->fi", body_R[fb], model.frame_p)
    else:
        frame_R = jnp.zeros((0, 3, 3), body_R.dtype)
        frame_p = jnp.zeros((0, 3), body_R.dtype)
    return KinState(
        body_R=body_R,
        body_p=body_p,
        body_com_w=body_com_w,
        joint_axis_w=jnp.stack(axis_w_list),
        joint_origin_w=jnp.stack(org_w_list),
        frame_R=frame_R,
        frame_p=frame_p,
    )


@lru_cache(maxsize=None)
def _ancestor_mask_np(parent: tuple):
    nb, nj = len(parent), len(parent) - 1
    mask = np.zeros((nb, nj))
    for b in range(1, nb):
        mask[b] = mask[parent[b]].copy()
        mask[b, b - 1] = 1.0
    return mask


def point_jacobians(model: RobotModel, kin: KinState, points, point_bodies) -> jax.Array:
    """Mixed Jacobians (np, 6, nv) of world points attached to bodies.

    points: (np, 3); point_bodies: static tuple of owning body indices.
    One fused masked-cross-product computation for all points x joints."""
    nj = model.num_joints
    dtype = points.dtype
    npts = points.shape[0]
    mask = jnp.asarray(
        _ancestor_mask_np(model.parent)[np.asarray(point_bodies)], dtype
    )  # (np, nj)

    rel = points[:, None, :] - kin.joint_origin_w[None, :, :]       # (np, nj, 3)
    jv = jnp.cross(kin.joint_axis_w[None, :, :], rel) * mask[..., None]
    jw = jnp.broadcast_to(kin.joint_axis_w[None], (npts, nj, 3)) * mask[..., None]

    eye3 = jnp.broadcast_to(jnp.eye(3, dtype=dtype), (npts, 3, 3))
    zero3 = jnp.zeros((npts, 3, 3), dtype)
    Jv = jnp.concatenate(
        [eye3, -spatial.skew(points - kin.body_p[0]), jnp.swapaxes(jv, 1, 2)], axis=2
    )  # (np, 3, nv)
    Jw = jnp.concatenate([zero3, eye3, jnp.swapaxes(jw, 1, 2)], axis=2)
    return jnp.concatenate([Jv, Jw], axis=1)


def body_com_jacobians(model: RobotModel, kin: KinState) -> jax.Array:
    """(nb, 6, nv) mixed Jacobians at each body's CoM (for M, bias, energy)."""
    return point_jacobians(
        model, kin, kin.body_com_w, tuple(range(model.num_bodies))
    )


class JacobianParts(NamedTuple):
    """The information content of the body-CoM Jacobian stack WITHOUT the

    (nb, 6, nv) materialization: the mixed Jacobian of body b's CoM is

        Jv_b = [ I3 | -skew(r_b) | jq_b ],   Jw_b = [ 0 | I3 | jw_b ]

    so every J-contraction (velocities, mass matrix, bias projection) can
    be assembled block-wise from these parts, and the stacked
    (B, nb, 6, 18) tensors never round-trip through device memory."""

    r: jax.Array    # (np, 3)      point - base origin
    jq: jax.Array   # (np, nj, 3)  translational joint columns (masked)
    jw: jax.Array   # (np, nj, 3)  rotational joint columns (masked)


def jacobian_parts(model: RobotModel, kin: KinState, points,
                   point_bodies) -> JacobianParts:
    """Jacobian parts of world points attached to bodies (cf.

    point_jacobians — same masked-cross-product math, no assembly)."""
    dtype = points.dtype
    mask = jnp.asarray(
        _ancestor_mask_np(model.parent)[np.asarray(point_bodies)], dtype
    )  # (np, nj)
    rel = points[:, None, :] - kin.joint_origin_w[None, :, :]
    jq = jnp.cross(kin.joint_axis_w[None, :, :], rel) * mask[..., None]
    jw = kin.joint_axis_w[None, :, :] * mask[..., None]
    return JacobianParts(r=points - kin.body_p[0], jq=jq, jw=jw)


def body_com_jacobian_parts(model: RobotModel, kin: KinState) -> JacobianParts:
    return jacobian_parts(
        model, kin, kin.body_com_w, tuple(range(model.num_bodies))
    )


def parts_velocities(parts: JacobianParts, u):
    """(v (np,3), w (np,3)) point linear / body angular velocities from

    Jacobian parts: v = v_base + omega x r + jq qdot, w = omega + jw qdot."""
    qd = u[6:]
    v = (
        u[0:3][None, :]
        + jnp.cross(u[3:6][None, :], parts.r)
        + jnp.einsum("pja,j->pa", parts.jq, qd)
    )
    w = u[3:6][None, :] + jnp.einsum("pja,j->pa", parts.jw, qd)
    return v, w


def frame_jacobians(model: RobotModel, kin: KinState) -> jax.Array:
    """(nf, 6, nv) mixed Jacobians of the named frames.

    Matches iDynTree getFrameFreeFloatingJacobian in MIXED representation
    (reference src/whole_body_controller.cpp:327-341 uses the top 3 rows)."""
    return point_jacobians(model, kin, kin.frame_p, model.frame_body)


def robot_com(model: RobotModel, kin: KinState) -> jax.Array:
    """(3,) total CoM — iDynTree getCenterOfMassPosition."""
    return jnp.einsum("b,bi->i", model.mass, kin.body_com_w) / model.total_mass


def body_velocities(model: RobotModel, base_R, base_p, q, u):
    """Per-body CoM linear velocity and angular velocity.

    Returns (v_com (nb,3), omega (nb,3)).  Linear in u; used directly and —
    via jax.jvp along the state flow — for velocity-product accelerations."""
    kin = forward_kinematics(model, base_R, base_p, q)
    J = body_com_jacobians(model, kin)  # (nb, 6, nv)
    vel6 = jnp.einsum("bij,j->bi", J, u)
    return vel6[:, :3], vel6[:, 3:]


def frame_velocities(model: RobotModel, kin: KinState, u):
    """(nf, 6) mixed frame velocities [v_origin_world; omega_world].

    iDynTree getFrameVel (reference src/whole_body_controller.cpp:369-379
    uses the top 3 entries)."""
    J = frame_jacobians(model, kin)
    return jnp.einsum("fij,j->fi", J, u)


def com_velocity(model: RobotModel, kin: KinState, u) -> jax.Array:
    """(3,) CoM linear velocity — iDynTree getCenterOfMassVelocity."""
    J = body_com_jacobians(model, kin)
    v = jnp.einsum("b,bij,j->i", model.mass, J[:, :3, :], u)
    return v / model.total_mass


def state_flow(base_R, base_p, q, u):
    """Time derivative of the configuration (base_R, base_p, q) under mixed

    velocity u: (Rdot, pdot, qdot) with Rdot = skew(omega_world) @ R."""
    return (
        spatial.skew(u[3:6]) @ base_R,
        u[0:3],
        u[6:],
    )

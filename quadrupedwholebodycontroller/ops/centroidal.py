"""Centroidal-coordinates transformation.

Replicates the reference's computeTransformationMatrix
(src/whole_body_controller.cpp:296-320) and the centroidal projections in
updateState (cpp:268-293), with the block structure exploited for exact,
well-conditioned inverses (T is block upper-triangular with an SE(3)-adjoint
top-left block, so no generic 18x18 inversion is ever needed).

The transform maps the mixed generalized velocity u = [v_base; omega; qdot]
to [v_avg_com (6); qdot] where the 6D "average velocity at the CoM"
reproduces the total centroidal momentum: h_G = I_G v_avg.  Consequently the
transformed mass matrix is block-diagonal:  M_c = diag(I_G, M_jj_c) with
I_G = diag(m I3, locked rotational inertia about the CoM) — properties the
unit tests assert.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from quadrupedwholebodycontroller.ops import spatial


class CentroidalTransform(NamedTuple):
    T: jax.Array      # (nv, nv)
    T_inv: jax.Array  # (nv, nv)


def centroidal_transform(M, com, base_p) -> CentroidalTransform:
    """Build T and its exact inverse from the mass matrix.

    Mirrors reference cpp:296-320:
      Adj     = [[I, skew(c - p_b)], [0, I]]
      AdjInv  = Adj with the skew block negated
      J_com   = AdjInv @ Mb^{-1} @ [Mb | Mbj]  =  [AdjInv | AdjInv Mb^{-1} Mbj]
      T       = [[J_com], [0, I_nj]]
      T^{-1}  = [[Adj, -Mb^{-1} Mbj], [0, I_nj]]   (block-triangular inverse)
    """
    nv = M.shape[-1]
    nj = nv - 6
    dtype = M.dtype
    S = spatial.skew(com - base_p)
    eye3 = jnp.eye(3, dtype=dtype)
    zero3 = jnp.zeros((3, 3), dtype)
    adj = jnp.block([[eye3, S], [zero3, eye3]])
    adj_inv = jnp.block([[eye3, -S], [zero3, eye3]])

    Mb = M[:6, :6]
    Mbj = M[:6, 6:]
    if jax.default_backend() == "cpu":
        # LAPACK is fast and exact on CPU (the f64 test/golden configuration)
        from quadrupedwholebodycontroller.ops.linalg import spd_solve

        X = spd_solve(Mb, Mbj, iters=25, refine=2)  # Mb^{-1} Mbj  (6, nj)
    else:
        # closed-form 3x3-block Schur inverse + one refinement pass: exact
        # to f32 rounding and ~15 fused ops, vs ~50 launch-latency-bound
        # tiny kernels for an iterative inverse (ops/linalg.py)
        from quadrupedwholebodycontroller.ops.linalg import spd_inv6

        Mb_inv = spd_inv6(Mb)
        X = Mb_inv @ Mbj
        X = X + Mb_inv @ (Mbj - Mb @ X)
    B = adj_inv @ X                          # top-right block of T

    eye_j = jnp.eye(nj, dtype=dtype)
    zero_j6 = jnp.zeros((nj, 6), dtype)
    T = jnp.block([[adj_inv, B], [zero_j6, eye_j]])
    T_inv = jnp.block([[adj, -X], [zero_j6, eye_j]])
    return CentroidalTransform(T=T, T_inv=T_inv)


def centroidal_mass_matrix(M, tf: CentroidalTransform):
    """M_c = T^{-T} M T^{-1}  (reference cpp:270)."""
    return tf.T_inv.T @ M @ tf.T_inv


def project_jacobian(J, tf: CentroidalTransform):
    """J_c = J @ T^{-1}  (reference cpp:278,282)."""
    return J @ tf.T_inv


def centroidal_bias(h_coriolis, M, tdot_inv, u, tf: CentroidalTransform):
    """h_c = T^{-T} (h_C + M @ d(T^{-1})/dt @ u)  (reference cpp:289).

    tdot_inv is d(T^{-1})/dt — in the reference-faithful controller this is
    the one-cycle-stale finite-difference value carried across steps
    (cpp:289 reads the member written at cpp:293 of the previous cycle)."""
    return tf.T_inv.T @ (h_coriolis + M @ (tdot_inv @ u))


def tdot_inverse(tf: CentroidalTransform, T_dot):
    """d(T^{-1})/dt = -T^{-1} Tdot T^{-1}  (reference cpp:293)."""
    return -tf.T_inv @ T_dot @ tf.T_inv

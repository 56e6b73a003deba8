"""The framework is robot-agnostic: a different quadruped (2-DoF legs,

y-axis joints, different masses, an extra fixed sensor link) goes through
the same URDF pipeline, dynamics identities, and C++ oracle cross-check —
nothing is hardcoded to ANYmal-D."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from quadrupedwholebodycontroller.models.robot_model import RobotModel
from quadrupedwholebodycontroller.ops import dynamics as D
from quadrupedwholebodycontroller.ops import kinematics as K
from quadrupedwholebodycontroller.ops import spatial

URDF = os.path.join(os.path.dirname(__file__), "data", "toy_quadruped.urdf")
JOINTS = ("FL_hip", "FL_knee", "FR_hip", "FR_knee",
          "RL_hip", "RL_knee", "RR_hip", "RR_knee")
FEET = ("FL_foot", "FR_foot", "RL_foot", "RR_foot")


@pytest.fixture(scope="module")
def model():
    return RobotModel.from_urdf(URDF, JOINTS, FEET, dtype=jnp.float64)


def random_state(rng, nj):
    q = jnp.asarray(rng.uniform(-0.8, 0.3, size=nj), jnp.float64)
    base_p = jnp.asarray(rng.normal(size=3), jnp.float64)
    quat = rng.normal(size=4)
    quat /= np.linalg.norm(quat)
    base_R = spatial.quat_to_matrix(jnp.asarray(quat, jnp.float64))
    u = jnp.asarray(rng.normal(size=6 + nj), jnp.float64)
    return base_R, base_p, q, u


def test_model_structure(model):
    assert model.num_bodies == 9   # trunk + 4 x (upper, lower)
    assert model.num_joints == 8
    # trunk lumps the imu link (8.0 + 0.05)
    assert np.isclose(float(model.mass[0]), 8.05)
    assert np.isclose(float(model.total_mass), 8.05 + 4 * (0.7 + 0.25))


def test_dynamics_identities(model, rng):
    base_R, base_p, q, u = random_state(rng, 8)
    kin = K.forward_kinematics(model, base_R, base_p, q)
    M = np.asarray(D.mass_matrix(model, kin))
    assert np.allclose(M, M.T, atol=1e-11)
    assert np.all(np.linalg.eigvalsh(M) > 0)
    ke = float(D.kinetic_energy(model, kin, u))
    assert np.isclose(0.5 * np.asarray(u) @ M @ np.asarray(u), ke, rtol=1e-12)
    # Jacobian vs autodiff
    def fp(R, p, qq):
        return K.forward_kinematics(model, R, p, qq).frame_p
    flow = K.state_flow(base_R, base_p, q, u)
    _, dp = jax.jvp(fp, (base_R, base_p, q), flow)
    J = K.frame_jacobians(model, kin)
    v = jnp.einsum("fij,j->fi", J[:, :3, :], u)
    assert np.allclose(np.asarray(dp), np.asarray(v), atol=1e-10)


def test_cpp_oracle_agrees(model, rng):
    from quadrupedwholebodycontroller.runtime import native

    if native.load() is None:
        pytest.skip("native toolchain unavailable")
    base_R, base_p, q, u = random_state(rng, 8)
    kin = K.forward_kinematics(model, base_R, base_p, q)
    M_jax = np.asarray(D.mass_matrix(model, kin))
    h_jax = np.asarray(D.coriolis_bias(model, base_R, base_p, q, u))
    M_cpp, h_cpp = native.oracle_mass_and_bias(model, base_R, q, u)
    assert np.allclose(M_jax, M_cpp, atol=1e-10 * np.abs(M_cpp).max())
    assert np.allclose(h_jax, h_cpp, atol=1e-9 * max(1.0, np.abs(h_cpp).max()))

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from quadrupedwholebodycontroller.models import anymal_d_model
from quadrupedwholebodycontroller.models.anymal import (
    INITIAL_BASE_HEIGHT,
    INITIAL_JOINT_POS,
)
from quadrupedwholebodycontroller.ops import kinematics as K
from quadrupedwholebodycontroller.ops import spatial


@pytest.fixture(scope="module")
def model():
    return anymal_d_model(dtype=jnp.float64)


def random_state(rng, dtype=jnp.float64):
    q = jnp.asarray(rng.uniform(-0.7, 0.7, size=12), dtype)
    base_p = jnp.asarray(rng.normal(size=3), dtype)
    quat = rng.normal(size=4)
    quat /= np.linalg.norm(quat)
    base_R = spatial.quat_to_matrix(jnp.asarray(quat, dtype))
    u = jnp.asarray(rng.normal(size=18), dtype)
    return base_R, base_p, q, u


def test_initial_stance_feet(model):
    """At the hard-coded initial pose (reference cpp:81-82) all four feet

    should be below the base, symmetric, and near the ground."""
    base_R = jnp.eye(3, dtype=jnp.float64)
    base_p = jnp.array([0.0, 0.0, INITIAL_BASE_HEIGHT], dtype=jnp.float64)
    q = jnp.asarray(INITIAL_JOINT_POS, dtype=jnp.float64)
    kin = K.forward_kinematics(model, base_R, base_p, q)
    feet = np.asarray(kin.frame_p)  # LH, LF, RF, RH
    # symmetry: LH=-x,+y  LF=+x,+y  RF=+x,-y  RH=-x,-y
    assert feet[0, 0] < 0 and feet[0, 1] > 0
    assert feet[1, 0] > 0 and feet[1, 1] > 0
    assert feet[2, 0] > 0 and feet[2, 1] < 0
    assert feet[3, 0] < 0 and feet[3, 1] < 0
    assert np.allclose(feet[:, 2], feet[0, 2], atol=1e-9)  # all at same height
    assert np.all(feet[:, 2] < 0.15)  # near ground
    # left/right mirror symmetry
    assert np.allclose(feet[0, :2], feet[3, :2] * [1, -1], atol=1e-9)
    assert np.allclose(feet[1, :2], feet[2, :2] * [1, -1], atol=1e-9)


def test_com_reasonable(model):
    base_R = jnp.eye(3, dtype=jnp.float64)
    base_p = jnp.array([0.0, 0.0, INITIAL_BASE_HEIGHT], dtype=jnp.float64)
    q = jnp.asarray(INITIAL_JOINT_POS, dtype=jnp.float64)
    kin = K.forward_kinematics(model, base_R, base_p, q)
    com = np.asarray(K.robot_com(model, kin))
    assert abs(com[0]) < 0.1 and abs(com[1]) < 0.05
    assert 0.3 < com[2] < 0.65


def test_total_mass(model):
    assert np.isclose(float(model.total_mass), 51.63574, atol=1e-5)


def test_frame_jacobian_vs_autodiff(model, rng):
    """Geometric frame Jacobian linear part == d(frame position)/d(config)

    pushed through the mixed-velocity kinematic map (jacfwd check)."""
    base_R, base_p, q, u = random_state(rng)

    def frame_pos(R, p, qq):
        return K.forward_kinematics(model, R, p, qq).frame_p

    flow = K.state_flow(base_R, base_p, q, u)
    _, dp = jax.jvp(frame_pos, (base_R, base_p, q), flow)

    kin = K.forward_kinematics(model, base_R, base_p, q)
    J = K.frame_jacobians(model, kin)
    v_lin = jnp.einsum("fij,j->fi", J[:, :3, :], u)
    assert np.allclose(np.asarray(dp), np.asarray(v_lin), atol=1e-10)


def test_body_jacobian_vs_autodiff(model, rng):
    base_R, base_p, q, u = random_state(rng)

    def com_pos(R, p, qq):
        return K.forward_kinematics(model, R, p, qq).body_com_w

    flow = K.state_flow(base_R, base_p, q, u)
    _, dp = jax.jvp(com_pos, (base_R, base_p, q), flow)
    v_c, _ = K.body_velocities(model, base_R, base_p, q, u)
    assert np.allclose(np.asarray(dp), np.asarray(v_c), atol=1e-10)


def test_angular_velocity_consistency(model, rng):
    """omega from the Jacobian must satisfy Rdot = skew(omega) R for every body."""
    base_R, base_p, q, u = random_state(rng)

    def rots(R, p, qq):
        return K.forward_kinematics(model, R, p, qq).body_R

    flow = K.state_flow(base_R, base_p, q, u)
    Rs, dRs = jax.jvp(rots, (base_R, base_p, q), flow)
    _, w = K.body_velocities(model, base_R, base_p, q, u)
    expect = spatial.skew(w) @ Rs
    assert np.allclose(np.asarray(dRs), np.asarray(expect), atol=1e-10)


def test_com_velocity_consistency(model, rng):
    base_R, base_p, q, u = random_state(rng)

    def com(R, p, qq):
        return K.robot_com(model, K.forward_kinematics(model, R, p, qq))

    flow = K.state_flow(base_R, base_p, q, u)
    _, dcom = jax.jvp(com, (base_R, base_p, q), flow)
    kin = K.forward_kinematics(model, base_R, base_p, q)
    v = K.com_velocity(model, kin, u)
    assert np.allclose(np.asarray(dcom), np.asarray(v), atol=1e-10)


def test_vmap_batching(model, rng):
    """vmapped FK must agree with per-sample FK."""
    states = [random_state(rng) for _ in range(4)]
    bR = jnp.stack([s[0] for s in states])
    bp = jnp.stack([s[1] for s in states])
    bq = jnp.stack([s[2] for s in states])
    batched = jax.vmap(lambda R, p, q: K.forward_kinematics(model, R, p, q))(bR, bp, bq)
    for i, (R, p, q, _) in enumerate(states):
        single = K.forward_kinematics(model, R, p, q)
        assert np.allclose(np.asarray(batched.frame_p[i]), np.asarray(single.frame_p))

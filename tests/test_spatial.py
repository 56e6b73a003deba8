import jax.numpy as jnp
import numpy as np

from quadrupedwholebodycontroller.ops import spatial


def random_rotation(rng):
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    return np.asarray(spatial.quat_to_matrix(jnp.asarray(q)))


def test_skew_cross(rng):
    a = rng.normal(size=3)
    b = rng.normal(size=3)
    assert np.allclose(np.asarray(spatial.skew(jnp.asarray(a))) @ b, np.cross(a, b))


def test_rpy_roundtrip(rng):
    for _ in range(20):
        rpy = rng.uniform(-1.2, 1.2, size=3)  # within gimbal-safe range
        R = spatial.rpy_to_matrix(jnp.asarray(rpy))
        back = spatial.matrix_to_rpy(R)
        assert np.allclose(np.asarray(back), rpy, atol=1e-12)


def test_rpy_matches_reference_formula(rng):
    """matrix_to_rpy must equal the reference's eulAnglesRPY

    (src/whole_body_controller.cpp:12-20) element by element."""
    R = random_rotation(rng)
    out = np.asarray(spatial.matrix_to_rpy(jnp.asarray(R)))
    roll = np.arctan2(R[2, 1], R[2, 2])
    pitch = np.arctan2(-R[2, 0], np.hypot(R[2, 1], R[2, 2]))
    yaw = np.arctan2(R[1, 0], R[0, 0])
    assert np.allclose(out, [roll, pitch, yaw])


def test_axis_angle(rng):
    axis = np.array([0.0, 0.0, 1.0])
    R = spatial.axis_angle_to_matrix(jnp.asarray(axis), jnp.asarray(0.3))
    expect = np.array(
        [[np.cos(0.3), -np.sin(0.3), 0], [np.sin(0.3), np.cos(0.3), 0], [0, 0, 1]]
    )
    assert np.allclose(np.asarray(R), expect, atol=1e-15)
    # orthonormality for random axis
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    R = np.asarray(spatial.axis_angle_to_matrix(jnp.asarray(axis), jnp.asarray(1.1)))
    assert np.allclose(R @ R.T, np.eye(3), atol=1e-14)
    assert np.isclose(np.linalg.det(R), 1.0)


def test_quat_roundtrip(rng):
    for _ in range(10):
        R = random_rotation(rng)
        q = spatial.matrix_to_quat(jnp.asarray(R))
        R2 = spatial.quat_to_matrix(q)
        assert np.allclose(np.asarray(R2), R, atol=1e-12)


def test_orthonormalize(rng):
    R = random_rotation(rng) + 1e-4 * rng.normal(size=(3, 3))
    Ro = np.asarray(spatial.orthonormalize(jnp.asarray(R)))
    assert np.allclose(Ro @ Ro.T, np.eye(3), atol=1e-12)
    assert np.isclose(np.linalg.det(Ro), 1.0)

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from quadrupedwholebodycontroller.models import anymal_d_model
from quadrupedwholebodycontroller.ops import centroidal as C
from quadrupedwholebodycontroller.ops import dynamics as D
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


def setup(model, rng):
    base_R, base_p, q, u = random_state(rng)
    kin = K.forward_kinematics(model, base_R, base_p, q)
    M = D.mass_matrix(model, kin)
    com = K.robot_com(model, kin)
    tf = C.centroidal_transform(M, com, base_p)
    return base_R, base_p, q, u, kin, M, com, tf


def test_transform_inverse_exact(model, rng):
    *_, M, com, tf = setup(model, rng)
    assert np.allclose(np.asarray(tf.T @ tf.T_inv), np.eye(18), atol=1e-12)
    assert np.allclose(np.asarray(tf.T_inv @ tf.T), np.eye(18), atol=1e-12)


def test_centroidal_mass_matrix_structure(model, rng):
    """The whole point of the transform: M_c = diag(m I3, I_G, M_jj_c) —

    linear block m*I, zero linear/angular coupling, zero base/joint coupling."""
    *_, M, com, tf = setup(model, rng)
    Mc = np.asarray(C.centroidal_mass_matrix(M, tf))
    m = float(anymal_d_model(jnp.float64).total_mass)
    assert np.allclose(Mc[:3, :3], m * np.eye(3), atol=1e-8)
    assert np.allclose(Mc[:3, 3:6], 0.0, atol=1e-8)
    assert np.allclose(Mc[:6, 6:], 0.0, atol=1e-8)
    assert np.allclose(Mc, Mc.T, atol=1e-8)
    # locked rotational inertia about CoM is SPD
    assert np.all(np.linalg.eigvalsh(Mc[3:6, 3:6]) > 0)


def test_centroidal_velocity_reproduces_momentum(model, rng):
    """First 3 entries of T u must be the CoM linear velocity."""
    base_R, base_p, q, u, kin, M, com, tf = setup(model, rng)
    v_avg = np.asarray(tf.T @ u)
    v_com = np.asarray(K.com_velocity(model, kin, u))
    assert np.allclose(v_avg[:3], v_com, atol=1e-10)
    # and the joint part passes through untouched
    assert np.allclose(v_avg[6:], np.asarray(u[6:]), atol=1e-14)


def test_centroidal_gravity_theorem(model, rng):
    """T^{-T} @ generalized gravity = [m g_vec; 0; 0] — gravity produces no

    torque about the CoM and no joint-space force in centroidal coords.
    This is why the reference can put gravity only in the wrench equality
    (cpp:500-501) and exclude it from the joint bias (cpp:544-551)."""
    base_R, base_p, q, u, kin, M, com, tf = setup(model, rng)
    g_vec = jnp.array([0.0, 0.0, 9.81], dtype=jnp.float64)
    grav = D.gravity_force(model, kin, g_vec)
    gc = np.asarray(tf.T_inv.T @ grav)
    m = float(model.total_mass)
    assert np.allclose(gc[:3], m * np.asarray(g_vec), atol=1e-7)
    assert np.allclose(gc[3:], 0.0, atol=1e-7)


def test_exact_tdot_inverse(model, rng):
    """-T^{-1} Tdot T^{-1} must equal d(T^{-1})/dt (jvp along the flow)."""
    base_R, base_p, q, u, *_ = setup(model, rng)

    def tinv_fn(R, p, qq):
        kin = K.forward_kinematics(model, R, p, qq)
        M = D.mass_matrix(model, kin)
        com = K.robot_com(model, kin)
        return C.centroidal_transform(M, com, p)

    flow = K.state_flow(base_R, base_p, q, u)
    tf, dtf = jax.jvp(tinv_fn, (base_R, base_p, q), flow)
    via_formula = C.tdot_inverse(tf, dtf.T)
    assert np.allclose(np.asarray(via_formula), np.asarray(dtf.T_inv), atol=1e-9)

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from quadrupedwholebodycontroller.models import anymal_d_model
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


def test_mass_matrix_spd_and_kinetic_energy(model, rng):
    """0.5 u^T M u must equal the kinetic energy summed over bodies

    (independent code path), and M must be SPD."""
    for _ in range(5):
        base_R, base_p, q, u = random_state(rng)
        kin = K.forward_kinematics(model, base_R, base_p, q)
        M = np.asarray(D.mass_matrix(model, kin))
        assert np.allclose(M, M.T, atol=1e-11)
        assert np.all(np.linalg.eigvalsh(M) > 0)
        ke = float(D.kinetic_energy(model, kin, u))
        assert np.isclose(0.5 * np.asarray(u) @ M @ np.asarray(u), ke, rtol=1e-12)


def test_mass_matrix_base_block(model, rng):
    """Top-left 6x6 in mixed representation: [[m I, m skew(c - p_b)^T?]] —

    the linear-linear block must be total_mass * I (Newton: F = m a_com)."""
    base_R, base_p, q, _ = random_state(rng)
    kin = K.forward_kinematics(model, base_R, base_p, q)
    M = np.asarray(D.mass_matrix(model, kin))
    m = float(model.total_mass)
    assert np.allclose(M[:3, :3], m * np.eye(3), atol=1e-10)
    # linear-angular coupling = -m * skew(com - base_p)
    com = np.asarray(K.robot_com(model, kin))
    pb = np.asarray(base_p)
    expect = -m * np.asarray(spatial.skew(jnp.asarray(com - pb)))
    assert np.allclose(M[:3, 3:6], expect, atol=1e-9)


def test_momentum_rate_equals_force_free_dynamics(model, rng):
    """Along the free flow (no applied force, no gravity):

    d/dt (M u) with u_dot = -M^{-1} h_C must give  Mdot u - h_C - M M^{-1} h_C
    ... equivalently we check the defining property of h_C directly:
    d/dt KE = -u . h_C + u . (M u_dot) = 0 when u_dot = -M^{-1} h_C.
    Stronger: integrate a short free-fall (no gravity) trajectory and check
    energy and momentum conservation."""
    base_R, base_p, q, u = random_state(rng)
    dt = 1e-4
    steps = 200

    def deriv(state):
        R, p, qq, uu = state
        kin = K.forward_kinematics(model, R, p, qq)
        M = D.mass_matrix(model, kin)
        h = D.coriolis_bias(model, R, p, qq, uu)
        udot = jnp.linalg.solve(M, -h)
        Rdot, pdot, qdot = K.state_flow(R, p, qq, uu)
        return (Rdot, pdot, qdot, udot)

    @jax.jit
    def rk4(state):
        k1 = deriv(state)
        k2 = deriv(jax.tree.map(lambda s, k: s + 0.5 * dt * k, state, k1))
        k3 = deriv(jax.tree.map(lambda s, k: s + 0.5 * dt * k, state, k2))
        k4 = deriv(jax.tree.map(lambda s, k: s + dt * k, state, k3))
        state = jax.tree.map(
            lambda s, a, b, c, d: s + dt / 6.0 * (a + 2 * b + 2 * c + d),
            state, k1, k2, k3, k4,
        )
        R, p, qq, uu = state
        return (spatial.orthonormalize(R), p, qq, uu)

    state = (base_R, base_p, q, u)

    def energy_momentum(state):
        R, p, qq, uu = state
        kin = K.forward_kinematics(model, R, p, qq)
        ke = D.kinetic_energy(model, kin, uu)
        # linear momentum = m * v_com (conserved without external force)
        pmom = float(model.total_mass) * K.com_velocity(model, kin, uu)
        return float(ke), np.asarray(pmom)

    e0, p0 = energy_momentum(state)
    for _ in range(steps):
        state = rk4(state)
    e1, p1 = energy_momentum(state)
    assert np.isclose(e0, e1, rtol=1e-6), (e0, e1)
    assert np.allclose(p0, p1, atol=1e-8 * max(1.0, np.abs(p0).max()))


def test_bias_zero_velocity(model, rng):
    base_R, base_p, q, _ = random_state(rng)
    h = D.coriolis_bias(model, base_R, base_p, q, jnp.zeros(18, jnp.float64))
    assert np.allclose(np.asarray(h), 0.0, atol=1e-12)


def test_gravity_force_structure(model, rng):
    """Generalized gravity: linear part = m * g_vec; under pure vertical field

    the base-linear rows carry the whole weight."""
    base_R, base_p, q, _ = random_state(rng)
    kin = K.forward_kinematics(model, base_R, base_p, q)
    g_vec = jnp.array([0.0, 0.0, 9.81], dtype=jnp.float64)
    grav = np.asarray(D.gravity_force(model, kin, g_vec))
    assert np.allclose(grav[:3], float(model.total_mass) * np.asarray(g_vec), atol=1e-9)


def test_gravity_free_fall(model, rng):
    """forward_dynamics with zero applied torque: CoM acceleration = -g z."""
    base_R, base_p, q, u = random_state(rng)
    udot = D.forward_dynamics(model, base_R, base_p, q, u, jnp.zeros(18, jnp.float64))

    # check d/dt(m v_com) = -m g z  via jvp of com velocity along full flow
    def com_vel(R, p, qq, uu):
        kin = K.forward_kinematics(model, R, p, qq)
        return K.com_velocity(model, kin, uu)

    flow = K.state_flow(base_R, base_p, q, u)
    _, dv = jax.jvp(com_vel, (base_R, base_p, q, u), (*flow, udot))
    assert np.allclose(np.asarray(dv), [0.0, 0.0, -9.81], atol=1e-8)


def test_bias_energy_rate(model, rng):
    """Power identity: with u fixed (u_dot=0), d/dt KE = u^T (M u_dot + Cu)

    = u^T h_C.  Check u^T h_C == jvp of KE along the flow."""
    base_R, base_p, q, u = random_state(rng)

    def ke(R, p, qq):
        kin = K.forward_kinematics(model, R, p, qq)
        return D.kinetic_energy(model, kin, u)

    flow = K.state_flow(base_R, base_p, q, u)
    _, dke = jax.jvp(ke, (base_R, base_p, q), flow)
    h = D.coriolis_bias(model, base_R, base_p, q, u)
    # d/dt KE(q(t), u const) = 0.5 u^T Mdot u ; and u^T C u = 0.5 u^T Mdot u
    assert np.isclose(float(dke), float(jnp.dot(u, h)), rtol=1e-10)


def test_jacobian_parts_equivalences(model, rng):
    """The parts-based (never-materialized-J) assembly reproduces the
    J-stack mass matrix, force projection, and body velocities exactly."""
    from quadrupedwholebodycontroller.ops import kinematics as K

    for _ in range(3):
        R = K.spatial.axis_angle_to_matrix(
            jnp.asarray(rng.normal(size=3) / 3), jnp.asarray(rng.normal())
        ) if hasattr(K, "spatial") else jnp.eye(3)
        from quadrupedwholebodycontroller.ops import spatial
        ax = rng.normal(size=3); ax = ax / np.linalg.norm(ax)
        R = spatial.axis_angle_to_matrix(jnp.asarray(ax), jnp.asarray(rng.normal()))
        p = jnp.asarray(rng.normal(size=3))
        q = jnp.asarray(rng.normal(size=12))
        u = jnp.asarray(rng.normal(size=18))
        kin = K.forward_kinematics(model, R, p, q)
        J = K.body_com_jacobians(model, kin)
        parts = K.body_com_jacobian_parts(model, kin)

        M_ref = D.mass_matrix(model, kin, J)
        M_new = D.mass_matrix_from_parts(model, kin, parts)
        assert np.allclose(np.asarray(M_new), np.asarray(M_ref), atol=1e-11)

        F = jnp.asarray(rng.normal(size=(model.num_bodies, 3)))
        N = jnp.asarray(rng.normal(size=(model.num_bodies, 3)))
        h_ref = (jnp.einsum("bik,bi->k", J[:, :3, :], F)
                 + jnp.einsum("bik,bi->k", J[:, 3:, :], N))
        h_new = D.project_forces_from_parts(parts, F, N)
        assert np.allclose(np.asarray(h_new), np.asarray(h_ref), atol=1e-11)

        vel6 = jnp.einsum("bij,j->bi", J, u)
        v, w = K.parts_velocities(parts, u)
        assert np.allclose(np.asarray(v), np.asarray(vel6[:, :3]), atol=1e-11)
        assert np.allclose(np.asarray(w), np.asarray(vel6[:, 3:]), atol=1e-11)


def test_velocity_product_recursion_matches_jvp(model, rng):
    """The closed-form level recursion for velocity-product accelerations
    (velocity_product_kinematics) must reproduce the jvp-derived bias and
    body velocities exactly — the jvp route is exact by construction."""
    for _ in range(5):
        base_R, base_p, q, u = random_state(rng)
        h1, kin1, _, v1 = D.coriolis_bias_full(model, base_R, base_p, q, u)
        h2, kin2, _, v2 = D.coriolis_bias_full_jvp(model, base_R, base_p, q, u)
        assert np.allclose(np.asarray(h1), np.asarray(h2), atol=1e-11)
        assert np.allclose(np.asarray(v1), np.asarray(v2), atol=1e-12)

        # the recursion's own w must equal the Jacobian-parts angular velocity
        parts = K.body_com_jacobian_parts(model, kin1)
        _, w_parts = K.parts_velocities(parts, u)
        w, alpha, a_c = D.velocity_product_kinematics(model, kin1, u)
        assert np.allclose(np.asarray(w), np.asarray(w_parts), atol=1e-12)

"""Robustness-sweep scenario layer: payload lumping, pushes, friction."""
import jax
import jax.numpy as jnp
import numpy as np

from quadrupedwholebodycontroller.config import (
    ControllerParams,
    PlannerParams,
    QPSolverParams,
)
from quadrupedwholebodycontroller.models import anymal_d_model
from quadrupedwholebodycontroller.ops import dynamics as D
from quadrupedwholebodycontroller.ops import kinematics as K
from quadrupedwholebodycontroller.sim import SimParams
from quadrupedwholebodycontroller.sim.rollout import (
    closed_loop_rollout,
    init_rollout_carry,
)
from quadrupedwholebodycontroller.sim.scenario import Scenario, apply_payload


def test_apply_payload_mass_properties():
    model = anymal_d_model(dtype=jnp.float64)
    m_extra = jnp.asarray(5.0, jnp.float64)
    com_p = jnp.asarray([0.1, 0.0, 0.1], jnp.float64)
    pert = apply_payload(model, m_extra, com_p)
    assert np.isclose(float(pert.total_mass), float(model.total_mass) + 5.0)
    # composite CoM between originals
    c0 = np.asarray(model.com[0]); c1 = np.asarray(pert.com[0])
    expect = (float(model.mass[0]) * c0 + 5.0 * np.asarray(com_p)) / float(pert.mass[0])
    assert np.allclose(c1, expect)
    # inertia stays symmetric positive definite
    I1 = np.asarray(pert.inertia[0])
    assert np.allclose(I1, I1.T)
    assert np.all(np.linalg.eigvalsh(I1) > 0)
    # kinetic-energy identity still holds for the perturbed model
    kin = K.forward_kinematics(
        pert, jnp.eye(3, dtype=jnp.float64), jnp.zeros(3, jnp.float64),
        jnp.zeros(12, jnp.float64),
    )
    u = jnp.asarray(np.random.default_rng(0).normal(size=18), jnp.float64)
    M = D.mass_matrix(pert, kin)
    ke = D.kinetic_energy(pert, kin, u)
    assert np.isclose(float(0.5 * u @ M @ u), float(ke), rtol=1e-12)


def test_push_and_payload_rollout():
    """Standing with a 10 kg payload and a lateral push: the controller

    (nominal model) still holds the robot up; the push visibly displaces it."""
    dtype = jnp.float64
    model = anymal_d_model(dtype=dtype)
    cp, pp, sp = ControllerParams(), PlannerParams(), SimParams()
    qp = QPSolverParams()
    T = 260
    push = jnp.zeros((T, 6), dtype).at[120:160, 1].set(60.0)  # 60 N lateral
    scen = Scenario(
        sim_friction=jnp.asarray(0.9, dtype),
        payload_mass=jnp.asarray(10.0, dtype),
        payload_com=jnp.asarray([0.05, 0.0, 0.1], dtype),
        push_wrench=push,
    )
    sim_model = apply_payload(model, scen.payload_mass, scen.payload_com)
    carry = init_rollout_carry(model, cp, pp, dtype=dtype)
    cmds = jnp.zeros((T, 3), dtype)
    fn = jax.jit(
        lambda c, x: closed_loop_rollout(
            model, cp, pp, qp, sp, c, x, scen, sim_model
        )
    )
    _, tr = fn(carry, cmds)
    com = np.asarray(tr.com_pos)
    assert np.all(np.isfinite(com))
    assert com[:, 2].min() > 0.4          # survives payload + push
    # the push moves the CoM laterally, the controller recovers toward 0
    y_excursion = np.abs(com[120:200, 1]).max()
    assert y_excursion > 0.003
    assert abs(com[-1, 1]) < y_excursion + 1e-9
    # GRFs now carry robot + payload weight
    grf_z = np.asarray(tr.grf)[-1].reshape(4, 3)[:, 2].sum()
    assert grf_z > (51.63574 + 8.0) * 9.81 * 0.9


def test_scenario_random_batch_shapes(rng):
    scen = Scenario.random_batch(jax.random.PRNGKey(1), 8, 100, jnp.float32)
    assert scen.sim_friction.shape == (8,)
    assert scen.push_wrench.shape == (8, 100, 6)
    # each scenario has exactly one push window of the right length
    w = np.asarray(jnp.abs(scen.push_wrench).sum(-1) > 0)
    assert np.all(w.sum(axis=1) == 40)

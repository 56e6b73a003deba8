"""Torque parity evidence chain (BASELINE.md: per-scenario torque error

<= 1e-3 N m vs the C++ reference at the same control rate).

The C++ stack cannot run here (no ROS/Gazebo/iDynTree), so parity is
established by the chain:
  1. the dynamics quantities match an independent C++ Featherstone oracle to
     1e-10 (tests/test_native_oracle.py) — the iDynTree-equivalent layer;
  2. the QP formulation is replicated block-for-block from
     src/whole_body_controller.cpp:466-515 (SURVEY.md §3.5), and the QP is
     strictly convex, so its solution — and hence the torque map
     tau = M_jj qdd + h_j - J^T F (cpp:565-568) — is unique given the data;
  3. this test: on real WBC QP instances from a walking rollout, the
     framework's solver and an independent solver (scipy SLSQP) produce
     torques agreeing to <= 1e-3 N m.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from quadrupedwholebodycontroller.config import (
    ControllerParams,
    PlannerParams,
    QPSolverParams,
)
from quadrupedwholebodycontroller.control import wbc
from quadrupedwholebodycontroller.models import anymal_d_model
from quadrupedwholebodycontroller.ops import qp as qpm
from quadrupedwholebodycontroller.planner import gait
from quadrupedwholebodycontroller.sim import SimParams, world
from quadrupedwholebodycontroller.sim.rollout import init_rollout_carry


def scipy_qp(data):
    """Independent oracle: scipy SLSQP on the (Ruiz-equilibrated) QP.

    Equilibration is a benign change of variables — SLSQP otherwise fails
    its linesearch on the raw mixed-magnitude data (wrench rows ~5e2 vs
    acceleration rows ~1)."""
    from scipy.optimize import minimize

    H0 = np.asarray(data.H); g0 = np.asarray(data.g)
    A0 = np.asarray(data.A); l0 = np.asarray(data.l); u0 = np.asarray(data.u)
    d = np.ones(H0.shape[0]); e = np.ones(A0.shape[0])
    for _ in range(10):
        Hs = np.abs(d[:, None] * H0 * d[None, :])
        As = np.abs(e[:, None] * A0 * d[None, :])
        cx = np.maximum(Hs.max(0), As.max(0)); rz = As.max(1)
        d *= 1.0 / np.sqrt(np.maximum(cx, 1e-8))
        e *= 1.0 / np.sqrt(np.maximum(rz, 1e-8))
    H = d[:, None] * H0 * d[None, :]; g = d * g0
    A = e[:, None] * A0 * d[None, :]
    with np.errstate(invalid="ignore"):
        l = e * l0; u = e * u0
    from scipy.optimize import LinearConstraint

    nz = np.abs(A).sum(1) > 1e-12
    lc = np.where(np.isfinite(l), l, -np.inf)[nz]
    uc = np.where(np.isfinite(u), u, np.inf)[nz]
    res = minimize(
        lambda x: 0.5 * x @ H @ x + g @ x, np.zeros(len(g)),
        jac=lambda x: H @ x + g, hess=lambda x: H,
        constraints=[LinearConstraint(A[nz], lc, uc)],
        method="trust-constr",
        options=dict(maxiter=3000, gtol=1e-12, xtol=1e-14),
    )
    assert res.status in (1, 2), (res.status, res.message)
    return d * res.x  # back to original variables


@pytest.mark.parametrize("walk", [False, True])
def test_torque_parity_vs_independent_solver(walk):
    dtype = jnp.float64
    model = anymal_d_model(dtype=dtype)
    cp, pp, sp = ControllerParams(), PlannerParams(), SimParams()
    qp_p = QPSolverParams()

    carry = init_rollout_carry(model, cp, pp, dtype=dtype)
    sim, wcarry, pstate, ref = carry
    setup_fn = jax.jit(lambda o, r, c, n: wbc.wbc_setup(model, cp, o, r, c, n))
    solve_fn = jax.jit(lambda d, w: qpm.solve(d, w, qp_p))
    sim_fn = jax.jit(lambda s, t: world.sim_control_period(model, s, t, sp))
    plan_fn = jax.jit(lambda p, c: gait.planner_step(pp, p, c))

    steps = 120
    check_at = {40, 70, 90, 110}
    worst = 0.0
    for k in range(steps):
        cmd = jnp.array([0.5, 0.0, 0.0], dtype) if (walk and k >= 30) else jnp.zeros(3, dtype)
        ref_new = False
        if k % 4 == 0:
            pstate, nref, pub = plan_fn(pstate, cmd)
            ref = jax.tree.map(lambda n, o: jnp.where(pub, n, o), nref, ref)
            ref_new = bool(pub)
        obs = world.observe(sim)
        setup = setup_fn(obs, ref, wcarry, ref_new)
        switch = setup.carry_updates["switch_flag"]
        warm = qpm.QPState(
            x=wcarry.qp_warm.x,
            z=jnp.where(switch, 0.0, wcarry.qp_warm.z),
            y=jnp.where(switch, 0.0, wcarry.qp_warm.y),
        )
        qp_state, info = solve_fn(setup.qp_data, warm)

        def torque(x):
            x = np.asarray(x)
            return (
                np.asarray(setup.Mc_jj) @ x[6:18]
                + np.asarray(setup.h_c)[6:]
                - np.asarray(setup.Jc_st_j).T @ x[18:30]
            )

        if k in check_at:
            x_ref = scipy_qp(setup.qp_data)
            dtau = np.abs(torque(qp_state.x) - torque(x_ref)).max()
            worst = max(worst, dtau)
            assert dtau <= 1e-3, (k, dtau)

        tau = torque(qp_state.x)
        wcarry = wbc.WBCCarry(qp_warm=qp_state, **setup.carry_updates)
        sim = sim_fn(sim, jnp.asarray(tau, dtype))
    assert worst <= 1e-3

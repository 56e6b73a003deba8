"""End-to-end differentiability — a capability class the C++ reference

cannot offer: gradients through the entire closed loop (planner reference,
WBC QP solve, contact physics) enable on-device gain tuning / policy
learning.  The QP's ADMM iterations (unrolled scan) and matmul-only polish
are plain differentiable JAX ops."""
import jax
import jax.numpy as jnp
import numpy as np

from quadrupedwholebodycontroller.config import (
    ControllerParams,
    PlannerParams,
    QPSolverParams,
)
from quadrupedwholebodycontroller.models import anymal_d_model
from quadrupedwholebodycontroller.sim import SimParams, closed_loop_rollout
from quadrupedwholebodycontroller.sim.rollout import init_rollout_carry


def _make_cost(model, pp, sp, qp, T, dtype):
    def cost(log_kp):
        cp = ControllerParams(kp=jnp.exp(log_kp))
        carry = init_rollout_carry(model, cp, pp, dtype=dtype)
        cmds = jnp.zeros((T, 3), dtype)
        _, tr = closed_loop_rollout(model, cp, pp, qp, sp, carry, cmds)
        err = tr.com_pose[:, :3] - tr.ref_com_pose[:, :3]
        return jnp.mean(err**2)

    return cost


def test_gradient_through_closed_loop():
    """d(tracking cost)/d(kp gain): finite, and a gradient step reduces the

    cost — the loss landscape is locally informative through 16 control
    cycles of QP + contact dynamics.  (Gradient magnitude grows with the
    horizon — standard BPTT-through-stiff-dynamics behaviour — so long
    horizons need clipping/truncation like any recurrent system; finiteness
    is asserted at T=30 separately.)"""
    dtype = jnp.float64
    model = anymal_d_model(dtype=dtype)
    pp, sp = PlannerParams(), SimParams(substeps=4)
    qp = QPSolverParams(iterations=40, polish=False)  # smooth solver path

    cost = _make_cost(model, pp, sp, qp, 16, dtype)
    # start from a detuned gain (kp = 600, a tenth of nominal)
    log_kp0 = jnp.log(jnp.asarray(600.0, dtype))
    val, grad = jax.value_and_grad(cost)(log_kp0)
    assert np.isfinite(float(val)) and np.isfinite(float(grad))
    assert float(grad) != 0.0
    # one gradient step must reduce the tracking cost
    val2 = cost(log_kp0 - 0.3 * jnp.sign(grad))
    assert float(val2) < float(val), (float(val), float(val2), float(grad))


def test_gradient_finite_long_horizon():
    dtype = jnp.float64
    model = anymal_d_model(dtype=dtype)
    pp, sp = PlannerParams(), SimParams(substeps=4)
    qp = QPSolverParams(iterations=40, polish=False)
    cost = _make_cost(model, pp, sp, qp, 30, dtype)
    grad = jax.grad(cost)(jnp.log(jnp.asarray(600.0, dtype)))
    assert np.isfinite(float(grad))

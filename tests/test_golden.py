"""Golden regression traces: the control law's exact f64 behavior is pinned

(standing / walking / trot / teleop closed loops, plus the
exact-derivative controller mode).  A diff here means the controller's
numerical behavior changed — if intentional, regenerate with
tools/make_golden.py and explain in the commit message."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from quadrupedwholebodycontroller.config import (
    ControllerParams,
    PlannerParams,
    QPSolverParams,
)
from quadrupedwholebodycontroller.models import anymal_d_model
from quadrupedwholebodycontroller.sim import SimParams, closed_loop_rollout
from quadrupedwholebodycontroller.sim.rollout import (
    init_rollout_carry,
    trot_rollout,
)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def teleop_commands(T=400):
    cmds = np.zeros((T, 3))
    cmds[80:200, 0] = 0.4
    cmds[200:320, 0] = 0.3
    cmds[200:320, 2] = 0.3
    return cmds


def run(T, walk_after=None, gait="walk", cmds=None, exact_derivatives=False):
    dtype = jnp.float64
    model = anymal_d_model(dtype=dtype)
    cp = ControllerParams(exact_derivatives=exact_derivatives)
    pp, sp = PlannerParams(), SimParams()
    qp = QPSolverParams()
    if cmds is None:
        cmds = jnp.zeros((T, 3), dtype)
        if walk_after is not None:
            cmds = cmds.at[walk_after:, 0].set(0.5)
    else:
        cmds = jnp.asarray(cmds, dtype)
    if gait == "trot":
        from quadrupedwholebodycontroller.planner.trot import (
            TrotParams,
            init_trot_state,
        )

        tp = TrotParams()
        carry = init_rollout_carry(
            model, cp, pp, dtype=dtype, planner_state=init_trot_state(tp, dtype)
        )
        _, tr = jax.jit(
            lambda c, x: trot_rollout(model, cp, tp, qp, sp, c, x)
        )(carry, cmds)
        return tr
    carry = init_rollout_carry(model, cp, pp, dtype=dtype)
    _, tr = jax.jit(
        lambda c, x: closed_loop_rollout(model, cp, pp, qp, sp, c, x)
    )(carry, cmds)
    return tr


@pytest.mark.parametrize("name,kwargs", [
    ("standing", dict(T=200)),
    ("walking", dict(T=400, walk_after=100)),
    ("trot", dict(T=400, walk_after=100, gait="trot")),
    ("teleop", dict(T=400, cmds=teleop_commands(400))),
    ("standing_exact", dict(T=200, exact_derivatives=True)),
])
def test_golden_trace(name, kwargs):
    tr = run(**kwargs)
    with np.load(os.path.join(GOLDEN, f"{name}.npz")) as g:
        # trajectories are chaotic: identical code must match to fp-noise
        # levels; any algorithmic change shows up at O(1)
        assert np.allclose(np.asarray(tr.com_pose)[::10], g["com_pose"], atol=1e-6), name
        assert np.allclose(np.asarray(tr.tau)[::10], g["tau"], atol=1e-3), name
        assert np.allclose(np.asarray(tr.q)[::10], g["q"], atol=1e-6), name

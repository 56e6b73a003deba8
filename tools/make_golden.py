#!/usr/bin/env python3
"""Regenerate the golden regression traces (tests/golden/*.npz).

Run after an INTENTIONAL behavior change; the pinned values guard future
rounds against silent drift of the control law (f64, CPU, deterministic).
"""
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

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

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "..", "tests", "golden")


def generate(name, T, walk_after=None, gait="walk", cmds=None,
             exact_derivatives=False):
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
        T = cmds.shape[0]
    if gait == "trot":
        from quadrupedwholebodycontroller.planner.trot import (
            TrotParams,
            init_trot_state,
        )
        from quadrupedwholebodycontroller.sim.rollout import trot_rollout

        tp = TrotParams()
        carry = init_rollout_carry(
            model, cp, pp, dtype=dtype,
            planner_state=init_trot_state(tp, dtype),
        )
        _, tr = jax.jit(
            lambda c, x: trot_rollout(model, cp, tp, qp, sp, c, x)
        )(carry, cmds)
    else:
        carry = init_rollout_carry(model, cp, pp, dtype=dtype)
        _, tr = jax.jit(
            lambda c, x: closed_loop_rollout(model, cp, pp, qp, sp, c, x)
        )(carry, cmds)
    # subsample every 10th step to keep the files tiny
    out = dict(
        com_pose=np.asarray(tr.com_pose)[::10],
        tau=np.asarray(tr.tau)[::10],
        grf=np.asarray(tr.grf)[::10],
        q=np.asarray(tr.q)[::10],
    )
    os.makedirs(GOLDEN_DIR, exist_ok=True)
    path = os.path.join(GOLDEN_DIR, f"{name}.npz")
    np.savez_compressed(path, **out)
    print(f"{name}: T={T} -> {path}")


def teleop_commands(T=400):
    """The ZOH command stream of a teleop session: stand, walk forward,
    add yaw, stop (mirrors cli teleop-replay semantics)."""
    import numpy as _np

    cmds = _np.zeros((T, 3))
    cmds[80:200, 0] = 0.4      # forward
    cmds[200:320, 0] = 0.3     # forward + turn
    cmds[200:320, 2] = 0.3
    return cmds


if __name__ == "__main__":
    generate("standing", 200)
    generate("walking", 400, walk_after=100)
    generate("trot", 400, walk_after=100, gait="trot")
    generate("teleop", 400, cmds=teleop_commands(400))
    generate("standing_exact", 200, exact_derivatives=True)

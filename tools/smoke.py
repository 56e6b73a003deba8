#!/usr/bin/env python3
"""Interactive smoke test of the full closed-loop stack on CPU/f64."""
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np

from quadrupedwholebodycontroller.config import (
    ControllerParams, PlannerParams, QPSolverParams,
)
from quadrupedwholebodycontroller.models import anymal_d_model
from quadrupedwholebodycontroller.sim import (
    SimParams, closed_loop_rollout,
)
from quadrupedwholebodycontroller.sim.rollout import init_rollout_carry

dtype = jnp.float64
model = anymal_d_model(dtype=dtype)
cp = ControllerParams()
pp = PlannerParams()
qp = QPSolverParams(iterations=60)
sp = SimParams()

carry = init_rollout_carry(model, cp, pp, dtype=dtype)
T = int(sys.argv[1]) if len(sys.argv) > 1 else 200
mode = sys.argv[2] if len(sys.argv) > 2 else "stand"
cmds = jnp.zeros((T, 3), dtype)
if mode == "walk":
    # stand 0.25 s then walk forward
    cmds = cmds.at[100:, 0].set(0.5)

roll = jax.jit(
    lambda c, x: closed_loop_rollout(model, cp, pp, qp, sp, c, x)
)
import time
t0 = time.time()
carry2, trace = roll(carry, cmds)
jax.block_until_ready(trace)
print(f"compile+run: {time.time()-t0:.1f}s")

com = np.asarray(trace.com_pos)
tau = np.asarray(trace.tau)
kkt = np.asarray(trace.qp_kkt)
print("com z: start %.4f  end %.4f  min %.4f  max %.4f" % (com[0,2], com[-1,2], com[:,2].min(), com[:,2].max()))
print("com xy end:", com[-1,:2])
print("tau max abs: %.2f  (limit 80)" % np.abs(tau).max())
print("kkt resid: median %.2e  max %.2e" % (np.median(kkt), kkt.max()))
print("grf z sum end: %.1f (weight %.1f)" % (np.asarray(trace.grf)[-1].reshape(4,3)[:,2].sum(), 51.63574*9.81))
print("pose err end:", np.asarray(trace.com_pose[-1]) - np.asarray(trace.ref_com_pose[-1]))

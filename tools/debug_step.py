#!/usr/bin/env python3
"""Step-by-step NaN hunt: run the rollout python-side, step by step."""
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
from quadrupedwholebodycontroller.control import wbc
from quadrupedwholebodycontroller.planner import gait
from quadrupedwholebodycontroller.sim import world

dtype = jnp.float64
model = anymal_d_model(dtype=dtype)
cp = ControllerParams()
pp = PlannerParams()
qp_p = QPSolverParams(iterations=60)
sp = world.SimParams()

from quadrupedwholebodycontroller.sim.rollout import init_rollout_carry
carry = init_rollout_carry(model, cp, pp, dtype=dtype)
sim, wcarry, pstate, ref = carry

step_wbc = jax.jit(lambda obs, ref, wc, new: wbc.wbc_step(model, cp, qp_p, obs, ref, wc, new))
step_sim = jax.jit(lambda s, tau: world.sim_control_period(model, s, tau, sp))
step_plan = jax.jit(lambda ps, cmd: gait.planner_step(pp, ps, cmd))

cmd = jnp.zeros(3, dtype)
for k in range(40):
    if k % 4 == 0:
        pstate, new_ref, pub = step_plan(pstate, cmd)
        ref = jax.tree.map(lambda n, o: jnp.where(pub, n, o), new_ref, ref)
        ref_new = bool(pub)
    else:
        ref_new = False
    obs = world.observe(sim)
    out, wcarry = step_wbc(obs, ref, wcarry, ref_new)
    def nan_report(tree, name):
        bad = [k2 for k2, v in tree._asdict().items()
               if hasattr(v, 'dtype') and jnp.issubdtype(v.dtype, jnp.floating) and not bool(jnp.all(jnp.isfinite(v)))]
        if bad:
            print(f"step {k}: NaN in {name}: {bad}")
            return True
        return False
    b1 = nan_report(out, "wbc out")
    sim = step_sim(sim, out.tau)
    b2 = nan_report(sim, "sim")
    if b1 or b2:
        print("tau:", np.asarray(out.tau))
        print("qp kkt:", float(out.qp_info.kkt_residual), "polished", bool(out.qp_info.polished))
        print("base_p:", np.asarray(sim.base_p), "u:", np.asarray(sim.u))
        break
    if k < 6 or k % 10 == 0:
        print(f"step {k}: com z={float(out.com_pos[2]):.4f} tau_max={float(jnp.max(jnp.abs(out.tau))):.1f} "
              f"kkt={float(out.qp_info.kkt_residual):.2e} pol={bool(out.qp_info.polished)} "
              f"grfz={float(jnp.sum(out.grf.reshape(4,3)[:,2])):.1f}")

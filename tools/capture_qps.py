#!/usr/bin/env python3
"""Capture the per-step WBC QPs from a walking rollout into an npz for

offline solver experiments."""
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
from quadrupedwholebodycontroller.sim.rollout import init_rollout_carry
from quadrupedwholebodycontroller.ops import qp as qp_mod

dtype = jnp.float64
model = anymal_d_model(dtype=dtype)
cp, pp = ControllerParams(), PlannerParams()
qp_p = QPSolverParams(iterations=60)
sp = world.SimParams()

carry = init_rollout_carry(model, cp, pp, dtype=dtype)
sim, wcarry, pstate, ref = carry

setup_fn = jax.jit(lambda obs, ref, wc, new: wbc.wbc_setup(model, cp, obs, ref, wc, new))
solve_fn = jax.jit(lambda data, warm: qp_mod.solve(data, warm, qp_p))
step_sim = jax.jit(lambda s, tau: world.sim_control_period(model, s, tau, sp))
step_plan = jax.jit(lambda ps, cmd: gait.planner_step(pp, ps, cmd))

T = int(sys.argv[1]) if len(sys.argv) > 1 else 300
Hs, gs, As, ls, us, warms_x, warms_z, warms_y, kkts = [], [], [], [], [], [], [], [], []
for k in range(T):
    cmd = jnp.array([0.5, 0.0, 0.0], dtype) if k >= 100 else jnp.zeros(3, dtype)
    ref_new = False
    if k % 4 == 0:
        pstate, new_ref, pub = step_plan(pstate, cmd)
        ref = jax.tree.map(lambda n, o: jnp.where(pub, n, o), new_ref, ref)
        ref_new = bool(pub)
    obs = world.observe(sim)
    setup = setup_fn(obs, ref, wcarry, ref_new)
    switch = setup.carry_updates["switch_flag"]
    warm = qp_mod.QPState(
        x=wcarry.qp_warm.x,
        z=jnp.where(switch, 0.0, wcarry.qp_warm.z),
        y=jnp.where(switch, 0.0, wcarry.qp_warm.y),
    )
    qp_state, qp_info = solve_fn(setup.qp_data, warm)
    Hs.append(np.asarray(setup.qp_data.H)); gs.append(np.asarray(setup.qp_data.g))
    As.append(np.asarray(setup.qp_data.A)); ls.append(np.asarray(setup.qp_data.l))
    us.append(np.asarray(setup.qp_data.u))
    warms_x.append(np.asarray(warm.x)); warms_z.append(np.asarray(warm.z)); warms_y.append(np.asarray(warm.y))
    kkts.append(float(qp_info.kkt_residual))
    qdd = qp_state.x[6:18]; grf = qp_state.x[18:30]
    tau = setup.Mc_jj @ qdd + setup.h_c[6:] - setup.Jc_st_j.T @ grf
    wcarry = wbc.WBCCarry(qp_warm=qp_state, **setup.carry_updates)
    sim = step_sim(sim, tau)

np.savez_compressed(
    "/tmp/qps.npz", H=np.stack(Hs), g=np.stack(gs), A=np.stack(As),
    l=np.stack(ls), u=np.stack(us), wx=np.stack(warms_x), wz=np.stack(warms_z),
    wy=np.stack(warms_y), kkt=np.array(kkts),
)
kk = np.array(kkts)
print("saved", T, "QPs; spikes(kkt>0.1):", np.where(kk > 0.1)[0][:30])

#!/usr/bin/env python3
"""Record a steady-walking (obs, ref, ref_is_new) trajectory for bench.py's
evolving mode.

The round-1 headline bench held obs/ref constant through the scan, so every
step re-solved the SAME QP with a converged warm start — the absolute best
case for the warm path (VERDICT r1, weak #3).  This tool captures the real
thing: a closed-loop walking rollout (planner 100 Hz + WBC 400 Hz + physics,
the reference's node graph at src/whole_body_controller.cpp:637-676) whose
per-step observations, planner references and publish ticks are replayed by
bench.py so warm starts and the QPCache run under realistic per-step drift,
including contact switches.

Writes data/walk_traj_400hz.npz (f32, ~200 KB).  Run on CPU (f64 sim, cast
on save).
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
from quadrupedwholebodycontroller.control import wbc
from quadrupedwholebodycontroller.models import anymal_d_model
from quadrupedwholebodycontroller.planner import gait
from quadrupedwholebodycontroller.sim import world
from quadrupedwholebodycontroller.sim.rollout import init_rollout_carry


def main():
    warmup = int(sys.argv[1]) if len(sys.argv) > 1 else 400   # control steps
    record = int(sys.argv[2]) if len(sys.argv) > 2 else 200
    out = sys.argv[3] if len(sys.argv) > 3 else os.path.join(
        os.path.dirname(__file__), "..", "data", "walk_traj_400hz.npz"
    )
    dtype = jnp.float64
    model = anymal_d_model(dtype=dtype)
    cp, pp = ControllerParams(), PlannerParams()
    qp_p = QPSolverParams()
    sp = world.SimParams()

    sim, wcarry, pstate, ref = init_rollout_carry(model, cp, pp, dtype=dtype)

    step_ctrl = jax.jit(
        lambda obs, ref, wc, new: wbc.wbc_step(model, cp, qp_p, obs, ref, wc, new)
    )
    step_sim = jax.jit(lambda s, tau: world.sim_control_period(model, s, tau, sp))
    step_plan = jax.jit(lambda ps, cmd: gait.planner_step(pp, ps, cmd))

    rec = {k: [] for k in (
        "base_R", "base_p", "base_vel", "q", "qd",
        "com_pose", "com_vel", "com_acc", "swing_pos", "swing_vel",
        "swing_acc", "contacts", "ref_is_new",
    )}
    switches = 0
    prev_contacts = np.asarray(ref.contacts)
    for k in range(warmup + record):
        # stand briefly, then walk (the CLI walk profile)
        cmd = jnp.array([0.5, 0.0, 0.0], dtype) if k >= 100 else jnp.zeros(3, dtype)
        ref_new = False
        if k % 4 == 0:  # 100 Hz planner over the 400 Hz loop
            pstate, new_ref, pub = step_plan(pstate, cmd)
            ref = jax.tree.map(lambda n, o: jnp.where(pub, n, o), new_ref, ref)
            ref_new = bool(pub)
        obs = world.observe(sim)
        if k >= warmup:
            for name in ("base_R", "base_p", "base_vel", "q", "qd"):
                rec[name].append(np.asarray(getattr(obs, name)))
            for name in ("com_pose", "com_vel", "com_acc", "swing_pos",
                         "swing_vel", "swing_acc", "contacts"):
                rec[name].append(np.asarray(getattr(ref, name)))
            rec["ref_is_new"].append(ref_new)
            c = np.asarray(ref.contacts)
            if ref_new and (c != prev_contacts).any():
                switches += 1
            prev_contacts = c
        out_step, wcarry = step_ctrl(obs, ref, wcarry, ref_new)
        sim = step_sim(sim, out_step.tau)

    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    arrays = {
        k: np.stack(v).astype(np.float32) if k != "ref_is_new" else np.asarray(v)
        for k, v in rec.items()
    }
    np.savez_compressed(out, **arrays)
    z = arrays["base_p"][:, 2]
    print(
        f"saved {record} steps to {out}: contact switches={switches}, "
        f"com z=[{z.min():.3f},{z.max():.3f}], "
        f"x travel={arrays['base_p'][-1, 0] - arrays['base_p'][0, 0]:.3f} m"
    )
    assert switches >= 1, "recorded window contains no contact switch"


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Record a DIVERSE set of closed-loop trajectories for bench.py's diverse
replay mode (VERDICT r2 #6).

The nominal headline replay (data/walk_traj_400hz.npz) is one walk tiled
across the batch with constant state offsets: every scenario's contact
switches land on the same step, which flatters both the QPCache (switches
batch-synchronized) and the rescue (homogeneous tail).  This tool records
FOUR heterogeneous profiles; bench.py's diverse mode tiles them across the
batch with per-scenario phase offsets so contact switches desynchronize —
the workload the per-scenario warm gate (ops/qp.py cold_batch) exists for.

Profiles (200 steps @ 400 Hz each):
  0 walk       — nominal static walk, cmd (0.5, 0, 0)          [BASELINE cfg 2]
  1 walk_turn  — faster walk with yaw rate, cmd (0.7, 0, 0.4)
  2 trot       — diagonal-pair trot, cmd (0.4, 0, 0)           [BASELINE cfg 3]
  3 payload    — nominal walk with a 10 kg base payload and
                 friction 0.6 in the SIM only (controller keeps
                 the nominal model — unmodeled payload, the
                 sweep's robustness axis)                       [BASELINE cfg 5]

Writes data/diverse_traj_400hz.npz with a leading profile axis (P, T, ...).
Run on CPU (f64 sim, cast on save):
    JAX_PLATFORMS=cpu python tools/make_diverse_traj.py
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
from quadrupedwholebodycontroller.planner import gait, trot
from quadrupedwholebodycontroller.sim import world
from quadrupedwholebodycontroller.sim.rollout import init_rollout_carry
from quadrupedwholebodycontroller.sim.scenario import apply_payload

REC_KEYS = (
    "base_R", "base_p", "base_vel", "q", "qd",
    "com_pose", "com_vel", "com_acc", "swing_pos", "swing_vel",
    "swing_acc", "contacts", "ref_is_new",
)


def record_profile(name, cmd_vec, warmup, record, use_trot=False,
                   payload_kg=0.0, sim_friction=None):
    dtype = jnp.float64
    model = anymal_d_model(dtype=dtype)
    sim_model = (
        apply_payload(model, jnp.asarray(payload_kg, dtype),
                      jnp.asarray([0.1, 0.0, 0.05], dtype))
        if payload_kg else model
    )
    cp, pp = ControllerParams(), PlannerParams()
    qp_p = QPSolverParams()
    sp = world.SimParams()
    fric = (jnp.asarray(sim_friction, dtype)
            if sim_friction is not None else None)

    tp = trot.TrotParams()
    if use_trot:
        sim, wcarry, _, ref = init_rollout_carry(model, cp, pp, dtype=dtype)
        pstate = trot.init_trot_state(tp, dtype)
        step_plan = jax.jit(lambda ps, cmd: trot.trot_step(tp, ps, cmd))
        plan_every = 1  # trot planner ticks at the control rate
    else:
        sim, wcarry, pstate, ref = init_rollout_carry(model, cp, pp, dtype=dtype)
        step_plan = jax.jit(lambda ps, cmd: gait.planner_step(pp, ps, cmd))
        plan_every = 4  # 100 Hz planner over the 400 Hz loop

    step_ctrl = jax.jit(
        lambda obs, ref, wc, new: wbc.wbc_step(model, cp, qp_p, obs, ref, wc, new)
    )
    step_sim = jax.jit(
        lambda s, tau: world.sim_control_period(sim_model, s, tau, sp,
                                                friction=fric)
    )

    rec = {k: [] for k in REC_KEYS}
    switches = 0
    prev_contacts = np.asarray(ref.contacts)
    for k in range(warmup + record):
        cmd = (jnp.asarray(cmd_vec, dtype) if k >= 100
               else jnp.zeros(3, dtype))
        ref_new = False
        if k % plan_every == 0:
            pstate, new_ref, pub = step_plan(pstate, cmd)
            ref = jax.tree.map(lambda n, o: jnp.where(pub, n, o), new_ref, ref)
            ref_new = bool(pub)
        obs = world.observe(sim)
        if k >= warmup:
            for nm in ("base_R", "base_p", "base_vel", "q", "qd"):
                rec[nm].append(np.asarray(getattr(obs, nm)))
            for nm in ("com_pose", "com_vel", "com_acc", "swing_pos",
                       "swing_vel", "swing_acc", "contacts"):
                rec[nm].append(np.asarray(getattr(ref, nm)))
            rec["ref_is_new"].append(ref_new)
            c = np.asarray(ref.contacts)
            if ref_new and (c != prev_contacts).any():
                switches += 1
            prev_contacts = c
        out_step, wcarry = step_ctrl(obs, ref, wcarry, ref_new)
        sim = step_sim(sim, out_step.tau)

    arrays = {
        k: (np.stack(v).astype(np.float32) if k != "ref_is_new"
            else np.asarray(v))
        for k, v in rec.items()
    }
    z = arrays["base_p"][:, 2]
    print(f"{name}: switches={switches}, com z=[{z.min():.3f},{z.max():.3f}], "
          f"x travel={arrays['base_p'][-1, 0] - arrays['base_p'][0, 0]:.3f} m",
          flush=True)
    assert switches >= 1, f"{name}: no contact switch in the window"
    assert z.min() > 0.3, f"{name}: robot fell during recording"
    return arrays


def main():
    warmup = int(sys.argv[1]) if len(sys.argv) > 1 else 400
    record = int(sys.argv[2]) if len(sys.argv) > 2 else 200
    out = os.path.join(os.path.dirname(__file__), "..", "data",
                       "diverse_traj_400hz.npz")
    profiles = [
        record_profile("walk", (0.5, 0.0, 0.0), warmup, record),
        record_profile("walk_turn", (0.7, 0.0, 0.4), warmup, record),
        record_profile("trot", (0.4, 0.0, 0.0), warmup, record,
                       use_trot=True),
        record_profile("payload", (0.5, 0.0, 0.0), warmup, record,
                       payload_kg=10.0, sim_friction=0.6),
    ]
    stacked = {
        k: np.stack([p[k] for p in profiles]) for k in REC_KEYS
    }
    np.savez_compressed(out, **stacked)
    print(f"saved {len(profiles)} x {record} steps to {out}")


if __name__ == "__main__":
    main()

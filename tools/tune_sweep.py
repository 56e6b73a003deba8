#!/usr/bin/env python3
"""Perturbation-sweep robustness gate for QP solver configs.

Runs the full sharded scenario sweep (BASELINE config 5: random velocity
commands x friction x payload x pushes) for each named config from
tools/tune_qp.py CONFIGS and reports SweepMetrics + steady-state throughput.

    python tools/tune_sweep.py [config ...] [--gait walk|trot]
"""
import json
import os
import sys
import time

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from quadrupedwholebodycontroller.config import ControllerParams, PlannerParams
from quadrupedwholebodycontroller.models import anymal_d_model
from quadrupedwholebodycontroller.parallel import (
    make_mesh,
    shard_batch,
    sharded_sweep_step,
)
from quadrupedwholebodycontroller.sim import SimParams
from quadrupedwholebodycontroller.sim.rollout import init_rollout_carry
from quadrupedwholebodycontroller.sim.scenario import Scenario

from tune_qp import CONFIGS  # noqa: E402

B = int(os.environ.get("TUNE_SWEEP_B", "1024"))
T = int(os.environ.get("TUNE_SWEEP_T", "400"))


def main():
    argv = sys.argv[1:]
    gait = "walk"
    if "--gait" in argv:
        i = argv.index("--gait")
        gait = argv[i + 1]
        argv = argv[:i] + argv[i + 2:]
    names = [a for a in argv if not a.startswith("--")] or ["default"]
    dtype = jnp.float32
    model = anymal_d_model(dtype=dtype)
    cp, pp, sp = ControllerParams(), PlannerParams(), SimParams()
    mesh = make_mesh()

    if gait == "trot":
        from quadrupedwholebodycontroller.planner import trot as trot_mod

        carry = init_rollout_carry(
            model, cp, dtype=dtype,
            planner_state=trot_mod.init_trot_state(trot_mod.TrotParams(), dtype),
        )
    else:
        carry = init_rollout_carry(model, cp, pp, dtype=dtype)
    bcarry0 = jax.tree.map(lambda x: jnp.stack([x] * B), carry)
    key = jax.random.PRNGKey(0)
    kv, ks = jax.random.split(key)
    vx = jax.random.uniform(kv, (B,), dtype, 0.0, 0.8)
    cmds = jnp.zeros((B, T, 3), dtype).at[:, 40:, 0].set(vx[:, None])
    scen = Scenario.random_batch(ks, B, T, dtype)

    bcarry0 = shard_batch(bcarry0, mesh)
    cmds = shard_batch(cmds, mesh)
    scen = shard_batch(scen, mesh)

    for name in names:
        qp = CONFIGS[name]
        step = sharded_sweep_step(model, cp, pp, qp, sp, mesh, gait)
        _, m = step(bcarry0, cmds, scen)
        jax.block_until_ready(m.mean_kkt)
        t0 = time.time()
        _, m = step(bcarry0, cmds, scen)
        jax.block_until_ready(m.mean_kkt)
        dt = time.time() - t0
        print(json.dumps({
            "config": name, "gait": gait, "B": B, "T": T,
            "steps_per_s": round(B * T / dt, 1),
            "mean_kkt": float(m.mean_kkt),
            "max_kkt": float(m.max_kkt),
            "mean_tracking_err": float(m.mean_tracking_err),
            "fallen_fraction": float(m.fallen_fraction),
        }), flush=True)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Measured latency distributions for the WBC control cycle (VERDICT r2 #3).

Two quantities, each actually measured (no estimates):

1. DISPATCHED batch-cycle latency: one jitted full control cycle per
   blocking host call (obs in -> torques out), timed over >= `reps`
   dispatches at B in {1, 1024, 8192}; reports p50/p90/p99 — what a
   host-in-the-loop deployment sees per cycle, dispatch included.

2. SCAN-RESIDENT per-cycle chip time at B=1: the whole 400 Hz loop runs
   on-device as one lax.scan over T cycles (the sim/rollout.py
   architecture — the deployment shape for a real-time robot, reference
   budget 2.5 ms/cycle at whole_body_controller.cpp:639,673); wall/T over
   a T-step scan amortizes the dispatch constant below 1%.  This is the
   number that decides whether the architecture meets the 2.5 ms budget.

Usage:  python tools/measure_latency.py [--reps 100] [--scan-T 4000]
Writes one JSON line per measurement; finishes with a summary line.
"""
import argparse
import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from quadrupedwholebodycontroller.config import ControllerParams, QPSolverParams
from quadrupedwholebodycontroller.control import wbc
from quadrupedwholebodycontroller.models import anymal_d_model
from quadrupedwholebodycontroller.models.anymal import INITIAL_JOINT_POS
from quadrupedwholebodycontroller.ops import qp as qpm


def make_obs(batch, dtype):
    key = jax.random.PRNGKey(0)
    k1, k2, k3, k4 = jax.random.split(key, 4)
    return wbc.RobotObservation(
        base_R=jnp.broadcast_to(jnp.eye(3, dtype=dtype), (batch, 3, 3)),
        base_p=jnp.tile(jnp.array([0.0, 0.0, 0.55], dtype), (batch, 1))
        + 0.01 * jax.random.normal(k1, (batch, 3), dtype),
        base_vel=0.02 * jax.random.normal(k2, (batch, 6), dtype),
        q=jnp.tile(jnp.asarray(INITIAL_JOINT_POS, dtype), (batch, 1))
        + 0.02 * jax.random.normal(k3, (batch, 12), dtype),
        qd=0.05 * jax.random.normal(k4, (batch, 12), dtype),
    )


def dispatched_latency(model, cp, qp, batch, backend, reps, dtype):
    """p50/p90/p99 of one blocking dispatched batch cycle."""
    obs = make_obs(batch, dtype)
    ref = jax.tree.map(
        lambda x: jnp.stack([x] * batch), wbc.Reference.standing(cp, dtype)
    )
    cache = qpm.make_cache(batch, 42, 70, qp, dtype) if backend == "cached" else None

    @jax.jit
    def cycle(carry, cache, valid):
        if cache is not None:
            out, c2, cache2 = wbc.wbc_step_batched(
                model, cp, qp, obs, ref, carry, True, backend, cache, valid
            )
            return out.tau, c2, cache2
        out, c2 = wbc.wbc_step_batched(
            model, cp, qp, obs, ref, carry, True, backend
        )
        return out.tau, c2, None

    carry = jax.tree.map(lambda x: jnp.stack([x] * batch), wbc.init_carry(dtype))
    tau, carry, cache = cycle(carry, cache, False)
    jax.block_until_ready(tau)
    lat = []
    for _ in range(reps):
        t0 = time.perf_counter()
        tau, carry, cache = cycle(carry, cache, True)
        jax.block_until_ready(tau)
        lat.append((time.perf_counter() - t0) * 1e3)
    lat = np.sort(np.array(lat))
    return {
        "metric": "dispatched_cycle_latency_ms",
        "batch": batch,
        "reps": reps,
        "p50": round(float(np.percentile(lat, 50)), 2),
        "p90": round(float(np.percentile(lat, 90)), 2),
        "p99": round(float(np.percentile(lat, 99)), 2),
        "min": round(float(lat[0]), 2),
        "max": round(float(lat[-1]), 2),
    }


def scan_resident_cycle_time(model, cp, qp, T, backend, dtype, batch=1):
    """Wall/T of a T-cycle on-device scan at B=batch (the real-time
    architecture: no host round trips inside the loop)."""
    obs = make_obs(batch, dtype)
    ref = jax.tree.map(
        lambda x: jnp.stack([x] * batch), wbc.Reference.standing(cp, dtype)
    )
    cache = qpm.make_cache(batch, 42, 70, qp, dtype) if backend == "cached" else None

    @jax.jit
    def run(carry, cache, valid):
        def body(cc, _):
            c, cache = cc
            if cache is not None:
                out, c2, cache2 = wbc.wbc_step_batched(
                    model, cp, qp, obs, ref, c, True, backend, cache, valid
                )
            else:
                out, c2 = wbc.wbc_step_batched(
                    model, cp, qp, obs, ref, c, True, backend
                )
                cache2 = None
            return (c2, cache2), jnp.sum(out.tau)
        (c2, cache), taus = jax.lax.scan(body, (carry, cache), None, length=T)
        return c2, cache, taus

    carry = jax.tree.map(lambda x: jnp.stack([x] * batch), wbc.init_carry(dtype))
    carry, cache, taus = run(carry, cache, False)
    jax.block_until_ready(taus)
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        carry, cache, taus = run(carry, cache, True)
        jax.block_until_ready(taus)
        times.append((time.perf_counter() - t0) / T * 1e3)
    times.sort()
    return {
        "metric": "scan_resident_cycle_ms",
        "batch": batch,
        "T": T,
        "per_cycle_ms": round(times[1], 4),
        "budget_ms": 2.5,
        "meets_budget": bool(times[1] <= 2.5),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=100)
    ap.add_argument("--scan-T", type=int, default=4000)
    ap.add_argument("--batches", type=str, default="1,1024,8192")
    args = ap.parse_args()

    dtype = jnp.float32
    backend = "cached" if jax.default_backend() != "cpu" else "xla"
    model = anymal_d_model(dtype=dtype)
    cp = ControllerParams()
    qp = QPSolverParams()

    out = {"backend": backend, "device": jax.default_backend()}
    for b in (int(x) for x in args.batches.split(",")):
        row = dispatched_latency(model, cp, qp, b, backend, args.reps, dtype)
        print(json.dumps(row), flush=True)
        out[f"dispatched_B{b}"] = row
    row = scan_resident_cycle_time(model, cp, qp, args.scan_T, backend, dtype)
    print(json.dumps(row), flush=True)
    out["scan_resident_B1"] = row
    print(json.dumps({"summary": out}), flush=True)


if __name__ == "__main__":
    main()

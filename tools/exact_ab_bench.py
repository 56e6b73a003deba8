#!/usr/bin/env python3
"""Bench-level A/B of the exact-derivatives mode.

The fused setup's tangent mode (ops/setup_fused exact_mode) vs the FD
default at the HEADLINE level: the evolving walking replay at B=8192, FD
default vs exact_derivatives=True, in ONE process (the only comparison
that resolves <1 ms effects).

    python tools/exact_ab_bench.py [B]
"""
import json
import os
import sys
import time

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from quadrupedwholebodycontroller.config import ControllerParams, QPSolverParams
from quadrupedwholebodycontroller.control import wbc
from quadrupedwholebodycontroller.models import anymal_d_model
from quadrupedwholebodycontroller.ops import qp as qpm

from bench import make_evolving_step  # noqa: E402

REPS = 3


def main():
    B = int(sys.argv[1]) if len(sys.argv) > 1 else 8192
    dtype = jnp.float32
    model = anymal_d_model(dtype=dtype)
    qp = QPSolverParams()
    backend = "cached" if jax.default_backend() != "cpu" else "xla"
    carry0 = jax.tree.map(lambda x: jnp.stack([x] * B), wbc.init_carry(dtype))

    configs = {
        "fd_default": ControllerParams(),
        "exact_in_kernel": ControllerParams(exact_derivatives=True),
    }
    results = {}
    for name, cp in configs.items():
        cache0 = (qpm.make_cache(B, 42, 70, qp, dtype)
                  if backend == "cached" else None)
        multi_step, scan_len = make_evolving_step(
            model, cp, qp, B, backend, dtype
        )
        carry, cache, ts, kk, cnt = multi_step(carry0, cache0, False)
        jax.block_until_ready(ts)
        times = []
        for _ in range(REPS):
            t0 = time.perf_counter()
            carry, cache, ts, kk, cnt = multi_step(carry, cache, True)
            jax.block_until_ready(ts)
            times.append((time.perf_counter() - t0) / scan_len)
        times.sort()
        sps = B / times[len(times) // 2]
        results[name] = {
            "solves_per_s": round(sps, 1),
            "max_kkt": float(jnp.max(kk)),
            "flagged_max": int(jnp.max(cnt)),
        }
        print(json.dumps({"config": name, **results[name]}), flush=True)
    if len(results) == 2:
        a, b = results["fd_default"], results["exact_in_kernel"]
        print(json.dumps({
            "B": B,
            "exact_vs_fd_pct": round(
                100.0 * (b["solves_per_s"] / a["solves_per_s"] - 1.0), 2
            ),
        }), flush=True)


if __name__ == "__main__":
    main()

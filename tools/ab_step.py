#!/usr/bin/env python3
"""A/B solve-chain variants end to end on the evolving replay, in turns.

Every variant is the bench's evolving-replay step (bench.make_evolving_step)
with some QPSolverParams fields and/or the setup path changed.  All
variants are compiled first, then timed in the order given followed by the
reverse order (e.g. A B B A), one 200-step scan per turn, so drift on the
card hits both sides alike.  Optionally traces one scan of each variant
and reduces the trace to per-stage device time (tools/trace_stages.py;
stage attribution needs XLA_FLAGS=--xla_gpu_enable_command_buffer= ).

    python tools/ab_step.py base: tf32:ns_cold_prec=high \\
        --batch 4096 --trace-dir /tmp/ab_traces --out chiprun_out/ab.json

A variant is NAME:FIELD=VALUE[,FIELD=VALUE...]; FIELD is a QPSolverParams
field or `setup` (wbc_step_batched's setup_backend).  Prints one line per
turn and a JSON summary, each stamped with the card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))


def parse_variant(spec, qp0):
    name, _, fields = spec.partition(":")
    qp, setup = qp0, "auto"
    for kv in filter(None, fields.split(",")):
        k, v = kv.split("=", 1)
        if k == "setup":
            setup = v
            continue
        cur = getattr(qp0, k)
        qp = dataclasses.replace(qp, **{k: type(cur)(v)})
    return name, qp, setup


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("variants", nargs="+")
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--trace-dir", default="")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp

    import bench
    from quadrupedwholebodycontroller.config import (
        ControllerParams,
        QPSolverParams,
    )
    from quadrupedwholebodycontroller.models import anymal_d_model
    from quadrupedwholebodycontroller.runtime import accel

    accel.enable_compile_cache()
    stamp = accel.device_stamp()
    card = stamp["card"] or stamp["platform"]
    dtype = jnp.float32
    model = anymal_d_model(dtype=dtype)
    cp = ControllerParams()
    B = args.batch
    runs = {}
    for spec in args.variants:
        name, qp, setup = parse_variant(spec, QPSolverParams())
        step, scan_len = bench.make_evolving_step(
            model, cp, qp, B, dtype=dtype, setup_backend=setup
        )
        carry, cache = bench.init_state(B, qp, dtype)
        t0 = time.perf_counter()
        carry, cache, ts, kk, cnt = step(carry, cache, False)
        jax.block_until_ready(ts)
        runs[name] = dict(step=step, state=(carry, cache), scan=scan_len,
                          times=[], compile_s=time.perf_counter() - t0,
                          max_kkt=0.0, flagged_max=0)
        print(f"{name}: compiled + first scan {runs[name]['compile_s']:.1f} s "
              f"[{card}]", flush=True)
    order = list(runs) + list(reversed(runs))
    for name in order:
        r = runs[name]
        carry, cache = r["state"]
        t0 = time.perf_counter()
        carry, cache, ts, kk, cnt = r["step"](carry, cache, True)
        jax.block_until_ready(ts)
        dt = (time.perf_counter() - t0) / r["scan"]
        r["state"] = (carry, cache)
        r["times"].append(dt)
        r["max_kkt"] = max(r["max_kkt"], float(jnp.max(kk)))
        r["flagged_max"] = max(r["flagged_max"], int(jnp.max(cnt)))
        print(f"{name}: {dt * 1e3:.4f} ms/step, {B / dt:.1f} solves/s, "
              f"max_kkt {float(jnp.max(kk)):.3e} [{card}]", flush=True)
    summary = {"batch": B, **stamp, "variants": {}}
    for name, r in runs.items():
        summary["variants"][name] = {
            "ms_per_step": [t * 1e3 for t in r["times"]],
            "solves_per_s_mean": B / (sum(r["times"]) / len(r["times"])),
            "max_kkt": r["max_kkt"], "flagged_max": r["flagged_max"],
            "compile_plus_first_scan_s": r["compile_s"],
        }
    if args.trace_dir:
        from tools import trace_stages

        for name, r in runs.items():
            d = os.path.join(args.trace_dir, name)
            carry, cache = r["state"]
            op_names = trace_stages.op_names_from_hlo(
                r["step"].lower(carry, cache, True).compile().as_text()
            )
            with jax.profiler.trace(d):
                out = r["step"](carry, cache, True)
                jax.block_until_ready(out[2])
            red = trace_stages.reduce_trace(d, op_names)
            summary["variants"][name]["trace"] = red
            if name == next(iter(runs)):
                summary["trace_sample"] = trace_stages.sample_events(d, 12)
            for plane, v in red.items():
                print(f"{name} trace {plane}: idle {v['idle_share']:.4f}, "
                      f"stages ms/step "
                      + json.dumps({k: ns / r['scan'] / 1e6 for k, ns in
                                    v['stage_ns'].items()})
                      + f", other {v['other_ns'] / r['scan'] / 1e6:.4f} "
                      f"[{card}]", flush=True)
    print(json.dumps(summary))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)


if __name__ == "__main__":
    main()

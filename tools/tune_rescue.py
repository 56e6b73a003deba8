#!/usr/bin/env python3
"""In-process A/B of tail-rescue budgets on the evolving walking replay.

The rescue fires whenever ANY scenario's relative KKT exceeds the
threshold, and at B=8192 that happens on a sizable fraction of replay
steps — so its budget (extra ADMM iterations, polish rounds) sets the
headline cost.  This tool reruns bench.py's evolving scan for each budget
in ONE process (the only comparison that resolves <1 ms effects).

    python tools/tune_rescue.py [B]
"""
import dataclasses
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

from bench import make_diverse_step, make_evolving_step  # noqa: E402

# QWBC_TUNE_MODE=diverse switches the workload to the desynchronized
# 4-gait replay (bench.py diverse mode)
MODE = os.environ.get("QWBC_TUNE_MODE", "evolving")
REPS = 3


def main():
    B = int(sys.argv[1]) if len(sys.argv) > 1 else 8192
    dtype = jnp.float32
    model = anymal_d_model(dtype=dtype)
    cp = ControllerParams()
    backend = "cached" if jax.default_backend() != "cpu" else "xla"

    base = QPSolverParams()
    rb = lambda it, r, thr=3e-3, k=0, **kw: dataclasses.replace(
        base, rescue_threshold=thr, rescue_iterations=it,
        rescue_polish_rounds=r, rescue_batch=k, **kw,
    )
    configs = {
        # "off" also measures the flagged-count DEMAND (max/mean scenarios
        # above threshold per step) that sizes rescue_batch
        "off": dataclasses.replace(base, rescue_threshold=0.0),
        "full_it100_r2": rb(100, 2, k=0),
        "k128": rb(100, 2, k=128),
        "k256": rb(100, 2, k=256),
        "k512": rb(100, 2, k=512),
        # round-3 knobs: staged rescue + compensated refinement.
        # "r2_default" is the round-2 behavior (1 stage, no compensation);
        # "default" is whatever QPSolverParams currently ships.
        "r2_default": rb(100, 2, k=256, rescue_stages=1,
                         rescue_comp_refine=0),
        "stages3": rb(100, 2, k=256, rescue_stages=3, rescue_comp_refine=0),
        "comp2": rb(100, 2, k=256, rescue_stages=1, rescue_comp_refine=2),
        "stages3_comp2": rb(100, 2, k=256, rescue_stages=3,
                            rescue_comp_refine=2),
        "default": base,
        # budget-trim candidates under STAGING (round 3 follow-up): the
        # 100-iteration budget was tuned for a single-shot rescue; staged
        # re-fires may hold flagged_max=0 at a smaller per-stage budget
        # and a cheaper fire.  Any winner must ALSO hold the extreme
        # sweep (tools/tune_sweep.py) before shipping.
        "it60_r2_s3": rb(60, 2, k=256, rescue_stages=3),
        "it60_r1_s3": rb(60, 1, k=256, rescue_stages=3),
        "it40_r1_s4": rb(40, 1, k=256, rescue_stages=4),
        "it100_r2_k128_s3": rb(100, 2, k=128, rescue_stages=3),
        # diverse-mode warm-gate sizing: cold_batch must cover the worst
        # step's switch count for the compact path to hold (the 4-gait
        # replay peaks at ~495 switching scenarios/step at B=8192)
        "cold512": dataclasses.replace(base, cold_batch=512),
        "cold1024": dataclasses.replace(base, cold_batch=1024),
        "cold0": dataclasses.replace(base, cold_batch=0),
        "cold512_norescue": dataclasses.replace(
            base, cold_batch=512, rescue_threshold=0.0),
        "cold512_nocomp": dataclasses.replace(
            base, cold_batch=512, rescue_comp_refine=0),
        # round-4 drop-rule cost isolation: the torque-parity machinery's
        # evolving cost is the compacted round-2 cold polish (drop_batch
        # scenarios, ns_iters cold Schur inverse each step where any
        # scenario failed round 1).  "dropoff" (polish_rounds=1) bounds
        # the total cost; dropk* size the compaction cap.  Any winner
        # must ALSO hold the torque-parity replay (measure_torque_err)
        # before shipping.
        "dropoff": dataclasses.replace(base, polish_rounds=1),
        # explicitly pinned caps (the shipped default has moved 256 ->
        # 128 -> 64 across round 4; a config that aliases `base` silently
        # re-measures whatever ships — ADVICE r4)
        "dropk64": dataclasses.replace(base, drop_batch=64),
        "dropk128": dataclasses.replace(base, drop_batch=128),
        "dropk256": dataclasses.replace(base, drop_batch=256),
        # round-5 drop-round cost recovery (VERDICT r4 #1): gate the drop
        # round on the current best sign-augmented residual
        # (drop_fire_tol) and/or warm the compacted Schur inverse from
        # the carried rows (drop_warm_iters).  Winners must hold the
        # torque-parity replay (measure_torque_err, walk AND diverse)
        # before shipping.
        "ft1e6": dataclasses.replace(base, drop_fire_tol=1e-6),
        "ft1e5": dataclasses.replace(base, drop_fire_tol=1e-5),
        "ft1e4": dataclasses.replace(base, drop_fire_tol=1e-4),
        "dw8": dataclasses.replace(base, drop_warm_iters=8),
        "dw12": dataclasses.replace(base, drop_warm_iters=12),
        "ft1e5_dw8": dataclasses.replace(
            base, drop_fire_tol=1e-5, drop_warm_iters=8),
        "ft1e4_dw8": dataclasses.replace(
            base, drop_fire_tol=1e-4, drop_warm_iters=8),
        # skip the drop round's carried-sinv refresh (the lane-axis
        # gather + scatter over the (m, m, B) tensor)
        "nosinv": dataclasses.replace(base, drop_sinv_refresh=0),
        "nosinv_dw8": dataclasses.replace(
            base, drop_sinv_refresh=0, drop_warm_iters=8),
        "nosinv_dw8_ft1e4": dataclasses.replace(
            base, drop_sinv_refresh=0, drop_warm_iters=8,
            drop_fire_tol=1e-4),
        # cap scaling under the cheap branch (is the residual cost
        # row-proportional NS/polish work?)
        "nosinv_dw8_k32": dataclasses.replace(
            base, drop_sinv_refresh=0, drop_warm_iters=8, drop_batch=32),
        "nosinv_dw8_k16": dataclasses.replace(
            base, drop_sinv_refresh=0, drop_warm_iters=8, drop_batch=16),
        "nosinv_dw4_k32": dataclasses.replace(
            base, drop_sinv_refresh=0, drop_warm_iters=4, drop_batch=32),
        "nosinv_dw8_apx": dataclasses.replace(
            base, drop_sinv_refresh=0, drop_warm_iters=8,
            drop_approx_rank=1),
        # shorter cold NS for the drop round (probe-gated before any flip)
        "dni20": dataclasses.replace(base, drop_ns_iters=20),
        "dni15": dataclasses.replace(base, drop_ns_iters=15),
        # round-5b cond routing (cond_hoist): keep the carried (m, m, B)
        # / (n, n, B) inverses OUT of the cold-fix / drop-round cond
        # outputs (bitwise-identical values; buffer routing only).
        # Explicitly pinned both ways (`base` ships cond_hoist=0).
        "hoist0": dataclasses.replace(base, cond_hoist=0),
        "hoist1": dataclasses.replace(base, cond_hoist=1),
        "hoist0_dropoff": dataclasses.replace(
            base, cond_hoist=0, polish_rounds=1),
        "hoist1_dropoff": dataclasses.replace(
            base, cond_hoist=1, polish_rounds=1),
        # hoist1 measured slower than hoist0 (the hoisted scatter
        # materializes the copy); hoist2 hoists only the drop round's sinv
        # (no scatter), measured separately
        "hoist2": dataclasses.replace(base, cond_hoist=2),
        # mixed-precision cold NS chains (ns_cold_prec body, full tail)
        "nsbf16": dataclasses.replace(base, ns_cold_prec="bfloat16"),
        "nsbf16x3": dataclasses.replace(base, ns_cold_prec="high"),
        "nsbf16_t8": dataclasses.replace(
            base, ns_cold_prec="bfloat16", ns_cold_tail=8),
        "nsbf16_hoist2": dataclasses.replace(
            base, ns_cold_prec="bfloat16", cond_hoist=2),
        # GLOBAL hot-path matmul precision (ops/linalg._MATMUL_PRECISION,
        # normally QWBC_MATMUL_PRECISION): "high" = 3-pass bf16 for every
        # full_precision site (warm NS updates, K build, Schur assembly,
        # refinement) — in-process via monkeypatch, see the run loop
        "gprec_high": base,
        "gprec_high_nscold": dataclasses.replace(
            base, ns_cold_prec="high"),
        # tail sizing for the "high" cold-NS body (tail 6 failed the
        # forced-cap walk probe at 2 steps over 1e-3; tail 10 probes
        # CLEAN on walk AND diverse — see PERF.md round 5b)
        "nsbf16x3_t10": dataclasses.replace(
            base, ns_cold_prec="high", ns_cold_tail=10),
        # explicit all-highest pin (the shipped default is now
        # ns_cold_prec="high", tail 10, rescue chains always highest)
        "nsoff": dataclasses.replace(base, ns_cold_prec=""),
        # flagged-floor candidates: the ns_cold default leaves ONE
        # diverse scenario plateaued at 3.10e-3 (> threshold); the
        # compacted rescue round 2 exists for exactly this shape
        "r2c32": dataclasses.replace(
            base, rescue_polish_rounds=2, rescue_round2_batch=32),
        "it60": dataclasses.replace(base, rescue_iterations=60),
    }
    if len(sys.argv) > 2:  # optional config filter (exact names when all
        # requested entries are keys; substring match otherwise)
        keep = sys.argv[2].split(",")
        if all(s in configs for s in keep):
            configs = {n: configs[n] for n in keep}
        else:
            configs = {n: c for n, c in configs.items()
                       if any(s in n for s in keep)}

    carry0 = jax.tree.map(lambda x: jnp.stack([x] * B), wbc.init_carry(dtype))

    mk = make_diverse_step if MODE == "diverse" else make_evolving_step
    results = {}
    from quadrupedwholebodycontroller.ops import linalg as _linalg
    _prec0 = _linalg._MATMUL_PRECISION
    for name, qp in configs.items():
        # gprec_* configs flip the GLOBAL full_precision level for this
        # config only (fresh closure per config -> fresh trace, so the
        # flip takes effect despite not being a params field)
        _linalg._MATMUL_PRECISION = (
            name.split("_")[1] if name.startswith("gprec_") else _prec0
        )
        cache0 = (qpm.make_cache(B, 42, 70, qp, dtype)
                  if backend == "cached" else None)
        multi_step, scan_len = mk(model, cp, qp, B, backend, dtype)
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
            "flagged_mean": round(float(jnp.mean(cnt.astype(jnp.float32))), 2),
        }
        print(json.dumps({"config": name, **results[name]}), flush=True)
    print(json.dumps({"B": B, "results": results}), flush=True)


if __name__ == "__main__":
    main()

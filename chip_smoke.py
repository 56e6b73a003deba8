#!/usr/bin/env python3
"""Chip smoke test: the cached batched WBC chain end to end on one GPU.

Runs in ONE process (one process per card); every phase prints its own
line, and any failed phase exits non-zero.  Phases:

  device       a GPU must be present (else exit 1); prints device_kind,
               device count and the card's name and power limit
  compile      compiles every program of the run side by side (the
               evolving step at B=4096, the diverse step at B=8192, both
               torque replays, the sweep) and prints the evolving step's
               compiled.memory_analysis()
  main         the evolving replay (B=4096, 200-step scan) and the diverse
               replay (B=8192) through bench.py's step builders; gates:
               finite outputs, flagged_max == 0, max relative KKT <= 3e-3
  torque       walk and diverse replays at B=8 through the f32 chain vs the
               committed f64 CPU references (max error <= 1e-3 N·m);
               writes torque_run*.npz into --out
  closed_loop  the sweep path (sharded_sweep_step on a one-card mesh,
               B=1024, friction x payload x push) with zero falls and
               finite KKT, then the CLI `standing` in-process

The chain has no hand-written kernel: every stage is plain JAX compiled
by XLA (a Pallas-Triton ADMM kernel lost to it on the card, PERF.md).

`--four` runs only the four-card phase: sharded_sweep_step and
sharded_wbc_step on a flat 4-card mesh, each shard against its quarter of
the batch run alone on one card.

The last line of standard output is the JSON result; it is printed only
when every phase passed.  `--rehearse` runs the phases on the CPU at tiny
sizes to check the wiring (no result line).

    python chip_smoke.py            # one card
    python chip_smoke.py --four     # four cards
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
PHASES = ("device", "compile", "main", "torque", "closed_loop")
KKT_GATE = 3e-3
TORQUE_GATE = 1e-3  # N·m


class PhaseFailed(Exception):
    pass


def check(cond, what):
    if not cond:
        raise PhaseFailed(what)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card phase")
    ap.add_argument("--only", default="",
                    help="comma-separated subset of phases (debugging)")
    ap.add_argument("--out", default=os.path.join(REPO, "chiprun_out",
                                                  "smoke"))
    ap.add_argument("--rehearse", action="store_true",
                    help="CPU wiring check at tiny sizes")
    args = ap.parse_args(argv)
    if args.four:
        # the four-card phase compares results, it times nothing: skip the
        # GEMM/fusion autotuning that dominates its compile time (both
        # sides of the comparison compile with the same setting)
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                                   + " --xla_gpu_autotune_level=0").strip()

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu" and not args.rehearse:
        print(f"phase device: FAIL no GPU (JAX platform {dev.platform!r})",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from quadrupedwholebodycontroller.runtime import accel

    accel.enable_compile_cache()
    card = accel.card() or "no card (rehearsal)"
    n_dev = len(jax.devices())
    os.makedirs(args.out, exist_ok=True)
    ctx = Context(args, card)
    if args.four:
        phases = ("device", "four")
    elif args.only:
        phases = ("device",) + tuple(
            p for p in args.only.split(",") if p and p != "device"
        )
    else:
        phases = PHASES
    for name in phases:
        t0 = time.perf_counter()
        try:
            globals()[f"phase_{name}"](ctx)
        except Exception as exc:  # a failed phase fails the run, loudly
            print(f"phase {name}: FAIL {type(exc).__name__}: {exc} "
                  f"[{card}]", flush=True)
            raise
        print(f"phase {name}: ok in {time.perf_counter() - t0:.1f} s "
              f"[{card}]", flush=True)
    if args.rehearse:
        print("rehearsal ok (no result on the CPU)")
        return 0
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": n_dev,
    }}))
    return 0


class Context:
    def __init__(self, args, card):
        import jax.numpy as jnp

        from quadrupedwholebodycontroller.config import (
            ControllerParams,
            QPSolverParams,
        )
        from quadrupedwholebodycontroller.models import anymal_d_model

        self.args = args
        self.card = card
        self.small = args.rehearse
        self.dtype = jnp.float32
        self.model = anymal_d_model(dtype=self.dtype)
        self.cp = ControllerParams()
        self.qp = QPSolverParams()
        self.compiled = {}   # name -> (executable, args)
        self.scan_len = {}
        # batch sizes: the bench cells (tiny when rehearsing on the CPU)
        self.b_evolving = 8 if self.small else 4096
        self.b_diverse = 8 if self.small else 8192
        self.b_sweep = 8 if self.small else 1024
        self.t_sweep = 40 if self.small else 300

    def say(self, phase, msg):
        print(f"phase {phase}: {msg} [{self.card}]", flush=True)


def phase_device(ctx):
    import jax

    d = jax.devices()[0]
    ctx.say("device", f"platform={d.platform} device_kind={d.device_kind!r} "
            f"count={len(jax.devices())}")


def compile_all(ctx, programs):
    """Trace every program in this thread, then compile them all at once
    in worker threads (XLA compiles release the interpreter lock, so the
    programs compile side by side on the host's cores).  programs: name ->
    (jitted, args); fills ctx.compiled[name] = (executable, args)."""
    from concurrent.futures import ThreadPoolExecutor

    lowered = {k: (f.lower(*a), a) for k, (f, a) in programs.items()}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(lowered)) as ex:
        futs = {k: ex.submit(lw.compile) for k, (lw, _) in lowered.items()}
        for k, fut in futs.items():
            ctx.compiled[k] = (fut.result(), lowered[k][1])
    return time.perf_counter() - t0


def _sweep_inputs(ctx, B, T, seed=0):
    """(carry, commands, scenario) for B sweep scenarios, made from a seed."""
    import jax
    import jax.numpy as jnp

    from quadrupedwholebodycontroller.config import PlannerParams
    from quadrupedwholebodycontroller.sim.rollout import init_rollout_carry
    from quadrupedwholebodycontroller.sim.scenario import Scenario

    carry = init_rollout_carry(ctx.model, ctx.cp, PlannerParams(),
                               dtype=ctx.dtype)
    bcarry = jax.tree.map(lambda x: jnp.stack([x] * B), carry)
    kv, ks = jax.random.split(jax.random.PRNGKey(seed))
    vx = jax.random.uniform(kv, (B,), ctx.dtype, 0.0, 0.4)
    cmds = jnp.zeros((B, T, 3), ctx.dtype).at[:, 40:, 0].set(vx[:, None])
    return bcarry, cmds, Scenario.random_batch(ks, B, T, ctx.dtype)


def _sweep_program(ctx, mesh, inputs):
    from quadrupedwholebodycontroller.config import PlannerParams
    from quadrupedwholebodycontroller.parallel import sharded_sweep_step
    from quadrupedwholebodycontroller.sim import SimParams

    step = sharded_sweep_step(ctx.model, ctx.cp, PlannerParams(), ctx.qp,
                              SimParams(), mesh)
    return step.jitted, _sweep_args(mesh, inputs)


def _sweep_args(mesh, inputs):
    from quadrupedwholebodycontroller.parallel import shard_batch

    return [shard_batch(x, mesh) for x in inputs]


def _flagship_inputs(ctx, B):
    """(obs, ref, carry) for B perturbed standing robots (bench.py's)."""
    import jax
    import jax.numpy as jnp

    import bench
    from quadrupedwholebodycontroller.control import wbc

    obs = bench.perturbed_standing_obs(B, ctx.dtype)
    ref = jax.tree.map(lambda x: jnp.stack([x] * B),
                       wbc.Reference.standing(ctx.cp, ctx.dtype))
    carry = jax.tree.map(lambda x: jnp.stack([x] * B),
                         wbc.init_carry(ctx.dtype))
    return obs, ref, carry


def _flagship_program(ctx, mesh, inputs):
    from quadrupedwholebodycontroller.parallel import sharded_wbc_step

    step = sharded_wbc_step(ctx.model, ctx.cp, ctx.qp, mesh)
    return step, _flagship_args(ctx, mesh, inputs)


def _flagship_args(ctx, mesh, inputs):
    """(obs, ref, carry, a fresh QPCache, cache_valid=False)."""
    from quadrupedwholebodycontroller.ops import qp as qpm
    from quadrupedwholebodycontroller.parallel import shard_batch

    B = inputs[0].q.shape[0]
    return ([shard_batch(x, mesh) for x in inputs]
            + [qpm.make_cache(B, 42, 70, ctx.qp, ctx.dtype), False])


def phase_compile(ctx):
    """Every program of the run: the evolving (B=4096) and diverse
    (B=8192) bench cells, the two torque replays and the one-card sweep."""
    import bench
    from quadrupedwholebodycontroller.parallel import make_mesh
    from tools import measure_torque_err as mte

    programs = {}
    for name, make, batch in (("evolving", bench.make_evolving_step,
                               ctx.b_evolving),
                              ("diverse", bench.make_diverse_step,
                               ctx.b_diverse)):
        step, scan_len = make(ctx.model, ctx.cp, ctx.qp, batch,
                              dtype=ctx.dtype)
        carry, cache = bench.init_state(batch, ctx.qp, ctx.dtype)
        programs[name] = (step, (carry, cache, False))
        ctx.scan_len[name] = scan_len
    for traj in ("walk", "diverse"):
        run, carry, cache = mte.replay_program("float32", traj)
        programs[f"torque_{traj}"] = (run, (carry, cache, False))
    programs["sweep"] = _sweep_program(
        ctx, make_mesh(1), _sweep_inputs(ctx, ctx.b_sweep, ctx.t_sweep)
    )
    dt = compile_all(ctx, programs)
    ctx.say("compile", f"{len(programs)} programs ({', '.join(programs)}) "
            f"compiled side by side in {dt:.1f} s")
    ctx.say("compile", f"evolving B={ctx.b_evolving} memory_analysis: "
            f"{ctx.compiled['evolving'][0].memory_analysis()}")


def _gate_cell(ctx, phase, name, res, batch):
    ctx.say(phase, f"{name} B={batch}: {res['solves_per_s']:.1f} solves/s "
            f"max_kkt={res['max_kkt']:.3e} flagged_max={res['flagged_max']} "
            f"rep_spread={res['rep_spread']:.4f}")
    check(res["finite"], f"{name}: non-finite torques")
    check(res["flagged_max"] == 0, f"{name}: flagged_max {res['flagged_max']}")
    check(res["max_kkt"] <= KKT_GATE,
          f"{name}: max KKT {res['max_kkt']:.3e} > {KKT_GATE}")


def phase_main(ctx):
    import bench

    for name, batch in (("evolving", ctx.b_evolving),
                        ("diverse", ctx.b_diverse)):
        exe, (carry, cache, _) = ctx.compiled[name]
        res = bench.measure(exe, ctx.scan_len[name], carry, cache, batch,
                            reps=2)
        _gate_cell(ctx, "main", name, res, batch)


def phase_torque(ctx):
    import jax

    from tools import measure_torque_err as mte

    for traj in ("walk", "diverse"):
        exe, args = ctx.compiled[f"torque_{traj}"]
        tau, grf, kkt = (np.asarray(a, np.float64) for a in exe(*args))
        rec = dict(tau=tau, grf=grf, kkt=kkt, backend=jax.default_backend())
        suffix = "" if traj == "walk" else "_diverse"
        np.savez(os.path.join(ctx.args.out, f"torque_run{suffix}.npz"), **rec)
        st = mte.torque_stats(traj, rec)
        ctx.say("torque", f"{traj}: max {st['max']:.3e} N·m, p99 "
                f"{st['p99']:.3e}, median {st['median']:.3e}, steps over "
                f"1e-3: {st['steps_over_1e-3']}, f32 max KKT "
                f"{st['kkt_max_f32']:.3e}")
        check(st["max"] <= TORQUE_GATE,
              f"{traj}: torque error {st['max']:.3e} > {TORQUE_GATE} N·m")


def _run_sweep(exe, args):
    import jax

    out, metrics = exe(*args)
    jax.block_until_ready(metrics.mean_kkt)
    t0 = time.perf_counter()
    out, metrics = exe(*args)
    jax.block_until_ready(metrics.mean_kkt)
    return out, metrics, time.perf_counter() - t0


def phase_closed_loop(ctx):
    from quadrupedwholebodycontroller.cli.main import main as cli_main

    B, T = ctx.b_sweep, ctx.t_sweep
    _, m, dt = _run_sweep(*ctx.compiled["sweep"])
    ctx.say("closed_loop", f"sweep B={B} T={T}: {B * T / dt:.1f} "
            f"control-steps/s, fallen={float(m.fallen_fraction)} "
            f"mean_kkt={float(m.mean_kkt):.3e} max_kkt={float(m.max_kkt):.3e}")
    check(float(m.fallen_fraction) == 0.0, "sweep: a scenario fell")
    check(np.isfinite(float(m.max_kkt)), "sweep: non-finite KKT")
    check(cli_main(["standing", "--seconds", "0.25" if ctx.small else "1.0"])
          is None, "cli standing")


def phase_four(ctx):
    """Four cards against one: the sweep's scenario data-parallelism
    (sharded_sweep_step) and the sharded flagship step (sharded_wbc_step)
    on a flat 4-card mesh, each shard against the same local program on
    one card (its quarter of the batch run alone).  The cached chain's
    batch-level gates (cold-fix top-k, drop-round and rescue caps) act per
    shard, so a shard's program is the one-card program at the quarter
    batch, not at the full batch — the comparison tests/test_parallel.py
    makes per scenario.  Criteria: identical fall counts, sweep mean KKT
    within a relative 1e-2 (float32 reduction order), torques within
    2e-4 N·m, every carried leaf finite, and the KKT gate."""
    import jax
    import jax.numpy as jnp

    from quadrupedwholebodycontroller.parallel import make_mesh

    n = 4 if not ctx.small else min(4, len(jax.devices()))
    check(len(jax.devices()) >= n, f"need {n} devices")
    mesh4, mesh1 = make_mesh(n), make_mesh(1)
    check(mesh4.devices.shape == (1, n), "flat mesh")
    B, T = ctx.b_sweep, ctx.t_sweep
    Bf = 8 if ctx.small else 1024

    def quarters(tree, b):
        q = b // n
        return [jax.tree.map(lambda x: x[i * q:(i + 1) * q], tree)
                for i in range(n)]

    s_in = _sweep_inputs(ctx, B, T)
    f_in = _flagship_inputs(ctx, Bf)
    s_q = quarters(s_in, B)
    f_q = quarters(f_in, Bf)
    programs = {
        "sweep4": _sweep_program(ctx, mesh4, s_in),
        "sweep1": _sweep_program(ctx, mesh1, s_q[0]),
        "flagship4": _flagship_program(ctx, mesh4, f_in),
        "flagship1": _flagship_program(ctx, mesh1, f_q[0]),
    }
    dt = compile_all(ctx, programs)
    ctx.say("four", f"{len(programs)} programs compiled side by side in "
            f"{dt:.1f} s")

    exe1, _ = ctx.compiled["sweep1"]
    c4, m4, dt4 = _run_sweep(*ctx.compiled["sweep4"])
    runs1 = [_run_sweep(exe1, _sweep_args(mesh1, q)) for q in s_q]
    dt1 = sum(r[2] for r in runs1)
    kkt1 = float(np.mean([float(r[1].mean_kkt) for r in runs1]))
    fallen1 = float(np.mean([float(r[1].fallen_fraction) for r in runs1]))
    ctx.say("four", f"sweep B={B} T={T}: {n} cards {B * T / dt4:.1f} "
            f"control-steps/s, its {n} shards one after another on 1 card "
            f"{B * T / dt1:.1f}; mean_kkt {float(m4.mean_kkt):.4e} vs "
            f"{kkt1:.4e}, fallen {float(m4.fallen_fraction)} vs {fallen1}")
    check(float(m4.fallen_fraction) == fallen1, "sweep fall counts differ")
    check(abs(float(m4.mean_kkt) - kkt1) <= 1e-2 * abs(kkt1) + 1e-9,
          "sweep mean_kkt differs")
    for leaf in jax.tree.leaves(c4):
        check(bool(jnp.all(jnp.isfinite(leaf))), "non-finite sweep carry")
    p1 = np.concatenate([np.asarray(r[0].sim.base_p) for r in runs1])
    ctx.say("four", f"sweep final base position max diff "
            f"{np.max(np.abs(np.asarray(c4.sim.base_p) - p1)):.3e} m")

    def flagship(name, inputs=None):
        exe, args = ctx.compiled[name]
        if inputs is not None:
            args = _flagship_args(ctx, mesh1, inputs)
        o, r, c, cache, _ = args
        out, c2, cache2 = exe(o, r, c, cache, False)
        out, _, _ = exe(o, r, c2, cache2, True)
        return np.asarray(out.tau), float(jnp.max(out.qp_info.kkt_residual))

    tau4, kkt4 = flagship("flagship4")
    runs1 = [flagship("flagship1", q) for q in f_q]
    tau1 = np.concatenate([t for t, _ in runs1])
    kkt1 = max(k for _, k in runs1)
    dtau = float(np.max(np.abs(tau4 - tau1)))
    ctx.say("four", f"flagship B={Bf} cold+warm: tau max diff {dtau:.3e} "
            f"N·m, max KKT {kkt4:.3e} vs {kkt1:.3e}")
    check(dtau <= 2e-4, f"flagship tau differs by {dtau:.3e}")
    check(max(kkt4, kkt1) <= KKT_GATE, "flagship KKT gate")


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Headline benchmark: WBC QP solves/s on the local accelerator.

Measures the FULL control cycle (state update, centroidal dynamics, 42x70 QP
with warm start, torque map — everything the reference does per 400 Hz cycle
at src/whole_body_controller.cpp:650-652) over a scenario batch through the
cached batched chain (wbc_step_batched with qp_backend="cached" and a
QPCache), timed as a lax.scan of control steps inside one jit (the sweep
execution pattern) that ends in block_until_ready.  Prints ONE JSON line,
stamped with the device (platform, device_kind, device count) and, on the
GPU, the card's name and power limit.

There is no CPU fallback: without a GPU the bench exits non-zero.
`--cpu-rehearsal` runs the same chain on the CPU to check wiring; its line
then says platform "cpu", and its numbers are no device measurement.

Modes (QWBC_BENCH_MODE):
  evolving (default) — every scan step replays the next state/reference of a
    pre-recorded 200-step closed-loop WALKING trajectory
    (data/walk_traj_400hz.npz, tools/make_bench_traj.py), with per-scenario
    state perturbations, planner publish ticks, and 2 contact switches in
    the window — so warm starts and the QPCache run under the drift they
    see in production.  This is the honest headline.
  fixed — the frozen-problem variant (same QP re-solved each step,
    converged warm start): the warm path's best case, kept for comparison.
  diverse — 4 heterogeneous recorded gaits (walk / turning walk / trot /
    unmodeled-payload walk; tools/make_diverse_traj.py) tiled across the
    batch with per-scenario phase offsets (contact switches
    desynchronized).  The default evolving run ALSO reports this as
    diverse_* keys on the same JSON line (QWBC_BENCH_DIVERSE=0 skips).

vs_baseline is against the reference's engineered real-time rate: 400 WBC
QP solves/s on a desktop CPU (config/params_controller.yaml:3 — it publishes
no other perf numbers, BASELINE.md).
"""
import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from quadrupedwholebodycontroller.config import ControllerParams, QPSolverParams
from quadrupedwholebodycontroller.control import wbc
from quadrupedwholebodycontroller.models import anymal_d_model
from quadrupedwholebodycontroller.models.anymal import INITIAL_JOINT_POS
from quadrupedwholebodycontroller.ops import qp as qpm
from quadrupedwholebodycontroller.runtime import accel

TRAJ_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "data", "walk_traj_400hz.npz")
DIVERSE_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "data", "diverse_traj_400hz.npz")


def perturbed_standing_obs(batch, dtype):
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


def make_evolving_step(model, cp, qp, batch, backend="cached",
                       dtype=jnp.float32, setup_backend="auto"):
    """The evolving-replay multi-step: a jitted scan over the recorded
    walking trajectory with per-scenario constant state offsets.  Returns
    (multi_step(carry, cache, valid) -> (carry, cache, tau_sums, max_kkts,
    n_flagged), scan_len) where n_flagged counts the scenarios whose FINAL
    relative KKT still exceeds the rescue threshold each step (with the
    rescue on this is the residual demand the rescue did not clear — the
    compact rescue_batch must stay above the PRE-rescue count, measured
    with rescue off).  Shared by bench.py and tools/tune_rescue.py."""
    traj = np.load(TRAJ_PATH)
    scan_len = traj["base_R"].shape[0]
    xs_obs = wbc.RobotObservation(
        **{k: jnp.asarray(traj[k], dtype)
           for k in ("base_R", "base_p", "base_vel", "q", "qd")}
    )
    xs_ref = wbc.Reference(
        **{k: jnp.asarray(traj[k], dtype)
           for k in ("com_pose", "com_vel", "com_acc", "swing_pos",
                     "swing_vel", "swing_acc", "contacts")}
    )
    xs_new = jnp.asarray(traj["ref_is_new"])
    # per-scenario constant state offsets: scenarios stay distinct
    # problems while replaying the same commanded gait (a sweep's shape)
    key = jax.random.PRNGKey(1)
    k1, k2, k3, k4 = jax.random.split(key, 4)
    d_obs = dict(
        base_p=0.01 * jax.random.normal(k1, (batch, 3), dtype),
        base_vel=0.02 * jax.random.normal(k2, (batch, 6), dtype),
        q=0.02 * jax.random.normal(k3, (batch, 12), dtype),
        qd=0.05 * jax.random.normal(k4, (batch, 12), dtype),
    )

    def make_step_inputs(o_t, r_t):
        obs_b = wbc.RobotObservation(
            base_R=jnp.broadcast_to(o_t.base_R, (batch, 3, 3)),
            base_p=o_t.base_p + d_obs["base_p"],
            base_vel=o_t.base_vel + d_obs["base_vel"],
            q=o_t.q + d_obs["q"],
            qd=o_t.qd + d_obs["qd"],
        )
        ref_b = jax.tree.map(
            lambda x: jnp.broadcast_to(x, (batch,) + x.shape), r_t
        )
        return obs_b, ref_b

    flag_thr = qp.rescue_threshold if qp.rescue_threshold > 0 else 3e-3

    @jax.jit
    def multi_step(carry, cache, valid):
        def body(cc, xs):
            c, cache = cc
            o_t, r_t, new_t = xs
            obs_b, ref_b = make_step_inputs(o_t, r_t)
            if cache is not None:
                out, c2, cache2 = wbc.wbc_step_batched(
                    model, cp, qp, obs_b, ref_b, c, new_t, backend,
                    cache, valid, setup_backend=setup_backend,
                )
            else:
                out, c2 = wbc.wbc_step_batched(
                    model, cp, qp, obs_b, ref_b, c, new_t, backend,
                    setup_backend=setup_backend,
                )
                cache2 = None
            return (c2, cache2), (jnp.sum(out.tau),
                                  jnp.max(out.qp_info.kkt_residual),
                                  jnp.sum(out.qp_info.kkt_residual > flag_thr))
        (c2, cache), (ts, kk, cnt) = jax.lax.scan(
            body, (carry, cache), (xs_obs, xs_ref, xs_new)
        )
        return c2, cache, ts, kk, cnt

    return multi_step, scan_len


def make_diverse_step(model, cp, qp, batch, backend="cached",
                      dtype=jnp.float32, setup_backend="auto"):
    """The diverse-replay multi-step: 4 heterogeneous recorded gaits
    (walk / fast turning walk / trot / unmodeled-payload walk,
    tools/make_diverse_traj.py) tiled across the batch with per-scenario
    PHASE OFFSETS, so contact switches desynchronize — scenario QPs are
    heterogeneous every step and the per-scenario warm gate (ops/qp.py
    cold_batch) does real work.  Same contract as make_evolving_step."""
    traj = np.load(DIVERSE_PATH)
    P, scan_len = traj["base_R"].shape[:2]
    # flatten the profile axis: row p*T + t
    obs_flat = wbc.RobotObservation(
        **{k: jnp.asarray(traj[k], dtype).reshape((P * scan_len,) + traj[k].shape[2:])
           for k in ("base_R", "base_p", "base_vel", "q", "qd")}
    )
    ref_flat = wbc.Reference(
        **{k: jnp.asarray(traj[k], dtype).reshape((P * scan_len,) + traj[k].shape[2:])
           for k in ("com_pose", "com_vel", "com_acc", "swing_pos",
                     "swing_vel", "swing_acc", "contacts")}
    )
    new_flat = jnp.asarray(traj["ref_is_new"]).reshape(P * scan_len)
    key = jax.random.PRNGKey(2)
    k0, k1, k2, k3, k4 = jax.random.split(key, 5)
    profile = jnp.arange(batch, dtype=jnp.int32) % P
    # offsets in whole planner periods (x4 control steps) keep each
    # scenario's publish ticks aligned with its own replayed references
    offset = 4 * jax.random.randint(k0, (batch,), 0, scan_len // 4)
    d_obs = dict(
        base_p=0.01 * jax.random.normal(k1, (batch, 3), dtype),
        base_vel=0.02 * jax.random.normal(k2, (batch, 6), dtype),
        q=0.02 * jax.random.normal(k3, (batch, 12), dtype),
        qd=0.05 * jax.random.normal(k4, (batch, 12), dtype),
    )
    flag_thr = qp.rescue_threshold if qp.rescue_threshold > 0 else 3e-3

    @jax.jit
    def multi_step(carry, cache, valid):
        def body(cc, t):
            c, cache = cc
            idx = profile * scan_len + (t + offset) % scan_len
            obs_b = wbc.RobotObservation(
                base_R=jnp.take(obs_flat.base_R, idx, axis=0),
                base_p=jnp.take(obs_flat.base_p, idx, axis=0) + d_obs["base_p"],
                base_vel=jnp.take(obs_flat.base_vel, idx, axis=0)
                + d_obs["base_vel"],
                q=jnp.take(obs_flat.q, idx, axis=0) + d_obs["q"],
                qd=jnp.take(obs_flat.qd, idx, axis=0) + d_obs["qd"],
            )
            ref_b = jax.tree.map(
                lambda x: jnp.take(x, idx, axis=0), ref_flat
            )
            new_b = jnp.take(new_flat, idx, axis=0)  # per-scenario (B,)
            if cache is not None:
                out, c2, cache2 = wbc.wbc_step_batched(
                    model, cp, qp, obs_b, ref_b, c, new_b, backend,
                    cache, valid, setup_backend=setup_backend,
                )
            else:
                out, c2 = wbc.wbc_step_batched(
                    model, cp, qp, obs_b, ref_b, c, new_b, backend,
                    setup_backend=setup_backend,
                )
                cache2 = None
            return (c2, cache2), (jnp.sum(out.tau),
                                  jnp.max(out.qp_info.kkt_residual),
                                  jnp.sum(out.qp_info.kkt_residual > flag_thr))
        (c2, cache), (ts, kk, cnt) = jax.lax.scan(
            body, (carry, cache), jnp.arange(scan_len)
        )
        return c2, cache, ts, kk, cnt

    return multi_step, scan_len


def init_state(batch, qp, dtype=jnp.float32):
    """(carry, cache) for a fresh batch on the cached chain."""
    cache = qpm.make_cache(batch, 42, 70, qp, dtype)
    carry = jax.tree.map(lambda x: jnp.stack([x] * batch),
                         wbc.init_carry(dtype))
    return carry, cache


def measure(multi_step, scan_len, carry, cache, bsz, reps=3):
    """One cold warm-up scan, then `reps` timed warm scans.  Returns the
    cell's metrics: median solves/s, worst-step max relative KKT, the
    worst step's count of scenarios still above the rescue threshold, and
    the relative spread of the timed reps."""
    carry, cache, ts, kk, cnt = multi_step(carry, cache, False)
    jax.block_until_ready(ts)
    times = []
    for _ in range(reps):
        # evolving mode: the carry wraps around the finite replay — one
        # slightly-mismatched warm start per 200 steps, same as production
        # would see on any reference discontinuity
        t0 = time.perf_counter()
        carry, cache, ts, kk, cnt = multi_step(carry, cache, True)
        jax.block_until_ready(ts)
        times.append((time.perf_counter() - t0) / scan_len)
    times.sort()
    median = times[len(times) // 2]
    spread = (times[-1] - times[0]) / median
    return {
        "solves_per_s": bsz / median,
        "max_kkt": float(jnp.max(kk)),
        # scenarios whose FINAL KKT still exceeds the rescue threshold
        # (worst step) — nonzero means the rescue budget/stages or
        # rescue_batch is undersized for this workload
        "flagged_max": int(jnp.max(cnt)),
        "rep_spread": spread,
        "finite": bool(jnp.all(jnp.isfinite(ts))),
    }


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="allow a run without a GPU (wiring check only)")
    args = ap.parse_args(argv)
    stamp = accel.device_stamp()
    if stamp["platform"] != "gpu" and not args.cpu_rehearsal:
        sys.exit(f"bench.py: no GPU (JAX platform {stamp['platform']!r}); "
                 "pass --cpu-rehearsal for a wiring check")
    accel.enable_compile_cache()
    mode = os.environ.get("QWBC_BENCH_MODE", "evolving")
    # each mode runs at its own batch: the evolving replay at 4096, the
    # diverse replay at 8192 (its per-step switch load scales with B but the
    # cold-fix chain is k-capped, so bigger batches amortize it); an
    # evolving row at B=8192 rides the same line (b8192_* keys)
    batch = int(os.environ.get("QWBC_BENCH_BATCH", "4096"))
    reps = int(os.environ.get("QWBC_BENCH_REPS", "3"))
    dtype = jnp.float32

    model = anymal_d_model(dtype=dtype)
    cp = ControllerParams()
    qp = QPSolverParams()
    carry, cache = init_state(batch, qp, dtype)

    if mode == "evolving":
        multi_step, scan_len = make_evolving_step(model, cp, qp, batch,
                                                  dtype=dtype)
    elif mode == "diverse":
        multi_step, scan_len = make_diverse_step(model, cp, qp, batch,
                                                 dtype=dtype)
    else:  # fixed
        # rescue off: the frozen-problem mode exists as the warm path's
        # best-case comparison row, and a few permanently-above-threshold
        # perturbed-standing scenarios would otherwise fire the rescue
        # every step (the evolving default keeps the rescue ON)
        import dataclasses

        qp = dataclasses.replace(qp, rescue_threshold=0.0)
        scan_len = int(os.environ.get("QWBC_BENCH_SCAN", "50"))
        obs = perturbed_standing_obs(batch, dtype)
        ref = jax.tree.map(
            lambda x: jnp.stack([x] * batch), wbc.Reference.standing(cp, dtype)
        )

        @jax.jit
        def multi_step(carry, cache, valid):
            def body(cc, _):
                c, cache = cc
                out, c2, cache2 = wbc.wbc_step_batched(
                    model, cp, qp, obs, ref, c, True, "cached", cache, valid
                )
                return (c2, cache2), (jnp.sum(out.tau),
                                      jnp.max(out.qp_info.kkt_residual),
                                      jnp.zeros((), jnp.int32))
            (c2, cache), (ts, kk, cnt) = jax.lax.scan(
                body, (carry, cache), None, length=scan_len
            )
            return c2, cache, ts, kk, cnt

    head = measure(multi_step, scan_len, carry, cache, batch, reps)
    row = {
        "metric": "wbc_qp_solves_per_s",
        "value": head["solves_per_s"],
        "unit": "solves/s/chip",
        "vs_baseline": head["solves_per_s"] / 400.0,
        "mode": mode,
        "max_kkt": head["max_kkt"],
        "flagged_max": head["flagged_max"],
        "rep_spread": head["rep_spread"],
        "finite": head["finite"],
    }
    # the diverse row rides the headline run: 4 heterogeneous gaits with
    # per-scenario phase offsets, contact switches desynchronized — the
    # nominal replay's switches are batch-synchronized, which flatters the
    # cache and the rescue
    if mode == "evolving" and os.path.exists(DIVERSE_PATH) and int(
        os.environ.get("QWBC_BENCH_DIVERSE", "1")
    ):
        d_batch = int(os.environ.get("QWBC_BENCH_DIVERSE_BATCH", "8192"))
        d_step, d_len = make_diverse_step(model, cp, qp, d_batch, dtype=dtype)
        div = measure(d_step, d_len, *init_state(d_batch, qp, dtype),
                      d_batch, reps)
        row["diverse_batch"] = d_batch
        row.update({f"diverse_{k}": v for k, v in div.items()})
    if mode == "evolving" and batch != 8192 and int(
        os.environ.get("QWBC_BENCH_B8192", "1")
    ):
        h_step, h_len = make_evolving_step(model, cp, qp, 8192, dtype=dtype)
        hist = measure(h_step, h_len, *init_state(8192, qp, dtype), 8192,
                       reps)
        row.update({f"b8192_{k}": v for k, v in hist.items()})
    row["batch"] = batch
    row.update(stamp)
    print(json.dumps(row))


if __name__ == "__main__":
    main()

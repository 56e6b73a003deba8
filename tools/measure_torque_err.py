#!/usr/bin/env python3
"""f32 torque error of the accelerator chain vs the f64 reference path
(BASELINE.md torque-parity row; reference torque map
whole_body_controller.cpp:565-568).

Replays a recorded 400 Hz trajectory through a controller path and records
the per-step joint torques tau (12,).  The f64 CPU xla path is the
reference-grade baseline (tests/test_parity.py pins it to the C++ chain at
<= 1e-3 N.m); the f32 path — the cached batched chain on the GPU, or xla
f32 on CPU as the CI proxy — is the production configuration whose torque
error this tool measures.

Two trajectories (--traj):
  * walk (default): data/walk_traj_400hz.npz — the bench headline input,
    the gait the reference itself executes (motion_planner.cpp:180-376).
  * diverse: data/diverse_traj_400hz.npz — 4 heterogeneous gaits (walk /
    fast turn / trot / payload+low-friction, tools/make_diverse_traj.py)
    replayed as 4 scenarios of one batch, so per-scenario warm gating and
    the drop rule see desynchronized contact switches.

The reference is committed and config-free; the stages run in separate
processes:

    JAX_PLATFORMS=cpu python tools/measure_torque_err.py --stage cpu64 [--traj diverse]
    python tools/measure_torque_err.py --stage run [--traj diverse]   # f32 on the GPU
    python tools/measure_torque_err.py --stage report [--traj diverse]
    python tools/measure_torque_err.py --stage probes   # forced-cap probes

(chip_smoke.py runs the `run` + `report` pair in-process.)  Intermediate
torques land in data/torque_{cpu64,run}.npz (walk) or
data/torque_{cpu64,run}_diverse.npz; `report` prints the per-step error
distribution (median / p99 / max), the worst steps, and whether they sit
near the trajectory's contact switches (active-set boundaries).  The TQ_*
environment variables below force individual solver paths (the forced-cap
probes); TQ_TAG suffixes the probe artifacts.
"""
import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
TRAJS = {
    "walk": os.path.join(ROOT, "data", "walk_traj_400hz.npz"),
    "diverse": os.path.join(ROOT, "data", "diverse_traj_400hz.npz"),
}


def replay_torques(dtype_str, traj_name):
    """Replay the trajectory; returns (tau, grf, kkt) per step as float64
    numpy arrays (see replay_program)."""
    run, carry, cache = replay_program(dtype_str, traj_name)
    taus, grfs, kkts = run(carry, cache, False)
    return (np.asarray(taus, np.float64), np.asarray(grfs, np.float64),
            np.asarray(kkts, np.float64))


def replay_program(dtype_str, traj_name):
    """The jitted replay and its inputs: (run, carry, cache), where
    run(carry, cache, False) -> per-step (tau, grf, max KKT).

    walk: B=8 identical scenarios (the production cached chain at its
    batch-minor layout), scenario 0 recorded -> tau (T, 12).
    diverse: the P=4 gait profiles tiled twice across B=8 (scenario g is
    gait g % 4, no phase offsets / no observation noise so the f64 replay
    is bitwise the same problem), scenarios 0..3 recorded ->
    tau (T, 4, 12)."""
    import jax
    import jax.numpy as jnp

    from quadrupedwholebodycontroller.config import (
        ControllerParams,
        QPSolverParams,
    )
    from quadrupedwholebodycontroller.control import wbc
    from quadrupedwholebodycontroller.models import anymal_d_model
    from quadrupedwholebodycontroller.ops import qp as qpm

    dtype = jnp.float64 if dtype_str == "float64" else jnp.float32
    backend = "cached" if jax.default_backend() != "cpu" else "xla"
    if dtype_str == "float64":
        backend = "xla"  # the f64 reference is the vmapped xla path
    model = anymal_d_model(dtype=dtype)
    cp = ControllerParams()
    qp = QPSolverParams()
    # config probes (A/B the parity contribution of individual mechanisms)
    import dataclasses

    if os.environ.get("TQ_COMPFINAL"):
        qp = dataclasses.replace(
            qp, comp_final_refine=int(os.environ["TQ_COMPFINAL"])
        )
    if os.environ.get("TQ_ROUNDS"):
        qp = dataclasses.replace(
            qp, polish_rounds=int(os.environ["TQ_ROUNDS"])
        )
    if os.environ.get("TQ_FIRE_TOL"):
        qp = dataclasses.replace(
            qp, drop_fire_tol=float(os.environ["TQ_FIRE_TOL"])
        )
    if os.environ.get("TQ_DROP_WARM"):
        qp = dataclasses.replace(
            qp, drop_warm_iters=int(os.environ["TQ_DROP_WARM"])
        )
    if os.environ.get("TQ_DROP_BATCH"):
        # a cap below B=8 forces the COMPACT drop-round branch (gather /
        # warm-or-cold Schur / scatter) on the parity replay, which the
        # default cap never enters at this batch size
        qp = dataclasses.replace(
            qp, drop_batch=int(os.environ["TQ_DROP_BATCH"])
        )
    if os.environ.get("TQ_SINV_REFRESH"):
        qp = dataclasses.replace(
            qp, drop_sinv_refresh=int(os.environ["TQ_SINV_REFRESH"])
        )
    if os.environ.get("TQ_DROP_NS"):
        qp = dataclasses.replace(
            qp, drop_ns_iters=int(os.environ["TQ_DROP_NS"])
        )
    if os.environ.get("TQ_COLD_BATCH"):
        # a cap below B=8 forces the per-scenario warm-mask path (the
        # compacted cold fixes), which the default cold_batch=512 >= B
        # collapses to the scalar gate on the parity replay
        qp = dataclasses.replace(
            qp, cold_batch=int(os.environ["TQ_COLD_BATCH"])
        )
    if os.environ.get("TQ_NS_COLD_PREC"):
        # mixed-precision cold-NS body probe ("off" = explicit default)
        v = os.environ["TQ_NS_COLD_PREC"]
        qp = dataclasses.replace(
            qp, ns_cold_prec="" if v == "off" else v
        )
    if os.environ.get("TQ_NS_COLD_TAIL"):
        qp = dataclasses.replace(
            qp, ns_cold_tail=int(os.environ["TQ_NS_COLD_TAIL"])
        )
    traj = np.load(TRAJS[traj_name])
    B = 8
    obs_keys = ("base_R", "base_p", "base_vel", "q", "qd")
    ref_keys = ("com_pose", "com_vel", "com_acc", "swing_pos",
                "swing_vel", "swing_acc", "contacts")
    if traj_name == "walk":
        # (T, ...) single profile, broadcast to B identical scenarios
        xs_obs = wbc.RobotObservation(
            **{k: jnp.asarray(traj[k], dtype) for k in obs_keys}
        )
        xs_ref = wbc.Reference(
            **{k: jnp.asarray(traj[k], dtype) for k in ref_keys}
        )
        xs_new = jnp.asarray(traj["ref_is_new"])

        def batchify(o_t, r_t, new_t):
            obs_b = jax.tree.map(
                lambda x: jnp.broadcast_to(x, (B,) + x.shape), o_t
            )
            ref_b = jax.tree.map(
                lambda x: jnp.broadcast_to(x, (B,) + x.shape), r_t
            )
            return obs_b, ref_b, new_t

        record = lambda out: (out.tau[0], out.grf[0])
    else:
        # (P, T, ...) profiles: scenario b replays gait b % P in lockstep
        P = traj["base_R"].shape[0]
        prof = np.arange(B) % P
        xs_obs = wbc.RobotObservation(
            **{k: jnp.asarray(traj[k][prof], dtype).swapaxes(0, 1)
               for k in obs_keys}
        )  # leaves are (T, B, ...)
        xs_ref = wbc.Reference(
            **{k: jnp.asarray(traj[k][prof], dtype).swapaxes(0, 1)
               for k in ref_keys}
        )
        xs_new = jnp.asarray(traj["ref_is_new"][prof]).swapaxes(0, 1)

        def batchify(o_t, r_t, new_t):
            return o_t, r_t, new_t  # already (B, ...) per step

        record = lambda out: (out.tau[:P], out.grf[:P])
    cache = qpm.make_cache(B, 42, 70, qp, dtype) if backend == "cached" else None
    carry = jax.tree.map(lambda x: jnp.stack([x] * B), wbc.init_carry(dtype))

    @jax.jit
    def run(carry, cache, valid):
        def body(cc, xs):
            c, cache = cc
            o_t, r_t, new_t = xs
            obs_b, ref_b, new_b = batchify(o_t, r_t, new_t)
            if cache is not None:
                out, c2, cache2 = wbc.wbc_step_batched(
                    model, cp, qp, obs_b, ref_b, c, new_b, backend,
                    cache, valid,
                )
            else:
                out, c2 = wbc.wbc_step_batched(
                    model, cp, qp, obs_b, ref_b, c, new_b, backend
                )
                cache2 = None
            tau_t, grf_t = record(out)
            return (c2, cache2), (tau_t, grf_t,
                                  jnp.max(out.qp_info.kkt_residual))
        (c2, cache2), (taus, grfs, kkts) = jax.lax.scan(
            body, (carry, cache), (xs_obs, xs_ref, xs_new)
        )
        return taus, grfs, kkts

    return run, carry, cache


def _artifact_path(stage, traj_name, tag=""):
    suffix = "" if traj_name == "walk" else f"_{traj_name}"
    return os.path.join(ROOT, "data", f"torque_{stage}{suffix}{tag}.npz")


def report(traj_name, tag=""):
    # TQ_TAG probe runs compare their tagged f32 replay against the
    # CANONICAL committed f64 reference (the reference is config-free)
    stats = torque_stats(traj_name, np.load(_artifact_path("run", traj_name, tag)))
    print(json.dumps(stats))
    return stats


def torque_stats(traj_name, f32):
    """Error statistics of an f32 replay (mapping with tau / grf / kkt /
    backend) against the committed f64 reference."""
    ref = np.load(_artifact_path("cpu64", traj_name))
    traj = np.load(TRAJS[traj_name])
    err = np.abs(f32["tau"] - ref["tau"])  # (T, 12) or (T, 4, 12)
    step_err = err.reshape(err.shape[0], -1).max(axis=1)
    # contact-switch steps (the active-set boundaries)
    c = traj["contacts"]
    new = traj["ref_is_new"]
    if c.ndim == 3:  # diverse: a step is a switch step if ANY gait switches
        P, T = c.shape[:2]
        switch = np.zeros(T, bool)
        prev = c[:, 0].copy()
        for t in range(T):
            for p in range(P):
                if new[p, t] and np.any(c[p, t] != prev[p]):
                    switch[t] = True
                    prev[p] = c[p, t]
    else:
        switch = np.zeros(len(c), bool)
        prev = c[0]
        for t in range(len(c)):
            if new[t] and np.any(c[t] != prev):
                switch[t] = True
                prev = c[t]
    near_switch = np.zeros_like(switch)
    for t in np.flatnonzero(switch):
        near_switch[max(0, t - 2):t + 8] = True
    worst = np.argsort(-step_err)[:5]
    stats = {
        "metric": f"f32_torque_error_Nm_vs_f64_{traj_name}",
        "backend_f32": str(f32["backend"]),
        "median": float(np.median(err)),
        "p99": float(np.percentile(err, 99)),
        "max": float(err.max()),
        "median_step_max": float(np.median(step_err)),
        "steps_over_1e-3": int(np.sum(step_err > 1e-3)),
        "steps_over_1e-1": int(np.sum(step_err > 1e-1)),
        "worst_steps": [
            {"t": int(t), "err": float(step_err[t]),
             "near_contact_switch": bool(near_switch[t])}
            for t in worst
        ],
        "max_err_off_switch": float(step_err[~near_switch].max())
        if (~near_switch).any() else 0.0,
        "grf_max_err_N": float(np.abs(f32["grf"] - ref["grf"]).max()),
        "kkt_max_f32": float(f32["kkt"].max()),
        "kkt_max_f64": float(ref["kkt"].max()),
    }
    if err.ndim == 3:  # per-gait breakdown
        P = err.shape[1]
        # the canonical 4-gait set (tools/make_diverse_traj.py); generic
        # labels if the trajectory is regenerated with a different P
        names = (["walk", "fast_turn", "trot", "payload_lowfric"]
                 if P == 4 else [f"gait{g}" for g in range(P)])
        stats["per_gait_max"] = {
            names[g]: float(err[:, g].max()) for g in range(P)
        }
        stats["per_gait_p99"] = {
            names[g]: float(np.percentile(err[:, g], 99))
            for g in range(P)
        }
    return stats


# the forced-cap probes: caps below B=8 force the compacted cold-fix and
# drop-round branches that the default caps never enter at this batch
PROBES = (("cold_batch4", {"TQ_COLD_BATCH": "4"}),
          ("drop_batch6", {"TQ_DROP_BATCH": "6"}))


def probes():
    """Every forced-cap probe on walk and diverse, in-process; prints one
    JSON line each (error statistics vs the committed f64 reference)."""
    import jax

    out = []
    for name, env in PROBES:
        for traj in ("walk", "diverse"):
            saved = {k: os.environ.get(k) for k in env}
            os.environ.update(env)
            try:
                tau, grf, kkt = replay_torques("float32", traj)
            finally:
                for k, v in saved.items():
                    if v is None:
                        os.environ.pop(k, None)
                    else:
                        os.environ[k] = v
            st = torque_stats(traj, dict(tau=tau, grf=grf, kkt=kkt,
                                         backend=jax.default_backend()))
            st["probe"] = name
            print(json.dumps(st), flush=True)
            out.append(st)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--stage", choices=["cpu64", "run", "report", "probes"],
                    required=True)
    ap.add_argument("--traj", choices=["walk", "diverse"], default="walk")
    args = ap.parse_args()
    tag = os.environ.get("TQ_TAG", "")
    if args.stage == "report":
        report(args.traj, tag)
        return
    if args.stage == "probes":
        probes()
        return
    import jax

    dtype = "float64" if args.stage == "cpu64" else "float32"
    if args.stage == "cpu64":
        assert jax.default_backend() == "cpu", (
            "run the cpu64 stage with JAX_PLATFORMS=cpu"
        )
        jax.config.update("jax_enable_x64", True)
    tau, grf, kkt = replay_torques(dtype, args.traj)
    out = _artifact_path(args.stage, args.traj,
                         "" if args.stage == "cpu64" else tag)
    np.savez(out, tau=tau, grf=grf, kkt=kkt,
             backend=jax.default_backend())
    print(json.dumps({"stage": args.stage, "saved": out,
                      "kkt_max": float(kkt.max())}))


if __name__ == "__main__":
    main()

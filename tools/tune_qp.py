#!/usr/bin/env python3
"""QP solver parameter tuning on the live accelerator.

For each candidate QPSolverParams config, measures
  * speed: the bench.py standing scan (B=4096) in ms/step,
  * quality: a walking closed-loop batched rollout (B=256, T=400) — KKT
    residual stats, fallen count, torque/CoM agreement vs the default config.

Honest scan-inside-jit timing only (CLAUDE.md).  Run:
    python tools/tune_qp.py [config names...]
"""
import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from quadrupedwholebodycontroller.config import (
    ControllerParams,
    PlannerParams,
    QPSolverParams,
    QP_NUM_CONSTRAINTS,
    QP_NUM_VARS,
)
from quadrupedwholebodycontroller.control import wbc
from quadrupedwholebodycontroller.models import anymal_d_model
from quadrupedwholebodycontroller.models.anymal import INITIAL_JOINT_POS
from quadrupedwholebodycontroller.ops import qp as qpm
from quadrupedwholebodycontroller.sim import SimParams
from quadrupedwholebodycontroller.sim.rollout import (
    batched_rollout,
    init_rollout_carry,
)
from quadrupedwholebodycontroller.planner import gait

CONFIGS = {
    "default": QPSolverParams(),
    # batch-minor solve chain (round 3): prepared tensors stay in the
    # setup kernel's native batch-minor layout; K build + warm-NS K^-1 run
    # as trailing-batch einsums; the ADMM kernel consumes the tiles
    # directly (no back()/to_tile boundary transposes, no padded
    # batch-major (B,42,42) HBM round trips)
    "layout_minor": QPSolverParams(solve_layout="minor"),
    "layout_minor_norescue": QPSolverParams(
        solve_layout="minor", rescue_threshold=0.0
    ),
    # the round-2 rescue (single stage, no compensated refinement,
    # batch-level warm gate) — isolates the round-3 additions
    "r2_rescue": QPSolverParams(
        rescue_stages=1, rescue_comp_refine=0, cold_batch=0
    ),
    # f32 tail-rescue A/B (VERDICT r1 item 5): default has
    # rescue_threshold=3e-3; this isolates its cost/benefit
    "norescue": QPSolverParams(rescue_threshold=0.0),
    "rescue_1e3": QPSolverParams(rescue_threshold=1e-3),
    "rescue_it100_r2": QPSolverParams(
        rescue_iterations=100, rescue_polish_rounds=2
    ),
    "warm3": QPSolverParams(ns_warm_iters=3),
    "warm3_fast": QPSolverParams(
        ns_warm_iters=3, scaling_iters=5, iterations=60, polish_refine=3
    ),
    "warm4_r1": QPSolverParams(ns_warm_iters=4, polish_rounds=1, polish_refine=3),
    "warm2_fast": QPSolverParams(
        ns_warm_iters=2, scaling_iters=4, iterations=50, polish_refine=3
    ),
    # 1-iteration NS tracking: the (B,70,70)/(B,42,42) warm updates are
    # HBM-bound, so halving them is a real win IF the polish refinement
    # absorbs the extra preconditioner error
    "warm1": QPSolverParams(ns_warm_iters=1),
    "warm1_refine4": QPSolverParams(ns_warm_iters=1, polish_refine=4),
    "warm1_iters40": QPSolverParams(ns_warm_iters=1, iterations=40),
    # split tracking: full-rate NS on the ADMM K^-1 (unguarded), 1-iteration
    # NS on the polish inverses (guarded by the refinement passes)
    "polish_warm1": QPSolverParams(ns_warm_iters=2, ns_warm_iters_polish=1),
    "kinv3_polish1": QPSolverParams(ns_warm_iters=3, ns_warm_iters_polish=1),
    # constraint-space (z, y) ADMM kernel: sigma = 0 closes the iteration
    # over P = A K^-1 A^T — one 70-wide reduction/iter instead of three
    # (sigma=0, iterations=60 became the default after the round-4 tuning)
    "sigma0": QPSolverParams(sigma=0.0, iterations=50),
    "sigma0_iters80": QPSolverParams(sigma=0.0, iterations=80),
    # legacy x-space proximal path (the pre-round-4 default)
    "sigma_prox": QPSolverParams(sigma=1e-6, iterations=50),
    # NS-budget trims under the sigma0 defaults: each warm NS iteration is
    # ~2 HBM-streamed (B,70,70)/(B,42,42) matmuls
    "kinv2": QPSolverParams(ns_warm_iters=2),
    # with the lazy Schur fast path, polish round 2 costs more than the
    # refine passes — try buying round-2's accuracy with refinement instead
    "rounds1_refine5": QPSolverParams(polish_rounds=1, polish_refine=5),
    # post-P-free candidates: ADMM iterations are 3 cheap matvecs now and
    # refine=5 absorbs preconditioner error — probe trimming the remaining
    # HBM-bound blocks (warm-NS matmuls) and the iteration count
    "admm40": QPSolverParams(iterations=40),
    "admm80": QPSolverParams(iterations=80),
    "warm1_new": QPSolverParams(ns_warm_iters=1),
    "warm1_admm80": QPSolverParams(ns_warm_iters=1, iterations=80),
    "rounds1_refine4_admm80": QPSolverParams(
        polish_rounds=1, polish_refine=4, iterations=80
    ),
    "polish0": QPSolverParams(ns_warm_iters_polish=0),
    "kinv2_polish0": QPSolverParams(ns_warm_iters=2, ns_warm_iters_polish=0),
    "iters50": QPSolverParams(iterations=50),
    # round-4: always-on compensated final refinement (the torque-parity
    # lever, config.comp_final_refine).  default now carries 2 passes;
    # compfinal0 isolates the cost, compfinal4 probes diminishing returns
    "compfinal0": QPSolverParams(comp_final_refine=0),
    # round-4 cost bisection: isolate the drop round (rounds=1 disables
    # it) and the rescue, under the new sign-augmented acceptance
    "rounds1": QPSolverParams(polish_rounds=1),
    "rounds1_norescue": QPSolverParams(
        polish_rounds=1, rescue_threshold=0.0
    ),
    "drop64": QPSolverParams(drop_batch=64),
    "drop128": QPSolverParams(drop_batch=128),
    "drop0": QPSolverParams(drop_batch=0),
    # lean 1e-3 rescue (VERDICT r3 #3): with the drop rounds fixing the
    # active sets, the rescue's remaining job is ADMM convergence — probe
    # smaller budgets at the tight threshold
    "rescue_1e3_lean": QPSolverParams(
        rescue_threshold=1e-3, rescue_iterations=40,
        rescue_polish_rounds=1,
    ),
    "rescue_1e3_it60": QPSolverParams(
        rescue_threshold=1e-3, rescue_iterations=60,
        rescue_polish_rounds=1, rescue_batch=128,
    ),
    "rescue_3e3_lean": QPSolverParams(
        rescue_threshold=3e-3, rescue_iterations=40,
        rescue_polish_rounds=1, rescue_batch=128,
    ),
    "rescue_1e3_it80": QPSolverParams(
        rescue_threshold=1e-3, rescue_iterations=80,
        rescue_polish_rounds=1, rescue_batch=192,
    ),
    "compfinal1": QPSolverParams(comp_final_refine=1),
    "compfinal4": QPSolverParams(comp_final_refine=4),
    # round-5: rescue-off at the SHIPPED drop cap (ADVICE r4: the README
    # "guarantee is ~free" A/B compared across the cap flip)
    "norescue_d64": QPSolverParams(rescue_threshold=0.0, drop_batch=64),
    # round-5 drop-round fire bar / warm compacted inverse (VERDICT r4 #1)
    "ft1e5": QPSolverParams(drop_fire_tol=1e-5),
    "ft1e5_dw8": QPSolverParams(drop_fire_tol=1e-5, drop_warm_iters=8),
    # round-5 compacted rescue round 2 (VERDICT r4 #2): the 1e-3 frontier
    # blocker was the SECOND cold polish round running over the whole
    # rescue sub-batch; r2cK caps it at the K still-flagged worst
    "rescue_1e3_60_r2c32": QPSolverParams(
        rescue_threshold=1e-3, rescue_iterations=60,
        rescue_polish_rounds=2, rescue_batch=128, rescue_round2_batch=32,
    ),
    "rescue_1e3_60_r2c16": QPSolverParams(
        rescue_threshold=1e-3, rescue_iterations=60,
        rescue_polish_rounds=2, rescue_batch=128, rescue_round2_batch=16,
    ),
    "rescue_1e3_100_r2c32": QPSolverParams(
        rescue_threshold=1e-3, rescue_iterations=100,
        rescue_polish_rounds=2, rescue_batch=128, rescue_round2_batch=32,
    ),
    "rescue_3e3_r2c32": QPSolverParams(
        rescue_iterations=40, rescue_polish_rounds=2,
        rescue_round2_batch=32,
    ),
    # second frontier probe wave: trim the rescue's round-1 width
    # (rescue_batch) and the compacted round-2 width further
    "rescue_1e3_100_r2c16": QPSolverParams(
        rescue_threshold=1e-3, rescue_iterations=100,
        rescue_polish_rounds=2, rescue_batch=128, rescue_round2_batch=16,
    ),
    "rescue_1e3_100_r2c32_rb96": QPSolverParams(
        rescue_threshold=1e-3, rescue_iterations=100,
        rescue_polish_rounds=2, rescue_batch=96, rescue_round2_batch=32,
    ),
    "rescue_1e3_100_r2c32_rb64": QPSolverParams(
        rescue_threshold=1e-3, rescue_iterations=100,
        rescue_polish_rounds=2, rescue_batch=64, rescue_round2_batch=32,
    ),
    "rescue_1e3_100_r2c32_s2": QPSolverParams(
        rescue_threshold=1e-3, rescue_iterations=100,
        rescue_polish_rounds=2, rescue_batch=128, rescue_round2_batch=32,
        rescue_stages=2,
    ),
}

BENCH_B = int(os.environ.get("TUNE_BENCH_B", "4096"))
ROLL_B = int(os.environ.get("TUNE_ROLL_B", "256"))
ROLL_T = int(os.environ.get("TUNE_ROLL_T", "400"))
SCAN = 50
REPS = 3


def bench_speed(qp):
    dtype = jnp.float32
    model = anymal_d_model(dtype=dtype)
    cp = ControllerParams()
    backend = "cached" if jax.default_backend() != "cpu" else "xla"
    B = BENCH_B
    key = jax.random.PRNGKey(0)
    k1, k2, k3, k4 = jax.random.split(key, 4)
    obs = wbc.RobotObservation(
        base_R=jnp.broadcast_to(jnp.eye(3, dtype=dtype), (B, 3, 3)),
        base_p=jnp.tile(jnp.array([0.0, 0.0, 0.55], dtype), (B, 1))
        + 0.01 * jax.random.normal(k1, (B, 3), dtype),
        base_vel=0.02 * jax.random.normal(k2, (B, 6), dtype),
        q=jnp.tile(jnp.asarray(INITIAL_JOINT_POS, dtype), (B, 1))
        + 0.02 * jax.random.normal(k3, (B, 12), dtype),
        qd=0.05 * jax.random.normal(k4, (B, 12), dtype),
    )
    ref = jax.tree.map(lambda x: jnp.stack([x] * B), wbc.Reference.standing(ControllerParams(), dtype))
    carry = jax.tree.map(lambda x: jnp.stack([x] * B), wbc.init_carry(dtype))
    cache = qpm.make_cache(B, QP_NUM_VARS, QP_NUM_CONSTRAINTS, qp, dtype)

    @jax.jit
    def multi(carry, cache, valid):
        def body(cc, _):
            c, ca = cc
            out, c2, ca2 = wbc.wbc_step_batched(
                model, cp, qp, obs, ref, c, True, backend, ca, valid
            )
            return (c2, ca2), (jnp.sum(out.tau), jnp.max(out.qp_info.kkt_residual),
                               jnp.mean(out.qp_info.kkt_residual))
        (c2, ca2), o = jax.lax.scan(body, (carry, cache), None, length=SCAN)
        return c2, ca2, o

    carry, cache, o = multi(carry, cache, False)
    jax.block_until_ready(o)
    times = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        carry, cache, o = multi(carry, cache, True)
        jax.block_until_ready(o)
        times.append((time.perf_counter() - t0) / SCAN)
    times.sort()
    ms = times[len(times) // 2] * 1e3
    return dict(
        ms_per_step=round(ms, 2),
        solves_per_s=round(BENCH_B / times[len(times) // 2], 1),
        standing_max_kkt=float(jnp.max(o[1])),
        standing_mean_kkt=float(jnp.mean(o[2])),
    )


def rollout_quality(qp):
    dtype = jnp.float32
    model = anymal_d_model(dtype=dtype)
    cp, pp, sp = ControllerParams(), PlannerParams(), SimParams()
    B, T = ROLL_B, ROLL_T
    carry1 = init_rollout_carry(model, cp, pp, dtype=dtype)
    bcarry = jax.tree.map(lambda x: jnp.stack([x] * B), carry1)
    # slight de-phased initial perturbations so the batch isn't degenerate
    key = jax.random.PRNGKey(7)
    bcarry = bcarry._replace(
        sim=bcarry.sim._replace(
            q=bcarry.sim.q + 0.01 * jax.random.normal(key, (B, 12), dtype)
        )
    )
    cmds = jnp.zeros((B, T, 3), dtype).at[:, 100:, 0].set(0.5)
    ratio = int(round(cp.loop_rate * pp.dt))

    run = jax.jit(
        lambda c, x: batched_rollout(
            model, cp, qp, sp,
            lambda s, cc: gait.planner_step(pp, s, cc),
            ratio, c, x,
            qp_backend="cached" if jax.default_backend() != "cpu" else "xla",
        )
    )
    t0 = time.perf_counter()
    fc, tr = run(bcarry, cmds)
    jax.block_until_ready(tr.tau)
    wall = time.perf_counter() - t0
    kkt = np.asarray(tr.qp_kkt)
    alive = kkt > 0  # frozen scenarios log 0
    fallen = int(B - np.sum(np.all(np.isfinite(np.asarray(tr.com_pos)), axis=(1, 2))
                            & (np.asarray(tr.com_pos)[:, -1, 2] > 0.2)))
    return dict(
        wall_s_first_call=round(wall, 1),
        walk_mean_kkt=float(np.mean(kkt[alive])),
        walk_p99_kkt=float(np.percentile(kkt[alive], 99)),
        walk_max_kkt=float(np.max(kkt)),
        fallen=fallen,
        tau=np.asarray(tr.tau),
        com=np.asarray(tr.com_pos),
    )


def main():
    names = sys.argv[1:] or list(CONFIGS)
    base_tau = base_com = None
    for name in names:
        qp = CONFIGS[name]
        speed = bench_speed(qp)
        qual = rollout_quality(qp)
        tau, com = qual.pop("tau"), qual.pop("com")
        if base_tau is None:
            base_tau, base_com = tau, com
            cmp_ = {}
        else:
            # pre-chaos agreement: first 80 steps (0.2 s) before divergence
            cmp_ = dict(
                tau_maxdiff_80=float(np.max(np.abs(tau[:, :80] - base_tau[:, :80]))),
                com_maxdiff_80=float(
                    np.max(np.linalg.norm(com[:, :80] - base_com[:, :80], axis=-1))
                ),
                com_z_maxdiff_full=float(
                    np.max(np.abs(com[:, :, 2] - base_com[:, :, 2]))
                ),
            )
        print(json.dumps({"config": name, **speed, **qual, **cmp_}), flush=True)


if __name__ == "__main__":
    main()

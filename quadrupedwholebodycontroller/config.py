"""Typed configuration objects.

Field names and default values mirror the reference YAML schemas so that the
reference configs port verbatim:
  * controller params — /root/reference/config/params_controller.yaml:1-12,
    loaded at /root/reference/src/whole_body_controller.cpp:122-148
  * planner params — /root/reference/config/params_planner.yaml:1-8,
    loaded at /root/reference/src/motion_planner.cpp:99-120
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

GRAVITY = 9.81  # reference: gravityAcceleration, whole_body_controller.hpp:30
# "infinity" for one-sided QP bounds — finite, the qpOASES INFTY convention
# (reference cpp:508-514); keeps every gradient path NaN-free under jit
QP_INF = 1.0e20

NUM_JOINTS = 12
NUM_LEGS = 4
NV = 6 + NUM_JOINTS  # floating-base velocity dimension (18)
# QP decision vector: [com accel (6); joint accel (12); GRFs (12); slacks (12)]
# reference: whole_body_controller.hpp:31
QP_NUM_VARS = 6 + NUM_JOINTS + 3 * NUM_LEGS + 3 * NUM_LEGS  # 42
# QP constraint rows: dynamics (6) + stance feet (12) + friction (16)
# + torque limits (12) + swing tracking (24) — whole_body_controller.hpp:32
QP_NUM_CONSTRAINTS = 6 + 3 * NUM_LEGS + 4 * NUM_LEGS + NUM_JOINTS + 6 * NUM_LEGS  # 70

# Leg order used everywhere (jacobian stacking, contact flags, reference msg):
# reference src/whole_body_controller.cpp:327-341
LEG_NAMES = ("LH", "LF", "RF", "RH")


@dataclasses.dataclass(frozen=True)
class ControllerParams:
    """WBC gains/limits (reference config/params_controller.yaml)."""

    friction: float = 1.0
    loop_rate: float = 400.0
    max_torque: float = 80.0
    kp: float = 6000.0          # reference: kpValue
    kp_z: float = 10000.0       # reference: kpValueZ
    kd: float = 1800.0          # reference: kdValue
    ki: float = 0.0             # reference: kiValue
    kp_swing: float = 250.0     # reference: kpSwingValue
    kd_swing: float = 20.0      # reference: kdSwingValue
    slack_weight: float = 1000.0
    initial_reference_pose: Sequence[float] = (0.0, 0.0, 0.50, 0.0, 0.0, 0.0)
    # beyond-reference option: analytic Tdot/Jdot via jvp instead of the
    # reference's finite differences (cpp:384-402) — no one-cycle lag, no
    # contact-switch transients
    exact_derivatives: bool = False
    # exact_derivatives implementation on the fused setup path:
    # False (default) = the tangent propagation runs inside the generated
    # setup (ops/setup_fused exact_mode); True = force the XLA jvp
    # epilogue (control/wbc._exact_epilogue_batched), kept as the
    # independent oracle for A/B and equivalence tests
    exact_epilogue: bool = False

    @property
    def dt(self) -> float:
        return 1.0 / self.loop_rate


@dataclasses.dataclass(frozen=True)
class PlannerParams:
    """Static-walk gait parameters (reference config/params_planner.yaml)."""

    step_length: float = 0.1
    height_control_point: float = 0.1
    x_offset: float = 0.50
    y_offset: float = 0.33
    step_duration: float = 0.2
    body_height: float = 0.50
    body_final_velocity: float = 0.40
    dt: float = 0.01

    @property
    def cycle_duration(self) -> float:
        # reference src/motion_planner.cpp:119
        return 4.0 * self.step_duration


@dataclasses.dataclass(frozen=True)
class QPSolverParams:
    """Batched OSQP-style ADMM solver settings (replaces qpOASES SQProblem

    hot-started active-set solves, reference whole_body_controller.cpp:517-533).

    The defaults were tuned with tools/tune_qp.py + tools/tune_sweep.py on
    the walking replay and the extreme-scenario sweep; the comments keep
    the decisions.  Speed numbers for the current accelerator live in
    PERF.md, never here.
    """

    iterations: int = 40          # ADMM iterations per hot-started solve
                                  # (40 holds walking max KKT inside the
                                  # accepted envelope at less cost than 60)
    cold_iterations: int = 200    # ADMM iterations when the warm start is
                                  # all-zero (the qpOASES init-vs-hotstart
                                  # asymmetry: nWSR=100 on init, cheap after
                                  # — reference cpp:523-533); a correct
                                  # active-set estimate from scratch needs
                                  # ~3x the hot-start iteration budget
    rho: float = 0.5              # base ADMM penalty (tuned on the WBC QP)
    rho_eq_scale: float = 1000.0  # penalty boost for equality rows
    sigma: float = 0.0            # proximal weight; 0 selects the
                                  # constraint-space (z,y) ADMM loop
                                  # (ops/admm.zy_loop) — same speed as a
                                  # small sigma and better walking KKT
    alpha: float = 1.6            # over-relaxation
    scaling_iters: int = 4        # Ruiz equilibration sweeps (0 = off)
    ns_iters: int = 30            # Newton-Schulz iterations for matmul-only inverses
    ns_warm_iters: int = 2        # NS iterations when restarting from a carried cache
    ns_warm_iters_polish: int = 0  # same, for the polish Schur inverse only;
                                  # -1 = use ns_warm_iters.  The polish
                                  # refinement passes recompute true KKT
                                  # residuals, so its inverse tolerates an
                                  # UN-updated carried warm start (0 NS
                                  # iterations — the safeguarded cache is
                                  # used as-is as the preconditioner) while
                                  # the ADMM K^-1 (whose error shifts the
                                  # iterate unguarded) gets 2; 2/0 was
                                  # faster than 3/1 at equal walking quality
    polish: bool = True           # active-set KKT polish after ADMM
    polish_rounds: int = 2        # iterated active-set refinement rounds.
                                  # Round 2 is the DROP round: rows whose
                                  # round-1 candidate multiplier came out
                                  # wrong-signed are banned from round 2's
                                  # estimate — the classical active-set
                                  # resolution of stale warm-start duals
                                  # that otherwise pin a row at a bound it
                                  # left (a 0.25 N·m torque error at a
                                  # "converged" certificate,
                                  # tools/debug_compfinal.py).  Steps whose
                                  # estimate is unchanged skip round 2
                                  # batch-wide via the `changed` cond.
    polish_reg: float = 1e-9
    polish_refine: int = 5        # coupled iterative-refinement passes per
                                  # polish round (preconditioned Richardson on
                                  # the KKT system — recovers the digits a
                                  # short warm NS inverse leaves on the table)
    # f32 tail rescue (the batched analogue of qpOASES setToReliable,
    # reference whole_body_controller.cpp:519): when any scenario's relative
    # KKT exceeds rescue_threshold after polish, the whole batch gets one
    # guarded re-solve (extra ADMM iterations from the current best iterate
    # + fresh cold-inverse polish), accepted per-scenario only where it
    # improves.  Wrapped in a batch-level lax.cond: costs nothing on the
    # (typical) steps where every scenario is already below threshold.
    rescue_threshold: float = 3e-3  # <= 0 disables
    rescue_iterations: int = 40   # with the polish drop rule fixing active
    rescue_polish_rounds: int = 2  # sets BEFORE the rescue, a lean 40-
                                  # iteration budget holds the extreme-sweep
                                  # tail.  Rounds >= 2 are compacted
                                  # (rescue_round2_batch); the second cold
                                  # polish round is what moves scenarios
                                  # that plateau just above the threshold.
                                  # Only 100 iterations / 2 rounds reach a
                                  # 1e-3 certificate (PERF.md).
    rescue_batch: int = 128       # compact the rescue to the top-k worst
                                  # scenarios (jax.lax.top_k on the relative
                                  # KKT): the cold K^-1 / extra ADMM / cold-
                                  # Schur polish run on a gathered (k, ...)
                                  # sub-batch and accepted improvements
                                  # scatter back, so the fire cost is O(k)
                                  # instead of O(B).  0 = full-batch rescue.
                                  # Scenarios beyond the k worst keep their
                                  # un-rescued result — size k above the
                                  # per-step flagged count (measured with
                                  # tools/tune_rescue.py)
    rescue_stages: int = 3        # the rescue re-fires (lax.while_loop, one
                                  # trace) until no scenario exceeds the
                                  # threshold or this many stages ran: each
                                  # stage continues ADMM from the improved
                                  # iterate and re-estimates the active set
                                  # from a closer point, so repeated stages
                                  # clear scenarios a single pass leaves
                                  # marginally above threshold
    rescue_comp_refine: int = 2   # compensated (double-f32, error-free-
                                  # transformation) refinement passes on the
                                  # active-set KKT system as the rescue's
                                  # final candidate (ops/compensated.py):
                                  # recovers the digits that plain-f32
                                  # residual evaluation noise-floors away.
                                  # 0 disables
    comp_final_refine: int = 0    # OPTIONAL compensated (double-f32)
                                  # refinement passes on the final accepted
                                  # iterate, reusing the polish
                                  # preconditioners in hand.  Default 0:
                                  # the f32 torque tail was MIS-CLASSIFIED
                                  # ACTIVE SETS, not arithmetic — with the
                                  # polish drop rule + relative activation
                                  # tolerances + sign-augmented acceptance
                                  # the walking replay holds the 1e-3 N·m
                                  # torque bar with comp passes off, and
                                  # identically with them on
    cold_batch: int = 512         # per-scenario warm-cache gating: scenarios
                                  # whose contact set switched are re-
                                  # inverted cold on a compacted top-k
                                  # sub-batch while the rest warm-update
                                  # from the carried cache (one scenario's
                                  # switch no longer cold-starts the whole
                                  # batch).  More switched scenarios than
                                  # this falls back to the full-batch cold
                                  # inverse.  0 = batch-level gating.  512
                                  # covers the diverse 4-gait replay's worst
                                  # step (~495 switch edges at B=8192)
    drop_batch: int = 64          # cap the polish DROP round (round 2+) at
                                  # the k WORST scenarios the previous
                                  # round failed (a wrong-signed candidate
                                  # multiplier or a rejected candidate),
                                  # ranked by max(res, sign_violation):
                                  # gather, assemble + cold-invert their
                                  # (k, m, m) Schur systems, scatter
                                  # accepted improvements back.  A HARD
                                  # cap, no full-batch fallback — on the
                                  # extreme sweep >25% of scenarios fail
                                  # round 1 every step (stiff-contact
                                  # transients); scenarios beyond the cap
                                  # keep round-1 results and the staged
                                  # rescue remains the tail guarantee.
                                  # k=64/128/256 gave identical quality
                                  # gates; the cap's cost is per-step
                                  # fixed overhead, so the smallest ships.
                                  # 0 = full-batch drop round.  The B=8
                                  # torque-parity replay is cap-invariant.
    drop_fire_tol: float = 0.0    # fire bar for the drop round: a scenario
                                  # enters round 2+ only when, besides
                                  # failing the previous round, its
                                  # current max(res, sv) exceeds this.
                                  # 0 = fire on any failure.  Measured no
                                  # effect on the evolving replay (some
                                  # scenario always exceeds any bar).
    drop_warm_iters: int = 0      # NS iterations to warm the drop round's
                                  # compacted (k, m, m) Schur inverse from
                                  # the carried `sinv` rows.  MUST stay 0
                                  # (cold): a drop changes the active set,
                                  # ||I - S_new W_old|| routinely exceeds
                                  # NS's convergence radius, and the
                                  # correction is silently lost below the
                                  # KKT gates (forced-cap parity probes).
    drop_sinv_refresh: int = 0    # 1: scatter the drop round's freshly
                                  # inverted (k, m, m) Schur blocks back
                                  # into the carried sinv rows.  0 skips
                                  # the refresh (the cross-step cache is
                                  # warm-gated and safeguarded anyway);
                                  # identical gates and parity probes.
    drop_ns_iters: int = 0        # Newton-Schulz budget for the compacted
                                  # drop round's cold Schur inverse; 0 =
                                  # use ns_iters (30).  20 and 15 failed
                                  # the forced-cap torque-parity probes
                                  # (the drop_warm_iters failure shape).
                                  # Keep 0.
    ns_cold_prec: str = ""        # matmul precision for the BODY
                                  # iterations of the PER-STEP cold
                                  # sub-batch NS chains (the cold-fix
                                  # (k, n, n) inverses and the drop
                                  # round's compacted Schur inverse; the
                                  # RESCUE's cold chains are explicitly
                                  # excluded — it is the tail guarantee
                                  # and stays all-highest, ops/qp.py
                                  # _rescue_core); the last ns_cold_tail
                                  # iterations run at full precision.
                                  # "" = all-highest.  "high" was
                                  # validated as 3-pass bf16 on the
                                  # machine this was first built for; on
                                  # the GPU it is TF32 (~10 mantissa
                                  # bits) and has not passed the
                                  # forced-cap torque-parity probes on
                                  # the card, so it is off (PERF.md).
                                  # Raw "bfloat16" bodies DIVERGE on hard
                                  # spectra.  Any change must hold the
                                  # forced-cap probes
                                  # (tools/measure_torque_err.py --stage
                                  # probes).
    ns_cold_tail: int = 10        # full-precision tail iterations when
                                  # ns_cold_prec is set.  PROBE-VALIDATED,
                                  # not assumed monotone: tails 6 AND 14
                                  # both failed the forced-cap walk probe;
                                  # re-probe any change (TQ_NS_COLD_TAIL)
    cond_hoist: int = 0           # cond buffer-routing experiments
                                  # (bitwise-identical values on every
                                  # path).  1: route only the gathered
                                  # (k, m, m) sub-blocks through the
                                  # cold-fix conds and scatter OUTSIDE
                                  # them — measured slower: the hoisted
                                  # scatter into the carried (m, m, B)
                                  # tensor materializes a full copy.  2:
                                  # hoist ONLY the drop-round's carried
                                  # sinv out of its cond outputs.
                                  # Default 0.
    drop_approx_rank: int = 0     # 1: rank the drop round's failed
                                  # scenarios with jax.lax.approx_max_k
                                  # instead of a full top_k sort (the cap
                                  # is a heuristic, ~0.95 recall is fine).
                                  # Measured no effect.
    rescue_round2_batch: int = 32  # compact the rescue's polish rounds >= 2
                                  # to the top-k scenarios still above
                                  # rescue_threshold after the previous
                                  # round (gather -> cold-Schur polish ->
                                  # scatter), instead of O(rescue_batch)
                                  # cold Schur inverses.  0 = uncompacted
    solve_layout: str = "minor"   # "minor": the scaled-problem solve chain
                                  # (prepared outputs -> K build -> warm-NS
                                  # K^-1 -> ADMM inputs) stays batch-minor
                                  # (dims..., B) end to end, coalesced
                                  # along the batch; "major" transposes at
                                  # each stage.  QPCache must be created
                                  # with the matching layout
                                  # (ops/qp.make_cache).


def load_yaml_params(path: str):
    """Load a reference-format YAML (params_controller.yaml /

    params_planner.yaml name scheme) into the typed dataclasses."""
    import yaml

    with open(path) as f:
        raw = yaml.safe_load(f)
    ctrl_map = {
        "friction": "friction",
        "loopRate": "loop_rate",
        "maxTorque": "max_torque",
        "kpValue": "kp",
        "kpValueZ": "kp_z",
        "kdValue": "kd",
        "kiValue": "ki",
        "kpSwingValue": "kp_swing",
        "kdSwingValue": "kd_swing",
        "slackWeight": "slack_weight",
        "initialReferencePose": "initial_reference_pose",
    }
    plan_keys = {
        "step_length", "height_control_point", "x_offset", "y_offset",
        "step_duration", "body_height", "body_final_velocity", "dt",
    }
    ctrl_kwargs = {v: raw[k] for k, v in ctrl_map.items() if k in raw}
    plan_kwargs = {k: raw[k] for k in plan_keys if k in raw}
    out = {}
    if ctrl_kwargs:
        if "initial_reference_pose" in ctrl_kwargs:
            ctrl_kwargs["initial_reference_pose"] = tuple(ctrl_kwargs["initial_reference_pose"])
        out["controller"] = ControllerParams(**ctrl_kwargs)
    if plan_kwargs:
        out["planner"] = PlannerParams(**plan_kwargs)
    return out

"""Sharded scenario sweeps: the batched-robustness workload

(BASELINE.json config 5: thousands of parallel scenarios over payload,
friction, and push disturbances, sharded across devices).

The whole closed-loop step (planner tick + WBC + physics) runs under
shard_map with the scenario batch split over the device mesh; cross-device
traffic is exactly one psum for the sweep metrics (the ROS topic bus
collapsed to one collective).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from quadrupedwholebodycontroller.config import (
    ControllerParams,
    PlannerParams,
    QPSolverParams,
)
from quadrupedwholebodycontroller.models.robot_model import RobotModel
from quadrupedwholebodycontroller.parallel.mesh import BATCH_AXES
from quadrupedwholebodycontroller.sim import world


class SweepMetrics(NamedTuple):
    """Globally-reduced health metrics (psum over the mesh)."""

    mean_kkt: jax.Array       # mean QP KKT residual over batch and time
    max_kkt: jax.Array
    mean_tracking_err: jax.Array  # mean |com - ref| (xyz)
    fallen_fraction: jax.Array    # scenarios whose CoM dropped below 0.2 m
    n_scenarios: jax.Array


def sweep_metrics(trace, axis_names=BATCH_AXES) -> SweepMetrics:
    """Per-shard trace -> globally psum-reduced metrics.  Call inside

    shard_map.  Non-finite values (frozen/fallen scenarios) are zeroed so a
    single diverged scenario cannot poison the reductions."""
    kkt = jnp.where(jnp.isfinite(trace.qp_kkt), trace.qp_kkt, 0.0)
    err = jnp.abs(trace.com_pose[..., :3] - trace.ref_com_pose[..., :3])
    err = jnp.where(jnp.isfinite(err), err, 0.0)
    fallen = jnp.any(
        (trace.com_pos[..., 2] < 0.2) | ~jnp.isfinite(trace.com_pos[..., 2]),
        axis=-1,
    )
    n_local = jnp.asarray(kkt.shape[0], kkt.dtype)

    n = jax.lax.psum(n_local, axis_names)
    return SweepMetrics(
        mean_kkt=jax.lax.psum(jnp.sum(jnp.mean(kkt, axis=-1)), axis_names) / n,
        max_kkt=jax.lax.pmax(jnp.max(kkt), axis_names),
        mean_tracking_err=jax.lax.psum(jnp.sum(jnp.mean(err, axis=(-2, -1))), axis_names) / n,
        fallen_fraction=jax.lax.psum(jnp.sum(fallen.astype(kkt.dtype)), axis_names) / n,
        n_scenarios=n,
    )


def sharded_sweep_step(
    model: RobotModel,
    cparams: ControllerParams,
    pparams: PlannerParams,
    qparams: QPSolverParams,
    sparams: world.SimParams,
    mesh: Mesh,
    gait_name: str = "walk",
):
    """Build the jitted sharded sweep: (batched carry, batched commands) ->

    (batched carry, SweepMetrics).  Batch axis must divide the mesh size.
    gait_name: "walk" (the reference's static walk) or "trot"."""

    from quadrupedwholebodycontroller.planner import gait, trot
    from quadrupedwholebodycontroller.sim.rollout import batched_rollout
    from quadrupedwholebodycontroller.sim.scenario import apply_payload

    # accelerators run the cached batched chain (the bench's program); the
    # CPU (test) path keeps the vmapped reference solver
    qp_backend = "xla" if jax.default_backend() == "cpu" else "cached"
    if gait_name == "walk":
        planner_fn = lambda s, c: gait.planner_step(pparams, s, c)
        ratio = int(round(cparams.loop_rate * pparams.dt))
    elif gait_name == "trot":
        tp = trot.TrotParams()
        planner_fn = lambda s, c: trot.trot_step(tp, s, c)
        ratio = max(1, int(round(cparams.loop_rate * tp.dt)))
    else:
        raise ValueError(gait_name)

    def shard_fn(carry, commands, scenario):
        sim_model = jax.vmap(
            lambda m, c: apply_payload(model, m, c)
        )(scenario.payload_mass, scenario.payload_com)
        carry, trace = batched_rollout(
            model, cparams, qparams, sparams,
            planner_fn, ratio, carry, commands, scenario, sim_model, qp_backend,
        )
        metrics = sweep_metrics(trace)
        return carry, metrics

    spec = P(BATCH_AXES)
    rep = P()
    fn = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(spec, spec, spec),
        out_specs=(spec, rep),
        check_vma=False,
    )
    jitted = jax.jit(fn)

    def run(carry, commands, scenario=None):
        if scenario is None:
            # build a nominal scenario batch so specs stay uniform
            from quadrupedwholebodycontroller.sim.scenario import Scenario

            B, T = commands.shape[0], commands.shape[1]
            nom = Scenario.nominal(T, sparams.friction, commands.dtype)
            scenario = jax.tree.map(lambda x: jnp.stack([x] * B), nom)
        return jitted(carry, commands, scenario)

    run.jitted = jitted  # for ahead-of-time compilation (chip_smoke.py)
    return run

"""The FLAGSHIP bench path under shard_map: wbc_step_batched with the
carried QPCache, fused setup (prepared batch-minor arrays), warm gating,
polish, compensated final refinement, and staged rescue — the exact
program bench.py measures — data-parallel over the device mesh.

Scenario data-parallelism has zero cross-scenario coupling inside a step
(every reduction in the solve chain is per-scenario; the batch-level
gates — rescue fire, warm top-k compaction — operate per SHARD, which is
the correct distributed semantics: a shard's tail rescue fires only for
its own scenarios, replacing the reference's per-process qpOASES instances
behind the ROS-master rendezvous, whole_body_controller.cpp:42-49).

Leaf-exactness vs the unsharded step holds whenever the per-shard gate
decisions match the global ones (no rescue fire, and the per-scenario
cold-fix top-k covers every cold scenario in each shard) — pinned by
tests/test_parallel.py on the virtual 8-device mesh.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from quadrupedwholebodycontroller.config import (
    ControllerParams,
    QPSolverParams,
)
from quadrupedwholebodycontroller.control import wbc
from quadrupedwholebodycontroller.models.robot_model import RobotModel
from quadrupedwholebodycontroller.parallel.mesh import BATCH_AXES


def sharded_wbc_step(
    model: RobotModel,
    cparams: ControllerParams,
    qparams: QPSolverParams,
    mesh: Mesh,
    qp_backend: str | None = None,
):
    """Build the jitted sharded flagship step:

        (obs, ref, carry, cache, cache_valid) ->
            (out, new_carry, new_cache)

    with every batched leaf split over the mesh's batch axes and
    cache_valid replicated.  The per-device program is wbc_step_batched
    with the full production configuration (cached batched chain +
    QPCache + prepared batch-minor arrays); CPU meshes run the same chain
    with the plain ADMM body, so the sharded program is the program the
    bench measures."""
    if qp_backend is None:
        qp_backend = "cached"

    from quadrupedwholebodycontroller.ops import qp as qpm

    def shard_fn(obs, ref, carry, cache, cache_valid):
        return wbc.wbc_step_batched(
            model, cparams, qparams, obs, ref, carry, True, qp_backend,
            cache, cache_valid,
        )

    spec = P(BATCH_AXES)
    # the batch-minor solve chain (solve_layout="minor") carries kinv
    # (n, n, B) and sinv (m, m, B) with the scenario batch on the LAST
    # axis — shard that axis, not axis 0
    minor_spec = P(None, None, BATCH_AXES)
    cache_spec = qpm.QPCache(
        kinv=minor_spec if qparams.solve_layout == "minor" else spec,
        hinv=spec,
        sinv=minor_spec if qparams.solve_layout == "minor" else spec,
    )
    fn = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(spec, spec, spec, cache_spec, P()),
        out_specs=(spec, spec, cache_spec),
        check_vma=False,
    )
    return jax.jit(fn)

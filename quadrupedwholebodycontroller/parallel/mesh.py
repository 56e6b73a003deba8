"""Device mesh + sharding helpers.

Replaces the reference's process graph / ROS pub-sub (its only concurrency,
SURVEY.md §2) with the parallelism this workload has: **scenario
data-parallelism** — the scenario batch is sharded over a (hosts, chips)
mesh, compute is replicated program / sharded data, and the only
cross-device communication is metric reductions (psum), replacing topic
hops.  On one host the mesh is flat (hosts=1): NVLink joins every card to
every other at the same rate, so the layout follows the algorithm alone.

No tensor/pipeline/sequence/expert parallelism applies: there are no neural
networks and no sequence axis in a WBC control step (SURVEY.md §2); the
18-dof dynamics and 42-var QPs are far below a single chip's compute
granularity and are batched, not sharded, within a chip.
"""
from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

BATCH_AXES = ("hosts", "chips")


def make_mesh(n_devices: int | None = None, hosts: int | None = None) -> Mesh:
    """A (hosts, chips) mesh over the available devices.

    Multi-process runs default to hosts=jax.process_count(); a single
    host (one or several cards, or virtual CPU devices) gets hosts=1.
    """
    devs = jax.devices()
    if n_devices is None:
        n_devices = len(devs)
    devs = devs[:n_devices]
    if hosts is None:
        hosts = jax.process_count() if jax.process_count() > 1 else 1
    chips = n_devices // hosts
    arr = np.array(devs).reshape(hosts, chips)
    return Mesh(arr, BATCH_AXES)


def batch_spec() -> P:
    """PartitionSpec sharding the leading scenario axis over the whole mesh."""
    return P(BATCH_AXES)


def shard_batch(tree, mesh: Mesh):
    """Place a pytree with leading batch axes onto the mesh (batch sharded,

    everything else replicated).

    Works single- and multi-process: every process passes the FULL global
    array; under a multi-process mesh each process materializes only its
    addressable shards (jax.make_array_from_callback), so the call is the
    one data-distribution idiom for both the virtual test mesh and a real
    multi-host mesh."""
    spec = batch_spec()
    multiprocess = jax.process_count() > 1

    def put(x):
        s = spec if (hasattr(x, "ndim") and x.ndim >= 1) else P()
        sharding = NamedSharding(mesh, s)
        if multiprocess:
            arr = np.asarray(x)
            return jax.make_array_from_callback(
                arr.shape, sharding, lambda idx, a=arr: a[idx]
            )
        return jax.device_put(x, sharding)

    return jax.tree.map(put, tree)


def distributed_init(coordinator: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None, local_devices: int | None = None):
    """Multi-host process-group bring-up (replaces the ROS master as the
    cross-machine rendezvous, reference whole_body_controller.cpp:42-49).

    On CPU backends the cross-process collective implementation is set to
    gloo (the jax CPU multi-process transport); on GPUs the platform
    handles collectives natively (NCCL).  local_devices optionally sets the number
    of CPU devices this process contributes (virtual-host testing).
    No-op when running single-process."""
    if num_processes is None or num_processes <= 1:
        return
    if jax.config.jax_platforms in (None, "cpu") or "cpu" in str(
        jax.config.jax_platforms
    ):
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
    if local_devices is not None:
        jax.config.update("jax_num_cpu_devices", local_devices)
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )

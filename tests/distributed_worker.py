"""Worker process for the 2-process jax.distributed CPU test.

Each worker contributes 4 virtual CPU devices to a 2-process, 8-device
(hosts=2, chips=4) mesh, rendezvouses through parallel.mesh.distributed_init
(the ROS-master replacement, reference whole_body_controller.cpp:42-49), and
runs ONE real sharded sweep step (planner + WBC + physics + gloo psum metric
reduction) AND the FLAGSHIP bench path (sharded_wbc_step: QPCache + fused
setup + warm gating + rescue, cold then warm — the program bench.py
measures, across a real process boundary).
Prints RESULT / FLAGSHIP json lines the parent test compares across
processes and against single-process references.

Not a pytest file (no test_ prefix) — launched by tests/test_distributed.py.
"""
import json
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


from flagship_fixture import flagship_inputs  # noqa: E402  (shared with
# test_parallel.py and test_distributed.py — one fixture, every mesh
# realization compares the same program inputs)


def main():
    pid = int(sys.argv[1])
    nproc = int(sys.argv[2])
    coordinator = sys.argv[3]

    from quadrupedwholebodycontroller.parallel import mesh as pm

    pm.distributed_init(coordinator, nproc, pid, local_devices=4)
    assert jax.process_count() == nproc, jax.process_count()
    assert jax.local_device_count() == 4
    assert jax.device_count() == 4 * nproc

    import jax.numpy as jnp
    import numpy as np

    from quadrupedwholebodycontroller.config import (
        ControllerParams,
        PlannerParams,
        QPSolverParams,
    )
    from quadrupedwholebodycontroller.models import anymal_d_model
    from quadrupedwholebodycontroller.parallel import (
        make_mesh,
        shard_batch,
        sharded_sweep_step,
    )
    from quadrupedwholebodycontroller.sim import SimParams
    from quadrupedwholebodycontroller.sim.rollout import init_rollout_carry

    dtype = jnp.float64
    model = anymal_d_model(dtype=dtype)
    cp, pp, sp = ControllerParams(), PlannerParams(), SimParams()
    qp = QPSolverParams()
    B, T = 8, 16

    mesh = make_mesh(8, hosts=nproc)
    # mesh row p must be exactly process p's devices — the hosts axis is a
    # REAL process boundary here, so the psum crosses gloo, not just memory
    for i, row in enumerate(mesh.devices):
        for d in row:
            assert d.process_index == i, (i, d)

    carry = init_rollout_carry(model, cp, pp, dtype=dtype)
    bcarry = jax.tree.map(lambda x: jnp.stack([x] * B), carry)
    cmds = jnp.zeros((B, T, 3), dtype).at[1::2, 4:, 0].set(0.5)

    step = sharded_sweep_step(model, cp, pp, qp, sp, mesh)
    out_carry, metrics = step(shard_batch(bcarry, mesh), shard_batch(cmds, mesh))

    def scalar(x):
        return float(np.asarray(x.addressable_data(0)))

    # this process's shards of the out-carry base height (in global batch
    # order) — proves per-scenario state survived the cross-process round trip
    shards = sorted(
        out_carry.sim.base_p.addressable_shards,
        key=lambda s: s.index[0].start or 0,
    )
    local_z = np.concatenate([np.asarray(s.data) for s in shards], axis=0)[:, 2]
    print(
        "RESULT "
        + json.dumps(
            {
                "process": pid,
                "n_scenarios": scalar(metrics.n_scenarios),
                "mean_kkt": scalar(metrics.mean_kkt),
                "max_kkt": scalar(metrics.max_kkt),
                "fallen_fraction": scalar(metrics.fallen_fraction),
                "local_base_z": [float(z) for z in local_z],
            }
        ),
        flush=True,
    )

    # FLAGSHIP across the real process boundary (VERDICT r4 #4): the bench
    # program itself — QPCache + fused setup + warm gating +
    # rescue — cold then warm over the (2, 4) gloo mesh.  The parent
    # compares each process's local tau shard BITWISE against the
    # single-process per-scenario B=1 steps (the leaf-exactness
    # test_parallel.py establishes on the virtual mesh).
    from quadrupedwholebodycontroller.parallel import (
        shard_batch,
        sharded_wbc_step,
    )

    model32, cp32, qp32, obs, ref, fcarry, fcache = flagship_inputs()
    sstep = sharded_wbc_step(model32, cp32, qp32, mesh)
    obs_s, ref_s, carry_s = (
        shard_batch(obs, mesh), shard_batch(ref, mesh),
        shard_batch(fcarry, mesh),
    )
    # the cache's minor-layout leaves are batch-LAST; let jit shard them
    # per the in_specs (shard_batch would mis-shard kinv/sinv)
    out_a, carry_a, cache_a = sstep(obs_s, ref_s, carry_s, fcache, False)
    out_b, carry_b, cache_b = sstep(obs_s, ref_s, carry_a, cache_a, True)

    def local_rows(x):
        shards = sorted(
            x.addressable_shards, key=lambda s: s.index[0].start or 0
        )
        return np.concatenate([np.asarray(s.data) for s in shards], axis=0)

    print(
        "FLAGSHIP "
        + json.dumps(
            {
                "process": pid,
                "tau_cold": local_rows(out_a.tau).tolist(),
                "tau_warm": local_rows(out_b.tau).tolist(),
                "kkt_warm": local_rows(
                    out_b.qp_info.kkt_residual
                ).tolist(),
            }
        ),
        flush=True,
    )


if __name__ == "__main__":
    main()

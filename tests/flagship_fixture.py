"""Shared deterministic flagship-step inputs (f32, the production dtype).

One fixture, three consumers, so the cross-realization comparisons stay
bitwise-meaningful on the SAME program inputs:
  * tests/test_parallel.py — in-process virtual 8-device mesh, leaf-exact
    vs per-scenario B=1 steps;
  * tests/distributed_worker.py — the 2-process gloo (2, 4) mesh;
  * tests/test_distributed.py — the parent's per-scenario B=1 reference.

Import-side-effect free (unlike distributed_worker, which configures
jax.distributed at import-adjacent time): safe to import from any test.
"""


def flagship_inputs(B=8):
    """Returns (model, cp, qp, obs, ref, carry, cache) for B scenarios.

    Mirrors the bench path's input shapes: QPCache + standing reference +
    perturbed standing observations (jax.random.PRNGKey(3))."""
    import jax
    import jax.numpy as jnp

    from quadrupedwholebodycontroller.config import (
        ControllerParams,
        QPSolverParams,
    )
    from quadrupedwholebodycontroller.control import wbc
    from quadrupedwholebodycontroller.models import anymal_d_model
    from quadrupedwholebodycontroller.models.anymal import (
        INITIAL_JOINT_POS,
    )
    from quadrupedwholebodycontroller.ops import qp as qpm

    dtype = jnp.float32
    model = anymal_d_model(dtype=dtype)
    cp = ControllerParams()
    qp = QPSolverParams()
    key = jax.random.PRNGKey(3)
    k1, k2, k3 = jax.random.split(key, 3)
    obs = wbc.RobotObservation(
        base_R=jnp.broadcast_to(jnp.eye(3, dtype=dtype), (B, 3, 3)),
        base_p=jnp.tile(jnp.array([0.0, 0.0, 0.55], dtype), (B, 1))
        + 0.01 * jax.random.normal(k1, (B, 3), dtype),
        base_vel=0.01 * jax.random.normal(k2, (B, 6), dtype),
        q=jnp.tile(jnp.asarray(INITIAL_JOINT_POS, dtype), (B, 1)),
        qd=0.02 * jax.random.normal(k3, (B, 12), dtype),
    )
    ref = jax.tree.map(
        lambda x: jnp.stack([x] * B), wbc.Reference.standing(cp, dtype)
    )
    carry = jax.tree.map(lambda x: jnp.stack([x] * B), wbc.init_carry(dtype))
    cache = qpm.make_cache(B, 42, 70, qp, dtype)
    return model, cp, qp, obs, ref, carry, cache

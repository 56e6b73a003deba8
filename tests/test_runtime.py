"""Checkpoint/resume and recording runtime components."""
import jax
import jax.numpy as jnp
import numpy as np

from quadrupedwholebodycontroller.config import (
    ControllerParams,
    PlannerParams,
    QPSolverParams,
)
from quadrupedwholebodycontroller.models import anymal_d_model
from quadrupedwholebodycontroller.runtime import checkpoint
from quadrupedwholebodycontroller.sim import SimParams
from quadrupedwholebodycontroller.sim.rollout import (
    closed_loop_rollout,
    init_rollout_carry,
)


def test_checkpoint_resume_bit_exact(tmp_path):
    """Run 60 steps, checkpoint, run 60 more; must equal 120 straight."""
    dtype = jnp.float64
    model = anymal_d_model(dtype=dtype)
    cp, pp, sp = ControllerParams(), PlannerParams(), SimParams()
    qp = QPSolverParams()
    fn = jax.jit(lambda c, x: closed_loop_rollout(model, cp, pp, qp, sp, c, x))

    carry0 = init_rollout_carry(model, cp, pp, dtype=dtype)
    cmds = jnp.zeros((120, 3), dtype).at[20:, 0].set(0.4)

    carry_mid, tr_a = fn(carry0, cmds[:60])
    path = str(tmp_path / "sweep.ckpt.npz")
    checkpoint.save_pytree(path, carry_mid, meta=dict(step=60))
    restored = checkpoint.load_pytree(path, carry_mid)
    assert checkpoint.load_meta(path)["step"] == 60

    _, tr_b = fn(restored, cmds[60:])
    _, tr_full = fn(carry0, cmds)
    assert np.allclose(
        np.asarray(tr_b.com_pos), np.asarray(tr_full.com_pos[60:]), atol=0
    )
    assert np.allclose(
        np.asarray(tr_b.tau), np.asarray(tr_full.tau[60:]), atol=0
    )


def test_treedef_mismatch_rejected(tmp_path):
    tree = {"a": jnp.zeros(3), "b": jnp.ones(2)}
    path = str(tmp_path / "x.npz")
    checkpoint.save_pytree(path, tree)
    other = {"a": jnp.zeros(3), "c": jnp.ones(2)}
    try:
        checkpoint.load_pytree(path, other)
        assert False, "should have raised"
    except ValueError:
        pass

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from quadrupedwholebodycontroller.config import (
    ControllerParams,
    QPSolverParams,
)
from quadrupedwholebodycontroller.models import anymal_d_model
from quadrupedwholebodycontroller.planner import trot
from quadrupedwholebodycontroller.sim import SimParams
from quadrupedwholebodycontroller.sim.rollout import (
    init_rollout_carry,
    trot_rollout,
)


@pytest.fixture(scope="module")
def tp():
    return trot.TrotParams()


def test_stand_until_commanded(tp):
    state = jax.tree.map(lambda x: x, trot.init_trot_state(tp, jnp.float64))
    step = jax.jit(lambda s, c: trot.trot_step(tp, s, c))
    for _ in range(5):
        state, ref, _ = step(state, jnp.zeros(3, jnp.float64))
    assert np.allclose(np.asarray(ref.contacts), 1.0)
    assert np.allclose(np.asarray(ref.com_pose)[:3], [0, 0, tp.body_height])


def test_diagonal_pairs_alternate(tp):
    state = trot.init_trot_state(tp, jnp.float64)
    cmd = jnp.asarray([0.4, 0.0, 0.0], jnp.float64)
    step = jax.jit(lambda s: trot.trot_step(tp, s, cmd))
    masks = []
    for _ in range(tp.stand_ticks + 3 * int(tp.step_duration / tp.dt)):
        state, ref, _ = step(state)
        masks.append(tuple(np.asarray(ref.contacts).astype(int)))
    trotting = [m for m in masks if m != (1, 1, 1, 1)]
    assert set(trotting) <= {(1, 0, 1, 0), (0, 1, 0, 1)}
    assert len(set(trotting)) == 2  # both pairs occurred
    # phases alternate in contiguous runs of step_duration/dt ticks
    runs = []
    cur, n = trotting[0], 0
    for m in trotting:
        if m == cur:
            n += 1
        else:
            runs.append(n); cur, n = m, 1
    expect = int(tp.step_duration / tp.dt)
    assert all(abs(r - expect) <= 1 for r in runs[:-1])


def test_closed_loop_trot():
    """2 s trot at 0.3 m/s: upright, tracks velocity, QP tight."""
    dtype = jnp.float64
    model = anymal_d_model(dtype=dtype)
    cp, sp = ControllerParams(), SimParams()
    tp_ = trot.TrotParams()
    qp = QPSolverParams()
    carry = init_rollout_carry(
        model, cp, dtype=dtype, planner_state=trot.init_trot_state(tp_, dtype)
    )
    T = 800
    cmds = jnp.zeros((T, 3), dtype).at[60:, 0].set(0.3)
    fn = jax.jit(lambda c, x: trot_rollout(model, cp, tp_, qp, sp, c, x))
    _, tr = fn(carry, cmds)
    com = np.asarray(tr.com_pos)
    assert np.all(np.isfinite(com))
    assert com[:, 2].min() > 0.4
    # distance: commanded 0.3 m/s for 1.85 s = 0.555 m; allow gait transients
    assert 0.35 < com[-1, 0] < 0.7, com[-1, 0]
    assert np.asarray(tr.qp_kkt).max() < 1e-3
    assert np.abs(np.asarray(tr.tau)).max() <= 80.0 + 1e-3
    # roll/pitch bounded
    assert np.abs(np.asarray(tr.com_pose)[:, 3:5]).max() < 0.25

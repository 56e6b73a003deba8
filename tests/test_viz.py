"""Plot rendering smoke tests (the plot_bag.py panel set + footprints)."""
import jax
import jax.numpy as jnp
import numpy as np

from quadrupedwholebodycontroller.config import (
    ControllerParams,
    PlannerParams,
    QPSolverParams,
)
from quadrupedwholebodycontroller.models import anymal_d_model
from quadrupedwholebodycontroller.sim import SimParams, closed_loop_rollout
from quadrupedwholebodycontroller.sim.rollout import init_rollout_carry
from quadrupedwholebodycontroller.viz import plots


def test_plot_roundtrip(tmp_path):
    dtype = jnp.float64
    model = anymal_d_model(dtype=dtype)
    cp, pp, sp = ControllerParams(), PlannerParams(), SimParams()
    carry = init_rollout_carry(model, cp, pp, dtype=dtype)
    cmds = jnp.zeros((40, 3), dtype)
    _, trace = jax.jit(
        lambda c, x: closed_loop_rollout(model, cp, pp, QPSolverParams(), sp, c, x)
    )(carry, cmds)

    npz = str(tmp_path / "run.npz")
    plots.save_trace(npz, trace, cp.loop_rate)
    arrs = plots.load_trace(npz)
    assert arrs["tau"].shape == (40, 12)
    assert float(arrs["control_rate"]) == 400.0

    png = str(tmp_path / "run.png")
    fig = plots.plot_run(arrs, skip_seconds=0.0, out_path=png)
    assert fig is not None
    import os

    assert os.path.getsize(png) > 10000

    fp = str(tmp_path / "fp.png")
    plots.plot_footprints(arrs, out_path=fp)
    assert os.path.getsize(fp) > 10000


def test_footprints_reference_markers(tmp_path):
    """The desired-reference channel (marker_publisher.cpp:12-75): body
    rectangles + swing-foot targets must render when the trace carries
    ref_swing_pos/contacts."""
    import matplotlib

    matplotlib.use("Agg")
    T = 40
    rng = np.random.default_rng(0)
    arrs = dict(
        com_pose=np.cumsum(rng.normal(scale=0.002, size=(T, 6)), axis=0),
        ref_com_pose=np.zeros((T, 6)),
        foot_pos=rng.normal(scale=0.3, size=(T, 12)),
        ref_swing_pos=rng.normal(scale=0.3, size=(T, 12)),
        contacts=np.tile([1.0, 0.0, 1.0, 1.0], (T, 1)),
        control_rate=np.asarray(400.0),
    )
    fp = str(tmp_path / "fp.png")
    fig = plots.plot_footprints(arrs, out_path=fp)
    labels = [t.get_text() for t in fig.legends[0].get_texts()] if fig.legends else [
        t.get_text() for t in fig.axes[0].get_legend().get_texts()
    ]
    assert "desired body" in labels and "swing target" in labels
    import os

    assert os.path.exists(fp)

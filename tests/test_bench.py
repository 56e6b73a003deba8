"""The driver-facing bench contract: bench.py must print one JSON line with
the agreed keys, in both modes, and the packaged replay trajectory must be
the production-shaped workload the headline claims (evolving states,
planner publish ticks, contact switches)."""
import io
import json
import os
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest

REPO = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, REPO)


def test_replay_trajectory_integrity():
    d = np.load(os.path.join(REPO, "data", "walk_traj_400hz.npz"))
    T = d["base_R"].shape[0]
    assert T >= 200
    for k in ("base_p", "base_vel", "q", "qd", "com_pose", "swing_pos",
              "contacts", "ref_is_new"):
        assert d[k].shape[0] == T, k
    # genuinely evolving states
    assert np.abs(np.diff(d["q"], axis=0)).max() > 1e-4
    # planner publishes at 100 Hz over the 400 Hz loop
    assert T // 5 <= d["ref_is_new"].sum() <= T // 3
    # at least one contact switch inside the window (the warm-path stressor)
    switches = (np.abs(np.diff(d["contacts"], axis=0)).sum(axis=1) > 0).sum()
    assert switches >= 1
    # rotations stay orthonormal (both engines assume SO(3))
    R = d["base_R"]
    err = np.abs(R @ np.swapaxes(R, 1, 2) - np.eye(3)).max()
    assert err < 1e-5


def test_bench_json_contract(monkeypatch):
    """The explicit CPU rehearsal runs the cached chain end to end and
    stamps the device; its line says platform "cpu"."""
    monkeypatch.setenv("QWBC_BENCH_BATCH", "2")
    monkeypatch.setenv("QWBC_BENCH_REPS", "1")
    monkeypatch.setenv("QWBC_BENCH_DIVERSE_BATCH", "4")
    monkeypatch.setenv("QWBC_BENCH_B8192", "0")
    import bench

    buf = io.StringIO()
    with redirect_stdout(buf):
        bench.main(["--cpu-rehearsal"])
    line = [l for l in buf.getvalue().splitlines() if l.startswith("{")][-1]
    out = json.loads(line)
    assert out["metric"] == "wbc_qp_solves_per_s"
    assert out["unit"] == "solves/s/chip"
    assert out["mode"] == "evolving"
    assert out["value"] > 0 and np.isfinite(out["vs_baseline"])
    assert np.isfinite(out["max_kkt"]) and out["max_kkt"] < 0.1
    assert out["platform"] == "cpu" and out["device_kind"] == "cpu"
    assert out["device_count"] >= 1 and out["card"] is None
    assert out["diverse_batch"] == 4 and out["diverse_flagged_max"] == 0
    assert out["finite"] and out["diverse_finite"]


def test_bench_refuses_without_gpu():
    """A plain run on the CPU is no measurement: bench.py exits non-zero
    and prints no result line."""
    import bench

    buf = io.StringIO()
    with redirect_stdout(buf), pytest.raises(SystemExit) as exc:
        bench.main([])
    assert exc.value.code not in (0, None)
    assert not [l for l in buf.getvalue().splitlines() if l.startswith("{")]


def test_device_stamp_and_card_off_gpu(monkeypatch):
    """The stamp every measurement carries: platform / kind / count as JAX
    reports them, and no card line without nvidia-smi."""
    from quadrupedwholebodycontroller.runtime import accel

    stamp = accel.device_stamp()
    assert stamp["platform"] == "cpu" and stamp["device_count"] >= 1
    assert stamp["card"] is None
    monkeypatch.setenv("PATH", "")
    assert accel.card() is None
    # the CPU backend keeps no persistent compile cache
    assert accel.enable_compile_cache() is None

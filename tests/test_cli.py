"""CLI entry points (the roslaunch/teleop replacement) — fast smoke runs."""
import os
import sys

import numpy as np

from quadrupedwholebodycontroller.cli import main as cli

CONFIGS = os.path.join(os.path.dirname(__file__), "..", "configs")


def test_standing_cli(tmp_path):
    trace = str(tmp_path / "t.npz")
    cli.main([
        "standing", "--seconds", "0.2", "--dtype", "float64",
        "--save", trace,
    ])
    assert os.path.exists(trace)


def test_teleop_replay_cli(tmp_path):
    stream = str(tmp_path / "cmd.csv")
    with open(stream, "w") as f:
        f.write("0.0, 0.0, 0.0, 0.0\n0.1, 0.4, 0.0, 0.0\n0.3, 0.0, 0.0, 0.0\n")
    cli.main(["teleop-replay", stream, "--dtype", "float64"])


def test_params_yaml_cli():
    cli.main([
        "standing", "--seconds", "0.1", "--dtype", "float64",
        "--params", os.path.join(CONFIGS, "params_controller.yaml"),
    ])


def test_sweep_cli(capsys):
    cli.main([
        "sweep", "--batch", "8", "--seconds", "0.06", "--dtype", "float64",
    ])
    out = capsys.readouterr().out
    assert "sweep B=8" in out and "fallen=" in out


def test_sweep_trot_cli(capsys):
    cli.main([
        "sweep", "--batch", "8", "--seconds", "0.06", "--dtype", "float64",
        "--gait", "trot",
    ])
    out = capsys.readouterr().out
    assert "sweep B=8" in out


def test_inspect_cli(tmp_path, capsys):
    out_png = str(tmp_path / "skel.png")
    cli.main(["inspect", "--dtype", "float64", "--out", out_png])
    out = capsys.readouterr().out
    assert "total_mass=51.6357" in out
    assert "frame LH_FOOT" in out
    assert os.path.exists(out_png)


def test_teleop_live_cli(tmp_path, monkeypatch, capsys):
    """Live teleop (reference teleop_gui_node.cpp): a scripted stdin session
    (one key per 100 ms tick, ZOH between ticks) must steer the robot and
    record a trace."""
    import io

    trace = str(tmp_path / "teleop.npz")
    # 4x vx+=0.1, hold 8 ticks, stop, hold 2, quit
    script = "w\nw\nw\nw\n" + "\n" * 8 + "x\n\n\np\n"
    monkeypatch.setattr(sys, "stdin", io.StringIO(script))
    cli.main(["teleop", "--seconds", "10", "--dtype", "float64", "--save", trace])
    out = capsys.readouterr().out
    assert "cmd=[+0.40" in out          # keys accumulated to 0.4 m/s
    assert "x realtime" in out
    assert os.path.exists(trace)
    d = np.load(trace)
    assert d["com_pos"].shape[0] == 15 * 40  # 15 ticks before 'p'


def test_replay_cli(tmp_path):
    """Offline 3-D replay (the RViz live-view analogue, A14): a saved trace
    renders to an animated GIF with full per-frame FK."""
    trace = str(tmp_path / "t.npz")
    gif = str(tmp_path / "replay.gif")
    cli.main(["standing", "--seconds", "0.2", "--dtype", "float64",
              "--save", trace])
    cli.main(["replay", trace, "--out", gif, "--every", "20",
              "--max-frames", "4"])
    assert os.path.exists(gif)
    from PIL import Image

    im = Image.open(gif)
    assert im.n_frames == 4

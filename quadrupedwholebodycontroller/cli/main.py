"""Command-line entry points — the roslaunch/teleop layer replacement.

Subcommands cover the five benchmark configurations (BASELINE.json):
  standing       quadruple-stance balance
  walk           static-walk gait (the reference's configuration)
  trot           trotting gait
  teleop-replay  closed loop driven by a recorded command stream (the Qt
                 teleop GUI was just a Twist source — reference
                 src/teleop_gui_node.cpp; here a (t, vx, vy, wz) CSV)
  sweep          batched robustness sweep on the device mesh
  plot           render the plot_bag.py panel set from a saved trace

Run:  python -m quadrupedwholebodycontroller.cli.main <subcommand> [...]
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def _common(ap):
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--dtype", choices=["float32", "float64"], default="float32")
    ap.add_argument("--qp-iters", type=int, default=100)
    ap.add_argument("--save", type=str, default=None, help="save trace .npz")
    ap.add_argument("--record", type=str, default=None,
                    help="save binary trajectory log (native TrajLog .qlog)")
    ap.add_argument("--plot", type=str, default=None, help="save plot .png")
    ap.add_argument("--footprints", type=str, default=None,
                    help="save top-down footprint plot .png")
    ap.add_argument("--params", type=str, default=None, help="reference-format yaml")


def _setup(args):
    if args.dtype == "float64":
        import jax

        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from quadrupedwholebodycontroller.config import (
        ControllerParams,
        PlannerParams,
        QPSolverParams,
        load_yaml_params,
    )
    from quadrupedwholebodycontroller.models import anymal_d_model
    from quadrupedwholebodycontroller.sim import SimParams

    dtype = jnp.float32 if args.dtype == "float32" else jnp.float64
    cp, pp = ControllerParams(), PlannerParams()
    if args.params:
        loaded = load_yaml_params(args.params)
        cp = loaded.get("controller", cp)
        pp = loaded.get("planner", pp)
    return dict(
        dtype=dtype,
        model=anymal_d_model(dtype=dtype),
        cp=cp,
        pp=pp,
        qp=QPSolverParams(iterations=args.qp_iters),
        sp=SimParams(),
    )


def _finish(args, trace, cp):
    from quadrupedwholebodycontroller.viz import plots

    arrs = plots.trace_to_arrays(trace)
    kkt = arrs["qp_kkt"]
    print(
        f"T={len(kkt)} steps | qp kkt med={np.median(kkt):.2e} max={kkt.max():.2e} | "
        f"com z=[{arrs['com_pos'][:, 2].min():.3f},{arrs['com_pos'][:, 2].max():.3f}] | "
        f"x travel={arrs['com_pos'][-1, 0] - arrs['com_pos'][0, 0]:.3f} m | "
        f"tau max={np.abs(arrs['tau']).max():.1f} N m"
    )
    if args.save:
        plots.save_trace(args.save, trace, cp.loop_rate)
        print("trace ->", args.save)
    if getattr(args, "record", None):
        from quadrupedwholebodycontroller.runtime.native import TrajLog

        # frame: [q(12), com_pose(6), tau(12), grf(12)] — the four recorded
        # topics of the reference's rosbag (launch/whole_body_controller.launch:27-35)
        frames = np.concatenate(
            [arrs["q"], arrs["com_pose"], arrs["tau"], arrs["grf"]], axis=1
        )
        log = TrajLog(frame_doubles=frames.shape[1])
        log.append(frames)
        log.flush(args.record)
        log.close()
        print("binary log ->", args.record)
    if args.plot:
        plots.plot_run(arrs, skip_seconds=0.5, control_rate=cp.loop_rate, out_path=args.plot)
        print("plot ->", args.plot)
    if getattr(args, "footprints", None):
        plots.plot_footprints(arrs, out_path=args.footprints)
        print("footprints ->", args.footprints)


def cmd_standing(args):
    import jax
    import jax.numpy as jnp

    from quadrupedwholebodycontroller.sim.rollout import (
        closed_loop_rollout,
        init_rollout_carry,
    )

    s = _setup(args)
    T = int(args.seconds * s["cp"].loop_rate)
    carry = init_rollout_carry(s["model"], s["cp"], s["pp"], dtype=s["dtype"])
    cmds = jnp.zeros((T, 3), s["dtype"])
    fn = jax.jit(
        lambda c, x: closed_loop_rollout(s["model"], s["cp"], s["pp"], s["qp"], s["sp"], c, x)
    )
    t0 = time.time()
    _, trace = fn(carry, cmds)
    jax.block_until_ready(trace.com_pos)
    print(f"standing {args.seconds}s sim in {time.time() - t0:.1f}s wall")
    _finish(args, trace, s["cp"])


def cmd_walk(args):
    import jax
    import jax.numpy as jnp

    from quadrupedwholebodycontroller.sim.rollout import (
        closed_loop_rollout,
        init_rollout_carry,
    )

    s = _setup(args)
    T = int(args.seconds * s["cp"].loop_rate)
    warmup = int(0.25 * s["cp"].loop_rate)
    carry = init_rollout_carry(s["model"], s["cp"], s["pp"], dtype=s["dtype"])
    cmds = jnp.zeros((T, 3), s["dtype"]).at[warmup:, 0].set(args.vx)
    cmds = cmds.at[warmup:, 1].set(args.vy).at[warmup:, 2].set(args.wz)
    fn = jax.jit(
        lambda c, x: closed_loop_rollout(s["model"], s["cp"], s["pp"], s["qp"], s["sp"], c, x)
    )
    t0 = time.time()
    _, trace = fn(carry, cmds)
    jax.block_until_ready(trace.com_pos)
    print(f"walk {args.seconds}s sim in {time.time() - t0:.1f}s wall")
    _finish(args, trace, s["cp"])


def cmd_trot(args):
    import jax
    import jax.numpy as jnp

    from quadrupedwholebodycontroller.planner import trot
    from quadrupedwholebodycontroller.sim.rollout import (
        init_rollout_carry,
        trot_rollout,
    )

    s = _setup(args)
    tp = trot.TrotParams()
    T = int(args.seconds * s["cp"].loop_rate)
    warmup = int(0.25 * s["cp"].loop_rate)
    carry = init_rollout_carry(
        s["model"], s["cp"], dtype=s["dtype"],
        planner_state=trot.init_trot_state(tp, s["dtype"]),
    )
    cmds = jnp.zeros((T, 3), s["dtype"]).at[warmup:, 0].set(args.vx)
    cmds = cmds.at[warmup:, 1].set(args.vy).at[warmup:, 2].set(args.wz)
    fn = jax.jit(
        lambda c, x: trot_rollout(s["model"], s["cp"], tp, s["qp"], s["sp"], c, x)
    )
    t0 = time.time()
    _, trace = fn(carry, cmds)
    jax.block_until_ready(trace.com_pos)
    print(f"trot {args.seconds}s sim in {time.time() - t0:.1f}s wall")
    _finish(args, trace, s["cp"])


def cmd_teleop_replay(args):
    import jax
    import jax.numpy as jnp

    from quadrupedwholebodycontroller.sim.rollout import (
        closed_loop_rollout,
        init_rollout_carry,
    )

    s = _setup(args)
    # command stream: CSV rows "t,vx,vy,wz", zero-order-held (Twist semantics)
    stream = np.loadtxt(args.stream, delimiter=",", ndmin=2)
    T = int(stream[-1, 0] * s["cp"].loop_rate) + 1
    tgrid = np.arange(T) / s["cp"].loop_rate
    idx = np.searchsorted(stream[:, 0], tgrid, side="right") - 1
    idx = np.clip(idx, 0, len(stream) - 1)
    cmds = jnp.asarray(stream[idx, 1:4], s["dtype"])
    carry = init_rollout_carry(s["model"], s["cp"], s["pp"], dtype=s["dtype"])
    fn = jax.jit(
        lambda c, x: closed_loop_rollout(s["model"], s["cp"], s["pp"], s["qp"], s["sp"], c, x)
    )
    _, trace = fn(carry, cmds)
    jax.block_until_ready(trace.com_pos)
    _finish(args, trace, s["cp"])


def cmd_teleop(args):
    """Live teleoperation: keyboard/stdin command source driving a running
    closed-loop rollout — the reference's Qt slider GUI publishing Twists at
    10 Hz + on-change (src/teleop_gui_node.cpp:10-82), redesigned for a
    terminal + XLA: the sim advances in jitted 100 ms segments (one 10 Hz
    teleop tick = `loop_rate/10` control steps, command zero-order-held
    across the segment), and between segments the command is updated from
    whatever arrived on stdin.

    Keys (single keystroke on a TTY; one per line when piped):
      w/s  vx +/- 0.1 m/s      a/d  vy +/- 0.05 m/s
      q/e  wz +/- 0.1 rad/s    x/space  full stop
      p    quit (also EOF or --seconds elapsed)
    """
    import select

    import jax
    import jax.numpy as jnp

    from quadrupedwholebodycontroller.sim.rollout import (
        closed_loop_rollout,
        init_rollout_carry,
    )

    s = _setup(args)
    rate = 10.0  # teleop tick rate (reference: publishVel QTimer at 100 ms)
    seg = max(1, int(round(s["cp"].loop_rate / rate)))
    carry = init_rollout_carry(s["model"], s["cp"], s["pp"], dtype=s["dtype"])
    fn = jax.jit(
        lambda c, x: closed_loop_rollout(s["model"], s["cp"], s["pp"], s["qp"], s["sp"], c, x)
    )

    is_tty = sys.stdin.isatty()
    if is_tty:
        import termios
        import tty

        fd = sys.stdin.fileno()
        saved = termios.tcgetattr(fd)
        tty.setcbreak(fd)

    def poll_keys():
        """TTY: drain every waiting keystroke.  Piped: consume exactly ONE
        line per tick (a scripted session advances one command per tick;
        empty line = hold current command), EOF = quit."""
        if not is_tty:
            line = sys.stdin.readline()
            if line == "":
                return ["p"]
            return list(line.strip())
        keys = []
        while select.select([sys.stdin], [], [], 0)[0]:
            ch = sys.stdin.read(1)
            if ch == "":
                keys.append("p")  # EOF = quit
                break
            ch = ch.strip("\n\r")
            if ch:
                keys.append(ch)
        return keys

    vmax = dict(vx=0.8, vy=0.4, wz=0.6)  # slider ranges, teleop_gui_node.cpp
    cmd = np.zeros(3)
    traces = []
    n_ticks = int(args.seconds * rate) if args.seconds > 0 else 10**9
    t0 = time.time()
    try:
        print(f"teleop: w/s=vx a/d=vy q/e=wz x=stop p=quit "
              f"(tick {1000/rate:.0f} ms = {seg} control steps)")
        for tick in range(n_ticks):
            quit_ = False
            for k in poll_keys():
                if k in ("w", "s"):
                    cmd[0] += 0.1 if k == "w" else -0.1
                elif k in ("a", "d"):
                    cmd[1] += 0.05 if k == "a" else -0.05
                elif k in ("q", "e"):
                    cmd[2] += 0.1 if k == "q" else -0.1
                elif k in ("x", " "):
                    cmd[:] = 0.0
                elif k == "p":
                    quit_ = True
            if quit_:
                break
            cmd[0] = np.clip(cmd[0], -vmax["vx"], vmax["vx"])
            cmd[1] = np.clip(cmd[1], -vmax["vy"], vmax["vy"])
            cmd[2] = np.clip(cmd[2], -vmax["wz"], vmax["wz"])
            cmds = jnp.broadcast_to(jnp.asarray(cmd, s["dtype"]), (seg, 3))
            carry, trace = fn(carry, cmds)
            traces.append(jax.tree.map(np.asarray, trace))
            com = traces[-1].com_pos[-1]
            print(
                f"\r t={(tick + 1) / rate:6.1f}s cmd=[{cmd[0]:+.2f} {cmd[1]:+.2f} "
                f"{cmd[2]:+.2f}] com=[{com[0]:+.3f} {com[1]:+.3f} {com[2]:.3f}] ",
                end="", flush=True,
            )
    finally:
        if is_tty:
            termios.tcsetattr(fd, termios.TCSADRAIN, saved)
    wall = time.time() - t0
    print()
    if not traces:
        print("no ticks ran")
        return
    trace = jax.tree.map(lambda *xs: np.concatenate(xs), *traces)
    sim_s = trace.com_pos.shape[0] / s["cp"].loop_rate
    print(f"teleop {sim_s:.1f}s sim in {wall:.1f}s wall ({sim_s / wall:.2f}x realtime)")
    _finish(args, trace, s["cp"])


def cmd_sweep(args):
    import jax
    import jax.numpy as jnp

    from quadrupedwholebodycontroller.parallel import (
        make_mesh,
        shard_batch,
        sharded_sweep_step,
    )
    from quadrupedwholebodycontroller.sim.rollout import init_rollout_carry

    from quadrupedwholebodycontroller.sim.scenario import Scenario

    s = _setup(args)
    mesh = make_mesh()
    B = args.batch
    T = int(args.seconds * s["cp"].loop_rate)
    carry = init_rollout_carry(s["model"], s["cp"], s["pp"], dtype=s["dtype"])
    bcarry = jax.tree.map(lambda x: jnp.stack([x] * B), carry)
    # scenario spread: velocity commands x friction x payload x pushes
    key = jax.random.PRNGKey(args.seed)
    kv, ks = jax.random.split(key)
    vx = jax.random.uniform(kv, (B,), s["dtype"], 0.0, 0.8)
    cmds = jnp.zeros((B, T, 3), s["dtype"]).at[:, 40:, 0].set(vx[:, None])
    scen = Scenario.random_batch(ks, B, T, s["dtype"])
    from quadrupedwholebodycontroller.planner import trot as trot_mod
    from quadrupedwholebodycontroller.sim.rollout import init_rollout_carry as _irc

    if args.gait == "trot":
        carry = _irc(
            s["model"], s["cp"], dtype=s["dtype"],
            planner_state=trot_mod.init_trot_state(trot_mod.TrotParams(), s["dtype"]),
        )
        bcarry = jax.tree.map(lambda x: jnp.stack([x] * B), carry)
    step = sharded_sweep_step(
        s["model"], s["cp"], s["pp"], s["qp"], s["sp"], mesh, args.gait
    )
    bcarry = shard_batch(bcarry, mesh)
    cmds = shard_batch(cmds, mesh)
    scen = shard_batch(scen, mesh)
    t0 = time.time()
    _, metrics = step(bcarry, cmds, scen)
    jax.block_until_ready(metrics.mean_kkt)
    dt = time.time() - t0
    print(
        f"sweep B={B} T={T} on {mesh.devices.size} devices in {dt:.1f}s | "
        f"{B * T / dt:,.0f} control-steps/s | mean_kkt={float(metrics.mean_kkt):.2e} "
        f"max_kkt={float(metrics.max_kkt):.2e} fallen={float(metrics.fallen_fraction):.3f}"
    )


def cmd_inspect(args):
    """Model inspector — the headless analogue of the reference's
    standalone.launch (joint_state_publisher sliders + robot_state_publisher
    + RViz, launch/standalone.launch:19-39): set a joint configuration, get
    the forward-kinematics view of the model (frame poses, CoM, per-body
    masses) and optionally a rendered skeleton."""
    import jax.numpy as jnp
    import numpy as np

    from quadrupedwholebodycontroller.models import anymal_d_model
    from quadrupedwholebodycontroller.models.anymal import INITIAL_JOINT_POS
    from quadrupedwholebodycontroller.ops import kinematics as K

    model = anymal_d_model(dtype=jnp.float64 if args.dtype == "float64" else jnp.float32)
    dtype = model.mass.dtype
    if args.q:
        q = jnp.asarray([float(v) for v in args.q.split(",")], dtype)
        assert q.shape[0] == model.num_joints, (
            f"expected {model.num_joints} joint angles, got {q.shape[0]}"
        )
    else:
        q = jnp.asarray(INITIAL_JOINT_POS, dtype)
    base_p = jnp.asarray([0.0, 0.0, args.z], dtype)
    kin = K.forward_kinematics(model, jnp.eye(3, dtype=dtype), base_p, q)
    com = K.robot_com(model, kin)

    print(f"model: {model.name}  bodies={model.num_bodies} joints={model.num_joints} "
          f"total_mass={float(model.total_mass):.4f} kg")
    print(f"com: [{float(com[0]):+.4f} {float(com[1]):+.4f} {float(com[2]):+.4f}]")
    for j, name in enumerate(model.joint_names):
        print(f"  joint {name:10s} q={float(q[j]):+.4f} rad  "
              f"origin={np.round(np.asarray(kin.joint_origin_w[j]), 4)}")
    for f, name in enumerate(model.frame_names):
        print(f"  frame {name:10s} p={np.round(np.asarray(kin.frame_p[f]), 4)}")
    if args.out:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig = plt.figure(figsize=(7, 6))
        ax = fig.add_subplot(111, projection="3d")
        bp = np.asarray(kin.body_p)
        for b in range(1, model.num_bodies):
            pa = bp[model.parent[b]]
            pb = bp[b]
            ax.plot(*zip(pa, pb), "o-", color="tab:blue", ms=3)
        fp = np.asarray(kin.frame_p)
        ax.scatter(fp[:, 0], fp[:, 1], fp[:, 2], c="tab:red", s=30, label="feet")
        c = np.asarray(com)
        ax.scatter([c[0]], [c[1]], [c[2]], c="k", marker="x", s=60, label="CoM")
        ax.set_xlabel("x"); ax.set_ylabel("y"); ax.set_zlabel("z")
        ax.legend(); ax.set_title(f"{model.name} @ z={args.z}")
        fig.savefig(args.out, dpi=110)
        print("skeleton ->", args.out)


def cmd_plot(args):
    from quadrupedwholebodycontroller.viz import plots

    arrs = plots.load_trace(args.trace)
    plots.plot_run(arrs, skip_seconds=args.skip, out_path=args.out)
    print("plot ->", args.out)


def cmd_replay(args):
    """Offline 3-D replay of a saved trace to an animated GIF — the RViz
    live-view analogue for this headless environment."""
    import jax.numpy as jnp

    from quadrupedwholebodycontroller.models import anymal_d_model
    from quadrupedwholebodycontroller.viz import plots

    arrs = plots.load_trace(args.trace)
    model = anymal_d_model(dtype=jnp.float64)
    plots.render_replay(
        arrs, model, args.out, every=args.every, max_frames=args.max_frames
    )
    print("replay ->", args.out)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="qwbc")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("standing"); _common(p); p.set_defaults(fn=cmd_standing)
    for name, fn in [("walk", cmd_walk), ("trot", cmd_trot)]:
        p = sub.add_parser(name); _common(p)
        p.add_argument("--vx", type=float, default=0.5)
        p.add_argument("--vy", type=float, default=0.0)
        p.add_argument("--wz", type=float, default=0.0)
        p.set_defaults(fn=fn)
    p = sub.add_parser("teleop-replay"); _common(p)
    p.add_argument("stream", help="CSV of t,vx,vy,wz")
    p.set_defaults(fn=cmd_teleop_replay)
    p = sub.add_parser("teleop"); _common(p)
    p.set_defaults(fn=cmd_teleop)
    p = sub.add_parser("sweep"); _common(p)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--gait", choices=["walk", "trot"], default="walk")
    p.set_defaults(fn=cmd_sweep)
    p = sub.add_parser("plot")
    p.add_argument("trace"); p.add_argument("--out", default="run.png")
    p.add_argument("--skip", type=float, default=3.0)
    p.set_defaults(fn=cmd_plot)
    p = sub.add_parser("replay")
    p.add_argument("trace"); p.add_argument("--out", default="replay.gif")
    p.add_argument("--every", type=int, default=8)
    p.add_argument("--max-frames", type=int, default=120)
    p.set_defaults(fn=cmd_replay)
    p = sub.add_parser("inspect")
    p.add_argument("--q", default="", help="12 comma-separated joint angles (rad)")
    p.add_argument("--z", type=float, default=0.6, help="base height")
    p.add_argument("--dtype", choices=["float32", "float64"], default="float32")
    p.add_argument("--out", default="", help="save a 3D skeleton png")
    p.set_defaults(fn=cmd_inspect)

    args = ap.parse_args(argv)
    from quadrupedwholebodycontroller.runtime import accel

    accel.enable_compile_cache()
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Per-stage device time of the control step, from a profiler trace.

The solve chain marks its stages with jax.named_scope (control/wbc.py:
setup, finish; ops/qp.py: kchain, admm, polish, drop_round, cold_fix,
rescue).  XLA carries the scope path into each HLO instruction's op_name
metadata; a device event names its instruction in the `hlo_op` stat, and
op_names_from_hlo() maps instruction names to scope paths from the
compiled program's text.  A device event belongs to the stage whose scope
name appears in its path.  Nested scopes resolve by STAGES order (a
rescue's ADMM counts as rescue, a cold fix inside the K chain as
cold_fix).

XLA's GPU command buffers (CUDA graphs) hide the instruction behind each
kernel (hlo_op "command_buffer"), so stage attribution needs a trace taken
with XLA_FLAGS=--xla_gpu_enable_command_buffer= ; the end-to-end times
come from runs without that flag.

    reduce_trace(trace_dir, op_names) -> dict with, per device plane:
        window_ns, busy_ns, idle_share, per-stage device ns, other_ns,
        and the busiest kernels.

Busy time is the union of the device events' intervals; idle share is
1 - busy / window over the traced window.  Used by chip_smoke.py (trace
phase) and runnable on a saved trace:

    python tools/trace_stages.py <trace_dir>
"""
from __future__ import annotations

import glob
import json
import os
import re
import sys

STAGES = ("rescue", "drop_round", "cold_fix", "admm", "kchain", "polish",
          "setup", "finish")
_SEG = re.compile(r"[^/\s,;:=#]+")
_INSTR = re.compile(r'^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=.*?op_name="([^"]*)"')


def op_names_from_hlo(hlo_text: str) -> dict:
    """{instruction name: op_name path} from a compiled program's text
    (both the dotted HLO name and the underscored kernel spelling)."""
    out = {}
    for line in hlo_text.splitlines():
        m = _INSTR.match(line)
        if m:
            name, path = m.groups()
            out[name] = path
            out[name.replace(".", "_").replace("-", "_")] = path
    return out


def stage_of(texts) -> str | None:
    """The stage an event belongs to, from its name and string stats."""
    segs = set()
    for t in texts:
        segs.update(_SEG.findall(t))
    for s in STAGES:
        if s in segs:
            return s
    return None


def _union_ns(intervals):
    tot = 0
    end = None
    for s, e in sorted(intervals):
        if end is None or s > end:
            tot += e - s
            end = e
        elif e > end:
            tot += e - end
            end = e
    return tot


def reduce_trace(trace_dir: str, op_names: dict | None = None,
                 top: int = 12) -> dict:
    from jax.profiler import ProfileData

    files = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                             recursive=True))
    if not files:
        raise FileNotFoundError(f"no .xplane.pb under {trace_dir}")
    pd = ProfileData.from_file(files[-1])
    out = {}
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        per_stage = {s: 0 for s in STAGES}
        other = 0
        kernels = {}
        intervals = []
        for line in plane.lines:
            # XLA's op lines repeat the kernels' time; count streams only
            if not line.name.startswith("Stream"):
                continue
            for ev in line.events:
                dur = ev.duration_ns
                intervals.append((ev.start_ns, ev.start_ns + dur))
                stats = dict(ev.stats)
                texts = [ev.name] + [
                    str(v) for v in stats.values() if isinstance(v, str)
                ]
                if op_names:
                    for key in (stats.get("hlo_op"), ev.name):
                        if isinstance(key, str) and key in op_names:
                            texts.append(op_names[key])
                st = stage_of(texts)
                if st is None:
                    other += dur
                else:
                    per_stage[st] += dur
                kernels[ev.name] = kernels.get(ev.name, 0) + dur
        if not intervals:
            continue
        window = max(e for _, e in intervals) - min(s for s, _ in intervals)
        busy = _union_ns(intervals)
        out[plane.name] = {
            "window_ns": window,
            "busy_ns": busy,
            "idle_share": 1.0 - busy / window if window else 0.0,
            "stage_ns": per_stage,
            "other_ns": other,
            "top_kernels_ns": dict(sorted(kernels.items(),
                                          key=lambda kv: -kv[1])[:top]),
        }
    return out


def sample_events(trace_dir: str, n: int = 8) -> list:
    """A few device events with their stats (for eyeballing names)."""
    from jax.profiler import ProfileData

    files = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                             recursive=True))
    pd = ProfileData.from_file(files[-1])
    got = []
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for ev in line.events:
                got.append({"line": line.name, "name": ev.name,
                            "stats": {k: str(v)[:200] for k, v in ev.stats}})
                if len(got) >= n:
                    return got
    return got


if __name__ == "__main__":
    print(json.dumps(reduce_trace(sys.argv[1]), indent=1))

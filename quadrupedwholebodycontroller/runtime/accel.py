"""Accelerator housekeeping shared by the entry points (bench.py, the CLI,
chip_smoke.py): the persistent compile cache and the device stamp that
every printed measurement carries."""
from __future__ import annotations

import os
import subprocess

import jax

_REPO_CACHE = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "..", ".jax_cache"
)


def enable_compile_cache() -> str | None:
    """Point JAX's persistent compile cache at JAX_COMPILATION_CACHE_DIR
    when that is set, else at the fixed <repo>/.jax_cache (git-ignored).
    Returns the directory; None on the CPU backend, whose compiles are
    cheap and whose cached objects are tied to the host's CPU features."""
    if jax.default_backend() == "cpu":
        return None
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.normpath(
        _REPO_CACHE
    )
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def card() -> str | None:
    """The card's name and power limit as nvidia-smi reports them
    ("NVIDIA H100 80GB HBM3, 700.00 W"), or None without nvidia-smi."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    lines = [l.strip() for l in out.splitlines() if l.strip()]
    return lines[0] if lines else None


def device_stamp() -> dict:
    """platform / device_kind / device count as JAX reports them, plus the
    card line (None off the GPU)."""
    d = jax.devices()[0]
    return {
        "platform": d.platform,
        "device_kind": d.device_kind,
        "device_count": len(jax.devices()),
        "card": card() if d.platform == "gpu" else None,
    }

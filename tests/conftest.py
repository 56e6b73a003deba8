"""Test harness config: run the suite on a virtual 8-device CPU mesh with

float64 available, per the test strategy in SURVEY.md §4 (multi-host paths
validated without a pod via virtual CPU devices).

The platform is pinned through jax.config (not only the environment) before
any backend initializes, so the suite runs on the CPU even where a GPU is
present; tests that need the card are marked `gpu` and skip here.
"""
import os

os.environ["JAX_PLATFORMS"] = "cpu"  # subprocesses stay on the CPU too
# The XLA CPU compiler has segfaulted NONDETERMINISTICALLY under heavy
# accumulated in-process compile load (observed in full-suite runs, each
# time inside backend_compile at a different test).  Two mitigations:
# single-threaded LLVM codegen here (the crash signature is consistent with
# a parallel-codegen race), and per-module cache clearing below to bound
# accumulated compiler state.  The heaviest compile consumers
# additionally run in subprocesses (tests/layout_equiv_worker.py).
_flags = os.environ.get("XLA_FLAGS", "")
if "parallel_codegen" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_cpu_parallel_codegen_split_count=1"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import quadrupedwholebodycontroller  # noqa: E402,F401


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


@pytest.fixture(scope="session", autouse=True)
def _check_devices():
    assert jax.device_count() >= 8, "expected 8 virtual CPU devices"


@pytest.fixture(scope="module", autouse=True)
def _bound_compiler_state():
    """Clear jax's compilation caches after every test module: bounds the
    compiler-state accumulation implicated in the nondeterministic XLA CPU
    crashes (see header note).  Costs some cross-module jit reuse; the
    per-module fixtures recompile anyway."""
    yield
    jax.clear_caches()

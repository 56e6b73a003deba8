"""The trace-to-stage reduction (tools/trace_stages.py) and the on-card
smoke phases.  The reduction is checked on the CPU against a compiled
program's own op_name metadata; the card test skips without a GPU."""
import os
import sys

import jax
import jax.numpy as jnp
import pytest

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

from tools import trace_stages  # noqa: E402


def _scoped_program():
    @jax.jit
    def f(x):
        with jax.named_scope("admm"):
            y = jnp.sin(x) * 2.0
        with jax.named_scope("rescue"):
            with jax.named_scope("admm"):
                w = jnp.cos(y) + 1.0
        with jax.named_scope("polish"):
            return jnp.sum(w * y)

    return f.lower(jnp.ones((8, 8), jnp.float32)).compile().as_text()


def test_op_names_map_instructions_to_scope_paths():
    names = trace_stages.op_names_from_hlo(_scoped_program())
    paths = set(names.values())
    assert any("/admm/" in p for p in paths)
    assert any("/polish/" in p for p in paths)
    # every dotted instruction name has its underscored kernel spelling
    for k in list(names):
        if "." in k:
            assert names[k.replace(".", "_")] == names[k]


@pytest.mark.parametrize("texts, want", [
    (["jit(f)/while/body/admm/mul"], "admm"),
    (["jit(f)/rescue/admm/cos"], "rescue"),           # nesting: rescue wins
    (["jit(f)/kchain/cold_fix/dot_general"], "cold_fix"),
    (["fusion_3", "jit(f)/polish/reduce"], "polish"),
    (["input_reduce_fusion_36"], None),                # no scope -> other
    (["jit(f)/setup_x/add"], None),                    # whole segments only
])
def test_stage_of(texts, want):
    assert trace_stages.stage_of(texts) == want


def test_busy_union_counts_overlaps_once():
    iv = [(0, 10), (5, 15), (20, 30), (25, 26)]
    assert trace_stages._union_ns(iv) == 25


@pytest.fixture
def gpu_device():
    """The card, decided at run time (never at import)."""
    d = jax.devices()[0]
    if d.platform != "gpu":
        pytest.skip(f"needs a GPU (JAX platform {d.platform!r}); "
                    "run `python chip_smoke.py` on the card")
    return d


@pytest.mark.gpu
def test_chip_smoke_phases_on_card(gpu_device):
    import chip_smoke

    assert chip_smoke.main(["--only", "compile,main"]) == 0

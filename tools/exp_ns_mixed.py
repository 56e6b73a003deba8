#!/usr/bin/env python3
"""A/B of mixed-precision cold Newton-Schulz (ops/linalg.ns_inverse
body_prec/tail) on cond-controlled SPD batches, on the accelerator.

The per-step cold sub-batch NS chains (cold-fix (k, 70, 70), the drop
round's compacted Schur inverse, the rescue's cold K^-1) are ~60
serialized matmuls each at "highest" (full f32) precision.  The early
iterations only need to contract error ~1 -> the reduced floor; this tool
measures, per condition-number bucket:

  * accuracy: ||I - A W||_inf (max / median over the batch) for
    cold-30-highest vs bf16/bf16_3x bodies with 4/6/8-iteration
    full-precision tails (and cold-20-highest, the known-parity-unsafe
    short budget, as a floor reference);
  * speed: scan-timed ns_inverse latency per variant at (512, 70, 70)
    f32 (the cold_batch fix shape), SCAN=50.

    python tools/exp_ns_mixed.py
"""
import functools
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import jax
import jax.numpy as jnp

from quadrupedwholebodycontroller.ops.linalg import full_precision, ns_inverse

K = int(os.environ.get("QWBC_NS_K", 512))
N = 70
SCAN = int(os.environ.get("QWBC_NS_SCAN", 50))


def make_spd(rng, k, n, cond, family="diag"):
    """SPD batch at condition number `cond` (numpy QR on CPU; the chip
    never factorizes).

    family="diag" (the production-representative case): a mildly
    conditioned core D-scaled to cond — the Jacobi preconditioner in
    _cold_init removes most of it, like the Ruiz-equilibrated polish
    Schur matrices NS-30 is specced for (cond <= ~1e7, CLAUDE.md).
    family="spread": spectrum log-spaced over [1/cond, 1] in a random
    orthogonal basis — Jacobi-irreducible, HARDER than production (even
    cold-30-highest fails this family beyond ~1e4)."""
    if family == "spread":
        q, _ = np.linalg.qr(rng.standard_normal((k, n, n)))
        ev = np.logspace(-np.log10(cond), 0.0, n)[None, :]
        return (q * ev[:, None, :]) @ np.swapaxes(q, -1, -2)
    q, _ = np.linalg.qr(rng.standard_normal((k, n, n)))
    ev = np.logspace(-1.0, 0.0, n)[None, :]  # mild core, cond 10
    core = (q * ev[:, None, :]) @ np.swapaxes(q, -1, -2)
    d = np.logspace(0.0, 0.5 * np.log10(cond / 10.0), n)
    d = d[rng.permuted(np.tile(np.arange(n), (k, 1)), axis=1)]
    return core * d[:, :, None] * d[:, None, :]


@full_precision
def residual(A, W):
    # must itself run at "highest": a default-precision A @ W puts a bf16
    # noise floor on the MEASUREMENT (chip rows read ~0.1 even for exact
    # inverses of well-scaled matrices otherwise)
    E = jnp.eye(N, dtype=A.dtype) - A @ W
    return jnp.max(jnp.sum(jnp.abs(E), axis=-1), axis=-1)


def main():
    rng = np.random.default_rng(0)
    variants = {
        "cold30_highest": dict(iters=30),
        "cold20_highest": dict(iters=20),
        "bf16_tail4": dict(iters=30, body_prec="bfloat16", tail=4),
        "bf16_tail6": dict(iters=30, body_prec="bfloat16", tail=6),
        "bf16_tail8": dict(iters=30, body_prec="bfloat16", tail=8),
        "bf16x3_tail4": dict(iters=30, body_prec="high", tail=4),
        "bf16x3_tail6": dict(iters=30, body_prec="high", tail=6),
    }

    # accuracy per cond bucket (single dispatch per variant per bucket)
    for family in ("diag", "spread"):
      for cond in (1e3, 1e5, 1e7):
        A = jnp.asarray(make_spd(rng, K, N, cond, family), jnp.float32)
        row = {"family": family, "cond": cond}
        for name, kw in variants.items():
            W = full_precision(ns_inverse)(A, **kw)
            r = np.asarray(jax.device_get(residual(A, W)))
            row[name] = [round(float(np.median(r)), 6),
                         round(float(np.max(r)), 6)]
        print(json.dumps({"accuracy_med_max": row}), flush=True)

    # latency: scan the inverse SCAN times inside one jit
    A = jnp.asarray(make_spd(rng, K, N, 1e6), jnp.float32)

    def timed(kw):
        @jax.jit
        def run(A):
            def step(c, _):
                W = full_precision(ns_inverse)(A + 1e-6 * c, **kw)
                return c + jnp.float32(1e-9) * W[0, 0, 0], W[0, 0, 0]
            return jax.lax.scan(step, jnp.float32(0.0), None, length=SCAN)
        run(A)[0].block_until_ready()
        t0 = time.perf_counter()
        out = run(A)
        jax.block_until_ready(out)
        return (time.perf_counter() - t0) / SCAN * 1e3

    for name, kw in variants.items():
        ms = timed(kw)
        print(json.dumps({"variant": name, "ms_per_inverse": round(ms, 3)}),
              flush=True)


if __name__ == "__main__":
    main()

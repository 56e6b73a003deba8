#!/usr/bin/env python3
"""What each f32 matmul precision computes on the local device.

For the solver's shapes (batched 42x42 and 70x42 products, as in the K
chain and the Newton-Schulz inverses) and one large square product, runs
jnp.matmul at precision "default", "high" and "highest" and prints the max
relative error against float64 numpy.  f32 proper sits near 1e-7; 3-pass
bf16 near 1e-6; TF32 (10 mantissa bits) near 1e-4 to 1e-3.  One line per
case, stamped with the device and the card.

    python tools/matmul_precision.py
"""
from __future__ import annotations

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))


def main():
    import jax
    import jax.numpy as jnp

    from quadrupedwholebodycontroller.runtime import accel

    stamp = accel.device_stamp()
    rng = np.random.default_rng(0)
    cases = {
        "batched 42x42 @ 42x42 (B=4096)": ((4096, 42, 42), (4096, 42, 42)),
        "batched 70x42 @ 42x42 (B=4096)": ((4096, 70, 42), (4096, 42, 42)),
        "2048x2048 @ 2048x2048": ((2048, 2048), (2048, 2048)),
    }
    for name, (sa, sb) in cases.items():
        a = rng.standard_normal(sa).astype(np.float32)
        b = rng.standard_normal(sb).astype(np.float32)
        want = np.matmul(a.astype(np.float64), b.astype(np.float64))
        scale = np.abs(a).astype(np.float64) @ np.abs(b).astype(np.float64)
        row = {"case": name, **stamp}
        for prec in ("default", "high", "highest"):
            f = jax.jit(lambda x, y, p=prec: jnp.matmul(x, y, precision=p))
            got = np.asarray(f(a, b), np.float64)
            row[prec] = float(np.max(np.abs(got - want) / scale))
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()

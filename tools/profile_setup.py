#!/usr/bin/env python3
"""wbc_setup cost breakdown: cumulative prefixes of the setup pipeline,
scan-timed (the per-block cost is the difference of consecutive prefixes).

    python tools/profile_setup.py [B]
"""
import json
import os
import sys
import time

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from quadrupedwholebodycontroller.config import NV, ControllerParams
from quadrupedwholebodycontroller.control import wbc
from quadrupedwholebodycontroller.models import anymal_d_model
from quadrupedwholebodycontroller.models.anymal import INITIAL_JOINT_POS
from quadrupedwholebodycontroller.ops import centroidal as C
from quadrupedwholebodycontroller.ops import dynamics as D
from quadrupedwholebodycontroller.ops import kinematics as K
from quadrupedwholebodycontroller.ops.linalg import full_precision

SCAN = 5
REPS = 3


def timed(name, fn, *args):
    out = fn(*args)
    jax.block_until_ready(out)
    ts = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        out = fn(*args)
        jax.block_until_ready(out)
        ts.append((time.perf_counter() - t0) / SCAN)
    ts.sort()
    ms = ts[len(ts) // 2] * 1e3
    print(json.dumps({"block": name, "ms": round(ms, 2)}), flush=True)
    return ms


def main():
    B = int(sys.argv[1]) if len(sys.argv) > 1 else 4096
    dtype = jnp.float32
    model = anymal_d_model(dtype=dtype)
    cp = ControllerParams()

    key = jax.random.PRNGKey(0)
    k1, k2, k3, k4 = jax.random.split(key, 4)
    obs = wbc.RobotObservation(
        base_R=jnp.broadcast_to(jnp.eye(3, dtype=dtype), (B, 3, 3)),
        base_p=jnp.tile(jnp.array([0.0, 0.0, 0.55], dtype), (B, 1))
        + 0.01 * jax.random.normal(k1, (B, 3), dtype),
        base_vel=0.02 * jax.random.normal(k2, (B, 6), dtype),
        q=jnp.tile(jnp.asarray(INITIAL_JOINT_POS, dtype), (B, 1))
        + 0.02 * jax.random.normal(k3, (B, 12), dtype),
        qd=0.05 * jax.random.normal(k4, (B, 12), dtype),
    )
    ref = jax.tree.map(lambda x: jnp.stack([x] * B), wbc.Reference.standing(cp, dtype))
    carry = jax.tree.map(lambda x: jnp.stack([x] * B), wbc.init_carry(dtype))

    @full_precision
    def p1(o):
        u = jnp.concatenate([o.base_vel, o.qd])
        h, kin, parts, v = D.coriolis_bias_full(model, o.base_R, o.base_p, o.q, u)
        return h, kin.body_com_w, parts.jq, v

    @full_precision
    def p2(o):
        u = jnp.concatenate([o.base_vel, o.qd])
        h, kin, parts, v = D.coriolis_bias_full(model, o.base_R, o.base_p, o.q, u)
        com = K.robot_com(model, kin)
        M = D.mass_matrix_from_parts(model, kin, parts)
        tf = C.centroidal_transform(M, com, o.base_p)
        Mc = C.centroidal_mass_matrix(M, tf)
        return h, Mc, tf.T

    @full_precision
    def p3(o):
        u = jnp.concatenate([o.base_vel, o.qd])
        h, kin, parts, v = D.coriolis_bias_full(model, o.base_R, o.base_p, o.q, u)
        com = K.robot_com(model, kin)
        M = D.mass_matrix_from_parts(model, kin, parts)
        tf = C.centroidal_transform(M, com, o.base_p)
        Mc = C.centroidal_mass_matrix(M, tf)
        J_feet = K.frame_jacobians(model, kin)[:, :3, :]
        Jst = J_feet.reshape(12, NV)
        Jc = C.project_jacobian(Jst, tf)
        hc = C.centroidal_bias(h, M, jnp.zeros((NV, NV), dtype), u, tf)
        return Mc, Jc, hc

    def scanify(f):
        @jax.jit
        def run(z):
            def body(z, _):
                out = jax.vmap(f)(obs)
                s = sum(jnp.sum(o) for o in jax.tree.leaves(out))
                return z + 0.0 * s, s
            z2, s = jax.lax.scan(body, z, None, length=SCAN)
            return z2, s
        return run

    t1 = timed("p1_fk_bias_jvp", scanify(p1), jnp.zeros((), dtype))
    t2 = timed("p2_+mass_transform", scanify(p2), jnp.zeros((), dtype))
    t3 = timed("p3_+jacobians_bias", scanify(p3), jnp.zeros((), dtype))

    @jax.jit
    def full(c):
        def body(c, _):
            s = jax.vmap(lambda o, r, cc: wbc.wbc_setup(model, cp, o, r, cc))(
                obs, ref, c
            )
            c2 = c._replace(**s.carry_updates)
            return c2, jnp.sum(s.qp_data.g)
        c2, s = jax.lax.scan(body, c, None, length=SCAN)
        return c2, s

    t4 = timed("p4_full_setup", full, carry)
    print(json.dumps({
        "B": B,
        "deltas_ms": {
            "fk_bias_jvp": round(t1, 2),
            "mass_transform": round(t2 - t1, 2),
            "jacobians_proj_bias": round(t3 - t2, 2),
            "assembly_rest": round(t4 - t3, 2),
        },
    }), flush=True)


if __name__ == "__main__":
    main()

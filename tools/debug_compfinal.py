#!/usr/bin/env python3
"""Dissect the compensated final refinement at a chosen replay step.

Replays the walking trajectory (the torque-parity input) to step T on the
production-shaped path (the cached batched chain, B=8; the CPU is fine),
then at
step T:
  * solves with comp_final_refine=0 to get the incumbent `best`,
  * builds a FRESH active-set preconditioner (compact H^-1 + cold Schur
    inverse) from the incumbent's active set,
  * runs the compensated refinement passes manually, printing per pass the
    measured f32 relative KKT, the sign violation, the f64-truth solution
    error, and the torque delta vs the f64 optimum,
so the acceptance decision and the convergence (or not) are visible.

    JAX_PLATFORMS=cpu python tools/debug_compfinal.py 100
"""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp

from quadrupedwholebodycontroller.config import (
    ControllerParams,
    QPSolverParams,
)
from quadrupedwholebodycontroller.control import wbc
from quadrupedwholebodycontroller.models import anymal_d_model
from quadrupedwholebodycontroller.ops import qp as qpm
from quadrupedwholebodycontroller.ops.linalg import ns_inverse

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
TRAJ = os.path.join(ROOT, "data", "walk_traj_400hz.npz")


def main():
    T_target = int(sys.argv[1]) if len(sys.argv) > 1 else 100
    dtype = jnp.float32
    model = anymal_d_model(dtype=dtype)
    cp = ControllerParams()
    qp0 = QPSolverParams(
        comp_final_refine=int(os.environ.get("DBG_COMPFINAL", "0")),
        rescue_threshold=float(os.environ.get("DBG_RESCUE", "3e-3")),
        rescue_polish_rounds=int(os.environ.get("DBG_ROUNDS", "2")),
    )
    traj = np.load(TRAJ)
    B = 8
    import dataclasses

    xs_obs = wbc.RobotObservation(
        **{k: jnp.asarray(traj[k], dtype)
           for k in ("base_R", "base_p", "base_vel", "q", "qd")}
    )
    xs_ref = wbc.Reference(
        **{k: jnp.asarray(traj[k], dtype)
           for k in ("com_pose", "com_vel", "com_acc", "swing_pos",
                     "swing_vel", "swing_acc", "contacts")}
    )
    xs_new = jnp.asarray(traj["ref_is_new"])
    cache = qpm.make_cache(B, 42, 70, qp0, dtype)
    carry = jax.tree.map(lambda x: jnp.stack([x] * B), wbc.init_carry(dtype))

    bcast = lambda t: jax.tree.map(
        lambda x: jnp.broadcast_to(x, (B,) + x.shape), t
    )

    @jax.jit
    def to_step(carry, cache, t_stop):
        def body(cc, xs):
            c, ca = cc
            o_t, r_t, new_t, t = xs

            def run(args):
                c, ca = args
                _, c2, ca2 = wbc.wbc_step_batched(
                    model, cp, qp0, bcast(o_t), bcast(r_t), c, new_t,
                    "cached", ca, False,
                )
                return c2, ca2

            cc2 = jax.lax.cond(t < t_stop, run, lambda a: a, (c, ca))
            return cc2, None

        ts = jnp.arange(xs_new.shape[0])
        (c2, ca2), _ = jax.lax.scan(body, (carry, cache),
                                    (xs_obs, xs_ref, xs_new, ts))
        return c2, ca2

    carry_t, cache_t = to_step(carry, cache, T_target)
    obs_t = bcast(jax.tree.map(lambda x: x[T_target], xs_obs))
    ref_t = bcast(jax.tree.map(lambda x: x[T_target], xs_ref))
    new_t = xs_new[T_target]

    # incumbent: the full production step minus the comp-final refinement
    out0, _, _ = wbc.wbc_step_batched(
        model, cp, qp0, obs_t, ref_t, carry_t, new_t, "cached",
        cache_t, False,
    )
    # the QP problem of this step (fused setup, batch-major unscaled data)
    import quadrupedwholebodycontroller.ops.setup_fused as sku

    sk = sku.setup_batched(model, cp, obs_t, ref_t, carry_t,
                           jnp.broadcast_to(jnp.asarray(new_t), (B,)))
    data = qpm.QPData(H=sk["H"], g=sk["g"], A=sk["A"], l=sk["l"], u=sk["u"])
    best = qpm.QPState(x=out0.qp_x, z=jnp.clip(
        jnp.einsum("bij,bj->bi", sk["A"], out0.qp_x), sk["l"], sk["u"]),
        y=jnp.zeros_like(sk["l"]))
    # recover y: re-solve the step's QP exactly as the production path did
    warm = jax.vmap(wbc._switch_masked_warm)(
        carry_t, sk["carry_updates"]["switch_flag"]
    )
    st, info, _ = qpm.solve_batched(
        data, warm, qp0, "cached", cache=cache_t,
        use_warm=jnp.zeros((B,), bool) if qp0.cold_batch > 0 else False,
        hinv_fn=wbc._wbc_polish_hinv,
    )
    best = st
    print("incumbent: res", float(jnp.max(info.kkt_residual)),
          "sv", float(jnp.max(qpm._sign_violation(data, st.x, st.y))))

    # f64 truth
    data64 = jax.tree.map(lambda x: x.astype(jnp.float64), data)
    warm64 = jax.tree.map(lambda x: x.astype(jnp.float64), warm)
    qp64 = dataclasses.replace(
        qp0, iterations=200, polish_rounds=3, ns_iters=40, polish_refine=8,
        rescue_threshold=0.0,
    )
    st64, info64 = qpm.solve_batched(data64, warm64, qp64, "xla")
    print("f64 truth: res", float(jnp.max(info64.kkt_residual)))
    x_true = st64.x

    def tau_of(x):
        qdd = x[:, 6:18]
        grf = x[:, 18:30]
        return (jnp.einsum("bij,bj->bi", sk["Mc_jj"], qdd)
                + sk["h_c"][:, 6:]
                - jnp.einsum("bji,bj->bi", sk["Jc_st_j"], grf))

    tau_true = tau_of(x_true.astype(jnp.float32))
    print("incumbent tau err vs f64:",
          float(jnp.max(jnp.abs(tau_of(best.x) - tau_true))),
          " x err:", float(jnp.max(jnp.abs(best.x - x_true.astype(jnp.float32)))))

    # fresh preconditioner from the incumbent's active set
    Hinv = wbc._wbc_polish_hinv(data.H, qp0.polish_reg)
    da, b = qpm._assemble_active(data, best, dtype)
    Hd = qpm._blockdiag_dense(Hinv)
    Bm = da[:, :, None] * data.A
    S = Bm @ Hd @ jnp.swapaxes(Bm, -1, -2) + jnp.einsum(
        "bi,ij->bij", qp0.polish_reg * da + (1.0 - da),
        jnp.eye(70, dtype=dtype))
    Sinv = ns_inverse(S, qp0.ns_iters)

    # classification dump for scenario 0: estimated vs f64-truth active set
    ax0 = jnp.einsum("ij,j->i", data.A[0], best.x[0])
    tol_p0, tol_d0 = qpm._active_tols(
        jax.tree.map(lambda a: a[0], data), ax0
    )
    ax64 = jnp.einsum("ij,j->i", data64.A[0], x_true[0])
    y64 = st64.y[0]
    print("tol_p", float(tol_p0), "tol_d", float(tol_d0))
    da0 = np.asarray(da[0] if False else qpm._assemble_active(
        data, best, dtype)[0][0])
    for i in range(70):
        true_act = (abs(float(y64[i])) > 1e-9
                    or float(ax64[i] - data64.l[0, i]) < 1e-9
                    or float(data64.u[0, i] - ax64[i]) < 1e-9)
        est_act = bool(da0[i] > 0.5)
        if est_act != true_act:
            print(f"row {i}: est={est_act} true={true_act} "
                  f"ax={float(ax0[i]):.6g} l={float(data.l[0,i]):.6g} "
                  f"u={float(data.u[0,i]):.6g} y={float(best.y[0,i]):.6g} "
                  f"y64={float(y64[i]):.6g} ax64={float(ax64[i]):.6g}")

    # manual drop-rule polish chain (mirrors _rescue_core's loop)
    from quadrupedwholebodycontroller.ops.linalg import ns_inverse as _nsi
    eqr = (data.u - data.l) <= 1e-9
    tol_dr = jnp.maximum(
        1e-6, 256.0 * float(jnp.finfo(dtype).eps)
        * jnp.maximum(1.0, jnp.max(jnp.abs(data.g), axis=-1)))[:, None]
    banned = jnp.zeros_like(eqr)
    hd_, hblk_, hstart_ = Hinv
    k_ = hblk_.shape[-1]
    diag_reg = jnp.diagonal(data.H, axis1=-2, axis2=-1) + qp0.polish_reg
    diag_reg = jnp.concatenate(
        [diag_reg[:, :hstart_], jnp.zeros_like(diag_reg[:, :k_]),
         diag_reg[:, hstart_ + k_:]], axis=1)
    blk_reg = (data.H[:, hstart_:hstart_ + k_, hstart_:hstart_ + k_]
               + qp0.polish_reg * jnp.eye(k_, dtype=dtype))
    H_pol = (diag_reg, blk_reg, hstart_)
    w = best
    sv_best = qpm._sign_violation(data, best.x, best.y)
    res_best = info.kkt_residual
    for rnd in range(6):
        da_r, b_r = qpm._assemble_active(data, w, dtype)
        da_r = da_r * (1.0 - banned.astype(dtype))
        b_r = jnp.where(banned, 0.0, b_r)
        pol, _, pr_p, du_p = qpm._polish_batched_kernel(
            data, w, qp0, H_pol, Hinv,
            lambda S_thunk: _nsi(S_thunk(), qp0.ns_iters),
            da_b=(da_r, b_r),
        )
        side_up = (b_r == data.u) & ~eqr
        wrong = (da_r > 0.5) & ~eqr & jnp.where(
            side_up, pol.y < -tol_dr, pol.y > tol_dr)
        res_p = jnp.maximum(pr_p, du_p)
        sv_p = qpm._sign_violation(data, pol.x, pol.y)
        terr = float(jnp.max(jnp.abs(tau_of(pol.x) - tau_true)))
        print(f"round {rnd}: active {int(jnp.sum(da_r[0]))} "
              f"res_p {float(res_p[0]):.3e} sv_p {float(sv_p[0]):.3e} "
              f"wrong {int(jnp.sum(wrong[0]))} "
              f"wrong_rows {np.flatnonzero(np.asarray(wrong[0])).tolist()} "
              f"tau_err {terr:.3e}")
        banned = banned | wrong
        w = pol
    print("best vs truth after chain: accepted-iterate res",
          float(res_best[0]), "sv", float(sv_best[0]))

    # manual compensated refinement passes
    x, y = best.x, best.y
    for p in range(4):
        qpp = dataclasses.replace(qp0, comp_final_refine=1)
        cand, pr, du = qpm._comp_refine_final(
            data, qpm.QPState(x=x, z=best.z, y=y), qpp, Hinv, Sinv
        )
        x, y = cand.x, cand.y
        res = jnp.maximum(pr, du)
        sv = qpm._sign_violation(data, x, y)
        terr = jnp.abs(tau_of(x) - tau_true)
        xerr = jnp.abs(x - x_true.astype(jnp.float32))
        print(f"pass {p+1}: res {float(jnp.max(res)):.3e} "
              f"sv {float(jnp.max(sv)):.3e} "
              f"tau_err {float(jnp.max(terr)):.3e} "
              f"x_err {float(jnp.max(xerr)):.3e}")


if __name__ == "__main__":
    main()


def classify_dump():
    """Appended probe: print per-row classification vs the f64 truth for
    the worst scenario (run via: debug_compfinal.py <T> dump)."""

"""The generated batch-minor setup vs the vmapped XLA wbc_setup.

ops/setup_fused.py re-derives the whole setup with block algebra (constant
T bottom rows, per-leg M_jj sparsity, closed-form Mb inverse), so
equivalence is pinned in f64 at tight tolerance — any algebra mistake
shows up far above 1e-9 — plus an f32 sanity pass at the accelerator's
working precision.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from quadrupedwholebodycontroller.config import ControllerParams
from quadrupedwholebodycontroller.control import wbc
from quadrupedwholebodycontroller.models import anymal_d_model
from quadrupedwholebodycontroller.models.anymal import INITIAL_JOINT_POS
from quadrupedwholebodycontroller.ops import setup_fused as setup_kernel


def _batch(dtype, B=4, seed=0):
    key = jax.random.PRNGKey(seed)
    ks = jax.random.split(key, 6)
    from quadrupedwholebodycontroller.ops import spatial

    rpy = 0.1 * jax.random.normal(ks[5], (B, 3), dtype)
    obs = wbc.RobotObservation(
        base_R=spatial.rpy_to_matrix(rpy),
        base_p=jnp.tile(jnp.array([0.0, 0.0, 0.55], dtype), (B, 1))
        + 0.02 * jax.random.normal(ks[0], (B, 3), dtype),
        base_vel=0.2 * jax.random.normal(ks[1], (B, 6), dtype),
        q=jnp.tile(jnp.asarray(INITIAL_JOINT_POS, dtype), (B, 1))
        + 0.1 * jax.random.normal(ks[2], (B, 12), dtype),
        qd=0.5 * jax.random.normal(ks[3], (B, 12), dtype),
    )
    cp = ControllerParams()
    ref = jax.tree.map(
        lambda x: jnp.stack([x] * B), wbc.Reference.standing(cp, dtype)
    )
    # scenario 1 swings leg LF; scenario 2 swings RH with nonzero swing refs
    contacts = ref.contacts.at[1, 1].set(0.0).at[2, 3].set(0.0)
    ref = ref._replace(
        contacts=contacts,
        swing_pos=0.1 * jax.random.normal(ks[4], (B, 12), dtype),
        swing_vel=jnp.ones((B, 12), dtype) * 0.2,
        swing_acc=jnp.ones((B, 12), dtype) * 0.1,
    )
    carry = jax.tree.map(lambda x: jnp.stack([x] * B), wbc.init_carry(dtype))
    return cp, obs, ref, carry


def _run_both(dtype, ref_is_new=True, steps=1):
    cp, obs, ref, carry = _batch(dtype)
    model = anymal_d_model(dtype=dtype)
    B = obs.q.shape[0]
    rn = jnp.broadcast_to(jnp.asarray(ref_is_new), (B,))

    # advance the XLA carry a couple of steps so old_T / tdot_inv / switch
    # state are all non-trivial, then compare one more step
    for _ in range(steps):
        setup_x = jax.vmap(
            lambda o, r, c, n: wbc.wbc_setup(model, cp, o, r, c, n)
        )(obs, ref, carry, rn)
        carry = carry._replace(**setup_x.carry_updates)

    out_k = setup_kernel.setup_batched(model, cp, obs, ref, carry, rn)
    setup_x = jax.vmap(
        lambda o, r, c, n: wbc.wbc_setup(model, cp, o, r, c, n)
    )(obs, ref, carry, rn)
    return out_k, setup_x


def _check(out_k, setup_x, tol):
    def close(a, b, name, scale_tol=tol):
        a = np.asarray(a, np.float64)
        b = np.asarray(b, np.float64)
        scale = max(1.0, np.abs(b).max())
        err = np.abs(a - b).max() / scale
        assert err < scale_tol, (name, err, scale)

    close(out_k["H"], setup_x.qp_data.H, "H")
    close(out_k["g"], setup_x.qp_data.g, "g")
    close(out_k["A"], setup_x.qp_data.A, "A")
    close(out_k["l"], setup_x.qp_data.l, "l")
    close(out_k["u"], setup_x.qp_data.u, "u")
    close(out_k["h_c"], setup_x.h_c, "h_c")
    close(out_k["Mc_jj"], setup_x.Mc_jj, "Mc_jj")
    close(out_k["Jc_st_j"], setup_x.Jc_st_j, "Jc_st_j")
    close(out_k["com"], setup_x.com, "com")
    close(out_k["current_pose"], setup_x.current_pose, "pose")
    close(out_k["foot_pos"], setup_x.foot_pos, "foot_pos")
    cu_k = out_k["carry_updates"]
    cu_x = setup_x.carry_updates
    close(cu_k["old_T"], cu_x["old_T"], "old_T")
    close(cu_k["old_J_st"], cu_x["old_J_st"], "old_J_st")
    close(cu_k["old_J_sw"], cu_x["old_J_sw"], "old_J_sw")
    close(cu_k["tdot_inv"], cu_x["tdot_inv"], "tdot_inv")
    close(cu_k["integral_error"], cu_x["integral_error"], "integral")
    close(cu_k["prev_contacts"], cu_x["prev_contacts"], "prev_contacts")
    assert np.array_equal(
        np.asarray(cu_k["switch_flag"]), np.asarray(cu_x["switch_flag"])
    )


def test_setup_kernel_matches_xla_f64_first_cycle():
    out_k, setup_x = _run_both(jnp.float64, ref_is_new=True, steps=0)
    _check(out_k, setup_x, 1e-9)


def test_setup_kernel_matches_xla_f64_warm_carry():
    # after two XLA steps the FD derivatives, stale tdot_inv and switch
    # bookkeeping are all exercised
    out_k, setup_x = _run_both(jnp.float64, ref_is_new=True, steps=2)
    _check(out_k, setup_x, 1e-9)


def test_setup_kernel_matches_xla_f64_ref_not_new():
    out_k, setup_x = _run_both(jnp.float64, ref_is_new=False, steps=2)
    _check(out_k, setup_x, 1e-9)


def test_setup_kernel_matches_xla_f32():
    out_k, setup_x = _run_both(jnp.float32, ref_is_new=True, steps=1)
    _check(out_k, setup_x, 2e-4)


def test_setup_kernel_fused_prepare_f64():
    """The fused-prepare epilogue (qp_params) matches the standalone
    prepare stage applied to the plain setup outputs, including the fused
    switch masking of the warm start."""
    from quadrupedwholebodycontroller.config import QPSolverParams
    from quadrupedwholebodycontroller.ops import prepare as prepare_kernel
    from quadrupedwholebodycontroller.ops import qp as qpm

    dtype = jnp.float64
    cp, obs, ref, carry = _batch(dtype)
    model = anymal_d_model(dtype=dtype)
    B = obs.q.shape[0]
    rn = jnp.ones((B,), bool)
    qp_params = QPSolverParams()
    # advance one step, give the carry a nonzero warm start, and force a
    # contact switch in scenario 0 so the warm masking path is exercised
    setup_x = jax.vmap(
        lambda o, r, c, n: wbc.wbc_setup(model, cp, o, r, c, n)
    )(obs, ref, carry, rn)
    carry = carry._replace(**setup_x.carry_updates)
    key = jax.random.PRNGKey(11)
    carry = carry._replace(
        qp_warm=qpm.QPState(
            x=jax.random.normal(key, (B, 42), dtype),
            z=jax.random.normal(jax.random.fold_in(key, 1), (B, 70), dtype),
            y=jax.random.normal(jax.random.fold_in(key, 2), (B, 70), dtype),
        )
    )
    ref2 = ref._replace(contacts=ref.contacts.at[0, 0].set(0.0))

    out_k = setup_kernel.setup_batched(
        model, cp, obs, ref2, carry, rn, qp_params=qp_params
    )
    assert out_k["prepared"] is not None

    setup_x2 = jax.vmap(
        lambda o, r, c, n: wbc.wbc_setup(model, cp, o, r, c, n)
    )(obs, ref2, carry, rn)
    switch = setup_x2.carry_updates["switch_flag"]
    warm = jax.vmap(wbc._switch_masked_warm)(carry, switch)
    want = prepare_kernel.prepare_scaled(
        setup_x2.qp_data.H, setup_x2.qp_data.A, setup_x2.qp_data.g,
        setup_x2.qp_data.l, setup_x2.qp_data.u, warm.x, warm.z, warm.y,
        sweeps=qp_params.scaling_iters, rho0=qp_params.rho,
        rho_eq_scale=qp_params.rho_eq_scale,
    )
    names = ["sH", "sA", "sg", "sl", "su", "rho", "wxs", "wzs", "wys",
             "d", "e"]
    for name, got, ref_v in zip(names, out_k["prepared"], want):
        a = np.asarray(got, np.float64)
        b = np.asarray(ref_v, np.float64)
        scale = max(1.0, np.abs(b).max())
        err = np.abs(a - b).max() / scale
        assert err < 1e-9, (name, err)


def test_setup_kernel_switch_path_f64():
    """Contact switch between steps zeroes the FD derivatives batch-wide."""
    dtype = jnp.float64
    cp, obs, ref, carry = _batch(dtype)
    model = anymal_d_model(dtype=dtype)
    B = obs.q.shape[0]
    rn = jnp.ones((B,), bool)
    setup_x = jax.vmap(
        lambda o, r, c, n: wbc.wbc_setup(model, cp, o, r, c, n)
    )(obs, ref, carry, rn)
    carry = carry._replace(**setup_x.carry_updates)
    # flip one leg's contact in scenario 0 -> switch there, not elsewhere
    ref2 = ref._replace(contacts=ref.contacts.at[0, 0].set(0.0))
    out_k = setup_kernel.setup_batched(model, cp, obs, ref2, carry, rn)
    setup_x2 = jax.vmap(
        lambda o, r, c, n: wbc.wbc_setup(model, cp, o, r, c, n)
    )(obs, ref2, carry, rn)
    _check(out_k, setup_x2, 1e-9)
    sw = np.asarray(out_k["carry_updates"]["switch_flag"])
    assert sw[0] and not sw[1:].any()

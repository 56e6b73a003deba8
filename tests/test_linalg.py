"""Matmul-only linear algebra vs LAPACK-path references."""
import jax.numpy as jnp
import numpy as np

from quadrupedwholebodycontroller.ops import linalg as L


def spd(rng, n, cond=1e4):
    Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    eigs = np.logspace(0, np.log10(cond), n)
    return Q @ np.diag(eigs) @ Q.T


def test_ns_inverse_f64(rng):
    for n, cond in [(6, 1e2), (18, 1e4), (42, 1e5), (70, 1e4)]:
        A = jnp.asarray(spd(rng, n, cond))
        Ainv = L.ns_inverse(A, iters=40)
        assert np.allclose(np.asarray(A @ Ainv), np.eye(n), atol=1e-9), (n, cond)


def test_ns_inverse_batched(rng):
    A = jnp.stack([jnp.asarray(spd(rng, 12, 1e3)) for _ in range(5)])
    Ainv = L.ns_inverse(A, iters=35)
    assert np.allclose(np.asarray(A @ Ainv), np.eye(12)[None], atol=1e-10)


def test_ns_inverse_f32(rng):
    A = jnp.asarray(spd(rng, 42, 1e4), jnp.float32)
    Ainv = L.ns_inverse(A, iters=30)
    # f32 plateau ~ cond * eps
    assert np.allclose(np.asarray(A @ Ainv), np.eye(42), atol=5e-2)


def test_spd_solve_refinement(rng):
    A = jnp.asarray(spd(rng, 42, 1e5))
    x_true = jnp.asarray(rng.normal(size=42))
    b = A @ x_true
    x = L.spd_solve(A, b, iters=40, refine=2)
    assert np.allclose(np.asarray(x), np.asarray(x_true), atol=1e-8)


def test_solve_kkt_schur_vs_dense(rng):
    """Matches the dense (LU) solution of the same regularized system."""
    n, m = 10, 14
    H = jnp.asarray(spd(rng, n, 1e3))
    A = rng.normal(size=(m, n))
    da = np.zeros(m)
    da[[0, 3, 5, 7]] = 1.0
    B = jnp.asarray(da[:, None] * A)
    g = jnp.asarray(rng.normal(size=n))
    b = jnp.asarray(rng.normal(size=m) * da)
    reg = 1e-9
    x, y = L.solve_kkt_schur(H, B, jnp.asarray(da), g, b, reg=reg, iters=40)

    # dense reference
    D = np.diag((1.0 - da) - reg * da)
    S = np.block([[np.asarray(H), np.asarray(B).T], [np.asarray(B), D]])
    rhs = np.concatenate([-np.asarray(g), da * np.asarray(b)])
    sol = np.linalg.solve(S, rhs)
    assert np.allclose(np.asarray(x), sol[:n], atol=1e-8)
    assert np.allclose(np.asarray(y), sol[n:], atol=1e-8)
    # inactive duals are (essentially) zero
    assert np.allclose(np.asarray(y)[da == 0], 0.0, atol=1e-10)


def test_inv3_closed_form(rng):
    A = jnp.asarray(rng.normal(size=(7, 3, 3)) + 4 * np.eye(3))
    Ainv = L.inv3(A)
    assert np.allclose(np.asarray(A @ Ainv), np.eye(3)[None], atol=1e-12)


def test_spd_inv6_closed_form(rng):
    A = jnp.stack([jnp.asarray(spd(rng, 6, 1e3)) for _ in range(5)])
    Ainv = L.spd_inv6(A)
    assert np.allclose(np.asarray(A @ Ainv), np.eye(6)[None], atol=1e-10)


def test_spd_inv6_f32_mass_matrix_like(rng):
    # conditioning representative of the base mass-matrix block
    A = jnp.asarray(spd(rng, 6, 1e2), jnp.float32)
    Ainv = L.spd_inv6(A)
    assert np.allclose(np.asarray(A @ Ainv), np.eye(6), atol=1e-4)


def test_spd_inv18_mass_matrix(rng):
    """Nested block-Schur inverse on real floating-base mass matrices."""
    import jax
    import jax.numpy as jnp_

    from quadrupedwholebodycontroller.models import anymal_d_model
    from quadrupedwholebodycontroller.models.anymal import INITIAL_JOINT_POS
    from quadrupedwholebodycontroller.ops import dynamics as D
    from quadrupedwholebodycontroller.ops import kinematics as K

    model = anymal_d_model(dtype=jnp_.float64)
    B = 4
    q = jnp_.asarray(INITIAL_JOINT_POS)[None] + 0.3 * jnp_.asarray(
        rng.normal(size=(B, 12))
    )
    def mass(qi):
        kin = K.forward_kinematics(
            model, jnp_.eye(3, dtype=jnp_.float64),
            jnp_.array([0.0, 0.0, 0.5]), qi,
        )
        return D.mass_matrix(model, kin)
    M = jax.vmap(mass)(q)
    X = L.spd_inv18(M)
    assert np.allclose(np.asarray(M @ X), np.eye(18)[None], atol=1e-9)
    # f32 path: good enough that 2 refinement passes reach the f32 floor
    X32 = L.spd_inv18(jnp_.asarray(M, jnp_.float32))
    r = np.max(np.abs(np.asarray(jnp_.asarray(M, jnp_.float32) @ X32) - np.eye(18)))
    assert r < 5e-3, r


def test_ns_inverse_warm_shared_matches():
    """Shared-matmul warm NS == ns_inverse bitwise for accepted warm
    starts; rejected warms fall back to a finite, safe X0."""
    import numpy as np

    from quadrupedwholebodycontroller.ops.linalg import (
        ns_inverse,
        ns_inverse_warm_shared,
    )

    rng = np.random.default_rng(5)
    B, n = 64, 42
    M = rng.normal(size=(B, n, 12))
    A = jnp.asarray(M @ np.swapaxes(M, 1, 2) + np.eye(n), jnp.float64)
    warm = ns_inverse(A, 30)
    A2 = A * (1.0 + 1e-3 * jnp.asarray(rng.normal(size=(B, 1, 1))))
    want = ns_inverse(A2, 30, warm=warm, warm_iters=2)
    got = ns_inverse_warm_shared(A2, warm, 2)
    assert float(jnp.max(jnp.abs(got - want))) == 0.0  # bitwise

    # poisoned warm: NaN and divergent entries fall back finite
    bad = warm.at[1].set(jnp.nan).at[3].set(warm[3] * 1e9)
    got_b = ns_inverse_warm_shared(A2, bad, 2)
    assert bool(jnp.all(jnp.isfinite(got_b)))
    # good lanes unaffected by the bad ones
    assert float(jnp.max(jnp.abs(got_b[0] - want[0]))) == 0.0


def test_ns_inverse_bm_matches_batch_major():
    """Batch-minor (n, n, B) NS functions == their batch-major versions
    (same matmul sequence expressed as trailing-batch einsums; f64 exact
    to roundoff-reassociation, checked tight)."""
    import numpy as np

    from quadrupedwholebodycontroller.ops.linalg import (
        ns_inverse,
        ns_inverse_bm,
        ns_inverse_warm_shared,
        ns_inverse_warm_shared_bm,
    )

    rng = np.random.default_rng(7)
    B, n = 32, 42
    M = rng.normal(size=(B, n, 12))
    A = jnp.asarray(M @ np.swapaxes(M, 1, 2) + np.eye(n), jnp.float64)
    A_t = jnp.transpose(A, (1, 2, 0))

    cold_maj = ns_inverse(A, 30)
    cold_bm = jnp.transpose(ns_inverse_bm(A_t, 30), (2, 0, 1))
    assert float(jnp.max(jnp.abs(cold_maj - cold_bm))) < 1e-12

    A2 = A * (1.0 + 1e-3 * jnp.asarray(rng.normal(size=(B, 1, 1))))
    warm_maj = ns_inverse_warm_shared(A2, cold_maj, 2)
    warm_bm = jnp.transpose(
        ns_inverse_warm_shared_bm(
            jnp.transpose(A2, (1, 2, 0)), jnp.transpose(cold_maj, (1, 2, 0)), 2
        ),
        (2, 0, 1),
    )
    assert float(jnp.max(jnp.abs(warm_maj - warm_bm))) < 1e-12

    # poisoned warm lanes fall back finite without contaminating others
    bad = cold_maj.at[1].set(jnp.nan).at[3].set(cold_maj[3] * 1e9)
    got = jnp.transpose(
        ns_inverse_warm_shared_bm(
            jnp.transpose(A2, (1, 2, 0)), jnp.transpose(bad, (1, 2, 0)), 2
        ),
        (2, 0, 1),
    )
    assert bool(jnp.all(jnp.isfinite(got)))
    assert float(jnp.max(jnp.abs(got[0] - warm_maj[0]))) < 1e-12

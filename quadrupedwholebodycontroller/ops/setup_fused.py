"""The whole WBC setup, generated as one batch-minor jnp program.

The same quantities as control/wbc.wbc_setup (the updateState +
solveQP-assembly halves of the reference cycle,
src/whole_body_controller.cpp:256-515), written over batch-minor arrays
(every per-scenario quantity is (dims..., B), the scenario batch last) so
that every operation is elementwise over the whole batch:

  * model constants (masses, joint frames, inertias, topology) are baked
    in as PYTHON FLOATS at generation time — zero/identity entries are
    skipped, so there are no masks and no constant arrays, and per-leg
    chain independence makes M_jj assembly block-sparse for free;
  * batch x batch contractions use the _mv/_mvt reduction pattern;
    matrices assemble column-/row-wise with jnp.stack;
  * block algebra eliminates every 18x18 product: T / T^-1 are block
    upper-triangular with CONSTANT bottom rows [0 I], so the centroidal
    projections reduce to 3/6/12-dim contractions (e.g. the centroidal
    foot-Jacobian base block is exactly [I | -skew(p_f - com)]);
  * sin(q), cos(q) and the base RPY are computed by the wrapper.

Semantics match control/wbc.wbc_setup (the reference-faithful
finite-difference path, exact_derivatives=False) to f32 rounding; the
equivalence is pinned by tests/test_setup_kernel.py in f64 (1e-9) and f32.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from quadrupedwholebodycontroller.config import (
    GRAVITY,
    NUM_JOINTS,
    NUM_LEGS,
    NV,
    QP_INF,
    QP_NUM_CONSTRAINTS,
    QP_NUM_VARS,
)
from quadrupedwholebodycontroller.ops.prepare import ruiz_scalings


# ---------------------------------------------------------------- helpers
def _mv(M, v):
    """(p, q, B) x (q, B) -> (p, B)."""
    return jnp.sum(M * v[None, :, :], axis=1)


def _mvt(M, w):
    """(p, q, B)^T x (p, B) -> (q, B)."""
    return jnp.sum(M * w[:, None, :], axis=0)


def _mm(A, B):
    """(p, q, B) @ (q, r, B) -> (p, r, B), column loop of _mv."""
    return jnp.stack([_mv(A, B[:, j]) for j in range(B.shape[1])], axis=1)


def _tr(M):
    """(p, q, B) -> (q, p, B) via column restacking (no transpose op)."""
    return jnp.stack([M[:, j] for j in range(M.shape[1])], axis=0)


def _cross(a, b):
    """(3, B) x (3, B) -> (3, B)."""
    return jnp.stack(
        [
            a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0],
        ]
    )


def _dot(a, b):
    """(k, B) . (k, B) -> (B,)."""
    return jnp.sum(a * b, axis=0)


def _skew(v):
    """(3, B) -> (3, 3, B)."""
    z = jnp.zeros_like(v[0])
    return jnp.stack(
        [
            jnp.stack([z, -v[2], v[1]]),
            jnp.stack([v[2], z, -v[0]]),
            jnp.stack([-v[1], v[0], z]),
        ]
    )


def _const_mv(M, c):
    """(p, k, B) @ const (k,) -> (p, B); zero entries skipped."""
    acc = None
    for k in range(len(c)):
        w = float(c[k])
        if w == 0.0:
            continue
        t = M[:, k] if w == 1.0 else M[:, k] * w
        acc = t if acc is None else acc + t
    return acc if acc is not None else jnp.zeros_like(M[:, 0])


def _const_mm(M, C):
    """(p, k, B) @ const (k, r) -> (p, r, B)."""
    return jnp.stack(
        [_const_mv(M, C[:, j]) for j in range(C.shape[1])], axis=1
    )


def _inv3(M):
    """Closed-form (3, 3, B) inverse (adjugate / det) — ops/linalg.inv3."""
    a, b, c = M[0, 0], M[0, 1], M[0, 2]
    d, e, f = M[1, 0], M[1, 1], M[1, 2]
    g, h, i = M[2, 0], M[2, 1], M[2, 2]
    co00 = e * i - f * h
    co01 = c * h - b * i
    co02 = b * f - c * e
    co10 = f * g - d * i
    co11 = a * i - c * g
    co12 = c * d - a * f
    co20 = d * h - e * g
    co21 = b * g - a * h
    co22 = a * e - b * d
    det = a * co00 + b * co10 + c * co20
    inv_det = 1.0 / det
    return (
        jnp.stack(
            [
                jnp.stack([co00, co01, co02]),
                jnp.stack([co10, co11, co12]),
                jnp.stack([co20, co21, co22]),
            ]
        )
        * inv_det
    )


def _zeros(shape_prefix, like):
    return jnp.zeros(shape_prefix + (like.shape[-1],), like.dtype)


def _topology(parent):
    """Per-body root->leaf ancestor joint chains (static)."""
    nb = len(parent)
    anc = [[] for _ in range(nb)]
    for b in range(1, nb):
        anc[b] = anc[parent[b]] + [b - 1]
    return anc


# ---------------------------------------------------------------- body
def _make_body(const, params, qp_params=None, exact_mode=False):
    """Build the generated setup body over static model constants.

    The body reads its inputs as `x_ref[:]` and writes each output once as
    `o_ref[:] = value`; setup_batched runs it on whole batch-minor arrays
    (_Ref).

    const: dict of numpy arrays/tuples (see setup_batched); params: the
    ControllerParams (hashable dataclass; only floats are read).
    qp_params (optional QPSolverParams): fuse the QP prepare stage (Ruiz
    equilibration + problem/warm scaling + rho, ops/prepare.py) into the
    same body — the warm start (wx, wz, wy) joins the inputs and the
    scaled problem joins the outputs.

    exact_mode: carry the jvp-exact tangent propagation (Rdot = skew(w) R,
    pdot = v, qdot along the state flow — ops/kinematics.state_flow) through
    the SAME unrolled recursion, replacing the reference's one-cycle-stale
    finite differences (cpp:384-402) with analytic Tdot/Jdot and the fresh
    Tdot^-1 in the centroidal bias — the fused form of
    control/wbc.wbc_setup's exact_derivatives branch (the XLA jvp epilogue
    re-runs differentiated kinematics outside; the tangent chain here is
    ~2x the primal op count of the blocks it touches).  No gating:
    tangents carry no history, so contact switches need no zeroing and
    deriv_valid is moot."""

    parent = const["parent"]
    anc = _topology(parent)
    nb = len(parent)
    nj = nb - 1
    nl = NUM_LEGS
    jR = const["joint_R"]          # (nj, 3, 3)
    jp = const["joint_p"]          # (nj, 3)
    jax_ = const["joint_axis"]     # (nj, 3)
    # python floats only: a stray np.float64 scalar would silently promote
    # the whole f32 lane arithmetic to f64 under jax_enable_x64
    mass = [float(x) for x in const["mass"]]         # (nb,)
    com_b = const["com"]           # (nb, 3)
    inertia = const["inertia"]     # (nb, 3, 3)
    foot_body = const["frame_body"]  # (nl,)
    foot_p = const["frame_p"]        # (nl, 3)
    m_tot = float(sum(mass))

    # Rodrigues folded into the parent-frame joint rotation:
    #   R_child = R_parent @ (jR @ (I + s K + (1-c) K^2))
    #           = R_parent @ (M0 + s M1 + (1-c) M2)
    M0 = jR
    M1 = np.empty_like(jR)
    M2 = np.empty_like(jR)
    jRa = np.empty((nj, 3))
    for j in range(nj):
        a = jax_[j]
        K = np.array(
            [[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]]
        )
        M1[j] = jR[j] @ K
        M2[j] = jR[j] @ (K @ K)
        jRa[j] = jR[j] @ a

    # M_jj sparsity: (j, k) nonzero iff some body has both as ancestors
    jj_bodies = {}
    for j in range(nj):
        for k in range(nj):
            bl = [b for b in range(nb) if j in anc[b] and k in anc[b]]
            if bl:
                jj_bodies[(j, k)] = bl

    dt = 1.0 / params.loop_rate
    mu = params.friction
    kp_diag = [params.kp, params.kp, params.kp_z,
               params.kp, params.kp, params.kp]
    mg = m_tot * GRAVITY
    inf = QP_INF

    def body(R0_ref, p0_ref, bv_ref, qd_ref, sq_ref, cq_ref, rpy_ref,
               rpose_ref, rvel_ref, racc_ref, spos_ref, svel_ref, sacc_ref,
               rcon_ref,
               oldT_ref, oldJst_ref, oldJsw_ref, tdinv_ref, integ_ref,
               prevc_ref, swflag_ref, derivv_ref, refnew_ref,
               A_ref, g_ref, lb_ref, ub_ref, Hblk_ref, hc_ref, com_ref,
               fpos_ref, Ttop_ref, tdnew_ref, intego_ref, prevco_ref,
               swo_ref):
        R0 = R0_ref[:]            # (3, 3, B)
        p0 = p0_ref[:]            # (3, B)
        bv = bv_ref[:]            # (6, B)
        qd = qd_ref[:]            # (nj, B)
        sq = sq_ref[:]
        cq = cq_ref[:]

        # ---- contact bookkeeping (referenceCallback, cpp:176-184) ----
        rcon = rcon_ref[:]        # (4, B) reference contacts
        prevc = prevc_ref[:]
        refnew = refnew_ref[0]    # (B,)
        # masks stay 0/1 floats: comparisons only feed select
        # predicates, never stored or combined as data
        changed_f = jnp.max(jnp.abs(rcon - prevc), axis=0)  # exact 0.0/1.0
        switch_f = jnp.where(refnew > 0.5, changed_f, swflag_ref[0])
        contacts = jnp.where(refnew[None, :] > 0.5, rcon, prevc)
        c_leg = [contacts[i] for i in range(nl)]


        # ---- FK (level math unrolled over the static tree) ----
        R = [None] * nb
        p = [None] * nb
        cw = [None] * nb
        R[0] = R0
        p[0] = p0
        cw[0] = p0 + _const_mv(R0, com_b[0])
        axw = [None] * nj
        orgw = [None] * nj
        N_list = [None] * nj
        for b in range(1, nb):
            j = b - 1
            pb = parent[b]
            s, c1 = sq[j], 1.0 - cq[j]
            rows = []
            for i in range(3):
                ent = []
                for l in range(3):
                    terms = []
                    if M0[j][i, l] != 0.0:
                        terms.append(
                            jnp.full_like(s, float(M0[j][i, l]))
                        )
                    if M1[j][i, l] != 0.0:
                        terms.append(s * float(M1[j][i, l]))
                    if M2[j][i, l] != 0.0:
                        terms.append(c1 * float(M2[j][i, l]))
                    v = terms[0] if terms else jnp.zeros_like(s)
                    for t in terms[1:]:
                        v = v + t
                    ent.append(v)
                rows.append(jnp.stack(ent))
            N = jnp.stack(rows)                      # (3, 3, B)
            N_list[j] = N
            R[b] = _mm(R[pb], N)
            p[b] = p[pb] + _const_mv(R[pb], jp[j])
            axw[j] = _const_mv(R[pb], jRa[j])
            orgw[j] = p[b]
            cw[b] = p[b] + _const_mv(R[b], com_b[b])


        # ---- tangent FK along the state flow (exact_mode only) ----
        # d/dt of every FK quantity under (Rdot = skew(omega_w) R0,
        # pdot = v_base, qdot): the same unrolled chain, dotted.
        dR = [None] * nb
        dp_ = [None] * nb
        dcw = [None] * nb
        daxw = [None] * nj
        dorgw = [None] * nj
        if exact_mode:
            dR[0] = _mm(_skew(bv[3:6]), R0)
            dp_[0] = bv[0:3]
            dcw[0] = dp_[0] + _const_mv(dR[0], com_b[0])
            for b in range(1, nb):
                j = b - 1
                pb = parent[b]
                # Ndot = (cos q * qd) M1 + (sin q * qd) M2
                sd = cq[j] * qd[j]
                cd = sq[j] * qd[j]
                rows = []
                for i in range(3):
                    ent = []
                    for l in range(3):
                        terms = []
                        if M1[j][i, l] != 0.0:
                            terms.append(sd * float(M1[j][i, l]))
                        if M2[j][i, l] != 0.0:
                            terms.append(cd * float(M2[j][i, l]))
                        vterm = terms[0] if terms else jnp.zeros_like(sd)
                        for t in terms[1:]:
                            vterm = vterm + t
                        ent.append(vterm)
                    rows.append(jnp.stack(ent))
                dN = jnp.stack(rows)
                dR[b] = _mm(dR[pb], N_list[j]) + _mm(R[pb], dN)
                dp_[b] = dp_[pb] + _const_mv(dR[pb], jp[j])
                daxw[j] = _const_mv(dR[pb], jRa[j])
                dorgw[j] = dp_[b]
                dcw[b] = dp_[b] + _const_mv(dR[b], com_b[b])

        # ---- Jacobian parts / body velocities (ops/kinematics.py) ----
        om = bv[3:6]
        r = [cw[b] - p0 for b in range(nb)]
        jq = [dict() for _ in range(nb)]
        for b in range(1, nb):
            for j in anc[b]:
                jq[b][j] = _cross(axw[j], cw[b] - orgw[j])
        v = [None] * nb
        for b in range(nb):
            vb = bv[0:3] + _cross(om, r[b])
            for j in anc[b]:
                vb = vb + qd[j] * jq[b][j]
            v[b] = vb

        com = cw[0] * (mass[0] / m_tot)
        clv = v[0] * (mass[0] / m_tot)
        for b in range(1, nb):
            com = com + cw[b] * (mass[b] / m_tot)
            clv = clv + v[b] * (mass[b] / m_tot)
        com_vel6 = jnp.concatenate([clv, om], axis=0)
        d_com = com - p0

        djq = [dict() for _ in range(nb)]
        dr_ = [None] * nb
        dcom = dd_com = None
        if exact_mode:
            for b in range(1, nb):
                for j in anc[b]:
                    djq[b][j] = _cross(daxw[j], cw[b] - orgw[j]) + _cross(
                        axw[j], dcw[b] - dorgw[j]
                    )
            dr_ = [dcw[b] - dp_[0] for b in range(nb)]
            dcom = dcw[0] * (mass[0] / m_tot)
            for b in range(1, nb):
                dcom = dcom + dcw[b] * (mass[b] / m_tot)
            dd_com = dcom - dp_[0]


        # ---- world inertias Iw = R I R^T ----
        Iw = [None] * nb
        dIw = [None] * nb
        for b in range(nb):
            A1 = _const_mm(R[b], inertia[b])
            Iw[b] = jnp.stack(
                [_mv(A1, R[b][jr]) for jr in range(3)], axis=1
            )
            if exact_mode:
                # Iw_dot = Rdot I R^T + R I Rdot^T, column-wise like Iw
                dA1 = _const_mm(dR[b], inertia[b])
                dIw[b] = jnp.stack(
                    [
                        _mv(dA1, R[b][jr]) + _mv(A1, dR[b][jr])
                        for jr in range(3)
                    ],
                    axis=1,
                )

        # ---- velocity-product recursion (ops/dynamics.py) ----
        w_ = [None] * nb
        al = [None] * nb
        ao = [None] * nb
        w_[0] = om
        al[0] = _zeros((3,), p0)
        ao[0] = al[0]
        for b in range(1, nb):
            j = b - 1
            pb = parent[b]
            rl = p[b] - p[pb]
            ao[b] = (
                ao[pb]
                + _cross(al[pb], rl)
                + _cross(w_[pb], _cross(w_[pb], rl))
            )
            w_[b] = w_[pb] + qd[j] * axw[j]
            al[b] = al[pb] + qd[j] * _cross(w_[pb], axw[j])

        h_lin = None
        h_ang = None
        F = [None] * nb
        Nb = [None] * nb
        for b in range(nb):
            dcb = cw[b] - p[b]
            a_com = (
                ao[b] + _cross(al[b], dcb)
                + _cross(w_[b], _cross(w_[b], dcb))
            )
            F[b] = a_com * mass[b]
            Nb[b] = _mv(Iw[b], al[b]) + _cross(w_[b], _mv(Iw[b], w_[b]))
            t_lin = F[b]
            t_ang = _cross(r[b], F[b]) + Nb[b]
            h_lin = t_lin if h_lin is None else h_lin + t_lin
            h_ang = t_ang if h_ang is None else h_ang + t_ang
        h_j = []
        for j in range(nj):
            acc = None
            for b in range(nb):
                if j not in anc[b]:
                    continue
                t = _dot(jq[b][j], F[b]) + _dot(axw[j], Nb[b])
                acc = t if acc is None else acc + t
            h_j.append(acc)
        h_cor = jnp.concatenate(
            [h_lin, h_ang, jnp.stack(h_j)], axis=0
        )                                             # (18, B)


        # ---- mass matrix blocks (ops/dynamics.mass_matrix_from_parts) ----
        # Iwa[b][j] = Iw_b @ axw_j, shared by Mbj-bottom and Mjj
        Iwa = [dict() for _ in range(nb)]
        for b in range(1, nb):
            for j in anc[b]:
                Iwa[b][j] = _mv(Iw[b], axw[j])
        mr = r[0] * mass[0]
        for b in range(1, nb):
            mr = mr + r[b] * mass[b]
        # rot = sum m (|r|^2 I - r r^T) + sum Iw
        rot_off = None
        diag_acc = None
        for b in range(nb):
            rr = r[b][:, None, :] * r[b][None, :, :]
            t = Iw[b] - rr * mass[b]
            rot_off = t if rot_off is None else rot_off + t
            dd = _dot(r[b], r[b]) * mass[b]
            diag_acc = dd if diag_acc is None else diag_acc + dd
        zc = jnp.zeros_like(diag_acc)
        rot = rot_off + jnp.stack(
            [
                jnp.stack([diag_acc, zc, zc]),
                jnp.stack([zc, diag_acc, zc]),
                jnp.stack([zc, zc, diag_acc]),
            ]
        )
        tr_cols = []
        mid_cols = []
        for j in range(nj):
            acc_t = None
            acc_m = None
            for b in range(1, nb):
                if j not in anc[b]:
                    continue
                tt = jq[b][j] * mass[b]
                mm_ = _cross(r[b], jq[b][j]) * mass[b] + Iwa[b][j]
                acc_t = tt if acc_t is None else acc_t + tt
                acc_m = mm_ if acc_m is None else acc_m + mm_
            tr_cols.append(acc_t if acc_t is not None else _zeros((3,), p0))
            mid_cols.append(acc_m if acc_m is not None else _zeros((3,), p0))
        Mbj = jnp.concatenate(
            [jnp.stack(tr_cols, axis=1), jnp.stack(mid_cols, axis=1)],
            axis=0,
        )                                             # (6, nj, B)
        mjj_rows = []
        for j in range(nj):
            ent = []
            for k in range(nj):
                bl = jj_bodies.get((j, k))
                if bl is None:
                    ent.append(zc)
                    continue
                acc = None
                for b in bl:
                    t = _dot(jq[b][j], jq[b][k]) * mass[b] + _dot(
                        axw[j], Iwa[b][k]
                    )
                    acc = t if acc is None else acc + t
                ent.append(acc)
            mjj_rows.append(jnp.stack(ent))
        Mjj = jnp.stack(mjj_rows)                     # (nj, nj, B)

        sk_mr = _skew(mr)
        one = jnp.ones_like(zc)
        mtotI = jnp.stack(
            [
                jnp.stack([one * m_tot, zc, zc]),
                jnp.stack([zc, one * m_tot, zc]),
                jnp.stack([zc, zc, one * m_tot]),
            ]
        )
        Mb = jnp.concatenate(
            [
                jnp.concatenate([mtotI, -sk_mr], axis=1),
                jnp.concatenate([sk_mr, rot], axis=1),
            ],
            axis=0,
        )                                             # (6, 6, B)

        dMbj = dMb = None
        if exact_mode:
            # tangents of the base/base-joint mass blocks (Mjj's tangent is
            # never needed: only T and the foot Jacobians carry derivatives
            # into the QP)
            dIwa = [dict() for _ in range(nb)]
            for b in range(1, nb):
                for j in anc[b]:
                    dIwa[b][j] = _mv(dIw[b], axw[j]) + _mv(Iw[b], daxw[j])
            dmr = dr_[0] * mass[0]
            for b in range(1, nb):
                dmr = dmr + dr_[b] * mass[b]
            drot_off = None
            ddiag = None
            for b in range(nb):
                drr = (
                    dr_[b][:, None, :] * r[b][None, :, :]
                    + r[b][:, None, :] * dr_[b][None, :, :]
                )
                t = dIw[b] - drr * mass[b]
                drot_off = t if drot_off is None else drot_off + t
                dd = 2.0 * _dot(r[b], dr_[b]) * mass[b]
                ddiag = dd if ddiag is None else ddiag + dd
            drot = drot_off + jnp.stack(
                [
                    jnp.stack([ddiag, zc, zc]),
                    jnp.stack([zc, ddiag, zc]),
                    jnp.stack([zc, zc, ddiag]),
                ]
            )
            dtr_cols = []
            dmid_cols = []
            for j in range(nj):
                acc_t = None
                acc_m = None
                for b in range(1, nb):
                    if j not in anc[b]:
                        continue
                    tt = djq[b][j] * mass[b]
                    mm_ = (
                        _cross(dr_[b], jq[b][j]) + _cross(r[b], djq[b][j])
                    ) * mass[b] + dIwa[b][j]
                    acc_t = tt if acc_t is None else acc_t + tt
                    acc_m = mm_ if acc_m is None else acc_m + mm_
                dtr_cols.append(
                    acc_t if acc_t is not None else _zeros((3,), p0)
                )
                dmid_cols.append(
                    acc_m if acc_m is not None else _zeros((3,), p0)
                )
            dMbj = jnp.concatenate(
                [jnp.stack(dtr_cols, axis=1), jnp.stack(dmid_cols, axis=1)],
                axis=0,
            )
            dsk_mr = _skew(dmr)
            z33d = _zeros((3, 3), p0)
            dMb = jnp.concatenate(
                [
                    jnp.concatenate([z33d, -dsk_mr], axis=1),
                    jnp.concatenate([dsk_mr, drot], axis=1),
                ],
                axis=0,
            )

        # ---- Mb^{-1} via 3x3 Schur with the constant m I top block ----
        inv_m = 1.0 / m_tot
        S3 = rot + _mm(sk_mr, sk_mr) * inv_m
        S3inv = _inv3(S3)
        WS = _mm(sk_mr, S3inv) * (-inv_m)             # W @ S3inv
        TL = _mm(WS, _tr(sk_mr)) * (-inv_m)
        TL = TL + mtotI * (inv_m * inv_m)             # (1/m) I + W Sinv W^T
        Mb_inv = jnp.concatenate(
            [
                jnp.concatenate([TL, -WS], axis=1),
                jnp.concatenate([-_tr(WS), S3inv], axis=1),
            ],
            axis=0,
        )
        # X = Mb^{-1} Mbj with one refinement pass (centroidal_transform)
        X = _mm(Mb_inv, Mbj)
        X = X + _mm(Mb_inv, Mbj - _mm(Mb, X))         # (6, nj, B)
        dX = None
        if exact_mode:
            # tangent of X = Mb^{-1} Mbj:  dX = Mb^{-1} (dMbj - dMb X)
            dX = _mm(Mb_inv, dMbj - _mm(dMb, X))


        # ---- centroidal mass blocks ----
        MbX = _mm(Mb, X)
        mcjj_cols = [
            Mjj[:, j]
            - _mvt(Mbj, X[:, j])
            - _mvt(X, Mbj[:, j])
            + _mvt(X, MbX[:, j])
            for j in range(nj)
        ]
        Mc_jj = jnp.stack(mcjj_cols, axis=1)          # (nj, nj, B)

        def mm_adj_right(Y):
            """Y (p, 6, B) @ adj, adj = [[I, skew(d_com)], [0, I]].

            skew(d) columns: e0 -> (0, d2, -d1), e1 -> (-d2, 0, d0),
            e2 -> (d1, -d0, 0)."""
            d0c, d1c, d2c = d_com[0], d_com[1], d_com[2]
            cols = [Y[:, j] for j in range(3)]
            cols.append(Y[:, 3] + Y[:, 1] * d2c - Y[:, 2] * d1c)
            cols.append(Y[:, 4] - Y[:, 0] * d2c + Y[:, 2] * d0c)
            cols.append(Y[:, 5] + Y[:, 0] * d1c - Y[:, 1] * d0c)
            return jnp.stack(cols, axis=1)

        def mm_adjT_left(Y):
            """adj^T @ Y = [Y_top; Y_bot - skew(d_com) @ Y_top]."""
            top = Y[0:3]
            bot_cols = [
                Y[3:6, j] - _cross(d_com, Y[0:3, j])
                for j in range(Y.shape[1])
            ]
            return jnp.concatenate(
                [top, jnp.stack(bot_cols, axis=1)], axis=0
            )

        Mc_base = mm_adjT_left(mm_adj_right(Mb))      # (6, 6, B)

        # ---- T top rows: [adj_inv | adj_inv @ X] ----
        # (needs only X and d_com; lives before the bias block so the
        # exact mode can form the fresh Tdot^-1 the bias consumes)
        eye3 = jnp.stack(
            [
                jnp.stack([one, zc, zc]),
                jnp.stack([zc, one, zc]),
                jnp.stack([zc, zc, one]),
            ]
        )
        btop_cols = [
            X[0:3, j] - _cross(d_com, X[3:6, j]) for j in range(nj)
        ]
        B_blk = jnp.concatenate(
            [jnp.stack(btop_cols, axis=1), X[3:6]], axis=0
        )                                             # (6, nj, B)
        z33 = _zeros((3, 3), p0)
        adjinv6 = jnp.concatenate(
            [
                jnp.concatenate([eye3, -_skew(d_com)], axis=1),
                jnp.concatenate([z33, eye3], axis=1),
            ],
            axis=0,
        )
        T_top = jnp.concatenate([adjinv6, B_blk], axis=1)  # (6, 18, B)

        def tdinv_from_tdot(Tdot_top):
            """d(T^-1)/dt top rows = -[adj D1 adj | adj (D2 - D1 X)],
            [D1 | D2] = Tdot_top (shared by the FD and exact paths)."""
            D1 = Tdot_top[:, 0:6]
            D2 = Tdot_top[:, 6:18]
            adjD1 = jnp.concatenate(
                [
                    jnp.stack(
                        [
                            D1[0:3, j] + _cross(d_com, D1[3:6, j])
                            for j in range(6)
                        ],
                        axis=1,
                    ),
                    D1[3:6],
                ],
                axis=0,
            )
            adjD2 = jnp.concatenate(
                [
                    jnp.stack(
                        [
                            D2[0:3, j] + _cross(d_com, D2[3:6, j])
                            for j in range(nj)
                        ],
                        axis=1,
                    ),
                    D2[3:6],
                ],
                axis=0,
            )
            return -jnp.concatenate(
                [mm_adj_right(adjD1), adjD2 - _mm(adjD1, X)], axis=1
            )                                         # (6, 18, B)

        if exact_mode:
            # exact Tdot_top = d/dt [adj_inv | adj_inv X]: the adj_inv
            # block's tangent is [[0, -skew(dd_com)], [0, 0]] and the
            # B-block's tangent chains dX with dd_com
            dbtop_cols = [
                dX[0:3, j]
                - _cross(dd_com, X[3:6, j])
                - _cross(d_com, dX[3:6, j])
                for j in range(nj)
            ]
            dB_blk = jnp.concatenate(
                [jnp.stack(dbtop_cols, axis=1), dX[3:6]], axis=0
            )
            dadjinv6 = jnp.concatenate(
                [
                    jnp.concatenate([z33, -_skew(dd_com)], axis=1),
                    jnp.concatenate([z33, z33], axis=1),
                ],
                axis=0,
            )
            Tdot_exact = jnp.concatenate([dadjinv6, dB_blk], axis=1)
            tdnew_top = tdinv_from_tdot(Tdot_exact)
            # the exact mode feeds the FRESH Tdot^-1 into the bias
            # (wbc_setup's exact branch); the FD mode keeps the
            # reference's one-cycle-stale member read (cpp:289 vs 293)
            tdinv_top_used = tdnew_top
        else:
            tdinv_top_used = tdinv_ref[:]

        # ---- centroidal bias ----
        u18 = jnp.concatenate([bv, qd], axis=0)
        td_u = _mv(tdinv_top_used, u18)               # (6, B)
        Mtd = jnp.concatenate(
            [_mv(Mb, td_u), _mvt(Mbj, td_u)], axis=0
        )
        hMT = h_cor + Mtd
        h6 = hMT[0:6]
        h_c = jnp.concatenate(
            [
                h6[0:3],
                h6[3:6] - _cross(d_com, h6[0:3]),
                hMT[6:] - _mvt(X, h6),
            ],
            axis=0,
        )                                             # (18, B)


        # ---- foot kinematics + centroidal foot Jacobians ----
        fp = []
        jqf = []
        fvel = []
        dfp = []
        djqf = []
        for f in range(nl):
            fb = foot_body[f]
            pf = p[fb] + _const_mv(R[fb], foot_p[f])
            fp.append(pf)
            jf = {j: _cross(axw[j], pf - orgw[j]) for j in anc[fb]}
            jqf.append(jf)
            vf = bv[0:3] + _cross(om, pf - p0)
            for j in anc[fb]:
                vf = vf + qd[j] * jf[j]
            fvel.append(vf)
            if exact_mode:
                dpf = dp_[fb] + _const_mv(dR[fb], foot_p[f])
                dfp.append(dpf)
                djqf.append(
                    {
                        j: _cross(daxw[j], pf - orgw[j])
                        + _cross(axw[j], dpf - dorgw[j])
                        for j in anc[fb]
                    }
                )
        foot_pos = jnp.concatenate(fp, axis=0)        # (12, B)
        foot_vel = jnp.concatenate(fvel, axis=0)

        Jc_feet = []
        Jd_feet = []
        for f in range(nl):
            fb = foot_body[f]
            rel_b = fp[f] - p0
            # joint part: jq_f - ([I | -skew(rel_b)] @ X)
            jbx_cols = [
                X[0:3, j] - _cross(rel_b, X[3:6, j]) for j in range(nj)
            ]
            cols = []
            for j in range(nj):
                cj = -jbx_cols[j]
                if j in jqf[f]:
                    cj = cj + jqf[f][j]
                cols.append(cj)
            jpart = jnp.stack(cols, axis=1)           # (3, nj, B)
            relc = fp[f] - com
            nsk = -_skew(relc)                        # -skew(p_f - com)
            Jc_feet.append(
                jnp.concatenate([eye3, nsk, jpart], axis=1)
            )                                         # (3, 18, B)
            if exact_mode:
                # tangent of the foot Jacobian block, term by term
                drel_b = dfp[f] - dp_[0]
                drelc = dfp[f] - dcom
                djbx_cols = [
                    dX[0:3, j]
                    - _cross(drel_b, X[3:6, j])
                    - _cross(rel_b, dX[3:6, j])
                    for j in range(nj)
                ]
                dcols = []
                for j in range(nj):
                    dcj = -djbx_cols[j]
                    if j in djqf[f]:
                        dcj = dcj + djqf[f][j]
                    dcols.append(dcj)
                djpart = jnp.stack(dcols, axis=1)
                z33f = _zeros((3, 3), p0)
                Jd_feet.append(
                    jnp.concatenate(
                        [z33f, -_skew(drelc), djpart], axis=1
                    )
                )
        Jc_st = jnp.concatenate(
            [Jc_feet[f] * c_leg[f] for f in range(nl)], axis=0
        )                                             # (12, 18, B)
        Jc_sw = jnp.concatenate(
            [Jc_feet[f] * (1.0 - c_leg[f]) for f in range(nl)], axis=0
        )


        # ---- derivatives: analytic tangents (exact) or the reference's
        # one-cycle finite differences (cpp:384-402) ----
        if exact_mode:
            # contacts are constant within the linearization, so the
            # stance/swing masks pass straight through to the tangents;
            # no history => no switch gating (wbc_setup exact branch)
            Jd_st = jnp.concatenate(
                [Jd_feet[f] * c_leg[f] for f in range(nl)], axis=0
            )
            Jd_sw = jnp.concatenate(
                [Jd_feet[f] * (1.0 - c_leg[f]) for f in range(nl)], axis=0
            )
            # tdnew_top (exact) was already formed before the bias block
        else:
            bad_f = switch_f + (1.0 - derivv_ref[0])  # >0.5: switch/!deriv
            gate = jnp.where(bad_f > 0.5, 0.0, 1.0)[None, None, :]
            inv_dt = 1.0 / dt
            Tdot_top = gate * (T_top - oldT_ref[:]) * inv_dt
            Jd_st = gate * (Jc_st - oldJst_ref[:]) * inv_dt
            Jd_sw = gate * (Jc_sw - oldJsw_ref[:]) * inv_dt
            tdnew_top = tdinv_from_tdot(Tdot_top)


        # ---- desired wrench (cpp:426-445) ----
        rpy = rpy_ref[:]
        current_pose = jnp.concatenate([com, rpy], axis=0)
        pose_err = current_pose - rpose_ref[:]
        gravw = jnp.stack([zc, zc, one * mg, zc, zc, zc])
        kp_arr = jnp.stack(
            [jnp.full_like(zc, kp_diag[i]) for i in range(6)]
        )
        w_des = (
            -kp_arr * pose_err
            - params.kd * (com_vel6 - rvel_ref[:])
            - params.ki * integ_ref[:]
            + gravw
            + _mv(Mc_base, racc_ref[:])
        )
        integ_new = integ_ref[:] + pose_err * dt

        # ---- swing commanded accelerations (cpp:447-464) ----
        a_cmd = (
            sacc_ref[:]
            + params.kd_swing * (svel_ref[:] - foot_vel)
            + params.kp_swing * (spos_ref[:] - foot_pos)
        )
        a_cmd = jnp.concatenate(
            [
                a_cmd[3 * f : 3 * f + 3] * (1.0 - c_leg[f])
                for f in range(nl)
            ],
            axis=0,
        )

        # ---- QP assembly (cpp:466-515) ----
        Jst_com = Jc_st[:, 0:6]                       # (12, 6, B)
        Jst_j = Jc_st[:, 6:18]
        Hblk_v = jnp.stack(
            [_mv(Jst_com, Jst_com[j]) for j in range(12)], axis=1
        )
        Hblk_ref[:] = Hblk_v
        g_blk = -_mv(Jst_com, w_des)
        g_v = jnp.concatenate(
            [_zeros((18,), p0), g_blk, _zeros((12,), p0)], axis=0
        )
        g_ref[:] = g_v

        neg_JstcomT = jnp.stack(
            [-Jst_com[:, i] for i in range(6)], axis=0
        )                                             # (6, 12, B)
        neg_JstjT = jnp.stack(
            [-Jst_j[:, i] for i in range(12)], axis=0
        )                                             # (12, 12, B)
        rb1 = jnp.concatenate(
            [Mc_base, _zeros((6, 12), p0), neg_JstcomT,
             _zeros((6, 12), p0)],
            axis=1,
        )
        rb2 = jnp.concatenate([Jc_st, _zeros((12, 24), p0)], axis=1)
        fr_blocks = []
        for f in range(nl):
            cf = c_leg[f]
            blk = jnp.stack(
                [
                    jnp.stack([cf, zc, -mu * cf]),
                    jnp.stack([-cf, zc, -mu * cf]),
                    jnp.stack([zc, cf, -mu * cf]),
                    jnp.stack([zc, -cf, -mu * cf]),
                ]
            )                                         # (4, 3, B)
            pre = _zeros((4, 3 * f), p0)
            post = _zeros((4, 9 - 3 * f), p0)
            fr_blocks.append(
                jnp.concatenate([pre, blk, post], axis=1)
                if 0 < 3 * f < 9
                else jnp.concatenate(
                    ([blk, post] if f == 0 else [pre, blk]), axis=1
                )
            )
        Dfr = jnp.concatenate(fr_blocks, axis=0)      # (16, 12, B)
        rb3 = jnp.concatenate(
            [_zeros((16, 18), p0), Dfr, _zeros((16, 12), p0)], axis=1
        )
        rb4 = jnp.concatenate(
            [_zeros((12, 6), p0), Mc_jj, neg_JstjT, _zeros((12, 12), p0)],
            axis=1,
        )
        i0 = jax.lax.broadcasted_iota(jnp.int32, (12, 12, p0.shape[-1]), 0)
        i1 = jax.lax.broadcasted_iota(jnp.int32, (12, 12, p0.shape[-1]), 1)
        eye12 = jnp.where(i0 == i1, 1.0, 0.0).astype(p0.dtype)
        rb5 = jnp.concatenate([Jc_sw, _zeros((12, 12), p0), -eye12], axis=1)
        rb6 = jnp.concatenate([Jc_sw, _zeros((12, 12), p0), eye12], axis=1)
        A_v = jnp.concatenate([rb1, rb2, rb3, rb4, rb5, rb6], axis=0)
        A_ref[:] = A_v

        vel_c = jnp.concatenate([com_vel6, qd], axis=0)
        stance_rhs = -_mv(Jd_st, vel_c)
        swing_rhs = a_cmd - _mv(Jd_sw, vel_c)
        tau_hi = params.max_torque - h_c[6:]
        tau_lo = -params.max_torque - h_c[6:]
        inf_12 = jnp.broadcast_to(
            jnp.full_like(zc, inf)[None, :], (12, zc.shape[-1])
        )
        inf_16 = jnp.broadcast_to(
            jnp.full_like(zc, inf)[None, :], (16, zc.shape[-1])
        )
        ub_v = jnp.concatenate(
            [-gravw, stance_rhs, _zeros((16,), p0), tau_hi, swing_rhs,
             inf_12],
            axis=0,
        )
        ub_ref[:] = ub_v
        lb_v = jnp.concatenate(
            [-gravw, stance_rhs, -inf_16, tau_lo, -inf_12, swing_rhs],
            axis=0,
        )
        lb_ref[:] = lb_v

        # ---- aux outputs / carry updates ----
        hc_ref[:] = h_c
        com_ref[:] = com
        fpos_ref[:] = foot_pos
        Ttop_ref[:] = T_top
        tdnew_ref[:] = tdnew_top
        intego_ref[:] = integ_new
        prevco_ref[:] = contacts
        swo_ref[:] = switch_f[None, :]
        # locals for the optional fused-prepare epilogue
        return dict(A=A_v, g=g_v, lb=lb_v, ub=ub_v, Hblk=Hblk_v,
                    switch_f=switch_f)

    if qp_params is None:
        def plain(*refs):
            body(*refs)

        return plain

    sw_weight = float(params.slack_weight)
    sweeps = int(qp_params.scaling_iters)
    rho0 = float(qp_params.rho)
    rho_eq = float(qp_params.rho) * float(qp_params.rho_eq_scale)

    def fused(*refs):
        """body inputs + (wx, wz, wy), then body outputs +
        (sH, sA, sg, sl, su, rho, wxs, wzs, wys, d, e)."""
        core_in = refs[:23]
        wx_ref, wz_ref, wy_ref = refs[23:26]
        core_out = refs[26:39]
        (sH_ref, sA_ref, sg_ref, sl_ref, su_ref, rho_ref,
         wxs_ref, wzs_ref, wys_ref, d_ref, e_ref) = refs[39:]
        vals = body(*core_in, *core_out)
        A = vals["A"]                # (m, n, B)
        g = vals["g"]
        lb = vals["lb"]
        ub = vals["ub"]
        Hblk = vals["Hblk"]          # (12, 12, B)
        Bt_ = A.shape[-1]
        dtype = A.dtype

        def eye(k):
            i0 = jax.lax.broadcasted_iota(jnp.int32, (k, k, Bt_), 0)
            i1 = jax.lax.broadcasted_iota(jnp.int32, (k, k, Bt_), 1)
            return jnp.where(i0 == i1, 1.0, 0.0).astype(dtype)

        z = lambda r, c: jnp.zeros((r, c, Bt_), dtype)
        # H = diag(R) + pad(Hblk): identity vars, GRF block + I, slack diag
        # (the same assembly the wrapper does in XLA for the unscaled H)
        H = jnp.concatenate(
            [
                jnp.concatenate([eye(18), z(18, 24)], axis=1),
                jnp.concatenate([z(12, 18), Hblk + eye(12), z(12, 12)],
                                axis=1),
                jnp.concatenate([z(12, 30), sw_weight * eye(12)], axis=1),
            ],
            axis=0,
        )                            # (n, n, B)

        d, e = ruiz_scalings(H, A, sweeps)

        sH_ref[:] = H * d[None, :, :] * d[:, None, :]
        sA_ref[:] = A * e[:, None, :] * d[None, :, :]
        sg_ref[:] = d * g
        sl_ref[:] = e * lb
        su_ref[:] = e * ub
        # equality detection on the UNSCALED bounds (ops/prepare.py)
        eq = (ub - lb) <= 1e-9
        rho_ref[:] = jnp.where(eq, rho_eq, rho0).astype(dtype)
        # contact-switch warm masking (control/wbc._switch_masked_warm):
        # keep the primal, drop z/y whose rows were re-masked
        keep = (1.0 - vals["switch_f"])[None, :]
        wxs_ref[:] = wx_ref[:] / d
        wzs_ref[:] = wz_ref[:] * keep * e
        wys_ref[:] = wy_ref[:] * keep / e
        d_ref[:] = d
        e_ref[:] = e

    return fused


class _Ref:
    """Array stand-in for a ref of the generated body: reads `r[:]` /
    `r[0]`, and one whole-array write `r[:] = v`."""

    __slots__ = ("value",)

    def __init__(self, value=None):
        self.value = value

    def __getitem__(self, idx):
        return self.value[idx]

    def __setitem__(self, idx, value):
        assert idx == slice(None), idx
        self.value = value


@functools.partial(
    jax.jit,
    static_argnames=("const_arrays", "params", "qp_params", "prep_layout",
                     "exact_mode"),
)
def _setup_call(const_arrays, params, R0, p0, bv, qd, sq, cq, rpy,
                rpose, rvel, racc, spos, svel, sacc, rcon,
                oldT_top, oldJst, oldJsw, tdinv_top, integ, prevc,
                swflag, derivv, refnew, wx=None, wz=None, wy=None,
                *, qp_params=None, prep_layout="major", exact_mode=False):
    """Batch-major wrapper (const_arrays: hashable tuple-of-tuples): runs
    the generated body on the whole batch-minor (dims..., B) arrays.

    With qp_params (and warm wx/wz/wy), the fused-prepare variant
    additionally returns the Ruiz-scaled problem.  prep_layout="minor"
    keeps THOSE outputs batch-minor — the batch-minor solve chain consumes
    them directly."""
    const = _unpack_const(const_arrays)
    dtype = p0.dtype
    to_minor = lambda a: jnp.moveaxis(a, 0, -1)
    args = [R0, p0, bv, qd, sq, cq, rpy, rpose, rvel, racc, spos, svel,
            sacc, rcon, oldT_top, oldJst, oldJsw, tdinv_top, integ, prevc,
            swflag, derivv, refnew]
    n_out = 13
    if qp_params is not None:
        args += [wx, wz, wy]
        n_out += 11
    outs = [_Ref() for _ in range(n_out)]
    _make_body(const, params, qp_params, exact_mode)(
        *(_Ref(to_minor(a)) for a in args), *outs
    )
    outs = [o.value.astype(dtype) for o in outs]
    back = lambda a: jnp.moveaxis(a, -1, 0)
    if qp_params is not None and prep_layout == "minor":
        # append batch-minor copies of the unscaled A/g/l/u (outs 0..3) so
        # the polish skips their transposes
        return (tuple(back(o) for o in outs[:13]) + tuple(outs[13:])
                + tuple(outs[:4]))
    return tuple(back(o) for o in outs)


def _pack_const(model):
    """Static, hashable model-constant pack (tuples of floats)."""

    def tup(x):
        return tuple(map(tuple, np.asarray(x).reshape(np.asarray(x).shape[0], -1).tolist()))

    return (
        tuple(model.parent),
        tup(model.joint_R), tup(model.joint_p), tup(model.joint_axis),
        tuple(np.asarray(model.mass).tolist()),
        tup(model.com), tup(model.inertia),
        tuple(model.frame_body), tup(model.frame_p),
    )


def _unpack_const(packed):
    (parent, jR, jp, jaxis, mass, com, inertia, fb, fp) = packed
    nj = len(jR)
    nb = len(mass)
    return dict(
        parent=parent,
        joint_R=np.asarray(jR, np.float64).reshape(nj, 3, 3),
        joint_p=np.asarray(jp, np.float64).reshape(nj, 3),
        joint_axis=np.asarray(jaxis, np.float64).reshape(nj, 3),
        mass=np.asarray(mass, np.float64),
        com=np.asarray(com, np.float64).reshape(nb, 3),
        inertia=np.asarray(inertia, np.float64).reshape(nb, 3, 3),
        frame_body=fb,
        frame_p=np.asarray(fp, np.float64).reshape(len(fb), 3),
    )


def setup_batched(model, params, obs, ref, carry, ref_is_new,
                  qp_params=None, prepared_layout="major", exact_mode=False):
    """Fused replacement for vmap(wbc_setup) (batch-major API).

    Returns the same pieces as control/wbc.WBCSetup, as a dict:
    qp H/g/A/l/u plus h_c, Mc_jj, Jc_st_j, com, current_pose, foot_pos and
    the carry_updates dict.  By default it computes the reference-faithful
    finite-difference derivative path; exact_mode=True carries the
    analytic tangent propagation through the same unrolled recursion
    (jvp-exact Tdot/Jdot + fresh Tdot^-1 in the bias — equivalent to
    wbc_setup's exact_derivatives branch, pinned in f64 by
    tests/test_exact_derivatives.py).  The XLA jvp epilogue
    (control/wbc._exact_epilogue_batched) remains as the independent
    oracle / fallback.

    With qp_params (QPSolverParams), the QP prepare stage (Ruiz + scaling,
    ops/prepare.py) runs in the same program using carry.qp_warm (with the
    contact-switch masking of control/wbc._switch_masked_warm); the result
    dict gains a "prepared" tuple for ops/qp.solve_batched(prepared=...)
    and, with prepared_layout="minor", a "tiles_minor" dict of batch-minor
    unscaled A/g/l/u."""
    from quadrupedwholebodycontroller.ops import spatial

    B = obs.q.shape[0]
    dtype = obs.base_p.dtype
    packed = _pack_const(model)

    ref_is_new_b = jnp.broadcast_to(
        jnp.asarray(ref_is_new), (B,)
    ).astype(dtype)
    sq = jnp.sin(obs.q)
    cq = jnp.cos(obs.q)
    rpy = spatial.matrix_to_rpy(obs.base_R)

    warm_args = ()
    if qp_params is not None:
        warm_args = (carry.qp_warm.x, carry.qp_warm.z, carry.qp_warm.y)
    outs = _setup_call(
        packed, params,
        obs.base_R, obs.base_p, obs.base_vel, obs.qd, sq, cq, rpy,
        ref.com_pose, ref.com_vel, ref.com_acc,
        ref.swing_pos, ref.swing_vel, ref.swing_acc,
        ref.contacts.astype(dtype),
        carry.old_T[:, 0:6, :], carry.old_J_st, carry.old_J_sw,
        carry.tdot_inv[:, 0:6, :], carry.integral_error,
        carry.prev_contacts.astype(dtype),
        carry.switch_flag.astype(dtype)[:, None],
        carry.deriv_valid.astype(dtype)[:, None],
        ref_is_new_b[:, None],
        *warm_args,
        qp_params=qp_params,
        prep_layout=prepared_layout,
        exact_mode=exact_mode,
    )
    prepared = None
    tiles_minor = None
    if qp_params is not None:
        if prepared_layout == "minor":
            outs, prep, raw = outs[:13], outs[13:24], outs[24:]
            tiles_minor = dict(A=raw[0], g=raw[1], l=raw[2], u=raw[3])
        else:
            outs, prep = outs[:13], outs[13:]
        prepared = tuple(prep)
    (A, g, lb, ub, Hblk, h_c, com, foot_pos, T_top, tdnew_top, integ_new,
     prevc_new, sw) = outs

    n = QP_NUM_VARS
    R_diag = jnp.ones((n,), dtype).at[30:42].set(params.slack_weight)
    H = jnp.pad(Hblk, ((0, 0), (18, 12), (18, 12))) + jnp.diag(R_diag)[None]

    bottom_T = jnp.concatenate(
        [jnp.zeros((NUM_JOINTS, 6), dtype), jnp.eye(NUM_JOINTS, dtype=dtype)],
        axis=1,
    )
    old_T = jnp.concatenate(
        [T_top, jnp.broadcast_to(bottom_T, (B, NUM_JOINTS, NV))], axis=1
    )
    tdot_inv = jnp.concatenate(
        [tdnew_top, jnp.zeros((B, NUM_JOINTS, NV), dtype)], axis=1
    )
    rpy_pose = jnp.concatenate([com, rpy], axis=-1)
    return dict(
        H=H, g=g, A=A, l=lb, u=ub, prepared=prepared,
        tiles_minor=tiles_minor,
        h_c=h_c,
        Mc_jj=A[:, 34:46, 6:18],
        Jc_st_j=A[:, 6:18, 6:18],
        com=com,
        current_pose=rpy_pose,
        foot_pos=foot_pos,
        carry_updates=dict(
            old_T=old_T,
            old_J_st=A[:, 6:18, 0:18],
            old_J_sw=A[:, 46:58, 0:18],
            tdot_inv=tdot_inv,
            integral_error=integ_new,
            prev_contacts=prevc_new,
            switch_flag=sw[:, 0] > 0.5,
            deriv_valid=jnp.ones((B,), bool),
        ),
    )

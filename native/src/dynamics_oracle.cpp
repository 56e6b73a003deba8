// Native dynamics oracle: an INDEPENDENT implementation of the floating-base
// mass matrix and Coriolis bias used to cross-validate the JAX engine.
//
// The JAX engine (quadrupedwholebodycontroller/ops/dynamics.py) computes
// M via CoM-Jacobian Gram sums and the bias via virtual work + autodiff
// velocity-product accelerations.  This oracle uses the classical
// Featherstone spatial-algebra route instead — CRBA and RNEA in body
// coordinates ([omega; v] ordering), then an exact change of basis to the
// mixed representation ([v_world; omega_world; qdot]) — so agreement to
// ~1e-10 validates both against implementation error.  It plays the role
// iDynTree plays for the reference controller
// (/root/reference/src/whole_body_controller.cpp:256-294) as a trusted
// CPU-side dynamics library, but is first-party C++ with no dependencies.
//
// Model layout (passed as flat arrays, same data as the qrm-v1 JSON spec):
//   nb bodies, body 0 = floating base, body i>0 attached by revolute joint
//   i-1 to parent[i] with joint frame (R, p) in the parent body frame and a
//   rotation axis in the joint frame.
#include <cmath>
#include <cstring>

namespace {

constexpr int kMaxBodies = 32;

struct Mat3 {
  double a[9];
  static Mat3 identity() {
    Mat3 m{};
    m.a[0] = m.a[4] = m.a[8] = 1.0;
    return m;
  }
};

struct Vec3 {
  double v[3];
};

inline Vec3 vec3(double x, double y, double z) { return Vec3{{x, y, z}}; }

inline Mat3 mul(const Mat3& A, const Mat3& B) {
  Mat3 C{};
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      double s = 0;
      for (int k = 0; k < 3; ++k) s += A.a[3 * i + k] * B.a[3 * k + j];
      C.a[3 * i + j] = s;
    }
  return C;
}

inline Vec3 mul(const Mat3& A, const Vec3& x) {
  Vec3 y{};
  for (int i = 0; i < 3; ++i)
    y.v[i] = A.a[3 * i] * x.v[0] + A.a[3 * i + 1] * x.v[1] + A.a[3 * i + 2] * x.v[2];
  return y;
}

inline Mat3 transpose(const Mat3& A) {
  Mat3 T{};
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) T.a[3 * i + j] = A.a[3 * j + i];
  return T;
}

inline Vec3 cross(const Vec3& a, const Vec3& b) {
  return vec3(a.v[1] * b.v[2] - a.v[2] * b.v[1],
              a.v[2] * b.v[0] - a.v[0] * b.v[2],
              a.v[0] * b.v[1] - a.v[1] * b.v[0]);
}

inline Mat3 skew(const Vec3& v) {
  Mat3 S{};
  S.a[1] = -v.v[2]; S.a[2] = v.v[1];
  S.a[3] = v.v[2];  S.a[5] = -v.v[0];
  S.a[6] = -v.v[1]; S.a[7] = v.v[0];
  return S;
}

inline Mat3 axis_angle(const Vec3& axis, double q) {
  // Rodrigues for unit axis
  Mat3 K = skew(axis);
  Mat3 K2 = mul(K, K);
  double c = std::cos(q), s = std::sin(q);
  Mat3 R = Mat3::identity();
  for (int i = 0; i < 9; ++i) R.a[i] += s * K.a[i] + (1.0 - c) * K2.a[i];
  return R;
}

// 6D spatial vectors, Featherstone ordering [angular(3); linear(3)].
struct SVec {
  double v[6];
};

// Plucker motion transform child <- parent, stored as (E = R_pc^T, p = p_pc).
//   v_child = [E, 0; -E*skew(p), E] v_parent
struct XForm {
  Mat3 E;
  Vec3 p;
};

inline SVec apply(const XForm& X, const SVec& m) {
  Vec3 w{{m.v[0], m.v[1], m.v[2]}};
  Vec3 l{{m.v[3], m.v[4], m.v[5]}};
  Vec3 wc = mul(X.E, w);
  Vec3 tmp = cross(X.p, w);
  Vec3 lc = mul(X.E, vec3(l.v[0] - tmp.v[0], l.v[1] - tmp.v[1], l.v[2] - tmp.v[2]));
  // note: -E*skew(p)*w = E*(l - p x w) handled above
  SVec out{};
  for (int i = 0; i < 3; ++i) { out.v[i] = wc.v[i]; out.v[3 + i] = lc.v[i]; }
  return out;
}

// Force transform parent <- child: f_p = X^T f_c (X the motion transform).
inline SVec apply_T(const XForm& X, const SVec& f) {
  Vec3 n{{f.v[0], f.v[1], f.v[2]}};
  Vec3 fl{{f.v[3], f.v[4], f.v[5]}};
  Mat3 Et = transpose(X.E);
  Vec3 np = mul(Et, n);
  Vec3 fp = mul(Et, fl);
  Vec3 pc = cross(X.p, fp);
  SVec out{};
  for (int i = 0; i < 3; ++i) {
    out.v[i] = np.v[i] + pc.v[i];
    out.v[3 + i] = fp.v[i];
  }
  return out;
}

// motion cross product: (v x) m
inline SVec crm(const SVec& v, const SVec& m) {
  Vec3 w{{v.v[0], v.v[1], v.v[2]}}, l{{v.v[3], v.v[4], v.v[5]}};
  Vec3 mw{{m.v[0], m.v[1], m.v[2]}}, ml{{m.v[3], m.v[4], m.v[5]}};
  Vec3 ow = cross(w, mw);
  Vec3 c1 = cross(l, mw);
  Vec3 c2 = cross(w, ml);
  SVec out{};
  for (int i = 0; i < 3; ++i) {
    out.v[i] = ow.v[i];
    out.v[3 + i] = c1.v[i] + c2.v[i];
  }
  return out;
}

// force cross product: (v x*) f
inline SVec crf(const SVec& v, const SVec& f) {
  Vec3 w{{v.v[0], v.v[1], v.v[2]}}, l{{v.v[3], v.v[4], v.v[5]}};
  Vec3 fn{{f.v[0], f.v[1], f.v[2]}}, fl{{f.v[3], f.v[4], f.v[5]}};
  Vec3 n = cross(w, fn);
  Vec3 n2 = cross(l, fl);
  Vec3 ff = cross(w, fl);
  SVec out{};
  for (int i = 0; i < 3; ++i) {
    out.v[i] = n.v[i] + n2.v[i];
    out.v[3 + i] = ff.v[i];
  }
  return out;
}

// 6x6 spatial inertia in body coords: I = [[Ic - m cx cx, m cx], [-m cx, m 1]]
struct SInertia {
  double m;
  Vec3 c;     // CoM offset in body frame
  Mat3 Ic;    // inertia about CoM, body frame
};

inline SVec apply(const SInertia& I, const SVec& v) {
  Vec3 w{{v.v[0], v.v[1], v.v[2]}}, l{{v.v[3], v.v[4], v.v[5]}};
  // h_ang = Ic w + c x (m (l + w x c))?? derive: momentum about origin:
  //   lin = m (l - c x w)... careful: v_com = l + w x c
  Vec3 vcom = vec3(l.v[0] + w.v[1] * I.c.v[2] - w.v[2] * I.c.v[1],
                   l.v[1] + w.v[2] * I.c.v[0] - w.v[0] * I.c.v[2],
                   l.v[2] + w.v[0] * I.c.v[1] - w.v[1] * I.c.v[0]);
  Vec3 plin = vec3(I.m * vcom.v[0], I.m * vcom.v[1], I.m * vcom.v[2]);
  Vec3 hcom = mul(I.Ic, w);
  Vec3 cxp = cross(I.c, plin);
  SVec out{};
  for (int i = 0; i < 3; ++i) {
    out.v[i] = hcom.v[i] + cxp.v[i];
    out.v[3 + i] = plin.v[i];
  }
  return out;
}

// dense 6x6 of the spatial inertia (for CRBA composites)
inline void to_matrix(const SInertia& I, double M[36]) {
  Mat3 cx = skew(I.c);
  Mat3 cxcx = mul(cx, cx);
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      M[6 * i + j] = I.Ic.a[3 * i + j] - I.m * cxcx.a[3 * i + j];
      M[6 * i + (j + 3)] = I.m * cx.a[3 * i + j];
      M[6 * (i + 3) + j] = -I.m * cx.a[3 * i + j];
      M[6 * (i + 3) + (j + 3)] = (i == j) ? I.m : 0.0;
    }
}

// C = X^T A X for 6x6 A (force-motion congruence used by CRBA composites)
inline void congruence(const XForm& X, const double A[36], double C[36]) {
  // Build dense 6x6 motion transform
  double Xd[36];
  Mat3 EpS = mul(X.E, skew(X.p));
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      Xd[6 * i + j] = X.E.a[3 * i + j];
      Xd[6 * i + (j + 3)] = 0.0;
      Xd[6 * (i + 3) + j] = -EpS.a[3 * i + j];
      Xd[6 * (i + 3) + (j + 3)] = X.E.a[3 * i + j];
    }
  double T[36];
  for (int i = 0; i < 6; ++i)
    for (int j = 0; j < 6; ++j) {
      double s = 0;
      for (int k = 0; k < 6; ++k) s += A[6 * i + k] * Xd[6 * k + j];
      T[6 * i + j] = s;
    }
  for (int i = 0; i < 6; ++i)
    for (int j = 0; j < 6; ++j) {
      double s = 0;
      for (int k = 0; k < 6; ++k) s += Xd[6 * k + i] * T[6 * k + j];
      C[6 * i + j] = s;
    }
}

struct Model {
  int nb;
  int parent[kMaxBodies];
  Mat3 jR[kMaxBodies];   // joint frame rotation in parent frame (joint i-1)
  Vec3 jp[kMaxBodies];
  Vec3 axis[kMaxBodies];
  SInertia I[kMaxBodies];
};

void build_model(int nb, const int* parent, const double* joint_R,
                 const double* joint_p, const double* joint_axis,
                 const double* mass, const double* com, const double* inertia,
                 Model* mdl) {
  mdl->nb = nb;
  for (int b = 0; b < nb; ++b) {
    mdl->parent[b] = parent[b];
    mdl->I[b].m = mass[b];
    std::memcpy(mdl->I[b].c.v, com + 3 * b, 3 * sizeof(double));
    std::memcpy(mdl->I[b].Ic.a, inertia + 9 * b, 9 * sizeof(double));
    if (b > 0) {
      std::memcpy(mdl->jR[b].a, joint_R + 9 * (b - 1), 9 * sizeof(double));
      std::memcpy(mdl->jp[b].v, joint_p + 3 * (b - 1), 3 * sizeof(double));
      std::memcpy(mdl->axis[b].v, joint_axis + 3 * (b - 1), 3 * sizeof(double));
    }
  }
}

// Mixed-representation mass matrix (nv x nv, row-major) and Coriolis-only
// bias (nv), nv = 6 + (nb-1) — shared by the extern entry points.
void mass_and_bias_impl(const Model& mdl, const double* base_R, const double* q,
                        const double* u, double* M_out, double* h_out) {
  const int nb = mdl.nb;
  const int nj = nb - 1;
  const int nv = 6 + nj;

  Mat3 Rw;  // base orientation
  std::memcpy(Rw.a, base_R, 9 * sizeof(double));
  Mat3 RwT = transpose(Rw);

  // --- base velocity in Featherstone base coords [omega_b; v_b] ---
  Vec3 v_w = vec3(u[0], u[1], u[2]);
  Vec3 w_w = vec3(u[3], u[4], u[5]);
  SVec v0{};
  {
    Vec3 wb = mul(RwT, w_w);
    Vec3 vb = mul(RwT, v_w);
    for (int i = 0; i < 3; ++i) { v0.v[i] = wb.v[i]; v0.v[3 + i] = vb.v[i]; }
  }

  // --- joint transforms and velocity propagation ---
  XForm X[kMaxBodies];       // child <- parent
  SVec vbod[kMaxBodies];     // body spatial velocity, body coords
  SVec Sj[kMaxBodies];       // joint motion subspace in child coords
  vbod[0] = v0;
  for (int b = 1; b < nb; ++b) {
    Mat3 R_pc = mul(mdl.jR[b], axis_angle(mdl.axis[b], q[b - 1]));
    X[b].E = transpose(R_pc);
    X[b].p = mdl.jp[b];
    SVec vp = apply(X[b], vbod[mdl.parent[b]]);
    SVec S{};
    for (int i = 0; i < 3; ++i) S.v[i] = mdl.axis[b].v[i];
    Sj[b] = S;
    for (int i = 0; i < 6; ++i) vbod[b].v[i] = vp.v[i] + S.v[i] * u[6 + (b - 1)];
  }

  // ================= RNEA bias (udot = 0, no gravity) =================
  SVec abod[kMaxBodies];
  SVec fbod[kMaxBodies];
  abod[0] = SVec{};  // base acceleration zero (bias computation)
  for (int b = 1; b < nb; ++b) {
    SVec ap = apply(X[b], abod[mdl.parent[b]]);
    SVec Sqd{};
    for (int i = 0; i < 6; ++i) Sqd.v[i] = Sj[b].v[i] * u[6 + (b - 1)];
    SVec vx = crm(vbod[b], Sqd);
    for (int i = 0; i < 6; ++i) abod[b].v[i] = ap.v[i] + vx.v[i];
  }
  for (int b = 0; b < nb; ++b) {
    SVec Ia = apply(mdl.I[b], abod[b]);
    SVec Iv = apply(mdl.I[b], vbod[b]);
    SVec vf = crf(vbod[b], Iv);
    for (int i = 0; i < 6; ++i) fbod[b].v[i] = Ia.v[i] + vf.v[i];
  }
  double hB[6 + kMaxBodies];  // Featherstone-ordered bias [base6; joints]
  for (int b = nb - 1; b >= 1; --b) {
    double dot = 0;
    for (int i = 0; i < 6; ++i) dot += Sj[b].v[i] * fbod[b].v[i];
    hB[6 + (b - 1)] = dot;
    SVec fp = apply_T(X[b], fbod[b]);
    for (int i = 0; i < 6; ++i) fbod[mdl.parent[b]].v[i] += fp.v[i];
  }
  for (int i = 0; i < 6; ++i) hB[i] = fbod[0].v[i];

  // ================= CRBA mass matrix =================
  double Ic[kMaxBodies][36];
  for (int b = 0; b < nb; ++b) to_matrix(mdl.I[b], Ic[b]);
  for (int b = nb - 1; b >= 1; --b) {
    double C[36];
    congruence(X[b], Ic[b], C);
    for (int i = 0; i < 36; ++i) Ic[mdl.parent[b]][i] += C[i];
  }
  // Featherstone-ordered MB: [base 6; joints], base block = composite
  double MB[(6 + kMaxBodies) * (6 + kMaxBodies)];
  std::memset(MB, 0, sizeof(MB));
  const int nB = nv;
  for (int i = 0; i < 6; ++i)
    for (int j = 0; j < 6; ++j) MB[nB * i + j] = Ic[0][6 * i + j];
  for (int b = 1; b < nb; ++b) {
    // F = Ic_b S_b, propagate to ancestors
    SVec F{};
    for (int i = 0; i < 6; ++i) {
      double s = 0;
      for (int k = 0; k < 6; ++k) s += Ic[b][6 * i + k] * Sj[b].v[k];
      F.v[i] = s;
    }
    {
      double dot = 0;
      for (int i = 0; i < 6; ++i) dot += Sj[b].v[i] * F.v[i];
      MB[nB * (6 + b - 1) + (6 + b - 1)] = dot;
    }
    int j = b;
    SVec Fc = F;
    while (mdl.parent[j] != 0) {
      Fc = apply_T(X[j], Fc);
      j = mdl.parent[j];
      double dot = 0;
      for (int i = 0; i < 6; ++i) dot += Sj[j].v[i] * Fc.v[i];
      MB[nB * (6 + b - 1) + (6 + j - 1)] = dot;
      MB[nB * (6 + j - 1) + (6 + b - 1)] = dot;
    }
    Fc = apply_T(X[j], Fc);  // into base coords
    for (int i = 0; i < 6; ++i) {
      MB[nB * i + (6 + b - 1)] = Fc.v[i];
      MB[nB * (6 + b - 1) + i] = Fc.v[i];
    }
  }

  // ================= change of basis to mixed =================
  // u_B = P u_m,  P = [[0, R^T, 0], [R^T, 0, 0], [0, 0, I]]
  // M_m = P^T M_B P ;  h_m = P^T (h_B + M_B Pdot u_m)
  double P[(6 + kMaxBodies) * (6 + kMaxBodies)];
  double Pd[(6 + kMaxBodies) * (6 + kMaxBodies)];
  std::memset(P, 0, sizeof(P));
  std::memset(Pd, 0, sizeof(Pd));
  Mat3 wx = skew(w_w);
  Mat3 Rdot = mul(wx, Rw);
  Mat3 RdT = transpose(Rdot);
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      P[nB * i + (3 + j)] = RwT.a[3 * i + j];
      P[nB * (3 + i) + j] = RwT.a[3 * i + j];
      Pd[nB * i + (3 + j)] = RdT.a[3 * i + j];
      Pd[nB * (3 + i) + j] = RdT.a[3 * i + j];
    }
  for (int k = 6; k < nv; ++k) P[nB * k + k] = 1.0;

  // h_m
  double Pdu[6 + kMaxBodies];
  for (int i = 0; i < nv; ++i) {
    double s = 0;
    for (int k = 0; k < nv; ++k) s += Pd[nB * i + k] * u[k];
    Pdu[i] = s;
  }
  double MPdu[6 + kMaxBodies];
  for (int i = 0; i < nv; ++i) {
    double s = 0;
    for (int k = 0; k < nv; ++k) s += MB[nB * i + k] * Pdu[k];
    MPdu[i] = s;
  }
  for (int i = 0; i < nv; ++i) {
    double s = 0;
    for (int k = 0; k < nv; ++k) s += P[nB * k + i] * (hB[k] + MPdu[k]);
    h_out[i] = s;
  }
  // M_m
  double T[(6 + kMaxBodies) * (6 + kMaxBodies)];
  for (int i = 0; i < nv; ++i)
    for (int j = 0; j < nv; ++j) {
      double s = 0;
      for (int k = 0; k < nv; ++k) s += MB[nB * i + k] * P[nB * k + j];
      T[nB * i + j] = s;
    }
  for (int i = 0; i < nv; ++i)
    for (int j = 0; j < nv; ++j) {
      double s = 0;
      for (int k = 0; k < nv; ++k) s += P[nB * k + i] * T[nB * k + j];
      M_out[nv * i + j] = s;
    }
}

// ===================== world-frame kinematics (for the QP oracle) ==========

struct WorldKin {
  Mat3 R[kMaxBodies];       // body orientation, world
  Vec3 p[kMaxBodies];       // body origin, world
  Vec3 com_w[kMaxBodies];   // body CoM, world
  Vec3 axis_w[kMaxBodies];  // world axis of joint b-1 (index by child body b)
  Vec3 org_w[kMaxBodies];   // world origin of joint b-1
  bool anc[kMaxBodies][kMaxBodies];  // anc[b][j]: body b moves with joint j+1's child
};

void world_fk(const Model& mdl, const Mat3& base_R, const Vec3& base_p,
              const double* q, WorldKin* kin) {
  kin->R[0] = base_R;
  kin->p[0] = base_p;
  for (int b = 1; b < mdl.nb; ++b) {
    const int pa = mdl.parent[b];
    Mat3 R_jf = mul(kin->R[pa], mdl.jR[b]);  // joint frame, world
    Vec3 pj = mul(kin->R[pa], mdl.jp[b]);
    for (int i = 0; i < 3; ++i) pj.v[i] += kin->p[pa].v[i];
    kin->axis_w[b] = mul(R_jf, mdl.axis[b]);
    kin->org_w[b] = pj;
    kin->R[b] = mul(R_jf, axis_angle(mdl.axis[b], q[b - 1]));
    kin->p[b] = pj;
  }
  for (int b = 0; b < mdl.nb; ++b) {
    Vec3 c = mul(kin->R[b], mdl.I[b].c);
    for (int i = 0; i < 3; ++i) kin->com_w[b].v[i] = kin->p[b].v[i] + c.v[i];
  }
  std::memset(kin->anc, 0, sizeof(kin->anc));
  for (int b = 1; b < mdl.nb; ++b) {
    const int pa = mdl.parent[b];
    for (int j = 0; j < mdl.nb - 1; ++j) kin->anc[b][j] = kin->anc[pa][j];
    kin->anc[b][b - 1] = true;
  }
}

// world velocity of a point attached to body `bod`:
//   v = v_base + omega x (pt - p_base) + sum_{j in ancestors} axis_j x (pt - org_j) qdot_j
Vec3 point_velocity(const Model& mdl, const WorldKin& kin, const Vec3& pt,
                    int bod, const double* u) {
  Vec3 vw = vec3(u[0], u[1], u[2]);
  Vec3 ww = vec3(u[3], u[4], u[5]);
  Vec3 r = vec3(pt.v[0] - kin.p[0].v[0], pt.v[1] - kin.p[0].v[1],
                pt.v[2] - kin.p[0].v[2]);
  Vec3 wxr = cross(ww, r);
  Vec3 v = vec3(vw.v[0] + wxr.v[0], vw.v[1] + wxr.v[1], vw.v[2] + wxr.v[2]);
  for (int j = 0; j < mdl.nb - 1; ++j) {
    if (!kin.anc[bod][j]) continue;
    Vec3 rel = vec3(pt.v[0] - kin.org_w[j + 1].v[0],
                    pt.v[1] - kin.org_w[j + 1].v[1],
                    pt.v[2] - kin.org_w[j + 1].v[2]);
    Vec3 col = cross(kin.axis_w[j + 1], rel);
    for (int i = 0; i < 3; ++i) v.v[i] += col.v[i] * u[6 + j];
  }
  return v;
}

// position-rows mixed Jacobian (3 x nv) of a world point attached to `bod`
void point_jacobian_rows(const Model& mdl, const WorldKin& kin, const Vec3& pt,
                         int bod, int nv, double* J /* 3*nv row-major */) {
  std::memset(J, 0, 3 * nv * sizeof(double));
  for (int i = 0; i < 3; ++i) J[nv * i + i] = 1.0;
  Vec3 r = vec3(pt.v[0] - kin.p[0].v[0], pt.v[1] - kin.p[0].v[1],
                pt.v[2] - kin.p[0].v[2]);
  Mat3 mS = skew(r);  // columns 3-5 are -skew(pt - p_base)
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) J[nv * i + 3 + j] = -mS.a[3 * i + j];
  for (int j = 0; j < mdl.nb - 1; ++j) {
    if (!kin.anc[bod][j]) continue;
    Vec3 rel = vec3(pt.v[0] - kin.org_w[j + 1].v[0],
                    pt.v[1] - kin.org_w[j + 1].v[1],
                    pt.v[2] - kin.org_w[j + 1].v[2]);
    Vec3 col = cross(kin.axis_w[j + 1], rel);
    for (int i = 0; i < 3; ++i) J[nv * i + 6 + j] = col.v[i];
  }
}

// Solve A X = B for X (n x m), A n x n row-major, Gaussian elimination with
// partial pivoting; A and B are destroyed.  n, m <= 18.
void solve_dense(int n, int m, double* A, double* B, double* X) {
  for (int k = 0; k < n; ++k) {
    int piv = k;
    for (int r = k + 1; r < n; ++r)
      if (std::abs(A[n * r + k]) > std::abs(A[n * piv + k])) piv = r;
    if (piv != k) {
      for (int c = 0; c < n; ++c) std::swap(A[n * k + c], A[n * piv + c]);
      for (int c = 0; c < m; ++c) std::swap(B[m * k + c], B[m * piv + c]);
    }
    const double d = A[n * k + k];
    for (int r = k + 1; r < n; ++r) {
      const double f = A[n * r + k] / d;
      if (f == 0.0) continue;
      for (int c = k; c < n; ++c) A[n * r + c] -= f * A[n * k + c];
      for (int c = 0; c < m; ++c) B[m * r + c] -= f * B[m * k + c];
    }
  }
  for (int r = n - 1; r >= 0; --r) {
    for (int c = 0; c < m; ++c) {
      double s = B[m * r + c];
      for (int k = r + 1; k < n; ++k) s -= A[n * r + k] * X[m * k + c];
      X[m * r + c] = s / A[n * r + r];
    }
  }
}

// C = A (ra x ca) * B (ca x cb), row-major
void matmul(int ra, int ca, int cb, const double* A, const double* B, double* C) {
  for (int i = 0; i < ra; ++i)
    for (int j = 0; j < cb; ++j) {
      double s = 0;
      for (int k = 0; k < ca; ++k) s += A[ca * i + k] * B[cb * k + j];
      C[cb * i + j] = s;
    }
}

// C = A^T (A is ra x ca) * B (ra x cb)
void matmul_tn(int ra, int ca, int cb, const double* A, const double* B, double* C) {
  for (int i = 0; i < ca; ++i)
    for (int j = 0; j < cb; ++j) {
      double s = 0;
      for (int k = 0; k < ra; ++k) s += A[ca * k + i] * B[cb * k + j];
      C[cb * i + j] = s;
    }
}

// ===================== QP assembly oracle ==================================
// Independent re-derivation of the full WBC QP assembly
// (reference /root/reference/src/whole_body_controller.cpp:256-320,384-515;
// JAX implementation quadrupedwholebodycontroller/control/wbc.py
// wbc_setup) using only the Featherstone/world-FK machinery above — no
// shared code with the JAX engine.  Hard-wired to the quadruped QP layout
// (SURVEY §3.5): nv=18, n=42 vars, m=70 rows, 4 feet.
constexpr int kNV = 18;
constexpr int kNJ = 12;
constexpr int kNL = 4;
constexpr int kNQ = 42;
constexpr int kNC = 70;

struct QPParams {
  double kp, kp_z, kd, ki, kp_swing, kd_swing;
  double friction, max_torque, slack_weight, loop_rate, qp_inf;
};

void qp_assembly_impl(
    const Model& mdl, int nf, const int* frame_body, const double* frame_p_local,
    const double* base_R, const double* base_p, const double* q, const double* u,
    const double* ref_com_pose, const double* ref_com_vel,
    const double* ref_com_acc, const double* swing_pos, const double* swing_vel,
    const double* swing_acc, const double* contacts,
    const double* old_T, const double* old_J_st, const double* old_J_sw,
    const double* tdot_inv_in, const double* integral_error_in,
    int switch_flag, int deriv_valid, const QPParams& par,
    double* H_out, double* g_out, double* A_out, double* l_out, double* u_out,
    double* h_c_out, double* T_out, double* Jc_st_out, double* Jc_sw_out,
    double* tdot_inv_out, double* integral_error_out) {
  const int nb = mdl.nb;
  const int nv = kNV;

  // ---- dynamics (CRBA/RNEA, mixed representation) ----
  double M[kNV * kNV], h_cor[kNV];
  mass_and_bias_impl(mdl, base_R, q, u, M, h_cor);

  // ---- world kinematics ----
  Mat3 Rw;
  std::memcpy(Rw.a, base_R, 9 * sizeof(double));
  Vec3 pw = vec3(base_p[0], base_p[1], base_p[2]);
  WorldKin kin;
  world_fk(mdl, Rw, pw, q, &kin);

  double m_tot = 0.0;
  Vec3 com_w{};
  Vec3 com_lin_vel{};
  for (int b = 0; b < nb; ++b) {
    m_tot += mdl.I[b].m;
    Vec3 vb = point_velocity(mdl, kin, kin.com_w[b], b, u);
    for (int i = 0; i < 3; ++i) {
      com_w.v[i] += mdl.I[b].m * kin.com_w[b].v[i];
      com_lin_vel.v[i] += mdl.I[b].m * vb.v[i];
    }
  }
  for (int i = 0; i < 3; ++i) {
    com_w.v[i] /= m_tot;
    com_lin_vel.v[i] /= m_tot;
  }
  double com_vel6[6] = {com_lin_vel.v[0], com_lin_vel.v[1], com_lin_vel.v[2],
                        u[3], u[4], u[5]};

  // current pose [com xyz; rpy] — rpy matches ops/spatial.matrix_to_rpy
  double current_pose[6];
  for (int i = 0; i < 3; ++i) current_pose[i] = com_w.v[i];
  current_pose[3] = std::atan2(Rw.a[7], Rw.a[8]);
  current_pose[4] = std::atan2(-Rw.a[6], std::sqrt(Rw.a[7] * Rw.a[7] + Rw.a[8] * Rw.a[8]));
  current_pose[5] = std::atan2(Rw.a[3], Rw.a[0]);

  // ---- centroidal transform T, T^-1 (cpp:296-320) ----
  double X[6 * kNJ];  // Mb^{-1} Mbj
  {
    double Mb[36], Mbj[6 * kNJ];
    for (int i = 0; i < 6; ++i)
      for (int j = 0; j < 6; ++j) Mb[6 * i + j] = M[nv * i + j];
    for (int i = 0; i < 6; ++i)
      for (int j = 0; j < kNJ; ++j) Mbj[kNJ * i + j] = M[nv * i + (6 + j)];
    solve_dense(6, kNJ, Mb, Mbj, X);
  }
  Mat3 S = skew(vec3(com_w.v[0] - pw.v[0], com_w.v[1] - pw.v[1],
                     com_w.v[2] - pw.v[2]));
  double T[kNV * kNV], Tinv[kNV * kNV];
  std::memset(T, 0, sizeof(T));
  std::memset(Tinv, 0, sizeof(Tinv));
  for (int i = 0; i < nv; ++i) { T[nv * i + i] = 1.0; Tinv[nv * i + i] = 1.0; }
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      T[nv * i + (3 + j)] = -S.a[3 * i + j];     // adj_inv top-right
      Tinv[nv * i + (3 + j)] = S.a[3 * i + j];   // adj top-right
    }
  // T top-right block = adj_inv @ X ; Tinv top-right = -X
  for (int i = 0; i < 6; ++i)
    for (int j = 0; j < kNJ; ++j) {
      double s = X[kNJ * i + j];
      if (i < 3)
        for (int k = 0; k < 3; ++k) s += -S.a[3 * i + k] * X[kNJ * (3 + k) + j];
      T[nv * i + (6 + j)] = s;
      Tinv[nv * i + (6 + j)] = -X[kNJ * i + j];
    }

  // ---- centroidal mass matrix Mc = Tinv^T M Tinv ----
  double tmpM[kNV * kNV], Mc[kNV * kNV];
  matmul_tn(nv, nv, nv, Tinv, M, tmpM);
  matmul(nv, nv, nv, tmpM, Tinv, Mc);

  // ---- foot jacobians (position rows) + stance/swing split ----
  double Jst[kNJ * kNV], Jsw[kNJ * kNV];
  double foot_pos[3 * kNL], foot_vel[3 * kNL];
  for (int f = 0; f < kNL; ++f) {
    const int bod = frame_body[f];
    Vec3 loc = vec3(frame_p_local[3 * f], frame_p_local[3 * f + 1],
                    frame_p_local[3 * f + 2]);
    Vec3 off = mul(kin.R[bod], loc);
    Vec3 pt = vec3(kin.p[bod].v[0] + off.v[0], kin.p[bod].v[1] + off.v[1],
                   kin.p[bod].v[2] + off.v[2]);
    double Jf[3 * kNV];
    point_jacobian_rows(mdl, kin, pt, bod, nv, Jf);
    Vec3 vf = point_velocity(mdl, kin, pt, bod, u);
    for (int i = 0; i < 3; ++i) {
      foot_pos[3 * f + i] = pt.v[i];
      foot_vel[3 * f + i] = vf.v[i];
      for (int j = 0; j < nv; ++j) {
        Jst[nv * (3 * f + i) + j] = contacts[f] * Jf[nv * i + j];
        Jsw[nv * (3 * f + i) + j] = (1.0 - contacts[f]) * Jf[nv * i + j];
      }
    }
  }
  double Jc_st[kNJ * kNV], Jc_sw[kNJ * kNV];
  matmul(kNJ, nv, nv, Jst, Tinv, Jc_st);
  matmul(kNJ, nv, nv, Jsw, Tinv, Jc_sw);

  // ---- finite-difference derivatives (cpp:384-402), gated on switch /
  // first cycle exactly like wbc_setup ----
  const double dt = 1.0 / par.loop_rate;
  const double gate = (switch_flag || !deriv_valid) ? 0.0 : 1.0;
  double T_dot[kNV * kNV], Jd_st[kNJ * kNV], Jd_sw[kNJ * kNV];
  for (int i = 0; i < nv * nv; ++i) T_dot[i] = gate * (T[i] - old_T[i]) / dt;
  for (int i = 0; i < kNJ * nv; ++i) {
    Jd_st[i] = gate * (Jc_st[i] - old_J_st[i]) / dt;
    Jd_sw[i] = gate * (Jc_sw[i] - old_J_sw[i]) / dt;
  }
  // d(T^-1)/dt = -Tinv T_dot Tinv  (cpp:293) — the NEW value, carried out
  {
    double t1[kNV * kNV];
    matmul(nv, nv, nv, Tinv, T_dot, t1);
    matmul(nv, nv, nv, t1, Tinv, tdot_inv_out);
    for (int i = 0; i < nv * nv; ++i) tdot_inv_out[i] = -tdot_inv_out[i];
  }
  // centroidal bias with the STALE carried tdot_inv (cpp:289 vs 293)
  double h_c[kNV];
  {
    double tiu[kNV], Mtiu[kNV], vsum[kNV];
    matmul(nv, nv, 1, tdot_inv_in, u, tiu);
    matmul(nv, nv, 1, M, tiu, Mtiu);
    for (int i = 0; i < nv; ++i) vsum[i] = h_cor[i] + Mtiu[i];
    matmul_tn(nv, nv, 1, Tinv, vsum, h_c);
  }

  // ---- desired wrench (cpp:426-445) ----
  constexpr double kGravity = 9.81;
  double gravity_wrench[6] = {0, 0, m_tot * kGravity, 0, 0, 0};
  double kp_diag[6] = {par.kp, par.kp, par.kp_z, par.kp, par.kp, par.kp};
  double w_des[6];
  for (int i = 0; i < 6; ++i) {
    const double pose_err = current_pose[i] - ref_com_pose[i];
    double mc_acc = 0;
    for (int k = 0; k < 6; ++k) mc_acc += Mc[nv * i + k] * ref_com_acc[k];
    w_des[i] = -kp_diag[i] * pose_err - par.kd * (com_vel6[i] - ref_com_vel[i]) -
               par.ki * integral_error_in[i] + gravity_wrench[i] + mc_acc;
    integral_error_out[i] = integral_error_in[i] + pose_err / par.loop_rate;
  }

  // ---- swing commanded accelerations (cpp:447-464) ----
  double a_cmd[3 * kNL];
  for (int f = 0; f < kNL; ++f)
    for (int i = 0; i < 3; ++i) {
      const int r = 3 * f + i;
      a_cmd[r] = (swing_acc[r] + par.kd_swing * (swing_vel[r] - foot_vel[r]) +
                  par.kp_swing * (swing_pos[r] - foot_pos[r])) *
                 (1.0 - contacts[f]);
    }

  // ---- QP assembly (cpp:466-515) ----
  std::memset(H_out, 0, kNQ * kNQ * sizeof(double));
  std::memset(g_out, 0, kNQ * sizeof(double));
  std::memset(A_out, 0, kNC * kNQ * sizeof(double));
  // H grf block = Jc_st_com Jc_st_com^T + I ; slack block = slack_weight I
  for (int i = 0; i < kNJ; ++i)
    for (int j = 0; j < kNJ; ++j) {
      double s = 0;
      for (int k = 0; k < 6; ++k) s += Jc_st[nv * i + k] * Jc_st[nv * j + k];
      H_out[kNQ * (18 + i) + (18 + j)] = s;
    }
  for (int i = 0; i < kNQ; ++i)
    H_out[kNQ * i + i] += (i >= 30) ? par.slack_weight : 1.0;
  for (int i = 0; i < kNJ; ++i) {
    double s = 0;
    for (int k = 0; k < 6; ++k) s += Jc_st[nv * i + k] * w_des[k];
    g_out[18 + i] = -s;
  }
  // rows 0-5: [Mc_base | 0 | -Jc_st_com^T | 0]
  for (int i = 0; i < 6; ++i) {
    for (int j = 0; j < 6; ++j) A_out[kNQ * i + j] = Mc[nv * i + j];
    for (int c = 0; c < kNJ; ++c) A_out[kNQ * i + (18 + c)] = -Jc_st[nv * c + i];
  }
  // rows 6-17: [Jc_st_com | Jc_st_j | 0 | 0]
  for (int r = 0; r < kNJ; ++r)
    for (int j = 0; j < nv; ++j) A_out[kNQ * (6 + r) + j] = Jc_st[nv * r + j];
  // rows 18-33: friction pyramid on F (contact-masked, cpp:404-424)
  {
    const double mu = par.friction;
    const double D[4][3] = {{1, 0, -mu}, {-1, 0, -mu}, {0, 1, -mu}, {0, -1, -mu}};
    for (int f = 0; f < kNL; ++f)
      for (int r = 0; r < 4; ++r)
        for (int c = 0; c < 3; ++c)
          A_out[kNQ * (18 + 4 * f + r) + (18 + 3 * f + c)] = contacts[f] * D[r][c];
  }
  // rows 34-45: [0 | Mc_jj | -Jc_st_j^T | 0]
  for (int r = 0; r < kNJ; ++r) {
    for (int j = 0; j < kNJ; ++j)
      A_out[kNQ * (34 + r) + (6 + j)] = Mc[nv * (6 + r) + (6 + j)];
    for (int c = 0; c < kNJ; ++c)
      A_out[kNQ * (34 + r) + (18 + c)] = -Jc_st[nv * c + (6 + r)];
  }
  // rows 46-57 / 58-69: swing tracking with slacks -/+I
  for (int r = 0; r < kNJ; ++r)
    for (int j = 0; j < nv; ++j) {
      A_out[kNQ * (46 + r) + j] = Jc_sw[nv * r + j];
      A_out[kNQ * (58 + r) + j] = Jc_sw[nv * r + j];
    }
  for (int r = 0; r < kNJ; ++r) {
    A_out[kNQ * (46 + r) + (30 + r)] = -1.0;
    A_out[kNQ * (58 + r) + (30 + r)] = 1.0;
  }
  // bounds
  double vel_c[kNV];
  for (int i = 0; i < 6; ++i) vel_c[i] = com_vel6[i];
  for (int i = 0; i < kNJ; ++i) vel_c[6 + i] = u[6 + i];
  double stance_rhs[kNJ], swing_rhs[kNJ];
  matmul(kNJ, nv, 1, Jd_st, vel_c, stance_rhs);
  matmul(kNJ, nv, 1, Jd_sw, vel_c, swing_rhs);
  for (int i = 0; i < kNJ; ++i) {
    stance_rhs[i] = -stance_rhs[i];
    swing_rhs[i] = a_cmd[i] - swing_rhs[i];
  }
  const double inf = par.qp_inf;
  for (int i = 0; i < 6; ++i) { l_out[i] = u_out[i] = -gravity_wrench[i]; }
  for (int i = 0; i < kNJ; ++i) { l_out[6 + i] = u_out[6 + i] = stance_rhs[i]; }
  for (int i = 0; i < 16; ++i) { l_out[18 + i] = -inf; u_out[18 + i] = 0.0; }
  for (int i = 0; i < kNJ; ++i) {
    l_out[34 + i] = -par.max_torque - h_c[6 + i];
    u_out[34 + i] = par.max_torque - h_c[6 + i];
  }
  for (int i = 0; i < kNJ; ++i) {
    l_out[46 + i] = -inf; u_out[46 + i] = swing_rhs[i];
    l_out[58 + i] = swing_rhs[i]; u_out[58 + i] = inf;
  }

  // carry updates for chaining multi-cycle oracle runs
  std::memcpy(h_c_out, h_c, kNV * sizeof(double));
  std::memcpy(T_out, T, kNV * kNV * sizeof(double));
  std::memcpy(Jc_st_out, Jc_st, kNJ * kNV * sizeof(double));
  std::memcpy(Jc_sw_out, Jc_sw, kNJ * kNV * sizeof(double));
  (void)nf;
}

}  // namespace

extern "C" {

// Mixed-representation mass matrix (nv x nv, row-major) and Coriolis-only
// bias (nv), nv = 6 + (nb-1).  Inputs:
//   base_R: 3x3 row-major world rotation of the base
//   q:      (nb-1) joint positions
//   u:      (nv) mixed velocity [v_base_world; omega_world; qdot]
void qwbc_mass_and_bias(
    int nb, const int* parent, const double* joint_R, const double* joint_p,
    const double* joint_axis, const double* mass, const double* com,
    const double* inertia, const double* base_R, const double* q,
    const double* u, double* M_out, double* h_out) {
  Model mdl;
  build_model(nb, parent, joint_R, joint_p, joint_axis, mass, com, inertia, &mdl);
  mass_and_bias_impl(mdl, base_R, q, u, M_out, h_out);
}

// Full WBC QP assembly oracle (see qp_assembly_impl).  `refs` packs the
// planner reference [com_pose(6); com_vel(6); com_acc(6); swing_pos(12);
// swing_vel(12); swing_acc(12); contacts(4)] = 58 doubles; `carry` packs
// [old_T(324); old_J_st(216); old_J_sw(216); tdot_inv(324);
// integral_error(6)] = 1086; `par` packs [kp, kp_z, kd, ki, kp_swing,
// kd_swing, friction, max_torque, slack_weight, loop_rate, qp_inf];
// `outs` receives [H(1764); g(42); A(2940); l(70); u(70); h_c(18); T(324);
// Jc_st(216); Jc_sw(216); tdot_inv(324); integral_error(6)] = 5990.
void qwbc_qp_assembly(
    int nb, const int* parent, const double* joint_R, const double* joint_p,
    const double* joint_axis, const double* mass, const double* com,
    const double* inertia, int nf, const int* frame_body,
    const double* frame_p_local, const double* base_R, const double* base_p,
    const double* q, const double* u, const double* refs, const double* carry,
    int switch_flag, int deriv_valid, const double* par, double* outs) {
  Model mdl;
  build_model(nb, parent, joint_R, joint_p, joint_axis, mass, com, inertia, &mdl);
  QPParams p{par[0], par[1], par[2], par[3], par[4],  par[5],
             par[6], par[7], par[8], par[9], par[10]};
  double* H = outs;
  double* g = H + kNQ * kNQ;
  double* A = g + kNQ;
  double* l = A + kNC * kNQ;
  double* ub = l + kNC;
  double* h_c = ub + kNC;
  double* T_o = h_c + kNV;
  double* Jst_o = T_o + kNV * kNV;
  double* Jsw_o = Jst_o + kNJ * kNV;
  double* tdi_o = Jsw_o + kNJ * kNV;
  double* ie_o = tdi_o + kNV * kNV;
  qp_assembly_impl(
      mdl, nf, frame_body, frame_p_local, base_R, base_p, q, u,
      refs, refs + 6, refs + 12, refs + 18, refs + 30, refs + 42, refs + 54,
      carry, carry + 324, carry + 540, carry + 756, carry + 1080,
      switch_flag, deriv_valid, p,
      H, g, A, l, ub, h_c, T_o, Jst_o, Jsw_o, tdi_o, ie_o);
}

}  // extern "C"

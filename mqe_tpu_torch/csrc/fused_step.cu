// One dynamics + integration substep for a batch of articulated actors that
// share one BodyModel: forward kinematics down the tree, body velocities,
// contact and gravity wrenches about body origins, Featherstone's
// articulated-body algorithm with joint damping (6x6 Cholesky for a free
// base), then semi-implicit Euler with velocity clips, joint limits and a
// quaternion exp-step.
//
// Replaces the TPU kernel `step_actor_pallas` (mqe_tpu/physics/pallas_step.py,
// pallas_call at line 141, body `_kernel`), which runs the same chain,
// `soa.step_entries`, over (tile, 128) lane tiles. Here one thread is one
// robot. The plain PyTorch version of the same arithmetic is
// mqe_tpu_torch/physics/soa.py::step_entries; every device function below is
// named after the soa.py function it mirrors, and keeps its order of
// operations.
//
// Layout: the wrapper (physics/fused_step.py) packs the inputs channel-major
// into X (C_in, B) float32, as pallas_step.py does: pos 3, quat 4, lin_vel 3,
// ang_vel 3, q nq, qd nq, tau nq, sphere positions 3*ns, sphere forces 3*ns,
// then payload 1, com shift 3 and per-body world wrench 6*nb where present.
// Thread b reads channel c at X[c*B + b], so a warp reads 128 contiguous
// bytes per channel. Y (C_out, B) holds pos 3, quat 4, lin_vel 3, ang_vel 3,
// q nq, qd nq.
//
// Model constants are not compiled in: they come from one float32 table per
// model (physics/model.py::model_tables, offsets below), copied into shared
// memory by each block. Body and sphere loops run to runtime counts under
// the compile-time bounds MAX_NB and MAX_NS, so one build serves go1 (13
// bodies, 12 joints, 40 spheres) and the NPC models (ball, box, seesaw, ...).
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s float32 without tensor cores):
// at the go1gate slice (B = 8192 robots, C_in = 293 with payload and com
// shift, C_out = 37) the step must move (293 + 37) * 4 B * 8192 = 10.8 MB,
// 3.2 us at the memory rate. The plain version does 2.25e4 float operations
// per robot (chip_smoke.py counts them over its aten calls), 1.84e8 for the
// batch, 2.8 us at the float32 rate. So the step is bound by bytes, 3.2 us.
//
// What this first design does about that bound: nothing yet. The per-robot
// body arrays (Rw, pw, Rl, pl, v, IA, pA, c, U, d, u) are indexed by runtime
// body numbers and so live in local memory (cached in L1/L2), which costs
// far more than the 10.8 MB the step must move. It is correct and simple;
// speed is later work (keeping the tree in registers per model, or one warp
// per robot).

#include <cuda_runtime.h>

#define MAX_NB 16
#define MAX_NS 64
#define THREADS 128
#define JOINT_PRISMATIC 2

// model table offsets (floats): must match physics/model.py::TABLE_FIELDS
#define T_PARENT 0
#define T_JTYPE (T_PARENT + MAX_NB)
#define T_JROT (T_JTYPE + MAX_NB)
#define T_JPOS (T_JROT + MAX_NB * 9)
#define T_JAXIS (T_JPOS + MAX_NB * 3)
#define T_MASS (T_JAXIS + MAX_NB * 3)
#define T_COM (T_MASS + MAX_NB)
#define T_ICOM (T_COM + MAX_NB * 3)
#define T_ISPAT (T_ICOM + MAX_NB * 9)
#define T_DAMP (T_ISPAT + MAX_NB * 36)
#define T_QLO (T_DAMP + MAX_NB)
#define T_QHI (T_QLO + MAX_NB)
#define T_QDLIM (T_QHI + MAX_NB)
#define T_SBODY (T_QDLIM + MAX_NB)
#define T_SPOS (T_SBODY + MAX_NS)
#define TABLE_SIZE (T_SPOS + MAX_NS * 3)

struct V3 { float x, y, z; };
struct M3 { float a[3][3]; };
struct SV { V3 w, v; };          // spatial vector (angular, linear)
struct SM { M3 A, B, C, D; };    // spatial matrix as 3x3 blocks [[A, B], [C, D]]

#define DEV __device__ __forceinline__

// max/min/clip that keep a NaN, as jnp.maximum / torch.clamp do
DEV float maxf_(float x, float c) { return x < c ? c : x; }
DEV float clipf_(float x, float lo, float hi) { return x < lo ? lo : (x > hi ? hi : x); }

DEV V3 v3(float x, float y, float z) { V3 r = {x, y, z}; return r; }
DEV V3 v_add(V3 a, V3 b) { return v3(a.x + b.x, a.y + b.y, a.z + b.z); }
DEV V3 v_sub(V3 a, V3 b) { return v3(a.x - b.x, a.y - b.y, a.z - b.z); }
DEV V3 v_scale(V3 a, float s) { return v3(a.x * s, a.y * s, a.z * s); }
DEV float v_dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
DEV V3 v_cross(V3 a, V3 b) {
  return v3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x);
}
DEV float vc(const V3& a, int i) { return i == 0 ? a.x : (i == 1 ? a.y : a.z); }

DEV V3 m_vec(const M3& M, V3 v) {
  return v3(M.a[0][0] * v.x + M.a[0][1] * v.y + M.a[0][2] * v.z,
            M.a[1][0] * v.x + M.a[1][1] * v.y + M.a[1][2] * v.z,
            M.a[2][0] * v.x + M.a[2][1] * v.y + M.a[2][2] * v.z);
}
DEV V3 mT_vec(const M3& M, V3 v) {
  return v3(M.a[0][0] * v.x + M.a[1][0] * v.y + M.a[2][0] * v.z,
            M.a[0][1] * v.x + M.a[1][1] * v.y + M.a[2][1] * v.z,
            M.a[0][2] * v.x + M.a[1][2] * v.y + M.a[2][2] * v.z);
}
DEV M3 m_mul(const M3& A, const M3& B) {
  M3 r;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      r.a[i][j] = A.a[i][0] * B.a[0][j] + A.a[i][1] * B.a[1][j] + A.a[i][2] * B.a[2][j];
  return r;
}
DEV M3 m_mulT(const M3& A, const M3& B) {  // A @ B.T
  M3 r;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      r.a[i][j] = A.a[i][0] * B.a[j][0] + A.a[i][1] * B.a[j][1] + A.a[i][2] * B.a[j][2];
  return r;
}
DEV M3 m_add(const M3& A, const M3& B) {
  M3 r;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) r.a[i][j] = A.a[i][j] + B.a[i][j];
  return r;
}
DEV M3 m_sub(const M3& A, const M3& B) {
  M3 r;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) r.a[i][j] = A.a[i][j] - B.a[i][j];
  return r;
}
DEV M3 m_transpose(const M3& A) {
  M3 r;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) r.a[i][j] = A.a[j][i];
  return r;
}
DEV M3 m_skew(V3 p) {
  M3 r = {{{0.0f, -p.z, p.y}, {p.z, 0.0f, -p.x}, {-p.y, p.x, 0.0f}}};
  return r;
}
DEV M3 m_outer(V3 a, V3 b) {
  M3 r;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) r.a[i][j] = vc(a, i) * vc(b, j);
  return r;
}
DEV M3 m_load(const float* t) {
  M3 r;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) r.a[i][j] = t[i * 3 + j];
  return r;
}
DEV V3 v_load(const float* t) { return v3(t[0], t[1], t[2]); }

DEV M3 quat_to_mat(float x, float y, float z, float w) {
  float xx = x * x, yy = y * y, zz = z * z;
  float xy = x * y, xz = x * z, yz = y * z;
  float wx = w * x, wy = w * y, wz = w * z;
  M3 r = {{{1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)},
           {2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)},
           {2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)}}};
  return r;
}

DEV M3 rodrigues(float angle, V3 ax) {
  float c = cosf(angle), s = sinf(angle);
  float one_c = 1.0f - c;
  M3 r = {{{c + one_c * ax.x * ax.x, one_c * ax.x * ax.y - s * ax.z, one_c * ax.x * ax.z + s * ax.y},
           {one_c * ax.y * ax.x + s * ax.z, c + one_c * ax.y * ax.y, one_c * ax.y * ax.z - s * ax.x},
           {one_c * ax.z * ax.x - s * ax.y, one_c * ax.z * ax.y + s * ax.x, c + one_c * ax.z * ax.z}}};
  return r;
}

DEV SV sv(V3 w, V3 v) { SV r = {w, v}; return r; }
DEV SV s_vec(const SM& M, const SV& x) {
  return sv(v_add(m_vec(M.A, x.w), m_vec(M.B, x.v)), v_add(m_vec(M.C, x.w), m_vec(M.D, x.v)));
}
DEV SM s_add(const SM& M, const SM& N) {
  SM r = {m_add(M.A, N.A), m_add(M.B, N.B), m_add(M.C, N.C), m_add(M.D, N.D)};
  return r;
}
DEV SM s_sub(const SM& M, const SM& N) {
  SM r = {m_sub(M.A, N.A), m_sub(M.B, N.B), m_sub(M.C, N.C), m_sub(M.D, N.D)};
  return r;
}
DEV SM s_outer_scaled(const SV& x, const SV& y, float s) {
  V3 xw = v_scale(x.w, s), xv = v_scale(x.v, s);
  SM r = {m_outer(xw, y.w), m_outer(xw, y.v), m_outer(xv, y.w), m_outer(xv, y.v)};
  return r;
}
DEV float s_dot(const SV& x, const SV& y) { return v_dot(x.w, y.w) + v_dot(x.v, y.v); }
DEV SV cross_motion(const SV& v, const SV& m) {
  return sv(v_cross(v.w, m.w), v_add(v_cross(v.w, m.v), v_cross(v.v, m.w)));
}
DEV SV cross_force(const SV& v, const SV& F) {
  return sv(v_add(v_cross(v.w, F.w), v_cross(v.v, F.v)), v_cross(v.w, F.v));
}
// X_up = motion_transform(Rl, pl): v_child = X v_parent
DEV SV x_motion(const M3& Rl, V3 pl, const SV& x) {
  return sv(mT_vec(Rl, x.w), mT_vec(Rl, v_sub(x.v, v_cross(pl, x.w))));
}
// X_up^T applied to a force: F_parent = X^T F_child
DEV SV xT_force(const M3& Rl, V3 pl, const SV& F) {
  V3 Rf = m_vec(Rl, F.v);
  return sv(v_add(m_vec(Rl, F.w), v_cross(pl, Rf)), Rf);
}

// Unrolled Cholesky solve of the 6x6 SPD system M x = b.
DEV SV solve_spd6(const SM& M, const SV& b) {
  float A[6][6];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      A[i][j] = M.A.a[i][j];
      A[i][j + 3] = M.B.a[i][j];
      A[i + 3][j] = M.C.a[i][j];
      A[i + 3][j + 3] = M.D.a[i][j];
    }
  float bb[6] = {b.w.x, b.w.y, b.w.z, b.v.x, b.v.y, b.v.z};
  float L[6][6];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    float s = A[j][j];
#pragma unroll
    for (int k = 0; k < j; ++k) s = s - L[j][k] * L[j][k];
    L[j][j] = sqrtf(maxf_(s, 1e-12f));
    float inv = 1.0f / L[j][j];
#pragma unroll
    for (int i = j + 1; i < 6; ++i) {
      float t = A[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) t = t - L[i][k] * L[j][k];
      L[i][j] = t * inv;
    }
  }
  float y[6], x[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float s = bb[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s = s - L[i][k] * y[k];
    y[i] = s / L[i][i];
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int k = i + 1; k < 6; ++k) s = s - L[k][i] * x[k];
    x[i] = s / L[i][i];
  }
  return sv(v3(x[0], x[1], x[2]), v3(x[3], x[4], x[5]));
}

// _spatial_inertia_blocks: spatial inertia at the body origin
DEV SM spatial_inertia_blocks(float mass, V3 com, const M3& I_com) {
  M3 C = m_skew(com);
  M3 CCt = m_mulT(C, C);
  SM r;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      r.A.a[i][j] = I_com.a[i][j] + mass * CCt.a[i][j];
      r.B.a[i][j] = mass * C.a[i][j];
      r.C.a[i][j] = mass * C.a[j][i];
      r.D.a[i][j] = (i == j) ? mass : 0.0f;
    }
  return r;
}

// motion subspace of the joint of body i (child frame)
DEV SV joint_S(const float* T, int i) {
  V3 axis = v_load(T + T_JAXIS + 3 * i);
  V3 zero = v3(0.0f, 0.0f, 0.0f);
  return ((int)T[T_JTYPE + i] == JOINT_PRISMATIC) ? sv(zero, axis) : sv(axis, zero);
}

__global__ void __launch_bounds__(THREADS)
fused_step_kernel(const float* __restrict__ X, float* __restrict__ Y,
                  const float* __restrict__ tables, int B, int nb, int nq, int ns,
                  int has_pay, int has_cs, int has_extra, int root_free,
                  int model_root_free, float dt) {
  __shared__ float T[TABLE_SIZE];
  for (int k = threadIdx.x; k < TABLE_SIZE; k += blockDim.x) T[k] = tables[k];
  __syncthreads();

  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t Bs = (size_t)B;
  const float* xb = X + b;
  auto in = [&](int c) { return xb[(size_t)c * Bs]; };
  auto in3 = [&](int c) { return v3(in(c), in(c + 1), in(c + 2)); };

  const int c_q = 13, c_qd = 13 + nq, c_tau = 13 + 2 * nq, c_sx = 13 + 3 * nq;
  const int c_sf = c_sx + 3 * ns;
  const int c_pay = c_sf + 3 * ns;
  const int c_cs = c_pay + (has_pay ? 1 : 0);
  const int c_extra = c_cs + (has_cs ? 3 : 0);

  const V3 p = in3(0);
  const float qx = in(3), qy = in(4), qz = in(5), qw = in(6);
  const V3 lv = in3(7), av = in3(10);
  float ql[MAX_NB], qdl[MAX_NB], tau[MAX_NB];
  for (int j = 0; j < nq; ++j) {
    ql[j] = in(c_q + j);
    qdl[j] = in(c_qd + j);
    tau[j] = in(c_tau + j);
  }
  const float pay = has_pay ? in(c_pay) : 0.0f;
  const V3 cs = has_cs ? in3(c_cs) : v3(0.0f, 0.0f, 0.0f);

  // ---- _fk ----
  M3 Rw[MAX_NB], Rl[MAX_NB];
  V3 pw[MAX_NB], pl[MAX_NB];
  Rw[0] = quat_to_mat(qx, qy, qz, qw);
  pw[0] = p;
  for (int i = 1; i < nb; ++i) {
    const int par = (int)T[T_PARENT + i];
    const M3 jrot = m_load(T + T_JROT + 9 * i);
    const V3 jpos = v_load(T + T_JPOS + 3 * i);
    const V3 axis = v_load(T + T_JAXIS + 3 * i);
    const float qi = ql[i - 1];
    if ((int)T[T_JTYPE + i] == JOINT_PRISMATIC) {
      Rl[i] = jrot;
      pl[i] = v_add(jpos, m_vec(jrot, v_scale(axis, qi)));
    } else {
      Rl[i] = m_mul(jrot, rodrigues(qi, axis));
      pl[i] = jpos;
    }
    Rw[i] = m_mul(Rw[par], Rl[i]);
    pw[i] = v_add(pw[par], m_vec(Rw[par], pl[i]));
  }

  // ---- _body_vels (body-frame spatial velocities) ----
  SV v[MAX_NB];
  v[0] = sv(mT_vec(Rw[0], av), mT_vec(Rw[0], lv));
  for (int i = 1; i < nb; ++i) {
    const int par = (int)T[T_PARENT + i];
    const SV S = joint_S(T, i);
    const SV vi = x_motion(Rl[i], pl[i], v[par]);
    v[i] = sv(v_add(vi.w, v_scale(S.w, qdl[i - 1])), v_add(vi.v, v_scale(S.v, qdl[i - 1])));
  }

  // ---- _contact_wrenches + _gravity_wrenches (+ extra): world, about origins ----
  SV fe[MAX_NB];
  for (int i = 0; i < nb; ++i) fe[i] = sv(v3(0.0f, 0.0f, 0.0f), v3(0.0f, 0.0f, 0.0f));
  for (int s = 0; s < ns; ++s) {
    const int bs = (int)T[T_SBODY + s];
    const V3 x = in3(c_sx + 3 * s);
    const V3 f = in3(c_sf + 3 * s);
    const V3 n = v_cross(v_sub(x, pw[bs]), f);
    fe[bs] = sv(v_add(fe[bs].w, n), v_add(fe[bs].v, f));
  }
  for (int i = 0; i < nb; ++i) {
    float mass = T[T_MASS + i];
    V3 com = v_load(T + T_COM + 3 * i);
    if (i == 0) {
      if (has_pay) mass = mass + pay;
      if (has_cs) com = v_add(com, cs);
    }
    const V3 com_w = m_vec(Rw[i], com);
    const V3 f = v3(0.0f, 0.0f, mass * -9.81f);
    fe[i] = sv(v_add(fe[i].w, v_cross(com_w, f)), v_add(fe[i].v, f));
    if (has_extra) {
      const V3 en = in3(c_extra + 6 * i), ef = in3(c_extra + 6 * i + 3);
      fe[i] = sv(v_add(fe[i].w, en), v_add(fe[i].v, ef));
    }
  }

  // ---- _inertias ----
  SM IA[MAX_NB];
  for (int i = 0; i < nb; ++i) {
    if (i == 0 && (has_pay || has_cs)) {
      float m0 = T[T_MASS] + pay;
      V3 com0 = v_load(T + T_COM);
      if (has_cs) com0 = v_add(com0, cs);
      IA[0] = spatial_inertia_blocks(m0, com0, m_load(T + T_ICOM));
    } else {
      const float* Ip = T + T_ISPAT + 36 * i;
      SM r;
#pragma unroll
      for (int ii = 0; ii < 3; ++ii)
#pragma unroll
        for (int jj = 0; jj < 3; ++jj) {
          r.A.a[ii][jj] = Ip[ii * 6 + jj];
          r.B.a[ii][jj] = Ip[ii * 6 + jj + 3];
          r.C.a[ii][jj] = Ip[(ii + 3) * 6 + jj];
          r.D.a[ii][jj] = Ip[(ii + 3) * 6 + jj + 3];
        }
      IA[i] = r;
    }
  }

  // ---- _aba ----
  SV pA[MAX_NB], c[MAX_NB], U[MAX_NB];
  float d[MAX_NB], u[MAX_NB], qdd[MAX_NB];
  for (int i = 0; i < nb; ++i) {
    const SV fb = sv(mT_vec(Rw[i], fe[i].w), mT_vec(Rw[i], fe[i].v));
    const SV bias = cross_force(v[i], s_vec(IA[i], v[i]));
    pA[i] = sv(v_sub(bias.w, fb.w), v_sub(bias.v, fb.v));
  }
  for (int i = 1; i < nb; ++i) {
    const SV S = joint_S(T, i);
    c[i] = cross_motion(v[i], sv(v_scale(S.w, qdl[i - 1]), v_scale(S.v, qdl[i - 1])));
  }
  for (int i = nb - 1; i > 0; --i) {
    const int par = (int)T[T_PARENT + i];
    const SV S = joint_S(T, i);
    const float tau_eff = tau[i - 1] - T[T_DAMP + i - 1] * qdl[i - 1];
    U[i] = s_vec(IA[i], S);
    d[i] = s_dot(S, U[i]) + 1e-9f;
    u[i] = tau_eff - s_dot(S, pA[i]);
    const float inv_d = 1.0f / d[i];
    const SM Ia = s_sub(IA[i], s_outer_scaled(U[i], U[i], inv_d));
    const SV Iac = s_vec(Ia, c[i]);
    const float us = u[i] * inv_d;
    const SV Uu = sv(v_scale(U[i].w, us), v_scale(U[i].v, us));
    const SV pa = sv(v_add(v_add(pA[i].w, Iac.w), Uu.w), v_add(v_add(pA[i].v, Iac.v), Uu.v));

    // IA[par] += X^T Ia X with X = [[Rt, 0], [-Rt phat, Rt]]
    const M3& R = Rl[i];
    const M3 Rt = m_transpose(R);
    const M3 P = m_skew(pl[i]);
    const M3 RtP = m_mul(Rt, P);
    const M3 PR = m_mul(P, R);
    const M3 M11 = m_sub(m_mul(Ia.A, Rt), m_mul(Ia.B, RtP));
    const M3 M12 = m_mul(Ia.B, Rt);
    const M3 M21 = m_sub(m_mul(Ia.C, Rt), m_mul(Ia.D, RtP));
    const M3 M22 = m_mul(Ia.D, Rt);
    SM N;
    N.A = m_add(m_mul(R, M11), m_mul(PR, M21));
    N.B = m_add(m_mul(R, M12), m_mul(PR, M22));
    N.C = m_mul(R, M21);
    N.D = m_mul(R, M22);
    IA[par] = s_add(IA[par], N);
    const SV xf = xT_force(Rl[i], pl[i], pa);
    pA[par] = sv(v_add(pA[par].w, xf.w), v_add(pA[par].v, xf.v));
  }

  SV a0;
  if (model_root_free) {
    SM I0 = IA[0];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      I0.A.a[k][k] = I0.A.a[k][k] + 1e-9f;
      I0.D.a[k][k] = I0.D.a[k][k] + 1e-9f;
    }
    a0 = solve_spd6(I0, sv(v_scale(pA[0].w, -1.0f), v_scale(pA[0].v, -1.0f)));
  } else {
    const float z = pA[0].w.x * 0.0f;
    a0 = sv(v3(z, z, z), v3(z, z, z));
  }
  SV* acc = fe;  // the world wrenches are consumed; reuse their storage
  acc[0] = a0;
  for (int i = 1; i < nb; ++i) {
    const int par = (int)T[T_PARENT + i];
    const SV S = joint_S(T, i);
    SV ai = x_motion(Rl[i], pl[i], acc[par]);
    ai = sv(v_add(ai.w, c[i].w), v_add(ai.v, c[i].v));
    const float qdd_i = (u[i] - s_dot(U[i], ai)) / d[i];
    acc[i] = sv(v_add(ai.w, v_scale(S.w, qdd_i)), v_add(ai.v, v_scale(S.v, qdd_i)));
    qdd[i - 1] = qdd_i;
  }

  // ---- world accelerations of the base (step_entries) ----
  V3 omega_dot_w = m_vec(Rw[0], a0.w);
  V3 a_lin_w = m_vec(Rw[0], v_add(a0.v, v_cross(v[0].w, v[0].v)));
  if (!root_free) {
    const float z = p.x * 0.0f;
    omega_dot_w = v3(z, z, z);
    a_lin_w = v3(z, z, z);
  }

  // ---- _integrate ----
  const V3 av2 = v3(clipf_(av.x + dt * omega_dot_w.x, -50.0f, 50.0f),
                    clipf_(av.y + dt * omega_dot_w.y, -50.0f, 50.0f),
                    clipf_(av.z + dt * omega_dot_w.z, -50.0f, 50.0f));
  const V3 lv2 = v3(clipf_(lv.x + dt * a_lin_w.x, -100.0f, 100.0f),
                    clipf_(lv.y + dt * a_lin_w.y, -100.0f, 100.0f),
                    clipf_(lv.z + dt * a_lin_w.z, -100.0f, 100.0f));
  const V3 p2 = v3(p.x + dt * lv2.x, p.y + dt * lv2.y, p.z + dt * lv2.z);

  // _quat_integrate
  const float angle = sqrtf(av2.x * av2.x + av2.y * av2.y + av2.z * av2.z);
  const float inv = 1.0f / maxf_(angle, 1e-9f);
  const float half = 0.5f * angle * dt;
  const float sh = sinf(half) * inv;
  float ax = av2.x * sh, ay = av2.y * sh, az = av2.z * sh, aw = cosf(half);
  if (angle < 1e-9f) { ax = 0.0f; ay = 0.0f; az = 0.0f; aw = 1.0f; }
  const float ox = aw * qx + ax * qw + ay * qz - az * qy;
  const float oy = aw * qy - ax * qz + ay * qw + az * qx;
  const float oz = aw * qz + ax * qy - ay * qx + az * qw;
  const float ow = aw * qw - ax * qx - ay * qy - az * qz;
  const float norm = maxf_(sqrtf(ox * ox + oy * oy + oz * oz + ow * ow), 1e-9f);

  float* yb = Y + b;
  auto out = [&](int ch, float val) { yb[(size_t)ch * Bs] = val; };
  out(0, p2.x); out(1, p2.y); out(2, p2.z);
  out(3, ox / norm); out(4, oy / norm); out(5, oz / norm); out(6, ow / norm);
  out(7, lv2.x); out(8, lv2.y); out(9, lv2.z);
  out(10, av2.x); out(11, av2.y); out(12, av2.z);
  for (int j = 0; j < nq; ++j) {
    const float lim = T[T_QDLIM + j];
    float qdj = clipf_(qdl[j] + dt * qdd[j], -lim, lim);
    float qj = ql[j] + dt * qdj;
    const float lo = T[T_QLO + j], hi = T[T_QHI + j];
    const bool at_lo = qj < lo, at_hi = qj > hi;
    qj = clipf_(qj, lo, hi);
    // a joint stop zeroes qd only when qd points outward
    if (at_lo && qdj < 0.0f) qdj = 0.0f;
    if (at_hi && qdj > 0.0f) qdj = 0.0f;
    out(13 + j, qj);
    out(13 + nq + j, qdj);
  }
}

extern "C" int fused_step_table_size() { return TABLE_SIZE; }

extern "C" int fused_step_max_sizes(int* max_nb, int* max_ns) {
  *max_nb = MAX_NB;
  *max_ns = MAX_NS;
  return 0;
}

// Launches on `stream` (PyTorch's current stream); does not synchronise.
// Returns cudaGetLastError() after the launch (0 = success).
extern "C" int fused_step_launch(const float* X, float* Y, const float* tables, int B,
                                 int nb, int nq, int ns, int has_pay, int has_cs,
                                 int has_extra, int root_free, int model_root_free,
                                 float dt, void* stream) {
  if (B <= 0) return 0;
  const int grid = (B + THREADS - 1) / THREADS;
  fused_step_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      X, Y, tables, B, nb, nq, ns, has_pay, has_cs, has_extra, root_free,
      model_root_free, dt);
  return (int)cudaGetLastError();
}

// Three kernels over a batch of articulated actors that share one BodyModel,
// one CUDA thread ("lane") per body:
//
//   fused_step_kernel - one dynamics + integration substep: forward
//     kinematics down the tree, body velocities, contact and gravity wrenches
//     about body origins, Featherstone's articulated-body algorithm with
//     joint damping (6x6 Cholesky for a free base), then semi-implicit Euler
//     with velocity clips, joint limits and a quaternion exp-step.
//     Replaces the TPU kernel `step_actor_pallas`
//     (mqe_tpu/physics/pallas_step.py, pallas_call at line 141, body
//     `_kernel`), which runs the same chain, `soa.step_entries`, over
//     (tile, 128) lane tiles. Plain PyTorch version:
//     mqe_tpu_torch/physics/soa.py::step_actor.
//   fk_spheres_kernel - the first two stages of the same chain (FK and body
//     velocities, the same device code) and the collision spheres' world
//     positions and velocities: soa.fk_spheres, which feeds the contact
//     stage. The JAX package has no Pallas kernel for it (XLA fuses it into
//     the jitted step).
//   fk_full_kernel - the same, plus each body's world pose and world
//     velocity: soa.fk_full, which feeds the NPCs' contact stage (their
//     primitives are posed from the bodies). No Pallas kernel either.
//
// Every device function is named after the soa.py function it mirrors and
// keeps its order of operations.
//
// Design of the step kernel. A robot gets `lanes` consecutive threads of a warp, the smallest
// power of two >= nb (16 for go1's 13 bodies, so two robots a warp; 2 for
// the one-joint NPC models, 1 for a free body). Lane i owns body i and keeps
// its per-body quantities (poses, velocity, the 6x6 articulated inertia
// IA, pA, c, U, d, u) in registers: nothing is indexed by a runtime body
// number, so nothing lands in local memory. The tree is walked level by
// level (physics/model.py::tree_schedule puts each body's depth and its
// children in the model table), with __syncwarp() between levels; parent
// and child exchange through a per-thread slot of shared memory:
//   - root to leaves (FK, velocities, accelerations): a body at level L
//     reads its parent's Rw, pw, v (or acc) from the parent's slot;
//   - leaves to root (ABA): a body writes X^T Ia X and X^T pa into its slot,
//     and its parent adds its children's in descending child index, the
//     order of soa._aba's `for i = nb-1 .. 1`.
// A body's lane sums its own spheres' wrenches in ascending sphere index, as
// soa._contact_wrenches does. The 6x6 base solve runs on the root's lane.
// Lanes of one robot read its (B, k) row-major state consecutively; the
// kernel reads every state tensor through its own pointer and writes six
// output tensors (no packed buffer). Optional inputs are null when absent.
//
// Rounding: utils/build.py compiles with -fmad=false, so every multiply and
// add rounds on its own, as the plain version's tensor ops do; with the
// plain version's order of operations the outputs then differ from it only
// by sin/cos rounding and sums the plain version takes in another order.
// (With contraction the full FK of the seesaw missed the 1e-6 bound of
// tests/test_torch_soa.py::test_fk_matches_jax by 1.19e-6 in sph_v.)
//
// Model constants are not compiled in: they come from one float32 table per
// model (physics/model.py::model_tables, offsets below), so one build serves
// go1 and the NPC models. The step kernel copies the whole table into shared
// memory in each block; the FK kernels read only their fields of it (see
// below).
//
// Design of the FK kernels, in three phases a block:
//   1. one lane per body, as in the step kernel (`fk_levels`, the same
//      device code): the tree walked level by level, each body's Rw, pw, v
//      and its world velocity left in its slot. The lanes read the table's
//      FK fields (parent, level, joint frames and axes, sphere bodies and
//      offsets: ~550 of its 1,664 floats) through the read-only data path,
//      where they stay in L1; there is no block copy of the table and no
//      block barrier before the walk.
//   2. after one __syncthreads(), the block's (robot, sphere) pairs are
//      spread over all its threads in order (thread t takes pairs t,
//      t + 128, ...), so no lane loops over all ns spheres and a body with
//      many spheres (go1's base has 8 of 40) holds up no warp. Each pair's
//      x and v go to a staging area in shared memory.
//   3. after a second __syncthreads(), the block writes its contiguous span
//      of sph_x and sph_v (and fk_full its Rw, pw, vw rows, straight from
//      the slots) with consecutive threads on consecutive floats.
// A block takes `robots_per_block` robots, a launch parameter that the
// wrapper chooses (physics/fused_step.py::fk_robots_per_block): full blocks for
// go1's robots, fewer robots a block for the NPC launches so that B = 4096
// spreads over about four blocks an SM (512 blocks of 8 robots, where one
// robot a lane gave 32 and 64 blocks).
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s float32 without tensor
// cores), at the go1gate slice (B = 8192 robots):
//   - step: reads pos, quat, lin_vel, ang_vel, q, qd, tau, sphere forces and
//     positions, payload, com shift (293 floats a robot) and writes 37:
//     10.8 MB, 3.2 us; the plain version's 2.25e4 float operations a robot
//     take 2.8 us. Bound by bytes.
//   - fk_spheres: reads 37 floats a robot, writes 240: 9.1 MB, 2.7 us.
//   - fk_full, at an NPC launch of the go1pushbox and go1seesaw slices
//     (B = 4096 NPCs): a box reads 13 floats and writes 18 + 48, 1.3 MB,
//     0.4 us; a seesaw (2 bodies, 35 spheres) reads 15 and writes 36 + 210,
//     4.3 MB, 1.3 us. Bound by bytes, like fk_spheres; the same design.
// What the design does about the bound: each byte is read once and written
// once with neighbouring lanes on neighbouring addresses, and the tree's
// arithmetic runs on 13 lanes a robot instead of one thread. At the NPC
// launches the bytes take less time than a launch; there the FK kernels aim
// at latency: no table copy and barrier ahead of the walk, enough blocks to
// occupy every SM, each thread a few spheres.

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
#define T_LEVEL (T_SPOS + MAX_NS * 3)
#define T_NCHILD (T_LEVEL + MAX_NB)
#define T_CHILD (T_NCHILD + MAX_NB)
#define TABLE_SIZE (T_CHILD + MAX_NB * MAX_NB)

// floats of a thread's exchange slot in shared memory, stored field-major
// (field f of slot k at f * THREADS + k: the lanes of a warp hit distinct
// banks)
#define FK_FIELDS 24    // fk_levels' Rw 9, pw 3, v 6; then world velocity ww 3, vw 3
#define STEP_FIELDS 42  // ABA: X^T Ia X 36, X^T pa 6 (also holds fk_levels' 18)
// a block's shared memory without opting in to more
#define SHARED_LIMIT (48 * 1024)

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

// sin and cos of a float angle, rounded from double precision. sinf/cosf
// keep a 32-byte local array for the reduction of huge arguments, which puts
// a stack frame on every kernel that calls them; sincospi reduces exactly
// and needs none. The rounded double result is within about half a float
// ulp of the exact value; sinf/cosf promise 2 ulp.
DEV void sincos_(float angle, float* s, float* c) {
  double sd, cd;
  sincospi((double)angle * 0.318309886183790671538, &sd, &cd);  // angle / pi
  *s = (float)sd;
  *c = (float)cd;
}

DEV M3 rodrigues(float angle, V3 ax) {
  float c, s;
  sincos_(angle, &s, &c);
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


// ---------------------------------------------------------------------------
// the exchange slots
// ---------------------------------------------------------------------------

DEV void put(float* S, int slot, int f, float x) { S[f * THREADS + slot] = x; }
DEV float get(const float* S, int slot, int f) { return S[f * THREADS + slot]; }
DEV void put_v(float* S, int slot, int f, V3 a) {
  put(S, slot, f, a.x); put(S, slot, f + 1, a.y); put(S, slot, f + 2, a.z);
}
DEV V3 get_v(const float* S, int slot, int f) {
  return v3(get(S, slot, f), get(S, slot, f + 1), get(S, slot, f + 2));
}
DEV void put_m(float* S, int slot, int f, const M3& M) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) put(S, slot, f + 3 * i + j, M.a[i][j]);
}
DEV M3 get_m(const float* S, int slot, int f) {
  M3 r;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) r.a[i][j] = get(S, slot, f + 3 * i + j);
  return r;
}
DEV void put_s(float* S, int slot, int f, const SV& x) { put_v(S, slot, f, x.w); put_v(S, slot, f + 3, x.v); }
DEV SV get_s(const float* S, int slot, int f) { return sv(get_v(S, slot, f), get_v(S, slot, f + 3)); }

// ---------------------------------------------------------------------------
// one lane = one body of one robot
// ---------------------------------------------------------------------------

struct Lane {
  long long b;    // robot
  int body;       // body of this lane
  int slot;       // this lane's exchange slot (threadIdx.x)
  int root;       // the slot of the robot's root body
  int level;      // depth of the body in the tree (root 0)
  int par;        // parent body (-1 for the root)
  bool active;    // a body of a robot in the batch
};

// The block's copy of the model table, and the lane's place in the batch.
// Every thread of the block runs every __syncwarp() of the kernel, active or
// not, so the warp's masks stay full.
DEV Lane lane_setup(float* T, const float* __restrict__ tables, int B, int nb,
                    int lanes_log2, int* depth) {
  for (int k = threadIdx.x; k < TABLE_SIZE; k += blockDim.x) T[k] = tables[k];
  __syncthreads();
  Lane L;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  L.b = tid >> lanes_log2;
  L.body = threadIdx.x & ((1 << lanes_log2) - 1);
  L.slot = threadIdx.x;
  L.root = threadIdx.x - L.body;
  L.active = L.b < B && L.body < nb;
  L.level = L.body < nb ? (int)T[T_LEVEL + L.body] : 0;
  L.par = L.body < nb ? (int)T[T_PARENT + L.body] : -1;
  int d = 0;
  for (int i = 0; i < nb; ++i) d = max(d, (int)T[T_LEVEL + i]);
  *depth = d;
  return L;
}

// The lane's inputs from the (B, k) row-major state tensors.
struct BodyIn {
  V3 p, lv, av;
  float qx, qy, qz, qw;
  float qi, qdi;
};

DEV BodyIn load_body(const Lane& L, int nq, const float* __restrict__ pos,
                     const float* __restrict__ quat, const float* __restrict__ lin_vel,
                     const float* __restrict__ ang_vel, const float* __restrict__ q,
                     const float* __restrict__ qd) {
  BodyIn in;
  const V3 z = v3(0.0f, 0.0f, 0.0f);
  in.p = z; in.lv = z; in.av = z;
  in.qx = 0.0f; in.qy = 0.0f; in.qz = 0.0f; in.qw = 1.0f;
  in.qi = 0.0f; in.qdi = 0.0f;
  if (!L.active) return in;
  const long long b = L.b;
  if (L.body == 0) {
    in.p = v_load(pos + 3 * b);
    in.lv = v_load(lin_vel + 3 * b);
    in.av = v_load(ang_vel + 3 * b);
    const float* qt = quat + 4 * b;
    in.qx = qt[0]; in.qy = qt[1]; in.qz = qt[2]; in.qw = qt[3];
  } else {
    in.qi = q[b * nq + L.body - 1];
    in.qdi = qd[b * nq + L.body - 1];
  }
  return in;
}

// Per-body kinematics: world pose (Rw, pw), pose in the parent (Rl, pl) and
// the body-frame spatial velocity v (soa._fk and soa._body_vels).
struct Kin {
  M3 Rw, Rl;
  V3 pw, pl;
  SV v;
};

// _fk + _body_vels, level by level. The root's lane reads the base state
// of `in`, a joint lane its joint's qi, qdi.
DEV Kin fk_levels(const float* T, float* S, const Lane& L, int depth, const BodyIn& in) {
  Kin k;
  const int i = L.body;
  if (L.active && i == 0) {
    k.Rw = quat_to_mat(in.qx, in.qy, in.qz, in.qw);
    k.pw = in.p;
    k.v = sv(mT_vec(k.Rw, in.av), mT_vec(k.Rw, in.lv));
    put_m(S, L.slot, 0, k.Rw);
    put_v(S, L.slot, 9, k.pw);
    put_s(S, L.slot, 12, k.v);
  }
  if (L.active && i > 0) {
    const M3 jrot = m_load(T + T_JROT + 9 * i);
    const V3 jpos = v_load(T + T_JPOS + 3 * i);
    const V3 axis = v_load(T + T_JAXIS + 3 * i);
    if ((int)T[T_JTYPE + i] == JOINT_PRISMATIC) {
      k.Rl = jrot;
      k.pl = v_add(jpos, m_vec(jrot, v_scale(axis, in.qi)));
    } else {
      k.Rl = m_mul(jrot, rodrigues(in.qi, axis));
      k.pl = jpos;
    }
  }
  for (int lev = 1; lev <= depth; ++lev) {
    __syncwarp();
    if (L.active && L.level == lev) {
      const int ps = L.root + L.par;
      const M3 Rwp = get_m(S, ps, 0);
      const V3 pwp = get_v(S, ps, 9);
      const SV vp = get_s(S, ps, 12);
      k.Rw = m_mul(Rwp, k.Rl);
      k.pw = v_add(pwp, m_vec(Rwp, k.pl));
      const SV S_ = joint_S(T, i);
      const SV vi = x_motion(k.Rl, k.pl, vp);
      k.v = sv(v_add(vi.w, v_scale(S_.w, in.qdi)), v_add(vi.v, v_scale(S_.v, in.qdi)));
      put_m(S, L.slot, 0, k.Rw);
      put_v(S, L.slot, 9, k.pw);
      put_s(S, L.slot, 12, k.v);
    }
  }
  __syncwarp();  // every read of the slots is done: they may be reused
  return k;
}

// ---------------------------------------------------------------------------
// fk_spheres: soa.fk_spheres -> sph_x, sph_v (B, ns, 3)
// fk_full: soa.fk_full -> Rw (B, nb, 3, 3), pw (B, nb, 3), vw (B, nb, 6), sph_x, sph_v
// ---------------------------------------------------------------------------

// Bytes of shared memory an FK block takes: the slots, then the staged
// sph_x and sph_v of its robots.
__host__ __device__ inline int fk_shared_bytes_(int rpb, int ns) {
  return (FK_FIELDS * THREADS + 6 * rpb * ns) * (int)sizeof(float);
}

// The FK kernels' lane: robot threadIdx.x >> lanes_log2 of the block's
// `rpb`; `depth` the tree's depth. Table fields come through the read-only
// path (__ldg).
DEV Lane fk_lane(const float* __restrict__ T, int B, int nb, int lanes_log2, int rpb,
                 int* depth) {
  Lane L;
  const int r = threadIdx.x >> lanes_log2;
  L.body = threadIdx.x & ((1 << lanes_log2) - 1);
  L.b = (long long)blockIdx.x * rpb + r;
  L.slot = threadIdx.x;
  L.root = threadIdx.x - L.body;
  L.active = r < rpb && L.b < B && L.body < nb;
  L.level = L.body < nb ? (int)__ldg(T + T_LEVEL + L.body) : 0;
  L.par = L.body < nb ? (int)__ldg(T + T_PARENT + L.body) : -1;
  int d = 0;
  for (int i = 0; i < nb; ++i) d = max(d, (int)__ldg(T + T_LEVEL + i));
  *depth = d;
  return L;
}

// fk_full's pose and velocity rows: `nf` fields from f0 of each (robot, body)
// slot to the block's rows of `out`, consecutive threads on consecutive floats.
DEV void fk_rows(float* __restrict__ out, const float* S, int f0, int nf, int nr, int nb,
                 int lanes_log2) {
  for (int e = threadIdx.x; e < nr * nb * nf; e += THREADS) {
    const int rb = e / nf, f = e - rb * nf;
    const int r = rb / nb, i = rb - r * nb;
    out[e] = get(S, (r << lanes_log2) + i, f0 + f);
  }
}

// One block of either FK kernel; `Rw_o` null for fk_spheres.
DEV void fk_block(float* smem, const float* __restrict__ pos, const float* __restrict__ quat,
                  const float* __restrict__ lin_vel, const float* __restrict__ ang_vel,
                  const float* __restrict__ q, const float* __restrict__ qd,
                  float* __restrict__ Rw_o, float* __restrict__ pw_o, float* __restrict__ vw_o,
                  float* __restrict__ sph_x, float* __restrict__ sph_v,
                  const float* __restrict__ T, int B, int nb, int nq, int ns, int lanes_log2,
                  int rpb) {
  float* S = smem;                            // the slots, FK_FIELDS * THREADS
  float* X = smem + FK_FIELDS * THREADS;      // staged sph_x, rpb * ns * 3
  float* V = X + rpb * ns * 3;                // staged sph_v
  const long long b0 = (long long)blockIdx.x * rpb;
  const int nr = (int)min((long long)rpb, (long long)B - b0);

  // ---- phase 1: _fk + _body_vels, one lane a body ----
  int depth;
  const Lane L = fk_lane(T, B, nb, lanes_log2, rpb, &depth);
  const BodyIn in = load_body(L, nq, pos, quat, lin_vel, ang_vel, q, qd);
  const Kin k = fk_levels(T, S, L, depth, in);
  if (L.active) {  // _body_vels' world velocity (angular, linear)
    put_v(S, L.slot, 18, m_vec(k.Rw, k.v.w));
    put_v(S, L.slot, 21, m_vec(k.Rw, k.v.v));
  }
  __syncthreads();

  // ---- phase 2: _spheres, the block's (robot, sphere) pairs in order ----
  for (int p = threadIdx.x; p < nr * ns; p += THREADS) {
    const int r = p / ns, s = p - r * ns;
    const int slot = (r << lanes_log2) + (int)__ldg(T + T_SBODY + s);
    const M3 Rw = get_m(S, slot, 0);
    const V3 pw = get_v(S, slot, 9), ww = get_v(S, slot, 18), vw = get_v(S, slot, 21);
    const V3 off = v3(__ldg(T + T_SPOS + 3 * s), __ldg(T + T_SPOS + 3 * s + 1),
                      __ldg(T + T_SPOS + 3 * s + 2));
    const V3 x = v_add(pw, m_vec(Rw, off));
    const V3 vel = v_add(vw, v_cross(ww, v_sub(x, pw)));
    X[3 * p] = x.x; X[3 * p + 1] = x.y; X[3 * p + 2] = x.z;
    V[3 * p] = vel.x; V[3 * p + 1] = vel.y; V[3 * p + 2] = vel.z;
  }
  if (Rw_o != nullptr) {  // fk_full's rows need only the slots
    fk_rows(Rw_o + b0 * nb * 9, S, 0, 9, nr, nb, lanes_log2);
    fk_rows(pw_o + b0 * nb * 3, S, 9, 3, nr, nb, lanes_log2);
    fk_rows(vw_o + b0 * nb * 6, S, 18, 6, nr, nb, lanes_log2);
  }
  __syncthreads();

  // ---- phase 3: the block's span of sph_x and sph_v ----
  const long long o = b0 * ns * 3;
  for (int e = threadIdx.x; e < nr * ns * 3; e += THREADS) {
    sph_x[o + e] = X[e];
    sph_v[o + e] = V[e];
  }
}

__global__ void __launch_bounds__(THREADS)
fk_spheres_kernel(const float* __restrict__ pos, const float* __restrict__ quat,
                  const float* __restrict__ lin_vel, const float* __restrict__ ang_vel,
                  const float* __restrict__ q, const float* __restrict__ qd,
                  float* __restrict__ sph_x, float* __restrict__ sph_v,
                  const float* __restrict__ tables, int B, int nb, int nq, int ns,
                  int lanes_log2, int rpb) {
  extern __shared__ float smem[];
  fk_block(smem, pos, quat, lin_vel, ang_vel, q, qd, nullptr, nullptr, nullptr, sph_x, sph_v,
           tables, B, nb, nq, ns, lanes_log2, rpb);
}

__global__ void __launch_bounds__(THREADS)
fk_full_kernel(const float* __restrict__ pos, const float* __restrict__ quat,
               const float* __restrict__ lin_vel, const float* __restrict__ ang_vel,
               const float* __restrict__ q, const float* __restrict__ qd,
               float* __restrict__ Rw_o, float* __restrict__ pw_o, float* __restrict__ vw_o,
               float* __restrict__ sph_x, float* __restrict__ sph_v,
               const float* __restrict__ tables, int B, int nb, int nq, int ns,
               int lanes_log2, int rpb) {
  extern __shared__ float smem[];
  fk_block(smem, pos, quat, lin_vel, ang_vel, q, qd, Rw_o, pw_o, vw_o, sph_x, sph_v,
           tables, B, nb, nq, ns, lanes_log2, rpb);
}

// ---------------------------------------------------------------------------
// fused_step: soa.step_actor -> pos, quat, lin_vel, ang_vel, q, qd
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS)
fused_step_kernel(const float* __restrict__ pos, const float* __restrict__ quat,
                  const float* __restrict__ lin_vel, const float* __restrict__ ang_vel,
                  const float* __restrict__ q, const float* __restrict__ qd,
                  const float* __restrict__ tau, const float* __restrict__ sph_force,
                  const float* __restrict__ sph_x, const float* __restrict__ payload,
                  const float* __restrict__ com_shift, const float* __restrict__ extra,
                  float* __restrict__ pos_o, float* __restrict__ quat_o,
                  float* __restrict__ lin_vel_o, float* __restrict__ ang_vel_o,
                  float* __restrict__ q_o, float* __restrict__ qd_o,
                  const float* __restrict__ tables, int B, int nb, int nq, int ns,
                  int lanes_log2, int root_free, int model_root_free, float dt) {
  __shared__ float T[TABLE_SIZE];
  __shared__ float S[STEP_FIELDS * THREADS];
  int depth;
  const Lane L = lane_setup(T, tables, B, nb, lanes_log2, &depth);
  const int i = L.body;
  const long long b = L.b;
  const BodyIn in = load_body(L, nq, pos, quat, lin_vel, ang_vel, q, qd);
  const bool has_pay = payload != nullptr, has_cs = com_shift != nullptr;
  float pay = 0.0f, taui = 0.0f;
  V3 cs = v3(0.0f, 0.0f, 0.0f);
  if (L.active && i == 0) {
    if (has_pay) pay = payload[b];
    if (has_cs) cs = v_load(com_shift + 3 * b);
  }
  if (L.active && i > 0) taui = tau[b * nq + i - 1];

  // ---- _fk, _body_vels ----
  const Kin k = fk_levels(T, S, L, depth, in);

  SV pA = sv(v3(0.0f, 0.0f, 0.0f), v3(0.0f, 0.0f, 0.0f)), c = pA, U = pA;
  SM IA;
  float d = 1.0f, u = 0.0f;
  if (L.active) {
    // ---- _contact_wrenches (this body's spheres, ascending) + _gravity_wrenches (+ extra) ----
    V3 fn = v3(0.0f, 0.0f, 0.0f), ff = fn;
    for (int s = 0; s < ns; ++s) {
      if ((int)T[T_SBODY + s] != i) continue;
      const V3 x = v_load(sph_x + (b * ns + s) * 3);
      const V3 f = v_load(sph_force + (b * ns + s) * 3);
      fn = v_add(fn, v_cross(v_sub(x, k.pw), f));
      ff = v_add(ff, f);
    }
    float mass = T[T_MASS + i];
    V3 com = v_load(T + T_COM + 3 * i);
    if (i == 0) {
      if (has_pay) mass = mass + pay;
      if (has_cs) com = v_add(com, cs);
    }
    const V3 com_w = m_vec(k.Rw, com);
    const V3 fg = v3(0.0f, 0.0f, mass * -9.81f);
    fn = v_add(fn, v_cross(com_w, fg));
    ff = v_add(ff, fg);
    if (extra != nullptr) {
      const float* e = extra + (b * nb + i) * 6;
      fn = v_add(fn, v3(e[0], e[1], e[2]));
      ff = v_add(ff, v3(e[3], e[4], e[5]));
    }

    // ---- _inertias ----
    if (i == 0 && (has_pay || has_cs)) {
      IA = spatial_inertia_blocks(T[T_MASS] + pay, v_add(v_load(T + T_COM), cs),
                                  m_load(T + T_ICOM));
    } else {
      const float* Ip = T + T_ISPAT + 36 * i;
#pragma unroll
      for (int ii = 0; ii < 3; ++ii)
#pragma unroll
        for (int jj = 0; jj < 3; ++jj) {
          IA.A.a[ii][jj] = Ip[ii * 6 + jj];
          IA.B.a[ii][jj] = Ip[ii * 6 + jj + 3];
          IA.C.a[ii][jj] = Ip[(ii + 3) * 6 + jj];
          IA.D.a[ii][jj] = Ip[(ii + 3) * 6 + jj + 3];
        }
    }

    // ---- _aba: bias force and velocity product ----
    const SV fb = sv(mT_vec(k.Rw, fn), mT_vec(k.Rw, ff));
    const SV bias = cross_force(k.v, s_vec(IA, k.v));
    pA = sv(v_sub(bias.w, fb.w), v_sub(bias.v, fb.v));
    if (i > 0) {
      const SV S_ = joint_S(T, i);
      c = cross_motion(k.v, sv(v_scale(S_.w, in.qdi), v_scale(S_.v, in.qdi)));
    }
  }

  // ---- _aba: leaves to root ----
  for (int lev = depth; lev >= 1; --lev) {
    if (L.active && L.level == lev) {
      const SV S_ = joint_S(T, i);
      const float tau_eff = taui - T[T_DAMP + i - 1] * in.qdi;
      U = s_vec(IA, S_);
      d = s_dot(S_, U) + 1e-9f;
      u = tau_eff - s_dot(S_, pA);
      const float inv_d = 1.0f / d;
      const SM Ia = s_sub(IA, s_outer_scaled(U, U, inv_d));
      const SV Iac = s_vec(Ia, c);
      const float us = u * inv_d;
      const SV Uu = sv(v_scale(U.w, us), v_scale(U.v, us));
      const SV pa = sv(v_add(v_add(pA.w, Iac.w), Uu.w), v_add(v_add(pA.v, Iac.v), Uu.v));

      // X^T Ia X with X = [[Rt, 0], [-Rt phat, Rt]], and X^T pa
      const M3& R = k.Rl;
      const M3 Rt = m_transpose(R);
      const M3 P = m_skew(k.pl);
      const M3 RtP = m_mul(Rt, P);
      const M3 PR = m_mul(P, R);
      const M3 M11 = m_sub(m_mul(Ia.A, Rt), m_mul(Ia.B, RtP));
      const M3 M12 = m_mul(Ia.B, Rt);
      const M3 M21 = m_sub(m_mul(Ia.C, Rt), m_mul(Ia.D, RtP));
      const M3 M22 = m_mul(Ia.D, Rt);
      put_m(S, L.slot, 0, m_add(m_mul(R, M11), m_mul(PR, M21)));
      put_m(S, L.slot, 9, m_add(m_mul(R, M12), m_mul(PR, M22)));
      put_m(S, L.slot, 18, m_mul(R, M21));
      put_m(S, L.slot, 27, m_mul(R, M22));
      put_s(S, L.slot, 36, xT_force(k.Rl, k.pl, pa));
    }
    __syncwarp();
    if (L.active && L.level == lev - 1) {
      // IA[par] += N, pA[par] += xf, children in descending index
      const int nch = (int)T[T_NCHILD + i];
      for (int j = 0; j < nch; ++j) {
        const int cs_ = L.root + (int)T[T_CHILD + MAX_NB * i + j];
        SM N;
        N.A = get_m(S, cs_, 0);
        N.B = get_m(S, cs_, 9);
        N.C = get_m(S, cs_, 18);
        N.D = get_m(S, cs_, 27);
        IA = s_add(IA, N);
        const SV xf = get_s(S, cs_, 36);
        pA = sv(v_add(pA.w, xf.w), v_add(pA.v, xf.v));
      }
    }
    __syncwarp();
  }

  // ---- _aba: the base, on the root's lane ----
  SV acc = sv(v3(0.0f, 0.0f, 0.0f), v3(0.0f, 0.0f, 0.0f));
  if (L.active && i == 0) {
    if (model_root_free) {
      SM I0 = IA;
#pragma unroll
      for (int kk = 0; kk < 3; ++kk) {
        I0.A.a[kk][kk] = I0.A.a[kk][kk] + 1e-9f;
        I0.D.a[kk][kk] = I0.D.a[kk][kk] + 1e-9f;
      }
      acc = solve_spd6(I0, sv(v_scale(pA.w, -1.0f), v_scale(pA.v, -1.0f)));
    } else {
      const float z = pA.w.x * 0.0f;
      acc = sv(v3(z, z, z), v3(z, z, z));
    }
    put_s(S, L.slot, 0, acc);
  }

  // ---- _aba: root to leaves ----
  float qdd = 0.0f;
  for (int lev = 1; lev <= depth; ++lev) {
    __syncwarp();
    if (L.active && L.level == lev) {
      const SV S_ = joint_S(T, i);
      SV ai = x_motion(k.Rl, k.pl, get_s(S, L.root + L.par, 0));
      ai = sv(v_add(ai.w, c.w), v_add(ai.v, c.v));
      qdd = (u - s_dot(U, ai)) / d;
      acc = sv(v_add(ai.w, v_scale(S_.w, qdd)), v_add(ai.v, v_scale(S_.v, qdd)));
      put_s(S, L.slot, 0, acc);
    }
  }
  if (!L.active) return;  // no __syncwarp() follows

  if (i == 0) {
    // ---- world accelerations of the base (step_entries) ----
    V3 omega_dot_w = m_vec(k.Rw, acc.w);
    V3 a_lin_w = m_vec(k.Rw, v_add(acc.v, v_cross(k.v.w, k.v.v)));
    if (!root_free) {
      const float z = in.p.x * 0.0f;
      omega_dot_w = v3(z, z, z);
      a_lin_w = v3(z, z, z);
    }

    // ---- _integrate: the base ----
    const V3 av = in.av, lv = in.lv, p = in.p;
    const V3 av2 = v3(clipf_(av.x + dt * omega_dot_w.x, -50.0f, 50.0f),
                      clipf_(av.y + dt * omega_dot_w.y, -50.0f, 50.0f),
                      clipf_(av.z + dt * omega_dot_w.z, -50.0f, 50.0f));
    const V3 lv2 = v3(clipf_(lv.x + dt * a_lin_w.x, -100.0f, 100.0f),
                      clipf_(lv.y + dt * a_lin_w.y, -100.0f, 100.0f),
                      clipf_(lv.z + dt * a_lin_w.z, -100.0f, 100.0f));
    const V3 p2 = v3(p.x + dt * lv2.x, p.y + dt * lv2.y, p.z + dt * lv2.z);

    // _quat_integrate
    const float qx = in.qx, qy = in.qy, qz = in.qz, qw = in.qw;
    const float angle = sqrtf(av2.x * av2.x + av2.y * av2.y + av2.z * av2.z);
    const float inv = 1.0f / maxf_(angle, 1e-9f);
    const float half = 0.5f * angle * dt;
    float sin_half, aw;
    sincos_(half, &sin_half, &aw);
    const float sh = sin_half * inv;
    float ax = av2.x * sh, ay = av2.y * sh, az = av2.z * sh;
    if (angle < 1e-9f) { ax = 0.0f; ay = 0.0f; az = 0.0f; aw = 1.0f; }
    const float ox = aw * qx + ax * qw + ay * qz - az * qy;
    const float oy = aw * qy - ax * qz + ay * qw + az * qx;
    const float oz = aw * qz + ax * qy - ay * qx + az * qw;
    const float ow = aw * qw - ax * qx - ay * qy - az * qz;
    const float norm = maxf_(sqrtf(ox * ox + oy * oy + oz * oz + ow * ow), 1e-9f);

    float* po = pos_o + 3 * b;
    po[0] = p2.x; po[1] = p2.y; po[2] = p2.z;
    float* qo = quat_o + 4 * b;
    qo[0] = ox / norm; qo[1] = oy / norm; qo[2] = oz / norm; qo[3] = ow / norm;
    float* lo_ = lin_vel_o + 3 * b;
    lo_[0] = lv2.x; lo_[1] = lv2.y; lo_[2] = lv2.z;
    float* ao = ang_vel_o + 3 * b;
    ao[0] = av2.x; ao[1] = av2.y; ao[2] = av2.z;
  } else {
    // ---- _integrate: this body's joint ----
    const int j = i - 1;
    const float lim = T[T_QDLIM + j];
    float qdj = clipf_(in.qdi + dt * qdd, -lim, lim);
    float qj = in.qi + dt * qdj;
    const float lo = T[T_QLO + j], hi = T[T_QHI + j];
    const bool at_lo = qj < lo, at_hi = qj > hi;
    qj = clipf_(qj, lo, hi);
    // a joint stop zeroes qd only when qd points outward
    if (at_lo && qdj < 0.0f) qdj = 0.0f;
    if (at_hi && qdj > 0.0f) qdj = 0.0f;
    q_o[b * nq + j] = qj;
    qd_o[b * nq + j] = qdj;
  }
}

extern "C" int fused_step_table_size() { return TABLE_SIZE; }

extern "C" int fused_step_max_sizes(int* max_nb, int* max_ns) {
  *max_nb = MAX_NB;
  *max_ns = MAX_NS;
  return 0;
}

static int grid_for(int B, int lanes_log2) {
  const long long threads = (long long)B << lanes_log2;
  return (int)((threads + THREADS - 1) / THREADS);
}

// All three launch on `stream` (PyTorch's current stream) and do not synchronise.
// They return cudaGetLastError() after the launch (0 = success).
extern "C" int fused_step_launch(const float* pos, const float* quat, const float* lin_vel,
                                 const float* ang_vel, const float* q, const float* qd,
                                 const float* tau, const float* sph_force, const float* sph_x,
                                 const float* payload, const float* com_shift,
                                 const float* extra, float* pos_o, float* quat_o,
                                 float* lin_vel_o, float* ang_vel_o, float* q_o, float* qd_o,
                                 const float* tables, int B, int nb, int nq, int ns,
                                 int lanes_log2, int root_free, int model_root_free,
                                 float dt, void* stream) {
  if (B <= 0) return 0;
  fused_step_kernel<<<grid_for(B, lanes_log2), THREADS, 0, (cudaStream_t)stream>>>(
      pos, quat, lin_vel, ang_vel, q, qd, tau, sph_force, sph_x, payload, com_shift, extra,
      pos_o, quat_o, lin_vel_o, ang_vel_o, q_o, qd_o, tables, B, nb, nq, ns, lanes_log2,
      root_free, model_root_free, dt);
  return (int)cudaGetLastError();
}

// The FK launches' grid for `rpb` robots a block, or 0 (and *rc) when the
// geometry is one the kernels do not take.
static int fk_grid(int B, int nb, int ns, int lanes_log2, int rpb, int* rc) {
  if (rpb < 1 || (rpb << lanes_log2) > THREADS || nb > (1 << lanes_log2) ||
      fk_shared_bytes_(rpb, ns) > SHARED_LIMIT) {
    *rc = (int)cudaErrorInvalidValue;
    return 0;
  }
  *rc = 0;
  return (B + rpb - 1) / rpb;
}

extern "C" int fk_shared_bytes(int rpb, int ns) { return fk_shared_bytes_(rpb, ns); }

extern "C" int fk_spheres_launch(const float* pos, const float* quat, const float* lin_vel,
                                 const float* ang_vel, const float* q, const float* qd,
                                 float* sph_x, float* sph_v, const float* tables, int B,
                                 int nb, int nq, int ns, int lanes_log2, int rpb, void* stream) {
  if (B <= 0) return 0;
  int rc;
  const int grid = fk_grid(B, nb, ns, lanes_log2, rpb, &rc);
  if (rc != 0) return rc;
  fk_spheres_kernel<<<grid, THREADS, fk_shared_bytes_(rpb, ns), (cudaStream_t)stream>>>(
      pos, quat, lin_vel, ang_vel, q, qd, sph_x, sph_v, tables, B, nb, nq, ns, lanes_log2, rpb);
  return (int)cudaGetLastError();
}

extern "C" int fk_full_launch(const float* pos, const float* quat, const float* lin_vel,
                              const float* ang_vel, const float* q, const float* qd,
                              float* Rw, float* pw, float* vw, float* sph_x, float* sph_v,
                              const float* tables, int B, int nb, int nq, int ns,
                              int lanes_log2, int rpb, void* stream) {
  if (B <= 0) return 0;
  int rc;
  const int grid = fk_grid(B, nb, ns, lanes_log2, rpb, &rc);
  if (rc != 0) return rc;
  fk_full_kernel<<<grid, THREADS, fk_shared_bytes_(rpb, ns), (cudaStream_t)stream>>>(
      pos, quat, lin_vel, ang_vel, q, qd, Rw, pw, vw, sph_x, sph_v, tables, B, nb, nq, ns,
      lanes_log2, rpb);
  return (int)cudaGetLastError();
}

// Per-frame math of the unrolled fused kernels: Kabsch alignment by QCP,
// every feature, the MLP, and the hand-derived adjoints of all three.
//
// Port of the tile math in molann_tpu/ops/fused.py:172-548
// (qcp_rotation, _align_tiles, the feature rows, _mlp_tiles,
// _forward_tiles). The Pallas kernels get their backward by applying
// jax.vjp to that math; a CUDA kernel has no autodiff, so the adjoints are
// written out here. Every function is __host__ __device__: the same code
// runs in the CUDA kernels (fused_unrolled.cu, fused_train.cu) and, compiled
// with a host C++ compiler, in the CPU test of the adjoints
// (tests/test_torch_port_frame_math.py).
//
// Conventions (row-vector, as in the JAX package):
//   c        = mean of the align atoms,
//   H[i][j]  = sum_n (x[a_n][i] - c[i]) * ref[n][j],
//   aligned  = (x - c) @ R, applied only to atoms that feed position
//              features; other features are rigid-motion invariant.
#pragma once

#ifndef __CUDACC__
#define __host__
#define __device__
#define __forceinline__ inline
#endif

#include <math.h>

// Compile-time envelope; the Python wrapper checks every model against it
// (molann_tpu_torch/ops/fused.py mirrors these numbers).
#define MOLANN_MAX_ATOMS 64   // UNROLLED_MAX_ATOMS, molann_tpu/ops/fused.py:72
#define MOLANN_MAX_COLS 96    // UNROLLED_MAX_COLS, molann_tpu/ops/fused.py:73
#define MOLANN_MAX_WIDTH 64   // widest MLP layer output (hidden or last)
#define MOLANN_MAX_LAYERS 4   // Linear layers of the MLP head
#define MOLANN_NEWTON_ITERS 12

enum { MOLANN_ACT_IDENTITY = 0, MOLANN_ACT_TANH = 1, MOLANN_ACT_RELU = 2,
       MOLANN_ACT_SIGMOID = 3 };

// Model description passed by value to the kernels. The index tables are
// int32 arrays and the weights float32 arrays in the kernel's memory space
// (device pointers in the kernels, host pointers in the host test). Field
// order is mirrored by the ctypes.Structure in ops/fused.py.
struct ModelArgs {
  int n_atoms;
  int n_angles, n_bonds, n_dihedrals, n_pos, n_align;
  int n_coord;     // coordination features, one column each
  int use_angle_value;
  int n_feat;      // feature columns (spec.out_dim)
  int has_perm;    // 0: feature columns already in feature-list order
  int n_layers;    // Linear layers (0: the features are the output)
  int activation;  // MOLANN_ACT_*
  int dims[MOLANN_MAX_LAYERS + 1];  // dims[0] = n_feat, dims[L+1] = out of L
  const int* angle_idx;     // [n_angles * 3], central atom second
  const int* bond_idx;      // [n_bonds * 2]
  const int* dihedral_idx;  // [n_dihedrals * 4]
  const int* pos_idx;       // [n_pos]
  const int* align_idx;     // [n_align]
  const int* perm;          // [n_feat] or null
  const int* coord_start;   // [n_coord + 1] rows of coord_pairs
  const int* coord_pairs;   // [n_pairs * 2] (i, j), d = x[j] - x[i]
  const float* coord_par;   // [n_coord * MOLANN_COORD_FLOATS]
  const float* ref_x;       // [n_align * 3] centred reference
  const float* params;      // per layer: Wt [d_out * d_in] row-major, b [d_out]
};

__host__ __device__ __forceinline__ int model_out_dim(const ModelArgs& m) {
  return m.n_layers ? m.dims[m.n_layers] : m.n_feat;
}

// Entries of the flat gradient vector [ref_x | W0 | b0 | W1 | b1 ...].
__host__ __device__ __forceinline__ int model_grad_size(const ModelArgs& m) {
  int n = 3 * m.n_align;
  for (int L = 0; L < m.n_layers; ++L) n += m.dims[L + 1] * (m.dims[L] + 1);
  return n;
}

// Frames per block of every kernel: 128 while the block's [F, 3n] input
// slab fits the default 48 KB of shared memory, else 64 (3n <= 192 always
// fits at 64).
inline int frames_per_block(int n3) { return n3 <= 96 ? 128 : 64; }

// ---------------------------------------------------------------------------
// Forward-mode dual numbers with 9 tangents: one per entry of H. Running the
// last Newton step, the adjugate, the normalisation and R(q) on Dual9 gives
// dR/dH exactly for the composite the JAX package differentiates.
// ---------------------------------------------------------------------------

struct Dual9 {
  float v;
  float d[9];
  __host__ __device__ Dual9() {}
  __host__ __device__ Dual9(float x) : v(x) {
    for (int k = 0; k < 9; ++k) d[k] = 0.f;
  }
};

__host__ __device__ __forceinline__ float val(float a) { return a; }
__host__ __device__ __forceinline__ float val(const Dual9& a) { return a.v; }

__host__ __device__ __forceinline__ Dual9 operator+(const Dual9& a, const Dual9& b) {
  Dual9 r; r.v = a.v + b.v;
  for (int k = 0; k < 9; ++k) r.d[k] = a.d[k] + b.d[k];
  return r;
}
__host__ __device__ __forceinline__ Dual9 operator-(const Dual9& a, const Dual9& b) {
  Dual9 r; r.v = a.v - b.v;
  for (int k = 0; k < 9; ++k) r.d[k] = a.d[k] - b.d[k];
  return r;
}
__host__ __device__ __forceinline__ Dual9 operator-(const Dual9& a) {
  Dual9 r; r.v = -a.v;
  for (int k = 0; k < 9; ++k) r.d[k] = -a.d[k];
  return r;
}
__host__ __device__ __forceinline__ Dual9 operator*(const Dual9& a, const Dual9& b) {
  Dual9 r; r.v = a.v * b.v;
  for (int k = 0; k < 9; ++k) r.d[k] = a.d[k] * b.v + a.v * b.d[k];
  return r;
}
__host__ __device__ __forceinline__ Dual9 operator/(const Dual9& a, const Dual9& b) {
  Dual9 r; r.v = a.v / b.v;
  const float inv = 1.f / b.v;
  for (int k = 0; k < 9; ++k) r.d[k] = (a.d[k] - r.v * b.d[k]) * inv;
  return r;
}
__host__ __device__ __forceinline__ Dual9 operator*(float s, const Dual9& a) {
  Dual9 r; r.v = s * a.v;
  for (int k = 0; k < 9; ++k) r.d[k] = s * a.d[k];
  return r;
}
__host__ __device__ __forceinline__ Dual9 operator*(const Dual9& a, float s) { return s * a; }
__host__ __device__ __forceinline__ Dual9 operator/(const Dual9& a, float s) {
  Dual9 r; r.v = a.v / s;
  for (int k = 0; k < 9; ++k) r.d[k] = a.d[k] / s;
  return r;
}
__host__ __device__ __forceinline__ Dual9 operator+(const Dual9& a, float s) {
  Dual9 r = a; r.v = a.v + s; return r;
}
__host__ __device__ __forceinline__ Dual9 operator+(float s, const Dual9& a) { return a + s; }
__host__ __device__ __forceinline__ Dual9 operator-(float s, const Dual9& a) {
  Dual9 r = -a; r.v = s - a.v; return r;
}
__host__ __device__ __forceinline__ float tsqrt(float a) { return sqrtf(a); }
__host__ __device__ __forceinline__ Dual9 tsqrt(const Dual9& a) {
  Dual9 r; r.v = sqrtf(a.v);
  const float h = 0.5f / r.v;
  for (int k = 0; k < 9; ++k) r.d[k] = a.d[k] * h;
  return r;
}

// ---------------------------------------------------------------------------
// QCP rotation (molann_tpu/ops/fused.py:192-307)
// ---------------------------------------------------------------------------

template <typename T>
__host__ __device__ __forceinline__ T det3(const T& a, const T& b, const T& c,
                                           const T& d, const T& e, const T& f,
                                           const T& g, const T& h, const T& i) {
  return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g);
}

// Entry adj[i][col] of the adjugate of the symmetric 4x4 m: the signed minor
// with row `col` and column `i` removed.
template <typename T>
__host__ __device__ __forceinline__ T adj_entry(const T (&m)[4][4], int col, int i) {
  int r[3], c[3];
  for (int k = 0, n = 0; k < 4; ++k) if (k != col) r[n++] = k;
  for (int k = 0, n = 0; k < 4; ++k) if (k != i) c[n++] = k;
  T v = det3(m[r[0]][c[0]], m[r[0]][c[1]], m[r[0]][c[2]],
             m[r[1]][c[0]], m[r[1]][c[1]], m[r[1]][c[2]],
             m[r[2]][c[0]], m[r[2]][c[1]], m[r[2]][c[2]]);
  return ((i + col) & 1) ? -v : v;
}

__host__ __device__ __forceinline__ float newton_step(float lam, float c2, float c1,
                                                      float c0) {
  float p = ((lam * lam + c2) * lam + c1) * lam + c0;
  float dp = (4.0f * lam * lam + 2.0f * c2) * lam + c1;
  return lam - p / (fabsf(dp) < 1e-30f ? 1e-30f : dp);
}

// The differentiable step: lam has zero tangent, c2/c1/c0 carry dH.
template <typename T>
__host__ __device__ __forceinline__ T newton_step_t(float lam, const T& c2,
                                                    const T& c1, const T& c0) {
  T p = ((lam * lam + c2) * lam + c1) * lam + c0;
  T dp = (4.0f * lam * lam + 2.0f * c2) * lam + c1;
  if (fabsf(val(dp)) < 1e-30f) dp = T(1e-30f);
  return T(lam) - p / dp;
}

// R such that aligned_i = sum_j v_j R[j][i]: the top eigenvector of Horn's
// 4x4 K by Newton on its characteristic polynomial (12 iterations on plain
// floats, then one step in T) and the largest-norm adjugate column
// (strict '>' priority select, first column wins ties).
template <typename T>
__host__ __device__ void qcp_rotation(const T (&H)[3][3], T (&R)[3][3]) {
  const T &Sxx = H[0][0], &Sxy = H[0][1], &Sxz = H[0][2];
  const T &Syx = H[1][0], &Syy = H[1][1], &Syz = H[1][2];
  const T &Szx = H[2][0], &Szy = H[2][1], &Szz = H[2][2];
  T k[4][4];
  k[0][0] = Sxx + Syy + Szz;
  k[0][1] = Syz - Szy;
  k[0][2] = Szx - Sxz;
  k[0][3] = Sxy - Syx;
  k[1][1] = Sxx - Syy - Szz;
  k[1][2] = Sxy + Syx;
  k[1][3] = Szx + Sxz;
  k[2][2] = -Sxx + Syy - Szz;
  k[2][3] = Syz + Szy;
  k[3][3] = -Sxx - Syy + Szz;
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < i; ++j) k[i][j] = k[j][i];

  T frob2 = H[0][0] * H[0][0];
  for (int n = 1; n < 9; ++n) frob2 = frob2 + H[n / 3][n % 3] * H[n / 3][n % 3];
  T c2 = -2.0f * frob2;
  T det_h = Sxx * (Syy * Szz - Syz * Szy) - Sxy * (Syx * Szz - Syz * Szx) +
            Sxz * (Syx * Szy - Syy * Szx);
  T c1 = -8.0f * det_h;
  // c0 = det K = p2^2/8 - p4/4 with p2 = tr K^2, p4 = tr K^4 (tr K = 0)
  T k2[4][4];
  for (int i = 0; i < 4; ++i)
    for (int j = i; j < 4; ++j) {
      T acc = k[i][0] * k[0][j];
      for (int m = 1; m < 4; ++m) acc = acc + k[i][m] * k[m][j];
      k2[i][j] = acc;
      k2[j][i] = acc;
    }
  T p2 = k2[0][0] + k2[1][1] + k2[2][2] + k2[3][3];
  T p4 = k2[0][0] * k2[0][0];
  for (int n = 1; n < 16; ++n) p4 = p4 + k2[n / 4][n % 4] * k2[n / 4][n % 4];
  T c0 = p2 * p2 / 8.0f - p4 / 4.0f;

  float lam0 = sqrtf(3.0f * val(frob2));
  for (int it = 0; it < MOLANN_NEWTON_ITERS; ++it)
    lam0 = newton_step(lam0, val(c2), val(c1), val(c0));
  T lam = newton_step_t(lam0, c2, c1, c0);

  T m[4][4];
  float mv[4][4];
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) {
      m[i][j] = (i == j) ? k[i][j] - lam : k[i][j];
      mv[i][j] = val(m[i][j]);
    }
  // select the column on values: the same expressions give the same floats
  // in T, and a where-select passes the selected column's tangent only
  int best = 0;
  float best_n = 0.f;
  for (int col = 0; col < 4; ++col) {
    float nrm = 0.f;
    for (int i = 0; i < 4; ++i) {
      float a = adj_entry(mv, col, i);
      nrm = (i == 0) ? a * a : nrm + a * a;
    }
    if (col == 0 || nrm > best_n) { best = col; best_n = nrm; }
  }
  T q[4];
  for (int i = 0; i < 4; ++i) q[i] = adj_entry(m, best, i);
  T qn = tsqrt(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
  T w = q[0] / qn, x = q[1] / qn, y = q[2] / qn, z = q[3] / qn;

  T xx = x * x, yy = y * y, zz = z * z;
  T xy = x * y, xz = x * z, yz = y * z;
  T wx = w * x, wy = w * y, wz = w * z;
  R[0][0] = 1.0f - 2.0f * (yy + zz);
  R[0][1] = 2.0f * (xy + wz);
  R[0][2] = 2.0f * (xz - wy);
  R[1][0] = 2.0f * (xy - wz);
  R[1][1] = 1.0f - 2.0f * (xx + zz);
  R[1][2] = 2.0f * (yz + wx);
  R[2][0] = 2.0f * (xz + wy);
  R[2][1] = 2.0f * (yz - wx);
  R[2][2] = 1.0f - 2.0f * (xx + yy);
}

// ---------------------------------------------------------------------------
// 3-vectors
// ---------------------------------------------------------------------------

struct V3 { float x, y, z; };

__host__ __device__ __forceinline__ V3 atom(const float* xs, int a) {
  return V3{xs[3 * a], xs[3 * a + 1], xs[3 * a + 2]};
}
__host__ __device__ __forceinline__ V3 sub3(V3 u, V3 v) { return V3{u.x - v.x, u.y - v.y, u.z - v.z}; }
__host__ __device__ __forceinline__ V3 add3(V3 u, V3 v) { return V3{u.x + v.x, u.y + v.y, u.z + v.z}; }
__host__ __device__ __forceinline__ V3 scale3(float s, V3 u) { return V3{s * u.x, s * u.y, s * u.z}; }
__host__ __device__ __forceinline__ float dot3(V3 u, V3 v) { return u.x * v.x + u.y * v.y + u.z * v.z; }
__host__ __device__ __forceinline__ float norm3(V3 u) { return sqrtf(dot3(u, u)); }
__host__ __device__ __forceinline__ V3 cross3(V3 u, V3 v) {
  return V3{u.y * v.z - u.z * v.y, u.z * v.x - u.x * v.z, u.x * v.y - u.y * v.x};
}
__host__ __device__ __forceinline__ void acc_atom(float* g, int a, V3 v) {
  g[3 * a] += v.x; g[3 * a + 1] += v.y; g[3 * a + 2] += v.z;
}

// ---------------------------------------------------------------------------
// The switching function of the coordination features
// (molann_tpu_torch/ops/features.py:112-143) and its derivative, shared by
// the unrolled kernels (a thread owns a frame) and the blocked ones
// (blocked_math.cuh, threads share a frame)
// ---------------------------------------------------------------------------

// Floats of one coordination feature's parameters, and the offsets into
// them (ops/fused.py packs them, coord_parameters).
#define MOLANN_COORD_FLOATS 20
enum { CP_R0 = 0, CP_NN = 1, CP_MM = 2, CP_HAS_DMAX = 3, CP_DMAX = 4,
       CP_SDMAX = 5, CP_STRETCH = 6, CP_HAS_BOX = 7, CP_INV = 8, CP_BOX = 11 };

// t^k for k >= 1 by repeated squaring, the products in the order of _ipow;
// the usual switching exponents are written out, so that they cost their
// two to four multiplies and no loop.
__host__ __device__ __forceinline__ float switch_ipow(float t, int k) {
  const float t2 = t * t, t4 = t2 * t2;
  switch (k) {
    case 1: return t;
    case 2: return t2;
    case 3: return t * t2;
    case 4: return t4;
    case 5: return t * t4;
    case 6: return t2 * t4;
    case 8: return t4 * t4;
    case 12: return t4 * (t4 * t4);
  }
  float acc = 1.f, sq = t;
  bool have = false;
  while (k) {
    if (k & 1) { acc = have ? acc * sq : sq; have = true; }
    k >>= 1;
    if (k) sq = sq * sq;
  }
  return acc;
}

// 1 + t + ... + t^(k-1) by Horner, and its derivative in t.
__host__ __device__ __forceinline__ void switch_geometric(float t, int k, float& v, float& dv) {
  v = 1.f; dv = 0.f;
  for (int i = 1; i < k; ++i) { dv = v + t * dv; v = 1.f + t * v; }
}

// Reciprocal and reciprocal square root of the pair loops. On the card the
// special-function unit and one Newton step (about 1 ulp) replace
// IEEE division and square root, which cost some ten operations each and
// were most of a pair's work; on the host the exact forms stand in.
#ifdef __CUDA_ARCH__
__device__ __forceinline__ float switch_rcp(float v) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  const float c = v * r;  // NaN for v = inf (r = 0): keep the 0
  return c == c ? r * (2.0f - c) : r;
}
__device__ __forceinline__ float switch_rsqrt(float v) {
  float r;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r * (1.5f - 0.5f * v * r * r);
}
#else
inline float switch_rcp(float v) { return 1.0f / v; }
inline float switch_rsqrt(float v) { return 1.0f / sqrtf(v); }
#endif

// A coordination feature's parameters, read once per thread into registers
// before its pair loop.
struct CoordPar {
  float r0, inv_r0, dmax, dmax2, sdmax, stretch;
  float inv[3], box[9];
  int nn, mm;
  bool has_dmax, has_box, ortho;
};

__host__ __device__ __forceinline__ CoordPar coord_load(const float* cp) {
  CoordPar c;
  c.r0 = cp[CP_R0];
  c.inv_r0 = 1.0f / c.r0;
  c.nn = (int)cp[CP_NN];
  c.mm = (int)cp[CP_MM];
  c.has_dmax = cp[CP_HAS_DMAX] != 0.f;
  c.dmax = cp[CP_DMAX];
  c.dmax2 = c.dmax * c.dmax;
  c.sdmax = cp[CP_SDMAX];
  c.stretch = cp[CP_STRETCH];
  c.has_box = cp[CP_HAS_BOX] != 0.f;
  for (int a = 0; a < 3; ++a) c.inv[a] = cp[CP_INV + a];
  for (int a = 0; a < 9; ++a) c.box[a] = cp[CP_BOX + a];
  c.ortho = c.box[1] == 0.f && c.box[2] == 0.f && c.box[3] == 0.f &&
            c.box[5] == 0.f && c.box[6] == 0.f && c.box[7] == 0.f;
  return c;
}

// s(r) and s'(r)/r of a pair at squared distance r2. Past d_max both are
// exactly 0, decided on r2 before any square root (a NaN too, as
// torch.where(r < d_max, ., 0) gives); r = 0 gives s'(r)/r = 0 times a
// finite number as the reference's guard does.
template <bool kGrad>
__host__ __device__ __forceinline__ void switch_eval(const CoordPar& cp, float r2, float& s,
                                                     float& ds_over_r) {
  ds_over_r = 0.f;
  if (cp.has_dmax && !(r2 < cp.dmax2)) { s = 0.f; return; }
  const float inv_r = r2 > 1e-30f ? switch_rsqrt(r2) : 0.f;
  // r / r0 by the reciprocal and one correction step: a bare r * (1 / r0)
  // is off by the same fraction of an ulp for every pair of a feature, and
  // thousands of such errors of one sign add up in the sum
  const float r = r2 * inv_r;
  float t = r * cp.inv_r0;
  t = fmaf(fmaf(-t, cp.r0, r), cp.inv_r0, t);
  float raw, draw = 0.f;
  if (cp.mm == 2 * cp.nn) {  // (1 - t^n)/(1 - t^2n) = 1/(1 + t^n)
    raw = switch_rcp(1.0f + switch_ipow(t, cp.nn));
    if (kGrad)
      draw = -(float)cp.nn * (cp.nn > 1 ? switch_ipow(t, cp.nn - 1) : 1.0f) * raw * raw;
  } else {                   // quotient of geometric sums
    float num, dnum, den, dden;
    switch_geometric(t, cp.nn, num, dnum);
    switch_geometric(t, cp.mm, den, dden);
    const float inv_den = switch_rcp(den);
    raw = num * inv_den;
    draw = (dnum - raw * dden) * inv_den;
  }
  const float scale = cp.has_dmax ? cp.stretch : 1.0f;
  s = cp.has_dmax ? (raw - cp.sdmax) * cp.stretch : raw;
  if (kGrad) ds_over_r = draw * scale * cp.inv_r0 * inv_r;
}

// The same function for mm == 2 nn with an even exponent nn = kNN >= 4,
// without a square root: s = 1 / (1 + (r^2 / r0^2)^(nn/2)) and s'(r)/r =
// -nn (r^2 / r0^2)^(nn/2 - 1) s^2 / r0^2 need r^2 only. r0^2 is carried as
// a rounded square and its rounding error (r02, r02_lo, from
// switch_even_r02) and the quotient gets one correction step, so that no
// error of one sign is shared by all the pairs of a sum. Past d_max both
// results are selected to 0, no branch. A pair loop that is all of one
// form saves a fifth of its instructions this way; the results differ from
// switch_eval's in the last bits.
struct SwitchEven { float r02, r02_lo, inv_r02; };

__host__ __device__ __forceinline__ SwitchEven switch_even_r02(const CoordPar& cp) {
  SwitchEven e;
  e.r02 = cp.r0 * cp.r0;
  e.r02_lo = fmaf(cp.r0, cp.r0, -e.r02);
  e.inv_r02 = 1.0f / e.r02;
  return e;
}

template <bool kGrad, int kNN>
__host__ __device__ __forceinline__ void switch_eval_even(const CoordPar& cp,
                                                          const SwitchEven& e, float r2,
                                                          float& s, float& ds_over_r) {
  static_assert(kNN >= 4 && kNN % 2 == 0, "an even exponent of at least 4");
  float t2 = r2 * e.inv_r02;
  t2 = fmaf(fmaf(-t2, e.r02_lo, fmaf(-t2, e.r02, r2)), e.inv_r02, t2);
  const float lower = switch_ipow(t2, kNN / 2 - 1);  // t^(nn - 2)
  const float raw = switch_rcp(1.0f + lower * t2);
  const bool inside = !cp.has_dmax || r2 < cp.dmax2;
  const float scale = cp.has_dmax ? cp.stretch : 1.0f;
  s = inside ? (cp.has_dmax ? (raw - cp.sdmax) * cp.stretch : raw) : 0.f;
  ds_over_r = 0.f;
  if (kGrad) ds_over_r = inside ? -(float)kNN * lower * raw * raw * (scale * e.inv_r02) : 0.f;
}

// The minimum image of a displacement when the feature has a box (rintf
// rounds half to even, as torch.round and jnp.round do). kBox: 0 no box,
// 1 an orthorhombic box, -1 read cp (any box).
template <int kBox>
__host__ __device__ __forceinline__ V3 min_image_as(float d0, float d1, float d2,
                                                    const CoordPar& cp) {
  if (kBox < 0 ? cp.has_box : kBox != 0) {
    if (kBox > 0 || cp.ortho) {  // written out: no array, whatever the compiler unrolls
      d2 = d2 - rintf(d2 * cp.inv[2]) * cp.box[8];
      d1 = d1 - rintf(d1 * cp.inv[1]) * cp.box[4];
      d0 = d0 - rintf(d0 * cp.inv[0]) * cp.box[0];
    } else {
      float d[3] = {d0, d1, d2};
#pragma unroll
      for (int a = 2; a >= 0; --a) {
        const float shift = rintf(d[a] * cp.inv[a]);
#pragma unroll
        for (int b = 0; b < 3; ++b) {
          const float e = cp.box[3 * a + b];
          if (e != 0.f) d[b] = d[b] - shift * e;
        }
      }
      return V3{d[0], d[1], d[2]};
    }
  }
  return V3{d0, d1, d2};
}

__host__ __device__ __forceinline__ V3 min_image(float d0, float d1, float d2,
                                                 const CoordPar& cp) {
  return min_image_as<-1>(d0, d1, d2, cp);
}

// ---------------------------------------------------------------------------
// Features (molann_tpu/ops/fused.py:364-389) and their adjoints
// ---------------------------------------------------------------------------

__host__ __device__ __forceinline__ float angle_fwd(const float* xs, const int* idx,
                                                    int use_angle_value) {
  V3 r21 = sub3(atom(xs, idx[0]), atom(xs, idx[1]));
  V3 r23 = sub3(atom(xs, idx[2]), atom(xs, idx[1]));
  float cs = dot3(r21, r23) / (norm3(r21) * norm3(r23));
  return use_angle_value ? acosf(cs) : cs;  // unclamped, as the reference
}

__host__ __device__ __forceinline__ void angle_bwd(const float* xs, const int* idx,
                                                   int use_angle_value, float g,
                                                   float* gx) {
  V3 r21 = sub3(atom(xs, idx[0]), atom(xs, idx[1]));
  V3 r23 = sub3(atom(xs, idx[2]), atom(xs, idx[1]));
  float d = dot3(r21, r23), n1 = norm3(r21), n2 = norm3(r23);
  float nn = n1 * n2;
  float gcos = g;
  if (use_angle_value) {
    float cs = d / nn;
    gcos = -g / sqrtf(1.0f - cs * cs);  // d acos(c)/dc, NaN for |c| > 1
  }
  float gd = gcos / nn;
  float gnn = -gcos * d / (nn * nn);
  V3 g21 = add3(scale3(gd, r23), scale3(gnn * n2 / n1, r21));
  V3 g23 = add3(scale3(gd, r21), scale3(gnn * n1 / n2, r23));
  acc_atom(gx, idx[0], g21);
  acc_atom(gx, idx[2], g23);
  acc_atom(gx, idx[1], scale3(-1.f, add3(g21, g23)));
}

__host__ __device__ __forceinline__ float bond_fwd(const float* xs, const int* idx) {
  return norm3(sub3(atom(xs, idx[1]), atom(xs, idx[0])));
}

__host__ __device__ __forceinline__ void bond_bwd(const float* xs, const int* idx,
                                                  float g, float* gx) {
  V3 r = sub3(atom(xs, idx[1]), atom(xs, idx[0]));
  V3 gr = scale3(g / norm3(r), r);
  acc_atom(gx, idx[1], gr);
  acc_atom(gx, idx[0], scale3(-1.f, gr));
}

// Writes 1 (phi) or 2 ([cos, sin]) rows; returns the count.
__host__ __device__ __forceinline__ int dihedral_fwd(const float* xs, const int* idx,
                                                     int use_angle_value, float* out) {
  V3 r12 = sub3(atom(xs, idx[1]), atom(xs, idx[0]));
  V3 r23 = sub3(atom(xs, idx[2]), atom(xs, idx[1]));
  V3 r34 = sub3(atom(xs, idx[3]), atom(xs, idx[2]));
  V3 n1 = cross3(r12, r23), n2 = cross3(r23, r34);
  float c = dot3(n1, n2);
  float s = dot3(n1, r34) * norm3(r23);
  if (use_angle_value) { out[0] = atan2f(s, c); return 1; }
  float rho = sqrtf(c * c + s * s);
  out[0] = c / rho;  // NaN at a degenerate dihedral (rho = 0), as the reference
  out[1] = s / rho;
  return 2;
}

__host__ __device__ __forceinline__ void dihedral_bwd(const float* xs, const int* idx,
                                                      int use_angle_value, const float* g,
                                                      float* gx) {
  V3 r12 = sub3(atom(xs, idx[1]), atom(xs, idx[0]));
  V3 r23 = sub3(atom(xs, idx[2]), atom(xs, idx[1]));
  V3 r34 = sub3(atom(xs, idx[3]), atom(xs, idx[2]));
  V3 n1 = cross3(r12, r23), n2 = cross3(r23, r34);
  float c = dot3(n1, n2);
  float len23 = norm3(r23);
  float p = dot3(n1, r34);
  float s = p * len23;
  float gc, gs;
  if (use_angle_value) {  // phi = atan2(s, c)
    float r2 = c * c + s * s;
    gc = -g[0] * s / r2;
    gs = g[0] * c / r2;
  } else {                // [c/rho, s/rho]
    float rho = sqrtf(c * c + s * s);
    float grho = -(g[0] * c + g[1] * s) / (rho * rho);
    gc = g[0] / rho + grho * c / rho;
    gs = g[1] / rho + grho * s / rho;
  }
  // c = n1.n2 ; s = (n1.r34) |r23|
  V3 gn1 = add3(scale3(gc, n2), scale3(gs * len23, r34));
  V3 gn2 = scale3(gc, n1);
  V3 g34 = scale3(gs * len23, n1);
  V3 g23 = scale3(gs * p / len23, r23);
  // n1 = r12 x r23 ; n2 = r23 x r34  (adjoint of a x b: b x g, g x a)
  V3 g12 = cross3(r23, gn1);
  g23 = add3(g23, cross3(gn1, r12));
  g23 = add3(g23, cross3(r34, gn2));
  g34 = add3(g34, cross3(gn2, r23));
  acc_atom(gx, idx[0], scale3(-1.f, g12));
  acc_atom(gx, idx[1], sub3(g12, g23));
  acc_atom(gx, idx[2], sub3(g23, g34));
  acc_atom(gx, idx[3], g34);
}

// One coordination feature of a frame (molann_tpu/ops/fused.py:392-410,
// _coordination_row): the switching function summed over the feature's
// pairs in table order. A thread owns its frame and the unrolled envelope
// has at most 96 pairs (UNROLLED_MAX_COORD_PAIRS, checked by the wrapper),
// so a plain loop in a fixed order is enough and gives the same bits on
// every launch.
__host__ __device__ __forceinline__ float coordination_fwd(const int* pairs, int n_pairs,
                                                           const CoordPar& cp,
                                                           const float* xs) {
  float acc = 0.f;
  for (int p = 0; p < n_pairs; ++p) {
    const int i = pairs[2 * p], j = pairs[2 * p + 1];
    const V3 d = min_image(xs[3 * j] - xs[3 * i], xs[3 * j + 1] - xs[3 * i + 1],
                           xs[3 * j + 2] - xs[3 * i + 2], cp);
    float s, ds;
    switch_eval<false>(cp, dot3(d, d), s, ds);
    acc += s;
  }
  return acc;
}

// Its adjoint: d s(|x_j - x_i|)/d x_j = s'(r)/r * d and the opposite on
// x_i; the minimum-image shift is constant.
__host__ __device__ __forceinline__ void coordination_bwd(const int* pairs, int n_pairs,
                                                          const CoordPar& cp,
                                                          const float* xs, float g,
                                                          float* gx) {
  for (int p = 0; p < n_pairs; ++p) {
    const int i = pairs[2 * p], j = pairs[2 * p + 1];
    const V3 d = min_image(xs[3 * j] - xs[3 * i], xs[3 * j + 1] - xs[3 * i + 1],
                           xs[3 * j + 2] - xs[3 * i + 2], cp);
    float s, coef;
    switch_eval<true>(cp, dot3(d, d), s, coef);
    const V3 gd = scale3(g * coef, d);
    acc_atom(gx, j, gd);
    acc_atom(gx, i, scale3(-1.f, gd));
  }
}

// ---------------------------------------------------------------------------
// Alignment (molann_tpu/ops/fused.py:310-361)
// ---------------------------------------------------------------------------

__host__ __device__ __forceinline__ bool needs_alignment(const ModelArgs& m) {
  return m.n_align > 0 && m.n_pos > 0;
}

__host__ __device__ __forceinline__ void align_covariance(const ModelArgs& m,
                                                          const float* xs, float c[3],
                                                          float H[3][3]) {
  const float n_a = (float)m.n_align;
  for (int i = 0; i < 3; ++i) {
    float s = 0.f;
    for (int n = 0; n < m.n_align; ++n) s += xs[3 * m.align_idx[n] + i];
    c[i] = s / n_a;
  }
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      float acc = 0.f;
      for (int n = 0; n < m.n_align; ++n)
        acc += (xs[3 * m.align_idx[n] + i] - c[i]) * m.ref_x[3 * n + j];
      H[i][j] = acc;
    }
}

// Intermediate (type-grouped) feature rows:
// [angles | bonds | dihedrals | coordinations | positions], the layout
// spec.perm indexes.
__host__ __device__ __forceinline__ void features_fwd(const ModelArgs& m, const float* xs,
                                                      bool aligned, const float c[3],
                                                      const float R[3][3], float* feat) {
  int row = 0;
  for (int i = 0; i < m.n_angles; ++i)
    feat[row++] = angle_fwd(xs, m.angle_idx + 3 * i, m.use_angle_value);
  for (int i = 0; i < m.n_bonds; ++i) feat[row++] = bond_fwd(xs, m.bond_idx + 2 * i);
  for (int i = 0; i < m.n_dihedrals; ++i)
    row += dihedral_fwd(xs, m.dihedral_idx + 4 * i, m.use_angle_value, feat + row);
  for (int k = 0; k < m.n_coord; ++k) {
    const int p0 = m.coord_start[k];
    feat[row++] = coordination_fwd(m.coord_pairs + 2 * p0, m.coord_start[k + 1] - p0,
                                   coord_load(m.coord_par + k * MOLANN_COORD_FLOATS), xs);
  }
  for (int p = 0; p < m.n_pos; ++p) {
    V3 v = atom(xs, m.pos_idx[p]);
    if (aligned) {
      v = V3{v.x - c[0], v.y - c[1], v.z - c[2]};
      feat[row++] = v.x * R[0][0] + v.y * R[1][0] + v.z * R[2][0];
      feat[row++] = v.x * R[0][1] + v.y * R[1][1] + v.z * R[2][1];
      feat[row++] = v.x * R[0][2] + v.y * R[1][2] + v.z * R[2][2];
    } else {
      feat[row++] = v.x;
      feat[row++] = v.y;
      feat[row++] = v.z;
    }
  }
}

// ---------------------------------------------------------------------------
// MLP (molann_tpu/ops/fused.py:505-522): no activation after the last layer
// ---------------------------------------------------------------------------

__host__ __device__ __forceinline__ float act_fwd(int act, float z) {
  switch (act) {
    case MOLANN_ACT_TANH: return tanhf(z);
    case MOLANN_ACT_RELU: return (z > 0.f || z != z) ? z : 0.f;  // NaN passes
    case MOLANN_ACT_SIGMOID: return 1.0f / (1.0f + expf(-z));
    default: return z;
  }
}

// Derivative from the activation's output t.
__host__ __device__ __forceinline__ float act_grad(int act, float t) {
  switch (act) {
    case MOLANN_ACT_TANH: return 1.0f - t * t;
    case MOLANN_ACT_RELU: return t > 0.f ? 1.0f : 0.0f;
    case MOLANN_ACT_SIGMOID: return t * (1.0f - t);
    default: return 1.0f;
  }
}

// h[L][:] = output of layer L (post-activation for hidden layers). Returns a
// pointer to the model output (cols itself when there is no MLP).
__host__ __device__ __forceinline__ const float* mlp_fwd(const ModelArgs& m,
                                                         const float* cols,
                                                         float (&h)[MOLANN_MAX_LAYERS][MOLANN_MAX_WIDTH]) {
  const float* in = cols;
  const float* w = m.params;
  for (int L = 0; L < m.n_layers; ++L) {
    const int d_in = m.dims[L], d_out = m.dims[L + 1];
    const float* b = w + d_out * d_in;
    const bool last = (L == m.n_layers - 1);
    for (int j = 0; j < d_out; ++j) {
      float acc = b[j] + w[j * d_in] * in[0];
      for (int k = 1; k < d_in; ++k) acc += w[j * d_in + k] * in[k];
      h[L][j] = last ? acc : act_fwd(m.activation, acc);
    }
    in = h[L];
    w = b + d_out;
  }
  return in;
}

// What the backward needs from a frame's forward.
struct FrameFwd {
  bool aligned;
  float c[3];
  float R[3][3];
  float dR[3][3][9];  // dR[i][j][3p+q] = dR_ij / dH_pq (filled when with_dR)
  float cols[MOLANN_MAX_COLS];  // the MLP's input, in feature-list order
  float h[MOLANN_MAX_LAYERS][MOLANN_MAX_WIDTH];
};

// Shared forward: alignment, features, permutation, MLP. with_dR runs the
// last QCP steps on Dual9 to get dR/dH, which only the adjoint of the
// position features needs. Returns a pointer to the model output.
__host__ __device__ __forceinline__ const float* frame_fwd(const ModelArgs& m,
                                                           const float* xs,
                                                           bool with_dR, FrameFwd& st) {
  st.aligned = needs_alignment(m);
  for (int i = 0; i < 3; ++i) st.c[i] = 0.f;
  if (st.aligned) {
    float Hf[3][3];
    align_covariance(m, xs, st.c, Hf);
    if (with_dR) {
      Dual9 H[3][3], Rd[3][3];
      for (int p = 0; p < 3; ++p)
        for (int q = 0; q < 3; ++q) {
          H[p][q] = Dual9(Hf[p][q]);
          H[p][q].d[3 * p + q] = 1.0f;
        }
      qcp_rotation(H, Rd);
      for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) {
          st.R[i][j] = Rd[i][j].v;
          for (int k = 0; k < 9; ++k) st.dR[i][j][k] = Rd[i][j].d[k];
        }
    } else {
      qcp_rotation(Hf, st.R);
    }
  }
  float feat[MOLANN_MAX_COLS];
  features_fwd(m, xs, st.aligned, st.c, st.R, feat);
  for (int k = 0; k < m.n_feat; ++k) st.cols[k] = m.has_perm ? feat[m.perm[k]] : feat[k];
  return mlp_fwd(m, st.cols, st.h);
}

__host__ __device__ __forceinline__ void frame_forward(const ModelArgs& m, const float* xs,
                                                       float* y) {
  FrameFwd st;
  const float* out = frame_fwd(m, xs, false, st);
  const int d_out = model_out_dim(m);
  for (int j = 0; j < d_out; ++j) y[j] = out[j];
}

// The cotangent of loss = sum_j (y_j - t_j)^2 * inv_count into ga[d];
// returns the frame's term of the loss (molann_tpu/ops/fused.py:946-954).
__host__ __device__ __forceinline__ float mse_cotangent(const float* y, const float* t,
                                                        int d, float inv_count, float* ga) {
  float e2 = 0.f;
  for (int j = 0; j < d; ++j) {
    const float e = y[j] - t[j];
    e2 += e * e;
    ga[j] = 2.0f * e * inv_count;
  }
  return e2 * inv_count;
}

// A sink that drops every gradient: the cv+forces kernel wants gx only.
struct NullSink {
  __host__ __device__ void operator()(int, float) const {}
};

// The VJP of one frame (molann_tpu/ops/fused.py:586-621 per frame): given
// the forward state `st` and the cotangent ga[d_out] of the output (used
// as scratch), hands the frame's term of each gradient to sink(index,
// value) and writes gx[3n] unless gx is null. `index` points into the flat
// gradient vector G = [ref_x (3 * n_align) | W0 [d1 * d0] | b0 [d1] | W1 |
// b1 ...], the layout of the kernels' float arguments. With want_ref, also
// the terms of the ref_x gradient
//   g_ref[n][j] = sum_i gH[i][j] * (x[a_n][i] - c_i).
// With neither gx nor want_ref only the MLP's backward runs: no adjoint of
// the features or of QCP (the point of _train_kernel, :902-913); st then
// needs no dR. Control flow depends on the model only, so every thread of
// a warp calls the sink with the same indices in the same order.
template <class Sink>
__host__ __device__ __forceinline__ void frame_vjp(const ModelArgs& m, const float* xs,
                                                   const FrameFwd& st, float* ga, float* gx,
                                                   bool want_ref, Sink& sink) {
  const bool ref_adj = want_ref && st.aligned;
  const bool input_adj = gx != nullptr || ref_adj;
  // MLP adjoint: ga holds d/dz of layer L's output, in_L its input
  float gb[MOLANN_MAX_COLS];
  if (m.n_layers) {
    const float* wl[MOLANN_MAX_LAYERS];
    int off[MOLANN_MAX_LAYERS];
    const float* w = m.params;
    int o = 3 * m.n_align;
    for (int L = 0; L < m.n_layers; ++L) {
      wl[L] = w;
      off[L] = o;
      const int size = m.dims[L + 1] * (m.dims[L] + 1);
      w += size;
      o += size;
    }
    for (int L = m.n_layers - 1; L >= 0; --L) {
      const int d_in = m.dims[L], d_o = m.dims[L + 1];
      const float* in = L > 0 ? st.h[L - 1] : st.cols;
      for (int j = 0; j < d_o; ++j) {
        for (int k = 0; k < d_in; ++k) sink(off[L] + j * d_in + k, ga[j] * in[k]);
        sink(off[L] + d_o * d_in + j, ga[j]);
      }
      if (L == 0 && !input_adj) return;
      for (int k = 0; k < d_in; ++k) {
        float acc = 0.f;
        for (int j = 0; j < d_o; ++j) acc += wl[L][j * d_in + k] * ga[j];
        gb[k] = (L > 0) ? acc * act_grad(m.activation, st.h[L - 1][k]) : acc;
      }
      for (int k = 0; k < d_in; ++k) ga[k] = gb[k];
    }
  }
  if (!input_adj) return;
  // undo the permutation: ga holds d/dcols; gb gets d/dfeat
  for (int k = 0; k < m.n_feat; ++k) gb[m.has_perm ? m.perm[k] : k] = ga[k];

  int row = 0;
  if (gx != nullptr) {
    for (int k = 0; k < 3 * m.n_atoms; ++k) gx[k] = 0.f;
    for (int i = 0; i < m.n_angles; ++i)
      angle_bwd(xs, m.angle_idx + 3 * i, m.use_angle_value, gb[row++], gx);
    for (int i = 0; i < m.n_bonds; ++i) bond_bwd(xs, m.bond_idx + 2 * i, gb[row++], gx);
    for (int i = 0; i < m.n_dihedrals; ++i) {
      dihedral_bwd(xs, m.dihedral_idx + 4 * i, m.use_angle_value, gb + row, gx);
      row += m.use_angle_value ? 1 : 2;
    }
    for (int k = 0; k < m.n_coord; ++k) {
      const int p0 = m.coord_start[k];
      coordination_bwd(m.coord_pairs + 2 * p0, m.coord_start[k + 1] - p0,
                       coord_load(m.coord_par + k * MOLANN_COORD_FLOATS), xs, gb[row++], gx);
    }
  } else {
    row = m.n_angles + m.n_bonds + m.n_dihedrals * (m.use_angle_value ? 1 : 2) + m.n_coord;
  }
  if (!st.aligned) {
    for (int p = 0; p < m.n_pos; ++p, row += 3)
      acc_atom(gx, m.pos_idx[p], V3{gb[row], gb[row + 1], gb[row + 2]});
    return;  // only reached with gx: ref_adj needs the alignment
  }
  // aligned_i = sum_j (x_j - c_j) R[j][i]: into x, c and R
  const float (&c)[3] = st.c;
  const float (&R)[3][3] = st.R;
  float gc[3] = {0.f, 0.f, 0.f};
  float gR[3][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
  for (int p = 0; p < m.n_pos; ++p, row += 3) {
    const int a = m.pos_idx[p];
    const float v[3] = {xs[3 * a] - c[0], xs[3 * a + 1] - c[1], xs[3 * a + 2] - c[2]};
    const float* g = gb + row;
    for (int j = 0; j < 3; ++j) {
      if (gx != nullptr) {
        float gv = R[j][0] * g[0] + R[j][1] * g[1] + R[j][2] * g[2];
        gx[3 * a + j] += gv;
        gc[j] -= gv;
      }
      for (int i = 0; i < 3; ++i) gR[j][i] += v[j] * g[i];
    }
  }
  // R(H): the QCP composite's Jacobian from the dual pass
  float gH[9];
  for (int k = 0; k < 9; ++k) {
    float acc = 0.f;
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) acc += gR[i][j] * st.dR[i][j][k];
    gH[k] = acc;
  }
  // H[i][j] = sum_n (x[a_n][i] - c[i]) ref[n][j]: into ref ...
  if (ref_adj)
    for (int n = 0; n < m.n_align; ++n) {
      const int a = m.align_idx[n];
      for (int j = 0; j < 3; ++j)
        sink(3 * n + j,
             gH[j] * (xs[3 * a] - c[0]) + gH[3 + j] * (xs[3 * a + 1] - c[1]) +
                 gH[6 + j] * (xs[3 * a + 2] - c[2]));
    }
  if (gx == nullptr) return;
  // ... and into x and c
  for (int n = 0; n < m.n_align; ++n) {
    const int a = m.align_idx[n];
    for (int i = 0; i < 3; ++i) {
      float t = gH[3 * i] * m.ref_x[3 * n] + gH[3 * i + 1] * m.ref_x[3 * n + 1] +
                gH[3 * i + 2] * m.ref_x[3 * n + 2];
      gx[3 * a + i] += t;
      gc[i] -= t;
    }
  }
  // c = mean of the align atoms
  const float inv_n = 1.0f / (float)m.n_align;
  for (int n = 0; n < m.n_align; ++n)
    for (int i = 0; i < 3; ++i) gx[3 * m.align_idx[n] + i] += gc[i] * inv_n;
}

// Values y and gx = d(sum_j ct_j y_j)/dx with ct all ones (component < 0)
// or one-hot at `component` (molann_tpu/ops/fused.py:1116-1172).
__host__ __device__ __forceinline__ void frame_cv_forces(const ModelArgs& m,
                                                         const float* xs, float* y,
                                                         float* gx, int component) {
  FrameFwd st;
  const float* out = frame_fwd(m, xs, true, st);
  const int d_out = model_out_dim(m);
  float ga[MOLANN_MAX_COLS];
  for (int j = 0; j < d_out; ++j) {
    y[j] = out[j];
    ga[j] = (component < 0 || j == component) ? 1.0f : 0.0f;
  }
  NullSink sink;
  frame_vjp(m, xs, st, ga, gx, false, sink);
}

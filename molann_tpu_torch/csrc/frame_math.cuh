// Per-frame math of the unrolled fused kernels: Kabsch alignment by QCP,
// every feature, the MLP, and the hand-derived adjoints of all three; and
// the steps a block of those kernels runs on its frames.
//
// Port of the tile math in molann_tpu/ops/fused.py:172-548
// (qcp_rotation, _align_tiles, the feature rows, _mlp_tiles,
// _forward_tiles). The Pallas kernels get their backward by applying
// jax.vjp to that math; a CUDA kernel has no autodiff, so the adjoints are
// written out here. Every function is __host__ __device__: the same code
// runs in the CUDA kernels (fused_unrolled.cu, fused_train.cu, and the
// blocked kernels through blocked_math.cuh) and, compiled with a host C++
// compiler, in the CPU tests that walk a block's threads in loops
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

// The unrolled family's envelope; the Python wrapper checks every model
// against it (molann_tpu_torch/ops/fused.py mirrors these numbers). No
// array is sized by it: a block's per-frame state lives in shared memory
// sized by the model at launch (UnrSmem below); the numbers bound that
// state, so that a block of 32 frames always fits.
#define MOLANN_MAX_ATOMS 64   // UNROLLED_MAX_ATOMS, molann_tpu/ops/fused.py:72
#define MOLANN_MAX_COLS 96    // UNROLLED_MAX_COLS, molann_tpu/ops/fused.py:73
#define MOLANN_MAX_WIDTH 64   // widest MLP layer output (hidden or last)
#define MOLANN_MAX_LAYERS 4   // Linear layers of the MLP head
#define MOLANN_NEWTON_ITERS 12

// The activations the JAX package serialises by name
// (molann_tpu/io/serialize.py:43-53).
enum { MOLANN_ACT_IDENTITY = 0, MOLANN_ACT_TANH = 1, MOLANN_ACT_RELU = 2,
       MOLANN_ACT_SIGMOID = 3, MOLANN_ACT_GELU = 4, MOLANN_ACT_ELU = 5,
       MOLANN_ACT_CELU = 6, MOLANN_ACT_SOFTPLUS = 7, MOLANN_ACT_SWISH = 8 };

// Model description passed by value to the kernels. The index tables are
// int32 arrays and the weights float32 arrays in the kernel's memory space
// (device pointers in the kernels, host pointers in the host test). The
// weights are the model's own tensors, one pointer each, so that a call
// copies nothing. Field order is mirrored by the ctypes.Structure in
// ops/fused.py.
struct ModelArgs {
  int n_atoms;
  int n_angles, n_bonds, n_dihedrals, n_pos, n_align;
  int n_coord;     // coordination features, one column each
  int use_angle_value;
  int n_feat;      // feature columns (spec.out_dim)
  int n_layers;    // Linear layers (0: the features are the output)
  int activation;  // MOLANN_ACT_*
  int dims[MOLANN_MAX_LAYERS + 1];  // dims[0] = n_feat, dims[L+1] = out of L
  const int* angle_idx;     // [n_angles * 3], central atom second
  const int* bond_idx;      // [n_bonds * 2]
  const int* dihedral_idx;  // [n_dihedrals * 4]
  const int* pos_idx;       // [n_pos]
  const int* align_idx;     // [n_align]
  const int* col_of;        // [n_feat] column of each type-grouped feature row
  const int* coord_start;   // [n_coord + 1] rows of coord_pairs
  const int* coord_pairs;   // [n_pairs * 2] (i, j), d = x[j] - x[i]
  const float* coord_par;   // [n_coord * MOLANN_COORD_FLOATS]
  const float* ref_x;       // [n_align * 3] centred reference
  const float* w[MOLANN_MAX_LAYERS];  // W_L [d_out, d_in] row-major (Linear.weight)
  const float* b[MOLANN_MAX_LAYERS];  // b_L [d_out]
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

// ---------------------------------------------------------------------------
// Forward-mode dual numbers with 9 tangents: one per entry of H. Running the
// last Newton step, the adjugate, the normalisation and R(q) on Dual9 gives
// dR/dH exactly for the composite the JAX package differentiates (the
// blocked kernels keep it per frame; the unrolled ones run the reverse pass,
// qcp_rotation_vjp, which the host test holds against it).
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

// One of the Newton steps held constant. On the card the quotient is the
// fast one (the special-function unit's reciprocal, about 2 ulp) in place of
// IEEE division, which was most of a step's serial chain: the steps converge
// on the root whatever the rounding of each, and the last, differentiated
// step (newton_step_t) keeps IEEE division.
__host__ __device__ __forceinline__ float newton_step(float lam, float c2, float c1,
                                                      float c0) {
  float p = ((lam * lam + c2) * lam + c1) * lam + c0;
  float dp = (4.0f * lam * lam + 2.0f * c2) * lam + c1;
#ifdef __CUDA_ARCH__
  return lam - __fdividef(p, fabsf(dp) < 1e-30f ? 1e-30f : dp);
#else
  return lam - p / (fabsf(dp) < 1e-30f ? 1e-30f : dp);
#endif
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
// (strict '>' priority select, first column wins ties). With lam_out, the
// result of the 12 Newton steps goes there too (qcp_rotation_vjp takes it).
template <typename T>
__host__ __device__ void qcp_rotation(const T (&H)[3][3], T (&R)[3][3],
                                      float* lam_out = nullptr) {
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
  if (lam_out) *lam_out = lam0;
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

// The gradient of a 3x3 determinant: dDet/dA[a][b] = cofactor(A)[a][b].
__host__ __device__ __forceinline__ void det3_grad(const float (&A)[3][3], float g,
                                                   float (&gA)[3][3]) {
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      const int a1 = (a + 1) % 3, a2 = (a + 2) % 3, b1 = (b + 1) % 3, b2 = (b + 2) % 3;
      gA[a][b] += g * (A[a1][b1] * A[a2][b2] - A[a1][b2] * A[a2][b1]);
    }
}

// The reverse mode of qcp_rotation: R, and gH[p][q] = sum_ij gR[i][j]
// dR[i][j]/dH[p][q] for the composite the Dual9 pass differentiates (the 12
// Newton steps held constant, the last one differentiated, the adjugate
// column chosen on values), by back-propagation through each step of the
// forward: R(q) and the normalisation, the chosen adjugate column of K -
// lambda I (each entry a signed 3x3 minor), the last Newton step through
// c2, c1, c0, and c0 = p2^2 / 8 - p4 / 4 through K^2. All arrays have
// compile-time indices, so nothing goes to local memory; a few hundred
// operations where the Dual9 pass carried 9 tangents through every one.
// lam0 is the forward's result of the 12 Newton steps on the same H
// (qcp_rotation's lam_out), so that the serial chain is not run twice; a
// negative lam0 runs it here.
__host__ __device__ inline void qcp_rotation_vjp(const float (&H)[3][3], const float (&gR)[3][3],
                                                 float lam0, float (&R)[3][3],
                                                 float (&gH)[3][3]) {
  const float Sxx = H[0][0], Sxy = H[0][1], Sxz = H[0][2];
  const float Syx = H[1][0], Syy = H[1][1], Syz = H[1][2];
  const float Szx = H[2][0], Szy = H[2][1], Szz = H[2][2];
  float k[4][4];
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
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < i; ++j) k[i][j] = k[j][i];
  float frob2 = H[0][0] * H[0][0];
#pragma unroll
  for (int n = 1; n < 9; ++n) frob2 = frob2 + H[n / 3][n % 3] * H[n / 3][n % 3];
  const float c2 = -2.0f * frob2;
  const float det_h = Sxx * (Syy * Szz - Syz * Szy) - Sxy * (Syx * Szz - Syz * Szx) +
                      Sxz * (Syx * Szy - Syy * Szx);
  const float c1 = -8.0f * det_h;
  float k2[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = i; j < 4; ++j) {
      float acc = k[i][0] * k[0][j];
#pragma unroll
      for (int m = 1; m < 4; ++m) acc = acc + k[i][m] * k[m][j];
      k2[i][j] = acc;
      k2[j][i] = acc;
    }
  const float p2 = k2[0][0] + k2[1][1] + k2[2][2] + k2[3][3];
  float p4 = k2[0][0] * k2[0][0];
#pragma unroll
  for (int n = 1; n < 16; ++n) p4 = p4 + k2[n / 4][n % 4] * k2[n / 4][n % 4];
  const float c0 = p2 * p2 / 8.0f - p4 / 4.0f;
  if (lam0 < 0.f) {
    lam0 = sqrtf(3.0f * frob2);
    for (int it = 0; it < MOLANN_NEWTON_ITERS; ++it) lam0 = newton_step(lam0, c2, c1, c0);
  }
  // the differentiable step, as newton_step_t
  const float P = ((lam0 * lam0 + c2) * lam0 + c1) * lam0 + c0;
  float D = (4.0f * lam0 * lam0 + 2.0f * c2) * lam0 + c1;
  const bool clamped = fabsf(D) < 1e-30f;
  if (clamped) D = 1e-30f;
  const float lam = lam0 - P / D;
  float m[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) m[i][j] = (i == j) ? k[i][j] - lam : k[i][j];
  // every adjugate column, and the largest-norm one (strict '>', first wins)
  float adj[4][4];
  int best = 0;
  float best_n = 0.f;
#pragma unroll
  for (int col = 0; col < 4; ++col) {
    float nrm = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      adj[col][i] = adj_entry(m, col, i);
      nrm = (i == 0) ? adj[col][i] * adj[col][i] : nrm + adj[col][i] * adj[col][i];
    }
    if (col == 0 || nrm > best_n) { best = col; best_n = nrm; }
  }
  float q[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    q[i] = best == 0 ? adj[0][i] : best == 1 ? adj[1][i] : best == 2 ? adj[2][i] : adj[3][i];
  const float qn = sqrtf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
  const float w = q[0] / qn, x = q[1] / qn, y = q[2] / qn, z = q[3] / qn;
  R[0][0] = 1.0f - 2.0f * (y * y + z * z);
  R[0][1] = 2.0f * (x * y + w * z);
  R[0][2] = 2.0f * (x * z - w * y);
  R[1][0] = 2.0f * (x * y - w * z);
  R[1][1] = 1.0f - 2.0f * (x * x + z * z);
  R[1][2] = 2.0f * (y * z + w * x);
  R[2][0] = 2.0f * (x * z + w * y);
  R[2][1] = 2.0f * (y * z - w * x);
  R[2][2] = 1.0f - 2.0f * (x * x + y * y);

  // R(u), u = (w, x, y, z)
  float gu[4];
  gu[0] = 2.0f * (z * (gR[0][1] - gR[1][0]) + y * (gR[2][0] - gR[0][2]) +
                  x * (gR[1][2] - gR[2][1]));
  gu[1] = -4.0f * x * (gR[1][1] + gR[2][2]) + 2.0f * (y * (gR[0][1] + gR[1][0]) +
          z * (gR[0][2] + gR[2][0]) + w * (gR[1][2] - gR[2][1]));
  gu[2] = -4.0f * y * (gR[0][0] + gR[2][2]) + 2.0f * (x * (gR[0][1] + gR[1][0]) +
          z * (gR[1][2] + gR[2][1]) + w * (gR[2][0] - gR[0][2]));
  gu[3] = -4.0f * z * (gR[0][0] + gR[1][1]) + 2.0f * (x * (gR[0][2] + gR[2][0]) +
          y * (gR[1][2] + gR[2][1]) + w * (gR[0][1] - gR[1][0]));
  // u = q / |q|
  const float u[4] = {w, x, y, z};
  const float ug = u[0] * gu[0] + u[1] * gu[1] + u[2] * gu[2] + u[3] * gu[3];
  float gq[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) gq[i] = (gu[i] - u[i] * ug) / qn;
  // q_i = adj_entry(m, best, i): the signed minor without row best, column i
  float gm[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) gm[i][j] = 0.f;
#pragma unroll
  for (int col = 0; col < 4; ++col) {
    if (col != best) continue;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int r[3], c[3];
#pragma unroll
      for (int a = 0, n = 0; a < 4; ++a) if (a != col) r[n++] = a;
#pragma unroll
      for (int a = 0, n = 0; a < 4; ++a) if (a != i) c[n++] = a;
      float A[3][3], gA[3][3];
#pragma unroll
      for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int b = 0; b < 3; ++b) { A[a][b] = m[r[a]][c[b]]; gA[a][b] = 0.f; }
      det3_grad(A, ((i + col) & 1) ? -gq[i] : gq[i], gA);
#pragma unroll
      for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int b = 0; b < 3; ++b) gm[r[a]][c[b]] += gA[a][b];
    }
  }
  // m = K - lam I; lam = lam0 - P / D through c2, c1, c0
  const float glam = -(gm[0][0] + gm[1][1] + gm[2][2] + gm[3][3]);
  const float inv_d = 1.0f / D;
  const float pd2 = clamped ? 0.f : P * inv_d * inv_d;
  const float gc2 = glam * (-lam0 * lam0 * inv_d + pd2 * 2.0f * lam0);
  const float gc1 = glam * (-lam0 * inv_d + pd2);
  const float gc0 = -glam * inv_d;
  // c0 = p2^2 / 8 - p4 / 4: p2 = tr K^2, p4 = |K^2|^2, so dc0/dK = p2 K / 2 - K^3
  const float gp2 = gc0 * p2 / 4.0f, gp4 = -gc0 / 4.0f;
  float gk[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float k3 = 0.f;  // (K^2 K)[i][j]
#pragma unroll
      for (int n = 0; n < 4; ++n) k3 += k2[i][n] * k[n][j];
      gk[i][j] = gm[i][j] + 2.0f * gp2 * k[i][j] + 4.0f * gp4 * k3;
    }
  // K(H): each upper entry and its mirror from one formula
  const float g00 = gk[0][0], g11 = gk[1][1], g22 = gk[2][2], g33 = gk[3][3];
  const float g01 = gk[0][1] + gk[1][0], g02 = gk[0][2] + gk[2][0],
              g03 = gk[0][3] + gk[3][0], g12 = gk[1][2] + gk[2][1],
              g13 = gk[1][3] + gk[3][1], g23 = gk[2][3] + gk[3][2];
  gH[0][0] = g00 + g11 - g22 - g33;
  gH[1][1] = g00 - g11 + g22 - g33;
  gH[2][2] = g00 - g11 - g22 + g33;
  gH[1][2] = g01 + g23;
  gH[2][1] = -g01 + g23;
  gH[2][0] = g02 + g13;
  gH[0][2] = -g02 + g13;
  gH[0][1] = g03 + g12;
  gH[1][0] = -g03 + g12;
  // c2 = -2 |H|^2 and c1 = -8 det H
  float gdet[3][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
  det3_grad(H, -8.0f * gc1, gdet);
#pragma unroll
  for (int p = 0; p < 3; ++p)
#pragma unroll
    for (int q2 = 0; q2 < 3; ++q2) gH[p][q2] += -4.0f * gc2 * H[p][q2] + gdet[p][q2];
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


// ---------------------------------------------------------------------------
// MLP activations (molann_tpu/io/serialize.py:43-53), as jax.nn computes
// them: gelu in its tanh form (jax.nn.gelu's default, approximate=True),
// elu and celu with alpha 1, softplus as log1p(exp(-|z|)) + max(z, 0),
// swish as z * sigmoid(z). No activation after the last layer
// (molann_tpu/ops/fused.py:505-522).
// ---------------------------------------------------------------------------

#define MOLANN_GELU_C 0.7978845608028654f  // sqrt(2 / pi)
#define MOLANN_GELU_A 0.044715f

// Whether act_grad needs the pre-activation z: gelu and swish cannot be
// inverted, so their derivative is not a function of the output.
__host__ __device__ __forceinline__ bool act_needs_z(int act) {
  return act == MOLANN_ACT_GELU || act == MOLANN_ACT_SWISH;
}

__host__ __device__ __forceinline__ float act_fwd(int act, float z) {
  switch (act) {
    case MOLANN_ACT_TANH: return tanhf(z);
    case MOLANN_ACT_RELU: return (z > 0.f || z != z) ? z : 0.f;  // NaN passes
    case MOLANN_ACT_SIGMOID: return 1.0f / (1.0f + expf(-z));
    case MOLANN_ACT_GELU:
      return z * (0.5f * (1.0f + tanhf(MOLANN_GELU_C * (z + MOLANN_GELU_A * (z * z * z)))));
    case MOLANN_ACT_ELU:
    case MOLANN_ACT_CELU: return z > 0.f ? z : expm1f(z);
    case MOLANN_ACT_SOFTPLUS: return fmaxf(z, 0.f) + log1pf(expf(-fabsf(z)));
    case MOLANN_ACT_SWISH: return z * (1.0f / (1.0f + expf(-z)));
    default: return z;
  }
}

// The derivative at pre-activation z whose output is t = act_fwd(act, z):
// from t where the activation can be inverted, from z for gelu and swish
// (act_needs_z); the other argument is not read.
__host__ __device__ __forceinline__ float act_grad(int act, float t, float z) {
  switch (act) {
    case MOLANN_ACT_TANH: return 1.0f - t * t;
    case MOLANN_ACT_RELU: return t > 0.f ? 1.0f : 0.0f;
    case MOLANN_ACT_SIGMOID: return t * (1.0f - t);
    case MOLANN_ACT_GELU: {
      const float z2 = z * z;
      const float th = tanhf(MOLANN_GELU_C * (z + MOLANN_GELU_A * (z2 * z)));
      return 0.5f * (1.0f + th) +
             0.5f * z * (1.0f - th * th) * MOLANN_GELU_C * (1.0f + 3.0f * MOLANN_GELU_A * z2);
    }
    case MOLANN_ACT_ELU:
    case MOLANN_ACT_CELU: return t > 0.f ? 1.0f : t + 1.0f;  // exp(z) = expm1(z) + 1
    case MOLANN_ACT_SOFTPLUS: return -expm1f(-t);            // sigmoid(z) = 1 - exp(-t)
    case MOLANN_ACT_SWISH: {
      const float s = 1.0f / (1.0f + expf(-z));
      return s * (1.0f + z * (1.0f - s));
    }
    default: return 1.0f;
  }
}

// ---------------------------------------------------------------------------
// The steps of an unrolled block
//
// A block takes F frames (F = UnrIO.frames, a power of two) and two threads
// a frame, (f, h) = (t mod F, t / F), for the serial chain of a frame: QCP,
// the features, the MLP and their adjoints, split so that the alignment's
// chain (h = 1) runs beside the other features' (h = 0) and the MLP's rows
// go to both. Everything a frame keeps lives in the block's shared memory
// as rows of `pitch` floats, one per frame (frame fastest, pitch = F + 1 so
// that a walk along a row and a walk down a column are both free of bank
// conflicts), sized by the model at launch (UnrSmem); a thread keeps in
// registers only what has compile-time indices (QCP's 4x4 and its adjoint,
// gR, gH). The steps, a barrier after each:
//   unr_load       x into the xs rows (and gx zeroed), every thread;
//   unr_feat       the feature columns: h = 0 angles, bonds, dihedrals and
//                  coordination, h = 1 the alignment and the positions;
//   unr_mlp        each layer forward, the outputs shared by the halves;
//   unr_seed       the output y and its cotangent (h = 0);
//   unr_bwd        each layer's input cotangent into the dz rows;
//   unr_param_sums the block's sums of the parameter gradients over its
//                  frames, in frame order, as rectangles of 2 x 2 entries a
//                  thread from the dz and activation rows, into the block's
//                  row of partials (backward and train);
//   unr_dcol       the feature columns' cotangents over the columns;
//   unr_adj_a      h = 0 the features' adjoints into the gx rows, h = 1 the
//                  alignment's: QCP back through its reverse pass, gH;
//   unr_adj_b      h = 1 the positions and the alignment into the gx rows;
//   unr_finish     the block's ref_x sums and the gx store, every thread.
// Every step is a function of (thread index, thread count) or of (frame,
// half): the kernels run it with threadIdx.x, the host test in loops.
// ---------------------------------------------------------------------------

enum { UNR_FORWARD = 0, UNR_FORCES = 1, UNR_BACKWARD = 2, UNR_TRAIN = 3 };
// The largest tile; a block has two threads a frame.
#define MOLANN_UNR_MAX_FRAMES 64
// Rows of the alignment state kept for the block's ref_x sums: gH, then c.
#define UNR_ST_ROWS 12

// One call's tensors. Frames are [l, 3n] (or with in_t [3n, l]); y and gx
// are [l, d] and [l, 3n] (or with out_t [d, l] and [3n, l]); aux is gy
// [l, d_out] for the backward kernel, or y_target in the layout of x's
// frames ([l, d_out] or with in_t [d_out, l]) for the train kernel.
struct UnrIO {
  const float* x;
  float* y;
  float* gx;          // null: no coordinate gradient
  const float* aux;
  float* partials;    // [blocks, 1 + G]: a block's [loss | G] (backward, train)
  long long l;
  int in_t, out_t;
  int component;      // output differentiated by cv+forces, < 0: their sum
  int want_ref;       // also the ref_x gradient (backward, train)
  float inv_count;    // 1 / (l * d_out), the train kernel's mean
  int frames, pitch;  // F, a power of two, and F + 1
};

__host__ __device__ __forceinline__ bool needs_alignment(const ModelArgs& m) {
  return m.n_align > 0 && m.n_pos > 0;
}

// Offsets in floats of the block's rows: xs [3n], gx [3n] (where gx is
// formed), cols [n_feat] (the MLP's input in final column order, then in
// the adjoint its cotangent), h [sum of
// the layer widths] (every layer's output, post-activation), z [as h] (the
// pre-activations, where the MLP runs backwards through gelu or swish), dz
// [the hidden layers' widths] (their outputs' cotangents; the output's
// cotangent overwrites the output, in h or, without an MLP, in cols),
// lam [1] (QCP's Newton result, where gx is formed in a model with
// alignment), st [UNR_ST_ROWS] (with ref: the backward and train kernels
// asked for the ref_x gradient of an aligned model), loss [1] (train).
struct UnrSmem { int xs, gx, cols, h, z, dz, lam, st, loss, total; };

__host__ __device__ inline UnrSmem unr_smem(const ModelArgs& m, int mode, bool gx, bool ref,
                                            int FP) {
  int hsum = 0;
  for (int L = 0; L < m.n_layers; ++L) hsum += m.dims[L + 1];
  const bool back = mode != UNR_FORWARD;
  UnrSmem s;
  int o = 0;
  s.xs = o;   o += 3 * m.n_atoms * FP;
  s.gx = o;   if (gx) o += 3 * m.n_atoms * FP;
  s.cols = o; o += m.n_feat * FP;
  s.h = o;    o += hsum * FP;
  s.z = o;    if (back && act_needs_z(m.activation)) o += hsum * FP;
  s.dz = o;   if (back && m.n_layers) o += (hsum - m.dims[m.n_layers]) * FP;
  s.lam = o;  if (back && gx && needs_alignment(m)) o += FP;
  s.st = o;   if (mode >= UNR_BACKWARD && ref && needs_alignment(m)) o += UNR_ST_ROWS * FP;
  s.loss = o; if (mode == UNR_TRAIN) o += FP;
  s.total = o;
  return s;
}

// Row offset of layer L's output inside h, z and dz.
__host__ __device__ __forceinline__ int unr_layer_row(const ModelArgs& m, int L) {
  int o = 0;
  for (int i = 0; i < L; ++i) o += m.dims[i + 1];
  return o;
}

// Offset in floats of the cotangent of layer L's output (L = n_layers - 1:
// the model's output, or without an MLP the columns), which overwrites the
// output itself.
__host__ __device__ __forceinline__ int unr_dz_at(const ModelArgs& m, const UnrSmem& so, int L,
                                                  int FP) {
  if (!m.n_layers) return so.cols;
  return (L == m.n_layers - 1 ? so.h : so.dz) + unr_layer_row(m, L) * FP;
}

// The atoms idx[0..cnt) of a frame, packed [cnt, 3] for the feature
// functions above: row r of the frame's state at xs[r * FP].
__host__ __device__ __forceinline__ void unr_atoms(const float* xs, int FP, const int* idx,
                                                   int cnt, float* loc) {
#pragma unroll
  for (int i = 0; i < cnt; ++i)
#pragma unroll
    for (int c = 0; c < 3; ++c) loc[3 * i + c] = xs[(3 * idx[i] + c) * FP];
}

// ... and an adjoint over them added into the gx rows.
__host__ __device__ __forceinline__ void unr_scatter(float* gx, int FP, const int* idx, int cnt,
                                                     const float* ga) {
#pragma unroll
  for (int i = 0; i < cnt; ++i)
#pragma unroll
    for (int c = 0; c < 3; ++c) gx[(3 * idx[i] + c) * FP] += ga[3 * i + c];
}

// One coordination feature of a frame (molann_tpu/ops/fused.py:392-410,
// _coordination_row): the switching function summed over the feature's
// pairs in table order. A thread owns its frame and the unrolled envelope
// has at most 96 pairs (UNROLLED_MAX_COORD_PAIRS, checked by the wrapper),
// so a plain loop in a fixed order is enough and gives the same bits on
// every launch.
__host__ __device__ __forceinline__ float coordination_fwd(const int* pairs, int n_pairs,
                                                           const CoordPar& cp,
                                                           const float* xs, int FP) {
  float acc = 0.f;
  for (int p = 0; p < n_pairs; ++p) {
    const float* xi = xs + 3 * pairs[2 * p] * FP;
    const float* xj = xs + 3 * pairs[2 * p + 1] * FP;
    const V3 d = min_image(xj[0] - xi[0], xj[FP] - xi[FP], xj[2 * FP] - xi[2 * FP], cp);
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
                                                          const float* xs, int FP, float g,
                                                          float* gx) {
  for (int p = 0; p < n_pairs; ++p) {
    const int i = 3 * pairs[2 * p] * FP, j = 3 * pairs[2 * p + 1] * FP;
    const V3 d = min_image(xs[j] - xs[i], xs[j + FP] - xs[i + FP],
                           xs[j + 2 * FP] - xs[i + 2 * FP], cp);
    float s, coef;
    switch_eval<true>(cp, dot3(d, d), s, coef);
    const V3 gd = scale3(g * coef, d);
    gx[j] += gd.x; gx[j + FP] += gd.y; gx[j + 2 * FP] += gd.z;
    gx[i] -= gd.x; gx[i + FP] -= gd.y; gx[i + 2 * FP] -= gd.z;
  }
}

// The centroid c and covariance H of a frame's align atoms
// (molann_tpu/ops/fused.py:310-361).
__host__ __device__ __forceinline__ void unr_covariance(const ModelArgs& m, const float* xs,
                                                        int FP, float c[3], float H[3][3]) {
  const float n_a = (float)m.n_align;
  for (int i = 0; i < 3; ++i) {
    float s = 0.f;
    for (int n = 0; n < m.n_align; ++n) s += xs[(3 * m.align_idx[n] + i) * FP];
    c[i] = s / n_a;
  }
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      float acc = 0.f;
      for (int n = 0; n < m.n_align; ++n)
        acc += (xs[(3 * m.align_idx[n] + i) * FP] - c[i]) * m.ref_x[3 * n + j];
      H[i][j] = acc;
    }
}

// Block `block`'s frames into the xs rows, coalesced on both layouts; the
// ragged last block repeats its last frame, so all math stays finite. With
// kGx the gx rows are zeroed too.
template <bool kGx>
__host__ __device__ inline void unr_load(const ModelArgs& m, const UnrIO& io, float* sm,
                                         const UnrSmem& so, long long block, int tid, int nt) {
  const int F = io.frames, FP = io.pitch, n3 = 3 * m.n_atoms;
  const long long f0 = block * F;
  const int nf = io.l - f0 < (long long)F ? (int)(io.l - f0) : F;
  float* xs = sm + so.xs;
  if (!io.in_t) {  // [l, 3n]: thread e takes (frame e / n3, column e % n3)
    int f = tid / n3, col = tid - f * n3;
    const float* src = io.x + f0 * n3;
    for (int e = tid; e < F * n3; e += nt) {
      xs[col * FP + f] = src[(long long)(f < nf ? f : nf - 1) * n3 + col];
      for (col += nt; col >= n3; col -= n3) ++f;
    }
  } else {         // [3n, l]: frames fastest
    for (int e = tid; e < F * n3; e += nt) {
      const int col = e / F, f = e - col * F;
      xs[col * FP + f] = io.x[(long long)col * io.l + f0 + (f < nf ? f : nf - 1)];
    }
  }
  if (kGx)
    for (int e = tid; e < n3 * FP; e += nt) sm[so.gx + e] = 0.f;
}

// The forward of thread (f, h), two threads a frame (h = 0, 1), each step
// followed by a barrier in the kernels:
// unr_feat: h = 0 the angle, bond, dihedral and coordination columns; h = 1
// the alignment (QCP on plain floats; with kGx its Newton result kept for
// the adjoint: the kernels without gx run it again where they want the
// ref_x gradient, as keeping it cost them more than it saved) and the
// position columns. Each column goes to its final place.
template <bool kKeepLam>
__host__ __device__ inline void unr_feat(const ModelArgs& m, const UnrIO& io, float* sm,
                                         const UnrSmem& so, int f, int h) {
  const int FP = io.pitch;
  const float* xs = sm + so.xs + f;
  float* cols = sm + so.cols + f;
  const int loc4[4] = {0, 1, 2, 3};
  float loc[12];
  int row = 0;
  if (h == 0) {
    for (int i = 0; i < m.n_angles; ++i) {
      unr_atoms(xs, FP, m.angle_idx + 3 * i, 3, loc);
      cols[m.col_of[row++] * FP] = angle_fwd(loc, loc4, m.use_angle_value);
    }
    for (int i = 0; i < m.n_bonds; ++i) {
      unr_atoms(xs, FP, m.bond_idx + 2 * i, 2, loc);
      cols[m.col_of[row++] * FP] = bond_fwd(loc, loc4);
    }
    for (int i = 0; i < m.n_dihedrals; ++i) {
      unr_atoms(xs, FP, m.dihedral_idx + 4 * i, 4, loc);
      float out[2];
      const int cnt = dihedral_fwd(loc, loc4, m.use_angle_value, out);
      for (int k = 0; k < cnt; ++k) cols[m.col_of[row++] * FP] = out[k];
    }
    for (int k = 0; k < m.n_coord; ++k) {
      const int p0 = m.coord_start[k];
      cols[m.col_of[row++] * FP] =
          coordination_fwd(m.coord_pairs + 2 * p0, m.coord_start[k + 1] - p0,
                           coord_load(m.coord_par + k * MOLANN_COORD_FLOATS), xs, FP);
    }
    return;
  }
  row = m.n_angles + m.n_bonds + m.n_dihedrals * (m.use_angle_value ? 1 : 2) + m.n_coord;
  const bool al = needs_alignment(m);
  float c[3] = {0.f, 0.f, 0.f}, R[3][3];
  if (al) {
    float H[3][3], lam0;
    unr_covariance(m, xs, FP, c, H);
    qcp_rotation(H, R, kKeepLam ? &lam0 : nullptr);
    if (kKeepLam) sm[so.lam + f] = lam0;  // for qcp_rotation_vjp
  }
  for (int p = 0; p < m.n_pos; ++p) {
    const float* xa = xs + 3 * m.pos_idx[p] * FP;
    float v[3] = {xa[0], xa[FP], xa[2 * FP]};
    if (al) {
      const float u[3] = {v[0] - c[0], v[1] - c[1], v[2] - c[2]};
      for (int i = 0; i < 3; ++i) v[i] = u[0] * R[0][i] + u[1] * R[1][i] + u[2] * R[2][i];
    }
    for (int i = 0; i < 3; ++i) cols[m.col_of[row++] * FP] = v[i];
  }
}

// unr_mlp: layer L forward, thread (f, h) the outputs j0..j0+3 of every
// second group of four (h = j0 / 4 mod 2), so that a loaded input feeds
// four sums; the pre-activations too where the MLP runs backwards through
// gelu or swish.
template <int kMode>
__host__ __device__ inline void unr_mlp(const ModelArgs& m, const UnrIO& io, float* sm,
                                        const UnrSmem& so, int L, int f, int h) {
  const int FP = io.pitch;
  const bool with_z = kMode != UNR_FORWARD && act_needs_z(m.activation);
  const int d_in = m.dims[L], d_o = m.dims[L + 1];
  const bool last = L == m.n_layers - 1;
  const float* in = L ? sm + so.h + unr_layer_row(m, L - 1) * FP + f : sm + so.cols + f;
  float* out = sm + so.h + unr_layer_row(m, L) * FP + f;
  float* zo = sm + so.z + unr_layer_row(m, L) * FP + f;
  for (int j0 = 4 * h; j0 < d_o; j0 += 8) {
    const float* w[4];
    float a[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = j0 + u < d_o ? j0 + u : d_o - 1;
      w[u] = m.w[L] + j * d_in;
      a[u] = m.b[L][j];
    }
    for (int k = 0; k < d_in; ++k) {
      const float v = in[k * FP];
#pragma unroll
      for (int u = 0; u < 4; ++u) a[u] += w[u][k] * v;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (j0 + u < d_o) {
        out[(j0 + u) * FP] = last ? a[u] : act_fwd(m.activation, a[u]);
        if (with_z && !last) zo[(j0 + u) * FP] = a[u];
      }
  }
}

// unr_seed, thread (f, 0): by mode the output y (forward, cv+forces) and
// the cotangent of the output over the output: the one-hot or all-ones
// component (cv+forces), gy (backward) or 2 (y - y_target) inv_count with
// the frame's loss term (train), zero on the ragged block's repeated frames.
template <int kMode>
__host__ __device__ inline void unr_seed(const ModelArgs& m, const UnrIO& io, float* sm,
                                         const UnrSmem& so, long long block, int f, int h) {
  if (h != 0) return;
  const int F = io.frames, FP = io.pitch;
  const long long f0 = block * F;
  const bool live = f0 + f < io.l;
  const long long fr = f0 + f;
  const int d_out = model_out_dim(m);
  float* yo = sm + unr_dz_at(m, so, m.n_layers - 1, FP) + f;  // the output, then its cotangent
  float loss = 0.f;
  for (int j = 0; j < d_out; ++j) {
    const float yj = yo[j * FP];
    if (kMode == UNR_FORWARD || kMode == UNR_FORCES) {
      if (live) io.y[io.out_t ? (long long)j * io.l + fr : fr * d_out + j] = yj;
      if (kMode == UNR_FORCES)
        yo[j * FP] = (io.component < 0 || j == io.component) ? 1.0f : 0.0f;
    } else if (kMode == UNR_BACKWARD) {
      yo[j * FP] = live ? io.aux[fr * d_out + j] : 0.f;
    } else {
      const float e = live ? yj - io.aux[io.in_t ? (long long)j * io.l + fr : fr * d_out + j] : 0.f;
      loss += e * e;
      yo[j * FP] = 2.0f * e * io.inv_count;
    }
  }
  if (kMode == UNR_TRAIN) sm[so.loss + f] = loss * io.inv_count;
}

// unr_bwd: layer L's input cotangent dz[L - 1] from dz[L], thread (f, h)
// every second group of four inputs.
__host__ __device__ inline void unr_bwd(const ModelArgs& m, const UnrIO& io, float* sm,
                                        const UnrSmem& so, int L, int f, int h) {
  const int FP = io.pitch;
  const bool with_z = act_needs_z(m.activation);
  const int d_in = m.dims[L], d_o = m.dims[L + 1];
  const int r_in = unr_layer_row(m, L - 1);
  const float* g = sm + unr_dz_at(m, so, L, FP) + f;
  const float* t = sm + so.h + r_in * FP + f;
  const float* zi = sm + so.z + r_in * FP + f;
  float* gi = sm + unr_dz_at(m, so, L - 1, FP) + f;
  for (int k0 = 4 * h; k0 < d_in; k0 += 8) {
    int k[4];
    float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int u = 0; u < 4; ++u) k[u] = k0 + u < d_in ? k0 + u : d_in - 1;
    for (int j = 0; j < d_o; ++j) {
      const float gj = g[j * FP];
      const float* w = m.w[L] + j * d_in;
#pragma unroll
      for (int u = 0; u < 4; ++u) a[u] += w[k[u]] * gj;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (k0 + u < d_in)
        gi[k[u] * FP] = a[u] * act_grad(m.activation, t[k[u] * FP], with_z ? zi[k[u] * FP] : 0.f);
  }
}

// The block's row [loss | ref_x | W0 | b0 | W1 | b1 ...] of partials: each
// layer's gW[j][k] = sum_f dz[j][f] a[k][f] and gb[j] = sum_f dz[j][f] over
// the block's true frames in order, a thread forming 2 x 2 entries (the
// bias as an input of ones) from four shared loads a frame; the loss by
// thread 0. The ref_x entries are zeros unless `ref_later` (unr_finish
// writes them). No atomics: the same inputs give the same bits.
__host__ __device__ inline void unr_param_sums(const ModelArgs& m, const UnrIO& io,
                                               const float* sm, const UnrSmem& so,
                                               long long block, int mode, bool ref_later,
                                               int tid, int nt) {
  const int F = io.frames, FP = io.pitch;
  const long long f0 = block * F;
  const int nf = io.l - f0 < (long long)F ? (int)(io.l - f0) : F;
  float* row = io.partials + block * (long long)(1 + model_grad_size(m));
  if (tid == 0) {
    float s = 0.f;
    if (mode == UNR_TRAIN)
      for (int f = 0; f < nf; ++f) s += sm[so.loss + f];
    row[0] = s;
  }
  if (!ref_later)
    for (int e = tid; e < 3 * m.n_align; e += nt) row[1 + e] = 0.f;
  int off = 1 + 3 * m.n_align;
  for (int L = 0; L < m.n_layers; ++L) {
    const int d_in = m.dims[L], d_o = m.dims[L + 1];
    const float* a = L ? sm + so.h + unr_layer_row(m, L - 1) * FP : sm + so.cols;
    const float* g = sm + unr_dz_at(m, so, L, FP);
    const int n_jp = (d_o + 1) / 2, n_kp = (d_in + 2) / 2;  // d_in + 1 inputs
    for (int it = tid; it < n_jp * n_kp; it += nt) {
      const int j0 = 2 * (it % n_jp), k0 = 2 * (it / n_jp);
      const float* g0 = g + j0 * FP;
      const float* g1 = g + (j0 + 1 < d_o ? j0 + 1 : j0) * FP;
      const float* a0 = k0 < d_in ? a + k0 * FP : nullptr;       // null: the bias
      const float* a1 = k0 + 1 < d_in ? a + (k0 + 1) * FP : nullptr;
      float t00 = 0.f, t01 = 0.f, t10 = 0.f, t11 = 0.f;
      for (int f = 0; f < nf; ++f) {
        const float u0 = g0[f], u1 = g1[f];
        const float v0 = a0 ? a0[f] : 1.0f, v1 = a1 ? a1[f] : 1.0f;
        t00 += u0 * v0; t01 += u0 * v1;
        t10 += u1 * v0; t11 += u1 * v1;
      }
      const float t[2][2] = {{t00, t01}, {t10, t11}};
      for (int jj = 0; jj < 2; ++jj)
        for (int kk = 0; kk < 2; ++kk) {
          const int j = j0 + jj, k = k0 + kk;
          if (j < d_o && k <= d_in)
            row[off + (k < d_in ? j * d_in + k : d_o * d_in + j)] = t[jj][kk];
        }
    }
    off += d_o * (d_in + 1);
  }
}

// The adjoint of thread (f, h), two threads a frame, each step followed by
// a barrier in the kernels:
// unr_dcol: the cotangents of the feature columns, W0^T dz0 (or the seed
// without an MLP), over the columns in place (so after unr_param_sums has
// read them), thread (f, h) every second group of four columns.
__host__ __device__ inline void unr_dcol(const ModelArgs& m, const UnrIO& io, float* sm,
                                         const UnrSmem& so, int f, int h) {
  const int FP = io.pitch;
  float* dc = sm + so.cols + f;
  const float* dz = sm + unr_dz_at(m, so, 0, FP) + f;
  if (!m.n_layers) return;  // the seed was written over the columns
  const int d_in = m.dims[0], d_o = m.dims[1];
  for (int k0 = 4 * h; k0 < d_in; k0 += 8) {
    int k[4];
    float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int u = 0; u < 4; ++u) k[u] = k0 + u < d_in ? k0 + u : d_in - 1;
    for (int j = 0; j < d_o; ++j) {
      const float gj = dz[j * FP];
      const float* w = m.w[0] + j * d_in;
#pragma unroll
      for (int u = 0; u < 4; ++u) a[u] += w[k[u]] * gj;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (k0 + u < d_in) dc[k[u] * FP] = a[u];
  }
}

// What the alignment's adjoint carries from unr_adj_a to unr_adj_b in the
// registers of thread (f, 1).
struct UnrAlignAdj { float R[3][3], gH[9], c[3]; };

// unr_adj_a: h = 0 every angle's, bond's, dihedral's and coordination
// feature's adjoint into the gx rows (with kGx); h = 1 the alignment's: gR
// from the position columns' cotangents, then QCP once more and back
// through it (qcp_rotation_vjp) for R and gH = gR : dR/dH into `a`, and
// with want_ref gH and c into the st rows for the block's ref_x sums.
template <bool kGx>
__host__ __device__ inline void unr_adj_a(const ModelArgs& m, const UnrIO& io, float* sm,
                                          const UnrSmem& so, int f, int h, bool want_ref,
                                          UnrAlignAdj& a) {
  const int FP = io.pitch;
  const float* xs = sm + so.xs + f;
  float* gx = sm + so.gx + f;
  const float* dc = sm + so.cols + f;
  int row = 0;
  if (h == 0) {
    if (!kGx) return;
    const int loc4[4] = {0, 1, 2, 3};
    float loc[12], ga[12];
    for (int i = 0; i < m.n_angles; ++i) {
      const int* idx = m.angle_idx + 3 * i;
      unr_atoms(xs, FP, idx, 3, loc);
#pragma unroll
      for (int q = 0; q < 9; ++q) ga[q] = 0.f;
      angle_bwd(loc, loc4, m.use_angle_value, dc[m.col_of[row++] * FP], ga);
      unr_scatter(gx, FP, idx, 3, ga);
    }
    for (int i = 0; i < m.n_bonds; ++i) {
      const int* idx = m.bond_idx + 2 * i;
      unr_atoms(xs, FP, idx, 2, loc);
#pragma unroll
      for (int q = 0; q < 6; ++q) ga[q] = 0.f;
      bond_bwd(loc, loc4, dc[m.col_of[row++] * FP], ga);
      unr_scatter(gx, FP, idx, 2, ga);
    }
    for (int i = 0; i < m.n_dihedrals; ++i) {
      const int* idx = m.dihedral_idx + 4 * i;
      unr_atoms(xs, FP, idx, 4, loc);
#pragma unroll
      for (int q = 0; q < 12; ++q) ga[q] = 0.f;
      float g[2];
      g[0] = dc[m.col_of[row++] * FP];
      g[1] = m.use_angle_value ? 0.f : dc[m.col_of[row++] * FP];
      dihedral_bwd(loc, loc4, m.use_angle_value, g, ga);
      unr_scatter(gx, FP, idx, 4, ga);
    }
    for (int k = 0; k < m.n_coord; ++k) {
      const int p0 = m.coord_start[k];
      coordination_bwd(m.coord_pairs + 2 * p0, m.coord_start[k + 1] - p0,
                       coord_load(m.coord_par + k * MOLANN_COORD_FLOATS), xs, FP,
                       dc[m.col_of[row++] * FP], gx);
    }
    return;
  }
  if (!needs_alignment(m)) return;
  row = m.n_angles + m.n_bonds + m.n_dihedrals * (m.use_angle_value ? 1 : 2) + m.n_coord;
  // aligned_i = sum_j (x_j - c_j) R[j][i]: gR[j][i] = sum_p v_p[j] g_p[i]
  float H[3][3];
  unr_covariance(m, xs, FP, a.c, H);
  float gR[3][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
  for (int p = 0; p < m.n_pos; ++p) {
    const float* xa = xs + 3 * m.pos_idx[p] * FP;
    const float v[3] = {xa[0] - a.c[0], xa[FP] - a.c[1], xa[2 * FP] - a.c[2]};
    for (int i = 0; i < 3; ++i) {
      const float g = dc[m.col_of[row++] * FP];
      for (int j = 0; j < 3; ++j) gR[j][i] += v[j] * g;
    }
  }
  // R(H) and gH = gR : dR/dH, QCP once more and back through it
  float gHm[3][3];
  qcp_rotation_vjp(H, gR, kGx ? sm[so.lam + f] : -1.0f, a.R, gHm);
  for (int k = 0; k < 9; ++k) a.gH[k] = gHm[k / 3][k % 3];
  if (want_ref) {  // g_ref[n][j] = sum_i gH[i][j] (x[a_n][i] - c_i), summed by the block
    float* st = sm + so.st + f;
    for (int k = 0; k < 9; ++k) st[k * FP] = a.gH[k];
    for (int i = 0; i < 3; ++i) st[(9 + i) * FP] = a.c[i];
  }
}

// unr_adj_b, thread (f, 1) with kGx: the position columns' cotangents into
// the gx rows, through R, H and the centroid where the model aligns.
template <bool kGx>
__host__ __device__ inline void unr_adj_b(const ModelArgs& m, const UnrIO& io, float* sm,
                                          const UnrSmem& so, int f, int h,
                                          const UnrAlignAdj& a) {
  if (!kGx || h != 1) return;
  const int FP = io.pitch;
  float* gx = sm + so.gx + f;
  const float* dc = sm + so.cols + f;
  int row = m.n_angles + m.n_bonds + m.n_dihedrals * (m.use_angle_value ? 1 : 2) + m.n_coord;
  if (!needs_alignment(m)) {
    for (int p = 0; p < m.n_pos; ++p)
      for (int i = 0; i < 3; ++i) gx[(3 * m.pos_idx[p] + i) * FP] += dc[m.col_of[row++] * FP];
    return;
  }
  // into x and c through R ...
  float gc[3] = {0.f, 0.f, 0.f};
  for (int p = 0; p < m.n_pos; ++p) {
    float g[3];
    for (int i = 0; i < 3; ++i) g[i] = dc[m.col_of[row++] * FP];
    float* ga_p = gx + 3 * m.pos_idx[p] * FP;
    for (int j = 0; j < 3; ++j) {
      const float gv = a.R[j][0] * g[0] + a.R[j][1] * g[1] + a.R[j][2] * g[2];
      ga_p[j * FP] += gv;
      gc[j] -= gv;
    }
  }
  // ... through H[i][j] = sum_n (x[a_n][i] - c[i]) ref[n][j] ...
  for (int n = 0; n < m.n_align; ++n) {
    float* ga_n = gx + 3 * m.align_idx[n] * FP;
    for (int i = 0; i < 3; ++i) {
      const float t = a.gH[3 * i] * m.ref_x[3 * n] + a.gH[3 * i + 1] * m.ref_x[3 * n + 1] +
                      a.gH[3 * i + 2] * m.ref_x[3 * n + 2];
      ga_n[i * FP] += t;
      gc[i] -= t;
    }
  }
  // ... and c = mean of the align atoms
  const float inv_n = 1.0f / (float)m.n_align;
  for (int n = 0; n < m.n_align; ++n)
    for (int i = 0; i < 3; ++i) gx[(3 * m.align_idx[n] + i) * FP] += gc[i] * inv_n;
}

// After the adjoints: with want_ref the block's ref_x sums, in frame order,
// into its row of partials; with kGx the gx rows out to gx, coalesced on
// both layouts.
template <bool kGx>
__host__ __device__ inline void unr_finish(const ModelArgs& m, const UnrIO& io, const float* sm,
                                           const UnrSmem& so, long long block, bool want_ref,
                                           int tid, int nt) {
  const int F = io.frames, FP = io.pitch, n3 = 3 * m.n_atoms;
  const long long f0 = block * F;
  const int nf = io.l - f0 < (long long)F ? (int)(io.l - f0) : F;
  if (want_ref) {
    float* row = io.partials + block * (long long)(1 + model_grad_size(m));
    const float* st = sm + so.st;
    for (int e = tid; e < 3 * m.n_align; e += nt) {
      const int n = e / 3, j = e - 3 * n;
      const float* xa = sm + so.xs + 3 * m.align_idx[n] * FP;
      float s = 0.f;
      for (int f = 0; f < nf; ++f)
        for (int i = 0; i < 3; ++i)
          s += st[(3 * i + j) * FP + f] * (xa[i * FP + f] - st[(9 + i) * FP + f]);
      row[1 + e] = s;
    }
  }
  if (!kGx) return;
  const float* gxs = sm + so.gx;
  if (!io.out_t) {
    int f = tid / n3, col = tid - f * n3;
    float* dst = io.gx + f0 * n3;
    for (int e = tid; e < nf * n3; e += nt) {
      dst[(long long)f * n3 + col] = gxs[col * FP + f];
      for (col += nt; col >= n3; col -= n3) ++f;
    }
  } else {
    for (int e = tid; e < F * n3; e += nt) {
      const int col = e / F, f = e - col * F;
      if (f < nf) io.gx[(long long)col * io.l + f0 + f] = gxs[col * FP + f];
    }
  }
}

// Frames a block of an unrolled kernel takes (two threads each): 64, or 32
// where two blocks of 64 would not fit beside each other in an SM's 228 KB
// of shared memory (each block reserves 1 KB), or else the largest tile that
// fits alone (227 KB); 0 when none does. A frame's state is some 0.5-1 KB,
// so shared memory sets how many blocks share an SM. On alanine on an H100
// 64 frames were the fastest tile for K2, K3 and K4 (K2 0.127 ms against
// 0.135 at 128 frames and 0.147 at 32) and within 7% of it for K1; the tile
// that kept the most frames resident was not (with one thread a frame, K2
// 0.178 ms at 32 frames, 9 blocks an SM, against 0.146 at 128).
__host__ __device__ inline int unr_choose_frames(const ModelArgs& m, int mode, bool gx,
                                                 bool ref) {
  for (int share = 2; share >= 1; --share)
    for (int F = MOLANN_UNR_MAX_FRAMES; F >= 32; F >>= 1) {
      const int smem = unr_smem(m, mode, gx, ref, F + 1).total * (int)sizeof(float);
      if (share * (smem + 1024) <= 228 * 1024 && smem <= 227 * 1024) return F;
    }
  return 0;
}

#ifdef __CUDACC__
// Launch `kernel` over l frames, F = io.frames a block.
template <class Kernel>
inline cudaError_t unr_launch(Kernel kernel, const ModelArgs& m, const UnrIO& io, int mode,
                              bool gx, long long blocks, cudaStream_t stream) {
  const bool ref = io.want_ref && needs_alignment(m);
  const int smem = unr_smem(m, mode, gx, ref, io.pitch).total * (int)sizeof(float);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)blocks, 2 * io.frames, smem, stream>>>(m, io);
  return cudaGetLastError();
}
#endif

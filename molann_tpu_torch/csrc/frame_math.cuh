// Per-frame math of the unrolled fused kernels: Kabsch alignment by QCP,
// every feature, the MLP, and the hand-derived adjoints of all three.
//
// Port of the tile math in molann_tpu/ops/fused.py:172-548
// (qcp_rotation, _align_tiles, the feature rows, _mlp_tiles,
// _forward_tiles). The Pallas kernels get their backward by applying
// jax.vjp to that math; a CUDA kernel has no autodiff, so the adjoints are
// written out here. Every function is __host__ __device__: the same code
// runs in the CUDA kernels (fused_unrolled.cu) and, compiled with a host C++
// compiler, in the CPU test of the adjoints
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
  const float* ref_x;       // [n_align * 3] centred reference
  const float* params;      // per layer: Wt [d_out * d_in] row-major, b [d_out]
};

__host__ __device__ __forceinline__ int model_out_dim(const ModelArgs& m) {
  return m.n_layers ? m.dims[m.n_layers] : m.n_feat;
}

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
// [angles | bonds | dihedrals | positions], the layout spec.perm indexes.
__host__ __device__ __forceinline__ void features_fwd(const ModelArgs& m, const float* xs,
                                                      bool aligned, const float c[3],
                                                      const float R[3][3], float* feat) {
  int row = 0;
  for (int i = 0; i < m.n_angles; ++i)
    feat[row++] = angle_fwd(xs, m.angle_idx + 3 * i, m.use_angle_value);
  for (int i = 0; i < m.n_bonds; ++i) feat[row++] = bond_fwd(xs, m.bond_idx + 2 * i);
  for (int i = 0; i < m.n_dihedrals; ++i)
    row += dihedral_fwd(xs, m.dihedral_idx + 4 * i, m.use_angle_value, feat + row);
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

// Shared forward: alignment (values), features, permutation, MLP.
__host__ __device__ __forceinline__ void frame_forward(const ModelArgs& m, const float* xs,
                                                       float* y) {
  float c[3] = {0.f, 0.f, 0.f};
  float R[3][3];
  const bool aligned = needs_alignment(m);
  if (aligned) {
    float H[3][3];
    align_covariance(m, xs, c, H);
    qcp_rotation(H, R);
  }
  float feat[MOLANN_MAX_COLS], cols[MOLANN_MAX_COLS];
  features_fwd(m, xs, aligned, c, R, feat);
  for (int k = 0; k < m.n_feat; ++k) cols[k] = m.has_perm ? feat[m.perm[k]] : feat[k];
  float h[MOLANN_MAX_LAYERS][MOLANN_MAX_WIDTH];
  const float* out = mlp_fwd(m, cols, h);
  const int d_out = model_out_dim(m);
  for (int j = 0; j < d_out; ++j) y[j] = out[j];
}

// Values y and gx = d(sum_j ct_j y_j)/dx with ct all ones (component < 0)
// or one-hot at `component` (molann_tpu/ops/fused.py:1116-1172).
__host__ __device__ __forceinline__ void frame_cv_forces(const ModelArgs& m,
                                                         const float* xs, float* y,
                                                         float* gx, int component) {
  const bool aligned = needs_alignment(m);
  float c[3] = {0.f, 0.f, 0.f};
  float R[3][3];
  float dR[3][3][9];  // dR[i][j][3p+q] = dR_ij / dH_pq
  if (aligned) {
    float Hf[3][3];
    align_covariance(m, xs, c, Hf);
    Dual9 H[3][3], Rd[3][3];
    for (int p = 0; p < 3; ++p)
      for (int q = 0; q < 3; ++q) {
        H[p][q] = Dual9(Hf[p][q]);
        H[p][q].d[3 * p + q] = 1.0f;
      }
    qcp_rotation(H, Rd);
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) {
        R[i][j] = Rd[i][j].v;
        for (int k = 0; k < 9; ++k) dR[i][j][k] = Rd[i][j].d[k];
      }
  }
  float feat[MOLANN_MAX_COLS], cols[MOLANN_MAX_COLS];
  features_fwd(m, xs, aligned, c, R, feat);
  for (int k = 0; k < m.n_feat; ++k) cols[k] = m.has_perm ? feat[m.perm[k]] : feat[k];
  float h[MOLANN_MAX_LAYERS][MOLANN_MAX_WIDTH];
  const float* out = mlp_fwd(m, cols, h);
  const int d_out = model_out_dim(m);
  for (int j = 0; j < d_out; ++j) y[j] = out[j];

  // MLP adjoint: cotangent of the output, then back through each layer
  float ga[MOLANN_MAX_COLS], gb[MOLANN_MAX_COLS];
  for (int j = 0; j < d_out; ++j) ga[j] = (component < 0 || j == component) ? 1.0f : 0.0f;
  if (m.n_layers) {
    const float* wl[MOLANN_MAX_LAYERS];
    const float* w = m.params;
    for (int L = 0; L < m.n_layers; ++L) {
      wl[L] = w;
      w += m.dims[L + 1] * (m.dims[L] + 1);
    }
    for (int L = m.n_layers - 1; L >= 0; --L) {
      const int d_in = m.dims[L], d_o = m.dims[L + 1];
      for (int k = 0; k < d_in; ++k) {
        float acc = 0.f;
        for (int j = 0; j < d_o; ++j) acc += wl[L][j * d_in + k] * ga[j];
        gb[k] = (L > 0) ? acc * act_grad(m.activation, h[L - 1][k]) : acc;
      }
      for (int k = 0; k < d_in; ++k) ga[k] = gb[k];
    }
  }
  // undo the permutation: ga holds d/dcols; gb gets d/dfeat
  for (int k = 0; k < m.n_feat; ++k) gb[m.has_perm ? m.perm[k] : k] = ga[k];

  for (int k = 0; k < 3 * m.n_atoms; ++k) gx[k] = 0.f;
  int row = 0;
  for (int i = 0; i < m.n_angles; ++i)
    angle_bwd(xs, m.angle_idx + 3 * i, m.use_angle_value, gb[row++], gx);
  for (int i = 0; i < m.n_bonds; ++i) bond_bwd(xs, m.bond_idx + 2 * i, gb[row++], gx);
  for (int i = 0; i < m.n_dihedrals; ++i) {
    dihedral_bwd(xs, m.dihedral_idx + 4 * i, m.use_angle_value, gb + row, gx);
    row += m.use_angle_value ? 1 : 2;
  }
  if (!aligned) {
    for (int p = 0; p < m.n_pos; ++p, row += 3)
      acc_atom(gx, m.pos_idx[p], V3{gb[row], gb[row + 1], gb[row + 2]});
    return;
  }
  // aligned_i = sum_j (x_j - c_j) R[j][i]: into x, c and R
  float gc[3] = {0.f, 0.f, 0.f};
  float gR[3][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
  for (int p = 0; p < m.n_pos; ++p, row += 3) {
    const int a = m.pos_idx[p];
    const float v[3] = {xs[3 * a] - c[0], xs[3 * a + 1] - c[1], xs[3 * a + 2] - c[2]};
    const float* g = gb + row;
    for (int j = 0; j < 3; ++j) {
      float gv = R[j][0] * g[0] + R[j][1] * g[1] + R[j][2] * g[2];
      gx[3 * a + j] += gv;
      gc[j] -= gv;
      for (int i = 0; i < 3; ++i) gR[j][i] += v[j] * g[i];
    }
  }
  // R(H): the QCP composite's Jacobian from the dual pass
  float gH[9];
  for (int k = 0; k < 9; ++k) {
    float acc = 0.f;
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) acc += gR[i][j] * dR[i][j][k];
    gH[k] = acc;
  }
  // H[i][j] = sum_n (x[a_n][i] - c[i]) ref[n][j]
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

// Per-block math of the blocked fused kernels: every phase a thread block
// runs on its tile of frames, written as plain functions of (thread index,
// thread count) so that the same code runs in the CUDA kernels
// (fused_blocked.cu), where the phases are separated by __syncthreads(), and,
// compiled with a host C++ compiler, in the CPU test that walks the threads
// of each phase in a loop (tests/test_torch_port_blocked_math.py).
//
// Port of WHAT molann_tpu/ops/fused_blocked.py computes per tile
// (_feats_from_segs :1030-1152, the coordination sums and pullbacks
// :813-885, _blk_cv_forces_kernel :1398-1471), not of how: a thread gathers
// x[a] through int32 index tables instead of multiplying by a 0/+-1 edge
// matrix, and the adjoints are written out by hand (frame_math.cuh holds the
// bond, angle, dihedral and QCP ones, reused here).
//
// Shared memory of a block, in rows of `pitch` floats (one float per frame
// of the tile, pitch odd so that both row-wise and frame-wise walks are
// bank-conflict free):
//   xs    [3 * n_act]  coordinates of the staged (active) atoms, row 3k+c
//   feat  [n_feat]     feature columns in final order; overwritten in place
//                      by their cotangents in the cv+forces kernel
//   h     [sum dims]   output of every MLP layer; overwritten in place by
//                      the layer cotangents
//   st    [21 | 123]   per-frame alignment state (only with alignment)
//   part  [n_coord * threads] partial switching sums, one per thread
#pragma once

#include "frame_math.cuh"

#define MOLANN_BLK_MAX_LAYERS 8
#define MOLANN_BLK_COORD_FLOATS 20
#define MOLANN_BLK_THREADS 256

// Kinds of an atom's entries in the gather table (atom_ent):
// kind << 28 | role << 26 | item.
enum { BLK_ENT_ANGLE = 0, BLK_ENT_BOND = 1, BLK_ENT_DIHEDRAL = 2,
       BLK_ENT_POS = 3, BLK_ENT_ALIGN = 4 };

// Rows of the per-frame alignment state.
enum { BLK_ST_C = 0, BLK_ST_H = 3, BLK_ST_R = 12, BLK_ST_FWD_ROWS = 21,
       BLK_ST_GR = 21, BLK_ST_GH = 30, BLK_ST_GC = 39, BLK_ST_DR = 42,
       BLK_ST_ALL_ROWS = 123 };

// Offsets into a coordination feature's MOLANN_BLK_COORD_FLOATS parameters.
enum { BLK_CP_R0 = 0, BLK_CP_NN = 1, BLK_CP_MM = 2, BLK_CP_HAS_DMAX = 3,
       BLK_CP_DMAX = 4, BLK_CP_SDMAX = 5, BLK_CP_STRETCH = 6,
       BLK_CP_HAS_BOX = 7, BLK_CP_INV = 8, BLK_CP_BOX = 11 };

// Model description, passed by value to the kernels; mirrored field by
// field by the ctypes.Structure in ops/fused_blocked.py. Every atom index
// in the tables is a STAGED index (position in the active-atom list).
struct BlockedArgs {
  int n_act;        // staged atoms (the active atoms, or all of them)
  int n_out;        // atoms of the gradient output
  int n_angles, n_bonds, n_dihedrals, n_coord, n_pos;
  int n_align;      // 0 unless the model aligns AND has position features
  int use_angle_value;
  int n_feat;       // feature columns
  int n_layers;
  int activation;   // MOLANN_ACT_*
  int dims[MOLANN_BLK_MAX_LAYERS + 1];  // dims[0] = n_feat
  int frames;       // frames per block, a power of two
  int pitch;        // floats per shared-memory row (frames | 1)
  const int* active_idx;    // [n_act] input atom of each staged atom; null = identity
  const int* out_map;       // [n_out] staged atom of each output atom, -1 = zero; null = identity
  const int* angle_idx;     // [n_angles * 3]
  const int* bond_idx;      // [n_bonds * 2]
  const int* dihedral_idx;  // [n_dihedrals * 4]
  const int* pos_idx;       // [n_pos]
  const int* align_idx;     // [n_align]
  const int* item_col;      // first final column of each angle, bond,
                            // dihedral, coordination feature, position atom
  const int* atom_ptr;      // [n_act + 1] rows of atom_ent
  const int* atom_ent;      // every (feature, role) that touches the atom
  const int* coord_start;   // [n_coord + 1] rows of pairs
  const int* pairs;         // [n_pairs * 2] (i, j), d = x[j] - x[i]
  const int* nbr_ptr;       // [n_coord * (n_act + 1)] rows of nbr
  const int* nbr;           // [n_pairs * 2] pair partners of each atom
  const float* coord_par;   // [n_coord * MOLANN_BLK_COORD_FLOATS]
  const float* ref_x;       // [n_align * 3]
  const float* params;      // per layer: W transposed, [d_in * d_out] row-major, then b [d_out]
  const float* weights;     // per layer: W [d_out * d_in] row-major, for the MLP backwards
};

// One call's tensors; strides in floats of frame, atom and component (x,
// gx) or frame and column (y).
struct BlockedIO {
  const float* x;
  float* y;
  float* gx;
  long long l;
  long long x_sf, x_sa, x_sc;
  long long y_sf, y_sj;
  long long g_sf, g_sa, g_sc;
  int component;  // final output column to differentiate, < 0 = their sum
};

struct BlkSmem { int xs, feat, h, st, part, total; };  // offsets in floats

__host__ __device__ __forceinline__ bool blk_aligned(const BlockedArgs& m) {
  return m.n_align > 0;
}

__host__ __device__ inline BlkSmem blk_smem(const BlockedArgs& m, int nt, bool forces) {
  BlkSmem s;
  int o = 0;
  s.xs = o;   o += 3 * m.n_act * m.pitch;
  s.feat = o; o += m.n_feat * m.pitch;
  s.h = o;
  for (int L = 0; L < m.n_layers; ++L) o += m.dims[L + 1] * m.pitch;
  s.st = o;
  if (blk_aligned(m)) o += (forces ? BLK_ST_ALL_ROWS : BLK_ST_FWD_ROWS) * m.pitch;
  s.part = o; o += m.n_coord * nt;
  s.total = o;
  return s;
}

// Offset of layer L's output inside the h region.
__host__ __device__ __forceinline__ int blk_h_off(const BlockedArgs& m, int L) {
  int o = 0;
  for (int i = 0; i < L; ++i) o += m.dims[i + 1] * m.pitch;
  return o;
}

__host__ __device__ __forceinline__ int blk_out_dim(const BlockedArgs& m) {
  return m.n_layers ? m.dims[m.n_layers] : m.n_feat;
}

// Phases: LOAD, FEAT, REDUCE, QCP, POS, one per MLP layer, OUT; the
// cv+forces kernel goes on with one per MLP layer backwards, GR, GH, GC and
// GATHER.
enum { BLK_PH_LOAD = 0, BLK_PH_FEAT = 1, BLK_PH_REDUCE = 2, BLK_PH_QCP = 3,
       BLK_PH_POS = 4, BLK_PH_MLP = 5 };

__host__ __device__ __forceinline__ int blk_n_phases(const BlockedArgs& m, bool forces) {
  return forces ? 10 + 2 * m.n_layers : 6 + m.n_layers;
}

// ---------------------------------------------------------------------------
// The switching function (molann_tpu_torch/ops/features.py:112-143) and its
// derivative
// ---------------------------------------------------------------------------

// t^k for k >= 1 by repeated squaring, the products in the order of _ipow;
// the usual switching exponents are written out, so that they cost their
// two to four multiplies and no loop.
__host__ __device__ __forceinline__ float blk_ipow(float t, int k) {
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
__host__ __device__ __forceinline__ void blk_geometric(float t, int k, float& v, float& dv) {
  v = 1.f; dv = 0.f;
  for (int i = 1; i < k; ++i) { dv = v + t * dv; v = 1.f + t * v; }
}

// Reciprocal and reciprocal square root of the pair loops. On the card the
// special-function unit and one Newton step (about 1 ulp) replace
// IEEE division and square root, which cost some ten operations each and
// were most of a pair's work; on the host the exact forms stand in.
#ifdef __CUDA_ARCH__
__device__ __forceinline__ float blk_rcp(float v) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  const float c = v * r;  // NaN for v = inf (r = 0): keep the 0
  return c == c ? r * (2.0f - c) : r;
}
__device__ __forceinline__ float blk_rsqrt(float v) {
  float r;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r * (1.5f - 0.5f * v * r * r);
}
#else
inline float blk_rcp(float v) { return 1.0f / v; }
inline float blk_rsqrt(float v) { return 1.0f / sqrtf(v); }
#endif

// A coordination feature's parameters, read once per thread into registers
// before its pair loop.
struct BlkCoord {
  float r0, inv_r0, dmax, dmax2, sdmax, stretch;
  float inv[3], box[9];
  int nn, mm;
  bool has_dmax, has_box, ortho;
};

__host__ __device__ __forceinline__ BlkCoord blk_coord(const float* cp) {
  BlkCoord c;
  c.r0 = cp[BLK_CP_R0];
  c.inv_r0 = 1.0f / c.r0;
  c.nn = (int)cp[BLK_CP_NN];
  c.mm = (int)cp[BLK_CP_MM];
  c.has_dmax = cp[BLK_CP_HAS_DMAX] != 0.f;
  c.dmax = cp[BLK_CP_DMAX];
  c.dmax2 = c.dmax * c.dmax;
  c.sdmax = cp[BLK_CP_SDMAX];
  c.stretch = cp[BLK_CP_STRETCH];
  c.has_box = cp[BLK_CP_HAS_BOX] != 0.f;
  for (int a = 0; a < 3; ++a) c.inv[a] = cp[BLK_CP_INV + a];
  for (int a = 0; a < 9; ++a) c.box[a] = cp[BLK_CP_BOX + a];
  c.ortho = c.box[1] == 0.f && c.box[2] == 0.f && c.box[3] == 0.f &&
            c.box[5] == 0.f && c.box[6] == 0.f && c.box[7] == 0.f;
  return c;
}

// s(r) and s'(r)/r of a pair at squared distance r2. Past d_max both are
// exactly 0, decided on r2 before any square root (a NaN too, as
// torch.where(r < d_max, ., 0) gives); r = 0 gives s'(r)/r = 0 times a
// finite number as the reference's guard does.
template <bool kGrad>
__host__ __device__ __forceinline__ void blk_switch(const BlkCoord& cp, float r2, float& s,
                                                    float& ds_over_r) {
  ds_over_r = 0.f;
  if (cp.has_dmax && !(r2 < cp.dmax2)) { s = 0.f; return; }
  const float inv_r = r2 > 1e-30f ? blk_rsqrt(r2) : 0.f;
  // r / r0 by the reciprocal and one correction step: a bare r * (1 / r0)
  // is off by the same fraction of an ulp for every pair of a feature, and
  // thousands of such errors of one sign add up in the sum
  const float r = r2 * inv_r;
  float t = r * cp.inv_r0;
  t = fmaf(fmaf(-t, cp.r0, r), cp.inv_r0, t);
  float raw, draw = 0.f;
  if (cp.mm == 2 * cp.nn) {  // (1 - t^n)/(1 - t^2n) = 1/(1 + t^n)
    raw = blk_rcp(1.0f + blk_ipow(t, cp.nn));
    if (kGrad)
      draw = -(float)cp.nn * (cp.nn > 1 ? blk_ipow(t, cp.nn - 1) : 1.0f) * raw * raw;
  } else {                   // quotient of geometric sums
    float num, dnum, den, dden;
    blk_geometric(t, cp.nn, num, dnum);
    blk_geometric(t, cp.mm, den, dden);
    const float inv_den = blk_rcp(den);
    raw = num * inv_den;
    draw = (dnum - raw * dden) * inv_den;
  }
  const float scale = cp.has_dmax ? cp.stretch : 1.0f;
  s = cp.has_dmax ? (raw - cp.sdmax) * cp.stretch : raw;
  if (kGrad) ds_over_r = draw * scale * cp.inv_r0 * inv_r;
}

// One step of a compensated (Kahan) sum: a switching sum runs over
// thousands of pairs and its value into the hundreds, where a plain f32
// accumulator would lose the digits the standardised MLP input needs.
__host__ __device__ __forceinline__ void blk_kahan(float v, float& acc, float& comp) {
  const float y = v - comp;
  const float t = acc + y;
  comp = (t - acc) - y;
  acc = t;
}

// d = x[j] - x[i] of frame f, by minimum image when the feature has a box
// (rintf rounds half to even, as torch.round and jnp.round do).
__host__ __device__ __forceinline__ V3 blk_pair_vector(const float* xs, int FP, int f, int i,
                                                       int j, const BlkCoord& cp) {
  float d[3];
  for (int c = 0; c < 3; ++c) d[c] = xs[(3 * j + c) * FP + f] - xs[(3 * i + c) * FP + f];
  if (cp.has_box) {
    if (cp.ortho) {
      for (int a = 2; a >= 0; --a) d[a] = d[a] - rintf(d[a] * cp.inv[a]) * cp.box[4 * a];
    } else {
      for (int a = 2; a >= 0; --a) {
        const float shift = rintf(d[a] * cp.inv[a]);
        for (int b = 0; b < 3; ++b) {
          const float e = cp.box[3 * a + b];
          if (e != 0.f) d[b] = d[b] - shift * e;
        }
      }
    }
  }
  return V3{d[0], d[1], d[2]};
}

// ---------------------------------------------------------------------------
// Phases
// ---------------------------------------------------------------------------

// The atoms idx[0..cnt) of frame f, packed [cnt, 3] for frame_math.cuh.
__host__ __device__ __forceinline__ void blk_local_atoms(const float* xs, int FP, int f,
                                                         const int* idx, int cnt, float* loc) {
  for (int i = 0; i < cnt; ++i)
    for (int c = 0; c < 3; ++c) loc[3 * i + c] = xs[(3 * idx[i] + c) * FP + f];
}

// kAligned must equal blk_aligned(m): a model without alignment gets a
// kernel without the QCP solve and its 9-tangent duals, which would
// otherwise set every phase's register count.
template <bool kForces, bool kAligned>
__host__ __device__ inline void blk_phase(const BlockedArgs& m, const BlockedIO& io, float* sm,
                                          long long block, int ph, int tid, int nt) {
  const int F = m.frames, FP = m.pitch, fmask = F - 1;
  int flog = 0;  // frames is a power of two: a mask and a shift split an index
  while ((1 << flog) < F) ++flog;
  const BlkSmem so = blk_smem(m, nt, kForces);
  float* xs = sm + so.xs;
  float* feat = sm + so.feat;
  float* hbuf = sm + so.h;
  float* st = sm + so.st;
  float* part = sm + so.part;
  const long long f0 = block * F;
  const long long left = io.l - f0;
  const int nf = left < (long long)F ? (int)left : F;
  const bool aligned = kAligned;
  const int nl = m.n_layers;
  const int loc4[4] = {0, 1, 2, 3};
  const int c_ang = 0, c_bond = m.n_angles, c_dih = c_bond + m.n_bonds,
            c_coord = c_dih + m.n_dihedrals, c_pos = c_coord + m.n_coord;
  const int dcols = m.use_angle_value ? 1 : 2;

  if (ph == BLK_PH_LOAD) {
    // the ragged last block repeats its last frame, so all math stays finite
    const int n3 = 3 * m.n_act;
    if (io.x_sf == 1) {  // frames minor: neighbouring threads, neighbouring frames
      for (int e = tid; e < n3 * F; e += nt) {
        const int f = e & fmask, jj = e >> flog;
        const int k = jj / 3, c = jj - 3 * k;
        const int a = m.active_idx ? m.active_idx[k] : k;
        const int ff = f < nf ? f : nf - 1;
        xs[jj * FP + f] = io.x[f0 + ff + (long long)a * io.x_sa + c * io.x_sc];
      }
    } else {             // frame major: a frame's row is contiguous
      // four frames' loads are issued before their stores, so that four
      // rows are in flight from device memory and not one
      for (int fb = 0; fb < F; fb += 4)
        for (int jj = tid; jj < n3; jj += nt) {
          const int k = jj / 3, c = jj - 3 * k;
          const int a = m.active_idx ? m.active_idx[k] : k;
          const long long col = (long long)a * io.x_sa + c * io.x_sc;
          float v[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int f = fb + u < F ? fb + u : F - 1;
            v[u] = io.x[(f0 + (f < nf ? f : nf - 1)) * io.x_sf + col];
          }
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (fb + u < F) xs[jj * FP + fb + u] = v[u];
        }
    }
    return;
  }

  if (ph == BLK_PH_FEAT) {
    const int n_items = c_coord + (aligned ? 0 : m.n_pos);
    for (int e = tid; e < n_items * F; e += nt) {
      const int f = e & fmask;
      int it = e >> flog;
      float loc[12];
      if (it < c_bond) {
        blk_local_atoms(xs, FP, f, m.angle_idx + 3 * it, 3, loc);
        feat[m.item_col[it] * FP + f] = angle_fwd(loc, loc4, m.use_angle_value);
      } else if (it < c_dih) {
        blk_local_atoms(xs, FP, f, m.bond_idx + 2 * (it - c_bond), 2, loc);
        feat[m.item_col[it] * FP + f] = bond_fwd(loc, loc4);
      } else if (it < c_coord) {
        blk_local_atoms(xs, FP, f, m.dihedral_idx + 4 * (it - c_dih), 4, loc);
        float out[2];
        const int cnt = dihedral_fwd(loc, loc4, m.use_angle_value, out);
        for (int c = 0; c < cnt; ++c) feat[(m.item_col[it] + c) * FP + f] = out[c];
      } else {  // position without alignment
        const int p = it - c_coord;
        const int col = m.item_col[c_pos + p];
        for (int c = 0; c < 3; ++c)
          feat[(col + c) * FP + f] = xs[(3 * m.pos_idx[p] + c) * FP + f];
      }
    }
    // partial switching sums: thread (q, f) takes pairs q, q + P, ... in
    // order, four at a time into four compensated sums, so that four pairs'
    // loads and arithmetic are in flight and not one
    const int P = nt >> flog, q = tid >> flog, fq = tid & fmask;
    for (int k = 0; k < m.n_coord; ++k) {
      const BlkCoord cp = blk_coord(m.coord_par + k * MOLANN_BLK_COORD_FLOATS);
      const int end = m.coord_start[k + 1];
      float acc[4] = {0.f, 0.f, 0.f, 0.f}, comp[4] = {0.f, 0.f, 0.f, 0.f};
      int p = m.coord_start[k] + q;
      for (; p + 3 * P < end; p += 4 * P) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int pp = p + u * P;
          const V3 d = blk_pair_vector(xs, FP, fq, m.pairs[2 * pp], m.pairs[2 * pp + 1], cp);
          float s, ds;
          blk_switch<false>(cp, dot3(d, d), s, ds);
          blk_kahan(s, acc[u], comp[u]);
        }
      }
      for (; p < end; p += P) {
        const V3 d = blk_pair_vector(xs, FP, fq, m.pairs[2 * p], m.pairs[2 * p + 1], cp);
        float s, ds;
        blk_switch<false>(cp, dot3(d, d), s, ds);
        blk_kahan(s, acc[0], comp[0]);
      }
      part[k * nt + tid] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
    }
    if (aligned)
      for (int e = tid; e < 3 * F; e += nt) {
        const int f = e & fmask, i = e >> flog;
        float s = 0.f;
        for (int n = 0; n < m.n_align; ++n) s += xs[(3 * m.align_idx[n] + i) * FP + f];
        st[(BLK_ST_C + i) * FP + f] = s / (float)m.n_align;
      }
    return;
  }

  if (ph == BLK_PH_REDUCE) {
    const int P = nt >> flog;
    for (int e = tid; e < m.n_coord * F; e += nt) {
      const int f = e & fmask, k = e >> flog;
      float acc = 0.f, comp = 0.f;
      for (int q = 0; q < P; ++q) blk_kahan(part[k * nt + q * F + f], acc, comp);
      feat[m.item_col[c_coord + k] * FP + f] = acc;
    }
    if (aligned)
      for (int e = tid; e < 9 * F; e += nt) {
        const int f = e & fmask, ij = e >> flog, i = ij / 3, j = ij - 3 * i;
        const float c = st[(BLK_ST_C + i) * FP + f];
        float acc = 0.f;
        for (int n = 0; n < m.n_align; ++n)
          acc += (xs[(3 * m.align_idx[n] + i) * FP + f] - c) * m.ref_x[3 * n + j];
        st[(BLK_ST_H + ij) * FP + f] = acc;
      }
    return;
  }

  if (ph == BLK_PH_QCP) {
    if (!aligned || tid >= F) return;
    const int f = tid;
    if (kForces) {  // the last QCP steps on duals give dR/dH
      Dual9 H[3][3], R[3][3];
      for (int k = 0; k < 9; ++k) {
        H[k / 3][k % 3] = Dual9(st[(BLK_ST_H + k) * FP + f]);
        H[k / 3][k % 3].d[k] = 1.0f;
      }
      qcp_rotation(H, R);
      for (int k = 0; k < 9; ++k) {
        st[(BLK_ST_R + k) * FP + f] = R[k / 3][k % 3].v;
        for (int q = 0; q < 9; ++q)
          st[(BLK_ST_DR + 9 * k + q) * FP + f] = R[k / 3][k % 3].d[q];
      }
    } else {
      float H[3][3], R[3][3];
      for (int k = 0; k < 9; ++k) H[k / 3][k % 3] = st[(BLK_ST_H + k) * FP + f];
      qcp_rotation(H, R);
      for (int k = 0; k < 9; ++k) st[(BLK_ST_R + k) * FP + f] = R[k / 3][k % 3];
    }
    return;
  }

  if (ph == BLK_PH_POS) {
    if (!aligned) return;
    for (int e = tid; e < m.n_pos * F; e += nt) {
      const int f = e & fmask, p = e >> flog;
      const int a = m.pos_idx[p], col = m.item_col[c_pos + p];
      float v[3];
      for (int j = 0; j < 3; ++j) v[j] = xs[(3 * a + j) * FP + f] - st[(BLK_ST_C + j) * FP + f];
      for (int i = 0; i < 3; ++i)
        feat[(col + i) * FP + f] = v[0] * st[(BLK_ST_R + i) * FP + f] +
                                   v[1] * st[(BLK_ST_R + 3 + i) * FP + f] +
                                   v[2] * st[(BLK_ST_R + 6 + i) * FP + f];
    }
    return;
  }

  if (ph < BLK_PH_MLP + nl) {  // layer L forward
    // thread (frame, output), outputs fastest: a warp reads one row of the
    // transposed weights as neighbouring addresses, and its frame's input
    // as a broadcast. Eight partial sums keep eight loads in flight.
    const int L = ph - BLK_PH_MLP;
    const int d_in = m.dims[L], d_o = m.dims[L + 1];
    const float* w = m.params;
    for (int i = 0; i < L; ++i) w += m.dims[i + 1] * (m.dims[i] + 1);
    const float* b = w + d_o * d_in;
    const float* in = L ? hbuf + blk_h_off(m, L - 1) : feat;
    float* out = hbuf + blk_h_off(m, L);
    for (int e = tid; e < d_o * F; e += nt) {
      const int j = e % d_o, f = e / d_o;
      const float* wj = w + j;
      const float* inf = in + f;
      float a[8] = {b[j], 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      int k = 0;
      for (; k + 7 < d_in; k += 8) {
#pragma unroll
        for (int u = 0; u < 8; ++u) a[u] += wj[(k + u) * d_o] * inf[(k + u) * FP];
      }
      for (; k < d_in; ++k) a[0] += wj[k * d_o] * inf[k * FP];
      const float acc = ((a[0] + a[1]) + (a[2] + a[3])) + ((a[4] + a[5]) + (a[6] + a[7]));
      out[j * FP + f] = (L == nl - 1) ? acc : act_fwd(m.activation, acc);
    }
    return;
  }

  if (ph == BLK_PH_MLP + nl) {  // OUT: write y; seed the output cotangent
    const int d_out = blk_out_dim(m);
    float* last = nl ? hbuf + blk_h_off(m, nl - 1) : feat;
    for (int e = tid; e < d_out * F; e += nt) {
      const int f = e & fmask, j = e >> flog;
      if (f < nf) io.y[(f0 + f) * io.y_sf + j * io.y_sj] = last[j * FP + f];
      if (kForces) last[j * FP + f] = (io.component < 0 || j == io.component) ? 1.0f : 0.0f;
    }
    return;
  }
  if (!kForces) return;

  const int pb = BLK_PH_MLP + nl + 1;
  if (ph < pb + nl) {  // layer L backward, in place over the layer's input
    const int L = nl - 1 - (ph - pb);
    const int d_in = m.dims[L], d_o = m.dims[L + 1];
    const float* w = m.weights;
    for (int i = 0; i < L; ++i) w += m.dims[i + 1] * m.dims[i];
    const float* g = hbuf + blk_h_off(m, L);
    float* in = L ? hbuf + blk_h_off(m, L - 1) : feat;
    for (int e = tid; e < d_in * F; e += nt) {
      const int f = e & fmask, k = e >> flog;
      float acc = 0.f;
      for (int j = 0; j < d_o; ++j) acc += w[j * d_in + k] * g[j * FP + f];
      in[k * FP + f] = L ? acc * act_grad(m.activation, in[k * FP + f]) : acc;
    }
    return;
  }

  if (ph == pb + nl) {  // GR[j][i] = sum_p v_p[j] * g_p[i]
    if (!aligned) return;
    for (int e = tid; e < 9 * F; e += nt) {
      const int f = e & fmask, ji = e >> flog, j = ji / 3, i = ji - 3 * j;
      const float c = st[(BLK_ST_C + j) * FP + f];
      float acc = 0.f;
      for (int p = 0; p < m.n_pos; ++p)
        acc += (xs[(3 * m.pos_idx[p] + j) * FP + f] - c) *
               feat[(m.item_col[c_pos + p] + i) * FP + f];
      st[(BLK_ST_GR + ji) * FP + f] = acc;
    }
    return;
  }

  if (ph == pb + nl + 1) {  // GH = GR : dR/dH
    if (!aligned) return;
    for (int e = tid; e < 9 * F; e += nt) {
      const int f = e & fmask, k = e >> flog;
      float acc = 0.f;
      for (int ij = 0; ij < 9; ++ij)
        acc += st[(BLK_ST_GR + ij) * FP + f] * st[(BLK_ST_DR + 9 * ij + k) * FP + f];
      st[(BLK_ST_GH + k) * FP + f] = acc;
    }
    return;
  }

  if (ph == pb + nl + 2) {  // GC: the cotangent of the centroid
    if (!aligned) return;
    for (int e = tid; e < 3 * F; e += nt) {
      const int f = e & fmask, j = e >> flog;
      float acc = 0.f;
      for (int p = 0; p < m.n_pos; ++p) {
        const int col = m.item_col[c_pos + p];
        for (int i = 0; i < 3; ++i)
          acc -= st[(BLK_ST_R + 3 * j + i) * FP + f] * feat[(col + i) * FP + f];
      }
      for (int n = 0; n < m.n_align; ++n)
        for (int q = 0; q < 3; ++q)
          acc -= st[(BLK_ST_GH + 3 * j + q) * FP + f] * m.ref_x[3 * n + q];
      st[(BLK_ST_GC + j) * FP + f] = acc;
    }
    return;
  }

  // GATHER: thread (output atom, frame) adds, in table order, the term of
  // every feature role and pair partner that touches its atom; nothing is
  // scattered, so the same inputs give the same bits. Frames run fastest
  // across threads whatever the gradient's layout: the table reads are then
  // warp-wide broadcasts, which on the card outweighs the frame-major
  // layouts' strided stores.
  for (int e = tid; e < m.n_out * F; e += nt) {
    const int f = e & fmask, o = e >> flog;
    const int k = m.out_map ? m.out_map[o] : o;
    float g[3] = {0.f, 0.f, 0.f};
    if (k >= 0) {
      for (int q = m.atom_ptr[k]; q < m.atom_ptr[k + 1]; ++q) {
        const int ent = m.atom_ent[q];
        const int kind = ent >> 28, role = (ent >> 26) & 3, it = ent & ((1 << 26) - 1);
        // the feature's whole adjoint, then this atom's share picked by
        // weights and not by an index, so that ga stays in registers
        float loc[12], ga[12];
        for (int c = 0; c < 12; ++c) ga[c] = 0.f;
        const float w0 = role == 0, w1 = role == 1, w2 = role == 2, w3 = role == 3;
        if (kind == BLK_ENT_ANGLE) {
          blk_local_atoms(xs, FP, f, m.angle_idx + 3 * it, 3, loc);
          angle_bwd(loc, loc4, m.use_angle_value, feat[m.item_col[c_ang + it] * FP + f], ga);
          for (int c = 0; c < 3; ++c) g[c] += w0 * ga[c] + w1 * ga[3 + c] + w2 * ga[6 + c];
        } else if (kind == BLK_ENT_BOND) {
          blk_local_atoms(xs, FP, f, m.bond_idx + 2 * it, 2, loc);
          bond_bwd(loc, loc4, feat[m.item_col[c_bond + it] * FP + f], ga);
          for (int c = 0; c < 3; ++c) g[c] += w0 * ga[c] + w1 * ga[3 + c];
        } else if (kind == BLK_ENT_DIHEDRAL) {
          blk_local_atoms(xs, FP, f, m.dihedral_idx + 4 * it, 4, loc);
          float gd[2];
          for (int c = 0; c < dcols; ++c) gd[c] = feat[(m.item_col[c_dih + it] + c) * FP + f];
          dihedral_bwd(loc, loc4, m.use_angle_value, gd, ga);
          for (int c = 0; c < 3; ++c)
            g[c] += w0 * ga[c] + w1 * ga[3 + c] + w2 * ga[6 + c] + w3 * ga[9 + c];
        } else if (kind == BLK_ENT_POS) {
          const int col = m.item_col[c_pos + it];
          for (int j = 0; j < 3; ++j) {
            if (aligned)
              g[j] += st[(BLK_ST_R + 3 * j) * FP + f] * feat[col * FP + f] +
                      st[(BLK_ST_R + 3 * j + 1) * FP + f] * feat[(col + 1) * FP + f] +
                      st[(BLK_ST_R + 3 * j + 2) * FP + f] * feat[(col + 2) * FP + f];
            else
              g[j] += feat[(col + j) * FP + f];
          }
        } else {  // BLK_ENT_ALIGN: through H, and the centroid's share
          for (int i = 0; i < 3; ++i)
            g[i] += st[(BLK_ST_GH + 3 * i) * FP + f] * m.ref_x[3 * it] +
                    st[(BLK_ST_GH + 3 * i + 1) * FP + f] * m.ref_x[3 * it + 1] +
                    st[(BLK_ST_GH + 3 * i + 2) * FP + f] * m.ref_x[3 * it + 2] +
                    st[(BLK_ST_GC + i) * FP + f] / (float)m.n_align;
        }
      }
      // pairs: d s(|x_j - x_k|)/d x_k = -s'(r)/r * d, the minimum-image
      // shift constant; each pair is recomputed from shared memory
      for (int cf = 0; cf < m.n_coord; ++cf) {
        const BlkCoord cp = blk_coord(m.coord_par + cf * MOLANN_BLK_COORD_FLOATS);
        const int* row = m.nbr_ptr + cf * (m.n_act + 1) + k;
        // two partners at a time into two sums, for the same reason
        float acc[2][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
        int q = row[0];
        for (; q + 1 < row[1]; q += 2) {
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const V3 d = blk_pair_vector(xs, FP, f, k, m.nbr[q + u], cp);
            float s, coef;
            blk_switch<true>(cp, dot3(d, d), s, coef);
            acc[u][0] -= coef * d.x; acc[u][1] -= coef * d.y; acc[u][2] -= coef * d.z;
          }
        }
        if (q < row[1]) {
          const V3 d = blk_pair_vector(xs, FP, f, k, m.nbr[q], cp);
          float s, coef;
          blk_switch<true>(cp, dot3(d, d), s, coef);
          acc[0][0] -= coef * d.x; acc[0][1] -= coef * d.y; acc[0][2] -= coef * d.z;
        }
        const float gc = feat[m.item_col[c_coord + cf] * FP + f];
        for (int c = 0; c < 3; ++c) g[c] += gc * (acc[0][c] + acc[1][c]);
      }
    }
    if (f < nf)
      for (int c = 0; c < 3; ++c)
        io.gx[(f0 + f) * io.g_sf + (long long)o * io.g_sa + c * io.g_sc] = g[c];
  }
}

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
#define MOLANN_BLK_THREADS 256

// Kinds of an atom's entries in the gather table (atom_ent):
// kind << 28 | role << 26 | item.
enum { BLK_ENT_ANGLE = 0, BLK_ENT_BOND = 1, BLK_ENT_DIHEDRAL = 2,
       BLK_ENT_POS = 3, BLK_ENT_ALIGN = 4 };

// Rows of the per-frame alignment state.
enum { BLK_ST_C = 0, BLK_ST_H = 3, BLK_ST_R = 12, BLK_ST_FWD_ROWS = 21,
       BLK_ST_GR = 21, BLK_ST_GH = 30, BLK_ST_GC = 39, BLK_ST_DR = 42,
       BLK_ST_ALL_ROWS = 123 };

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
  const float* coord_par;   // [n_coord * MOLANN_COORD_FLOATS]
  const float* ref_x;       // [n_align * 3]
  const float* params;      // per layer: W transposed, [d_in * d_out] row-major, then b [d_out]
  const float* weights;     // per layer: W [d_out * d_in] row-major, for the MLP backwards
};

// One call's tensors; strides in floats of frame, atom and component (x,
// gx) or frame and column (y, gy, y_target). The fields from gy on are read
// by the backward and train kernels only.
struct BlockedIO {
  const float* x;
  float* y;
  float* gx;       // null: the backward kernel skips the coordinate gradient
  long long l;
  long long x_sf, x_sa, x_sc;
  long long y_sf, y_sj;
  long long g_sf, g_sa, g_sc;
  int component;  // final output column to differentiate, < 0 = their sum
  int want_ref;   // also the ref_x gradient (needs alignment)
  const float* gy;        // the backward kernel's cotangent of y
  long long gy_sf, gy_sj;
  const float* y_target;  // the train kernel's labels
  long long t_sf, t_sj;
  float inv_count;        // 1 / (l * d_out), the train kernel's mean
  int acc_global;  // the block's sums live in its row of partials, not in shared memory
  float* partials;  // [blocks, 1 + G] per-block sums, then reduced by column
};

// Offsets in floats. acc: the block's running sums [loss | G], backward
// and train kernels only.
struct BlkSmem { int xs, feat, h, st, part, acc, total; };

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
  s.acc = o;
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

// One step of a compensated (Kahan) sum: a switching sum runs over
// thousands of pairs and its value into the hundreds, where a plain f32
// accumulator would lose the digits the standardised MLP input needs.
__host__ __device__ __forceinline__ void blk_kahan(float v, float& acc, float& comp) {
  const float y = v - comp;
  const float t = acc + y;
  comp = (t - acc) - y;
  acc = t;
}

// d = x[j] - x[i] of frame f, by minimum image when the feature has a box.
__host__ __device__ __forceinline__ V3 blk_pair_vector(const float* xs, int FP, int f, int i,
                                                       int j, const CoordPar& cp) {
  return min_image(xs[(3 * j) * FP + f] - xs[(3 * i) * FP + f],
                   xs[(3 * j + 1) * FP + f] - xs[(3 * i + 1) * FP + f],
                   xs[(3 * j + 2) * FP + f] - xs[(3 * i + 2) * FP + f], cp);
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
// `so` is the block's shared-memory layout; `block` the tile of frames.
template <bool kForces, bool kAligned>
__host__ __device__ inline void blk_phase_at(const BlockedArgs& m, const BlockedIO& io,
                                             float* sm, const BlkSmem& so, long long block,
                                             int ph, int tid, int nt) {
  const int F = m.frames, FP = m.pitch, fmask = F - 1;
  int flog = 0;  // frames is a power of two: a mask and a shift split an index
  while ((1 << flog) < F) ++flog;
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
      const CoordPar cp = coord_load(m.coord_par + k * MOLANN_COORD_FLOATS);
      const int end = m.coord_start[k + 1];
      float acc[4] = {0.f, 0.f, 0.f, 0.f}, comp[4] = {0.f, 0.f, 0.f, 0.f};
      int p = m.coord_start[k] + q;
      for (; p + 3 * P < end; p += 4 * P) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int pp = p + u * P;
          const V3 d = blk_pair_vector(xs, FP, fq, m.pairs[2 * pp], m.pairs[2 * pp + 1], cp);
          float s, ds;
          switch_eval<false>(cp, dot3(d, d), s, ds);
          blk_kahan(s, acc[u], comp[u]);
        }
      }
      for (; p < end; p += P) {
        const V3 d = blk_pair_vector(xs, FP, fq, m.pairs[2 * p], m.pairs[2 * p + 1], cp);
        float s, ds;
        switch_eval<false>(cp, dot3(d, d), s, ds);
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
        const CoordPar cp = coord_load(m.coord_par + cf * MOLANN_COORD_FLOATS);
        const int* row = m.nbr_ptr + cf * (m.n_act + 1) + k;
        // two partners at a time into two sums, for the same reason
        float acc[2][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
        int q = row[0];
        for (; q + 1 < row[1]; q += 2) {
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const V3 d = blk_pair_vector(xs, FP, f, k, m.nbr[q + u], cp);
            float s, coef;
            switch_eval<true>(cp, dot3(d, d), s, coef);
            acc[u][0] -= coef * d.x; acc[u][1] -= coef * d.y; acc[u][2] -= coef * d.z;
          }
        }
        if (q < row[1]) {
          const V3 d = blk_pair_vector(xs, FP, f, k, m.nbr[q], cp);
          float s, coef;
          switch_eval<true>(cp, dot3(d, d), s, coef);
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

// A phase of the forward (kForces = false) or cv+forces kernel on its own
// shared-memory layout.
template <bool kForces, bool kAligned>
__host__ __device__ inline void blk_phase(const BlockedArgs& m, const BlockedIO& io, float* sm,
                                          long long block, int ph, int tid, int nt) {
  blk_phase_at<kForces, kAligned>(m, io, sm, blk_smem(m, nt, kForces), block, ph, tid, nt);
}

// ---------------------------------------------------------------------------
// The backward and train kernels: the phases above with gy (or the MSE
// cotangent) as the seed, plus every frame's term of the parameter and ref_x
// gradients, summed over the block's tiles
// (molann_tpu/ops/fused_blocked.py, _blk_bwd_kernel :1192 and
// _blk_train_kernel :1285)
// ---------------------------------------------------------------------------

// Blocks of a backward or train launch: a fixed number, so that the order
// of the sum over frames depends on the frame count and the tile alone and
// never on the card. Block b takes tiles b, b + blocks, ... in order.
#define MOLANN_BLK_GRAD_BLOCKS 528

// Entries of the flat gradient vector [ref_x | W0 | b0 | W1 | b1 ...], W in
// [d_out, d_in] order; a row of partials is [loss | G].
__host__ __device__ __forceinline__ int blk_grad_size(const BlockedArgs& m) {
  int n = 3 * m.n_align;
  for (int L = 0; L < m.n_layers; ++L) n += m.dims[L + 1] * (m.dims[L] + 1);
  return n;
}

__host__ __device__ __forceinline__ long long blk_grad_blocks(const BlockedArgs& m, long long l) {
  const long long tiles = (l + m.frames - 1) / m.frames;
  return tiles < MOLANN_BLK_GRAD_BLOCKS ? tiles : MOLANN_BLK_GRAD_BLOCKS;
}

// The layout of the cv+forces kernel (the whole alignment state) and, unless
// the sums live in device memory, one row of running sums behind it.
__host__ __device__ inline BlkSmem blk_grad_smem(const BlockedArgs& m, int nt, bool acc_global) {
  BlkSmem s = blk_smem(m, nt, true);
  if (!acc_global) s.total += 1 + blk_grad_size(m);
  return s;
}

// Phases of one tile: LOAD, FEAT, REDUCE, QCP, POS, one per MLP layer, LOSS,
// SEED, then per layer from the last PGRAD and BWD, then GR, GH, GREF, GC,
// GATHER. A phase a call does not need returns at once.
__host__ __device__ __forceinline__ int blk_grad_n_phases(const BlockedArgs& m) {
  return 12 + 3 * m.n_layers;
}

// Zero the block's running sums; before its first tile.
__host__ __device__ inline void blk_grad_begin(const BlockedArgs& m, float* acc, int tid, int nt) {
  const int width = 1 + blk_grad_size(m);
  for (int e = tid; e < width; e += nt) acc[e] = 0.f;
}

// kTrain: the seed is the MSE cotangent 2 (y - y_target) inv_count on the
// true frames, the loss is summed, and there is no gx. Otherwise the seed is
// gy. Frames past the end get a zero seed, and with it zero terms. `acc`
// is the block's row of running sums; thread t owns entries t, t + nt, ...
// of every gradient, and adds a tile's term (summed over the tile's frames
// in order) to each: no atomics, the same bits on every launch.
template <bool kTrain, bool kAligned>
__host__ __device__ inline void blk_grad_phase(const BlockedArgs& m, const BlockedIO& io,
                                               float* sm, const BlkSmem& so, float* acc,
                                               long long tile, int ph, int tid, int nt) {
  const int F = m.frames, FP = m.pitch, fmask = F - 1;
  int flog = 0;
  while ((1 << flog) < F) ++flog;
  const int nl = m.n_layers;
  const bool want_gx = !kTrain && io.gx != nullptr;
  const bool want_ref = kAligned && io.want_ref != 0;
  const bool adjoint = want_gx || want_ref;  // anything below the MLP
  const long long f0 = tile * F;
  const long long left = io.l - f0;
  const int nf = left < (long long)F ? (int)left : F;
  float* feat = sm + so.feat;
  float* hbuf = sm + so.h;
  float* last = nl ? hbuf + blk_h_off(m, nl - 1) : feat;
  const int d_out = blk_out_dim(m);

  if (ph < BLK_PH_MLP + nl) {  // the forward, with dR/dH only where an adjoint needs it
    if (ph == BLK_PH_QCP && adjoint)
      blk_phase_at<true, kAligned>(m, io, sm, so, tile, ph, tid, nt);
    else
      blk_phase_at<false, kAligned>(m, io, sm, so, tile, ph, tid, nt);
    return;
  }
  int q = ph - (BLK_PH_MLP + nl);
  if (q == 0) {  // LOSS: one thread, frames then columns in order
    if (!kTrain || tid != 0) return;
    float e2 = 0.f;
    for (int f = 0; f < nf; ++f)
      for (int j = 0; j < d_out; ++j) {
        const float e = last[j * FP + f] - io.y_target[(f0 + f) * io.t_sf + j * io.t_sj];
        e2 += e * e;
      }
    acc[0] += e2 * io.inv_count;
    return;
  }
  if (q == 1) {  // SEED: the cotangent of the output, in place
    for (int e = tid; e < d_out * F; e += nt) {
      const int f = e & fmask, j = e >> flog;
      float g = 0.f;
      if (f < nf) {
        if (kTrain)
          g = 2.0f * (last[j * FP + f] - io.y_target[(f0 + f) * io.t_sf + j * io.t_sj]) *
              io.inv_count;
        else
          g = io.gy[(f0 + f) * io.gy_sf + j * io.gy_sj];
      }
      last[j * FP + f] = g;
    }
    return;
  }
  q -= 2;
  const int pb = BLK_PH_MLP + nl + 1;  // the cv+forces kernel's first backward phase
  if (q < 2 * nl) {
    const int L = nl - 1 - (q >> 1);
    if (q & 1) {  // BWD L: the cotangent of the layer's input, in place
      if (L > 0 || adjoint) blk_phase_at<true, kAligned>(m, io, sm, so, tile, pb + (q >> 1), tid, nt);
      return;
    }
    // PGRAD L: gW[j][k] += sum_f gz[j][f] a[k][f], gb[j] += sum_f gz[j][f],
    // before BWD L overwrites the layer's input a
    const int d_in = m.dims[L], d_o = m.dims[L + 1];
    int off = 1 + 3 * m.n_align;
    for (int i = 0; i < L; ++i) off += m.dims[i + 1] * (m.dims[i] + 1);
    const float* gz = hbuf + blk_h_off(m, L);
    const float* a = L ? hbuf + blk_h_off(m, L - 1) : feat;
    for (int e = tid; e < d_o * (d_in + 1); e += nt) {
      float s = 0.f;
      if (e < d_o * d_in) {
        const int j = e / d_in, k = e - j * d_in;
        for (int f = 0; f < F; ++f) s += gz[j * FP + f] * a[k * FP + f];
      } else {
        const int j = e - d_o * d_in;
        for (int f = 0; f < F; ++f) s += gz[j * FP + f];
      }
      acc[off + e] += s;
    }
    return;
  }
  q -= 2 * nl;
  if (!adjoint) return;
  if (q == 0 || q == 1) {  // GR, GH
    blk_phase_at<true, kAligned>(m, io, sm, so, tile, pb + nl + q, tid, nt);
    return;
  }
  if (q == 2) {  // GREF: g_ref[n][j] += sum_f sum_i gH[i][j] (x[a_n][i] - c_i)
    if (!want_ref) return;
    const float* xs = sm + so.xs;
    const float* st = sm + so.st;
    for (int e = tid; e < 3 * m.n_align; e += nt) {
      const int n = e / 3, j = e - 3 * n;
      const int a = m.align_idx[n];
      float s = 0.f;
      for (int f = 0; f < F; ++f)
        for (int i = 0; i < 3; ++i)
          s += st[(BLK_ST_GH + 3 * i + j) * FP + f] *
               (xs[(3 * a + i) * FP + f] - st[(BLK_ST_C + i) * FP + f]);
      acc[1 + e] += s;
    }
    return;
  }
  if (!want_gx) return;
  // GC, GATHER
  blk_phase_at<true, kAligned>(m, io, sm, so, tile, pb + nl + q - 1, tid, nt);
}

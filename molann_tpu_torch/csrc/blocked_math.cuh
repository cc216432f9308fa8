// Per-block math of the blocked fused kernels: every phase a thread block
// runs on its tile of frames, written as plain functions of (thread index,
// thread count) so that the same code runs in the CUDA kernels
// (fused_blocked.cu, fused_blocked_grads.cu), where the phases are separated
// by __syncthreads(), and, compiled with a host C++ compiler, in the CPU test
// that walks the threads of each phase in a loop
// (tests/test_torch_port_blocked_math.py).
//
// Port of WHAT molann_tpu/ops/fused_blocked.py computes per tile
// (_feats_from_segs :1030-1152, the coordination sums and pullbacks
// :813-885, _blk_cv_forces_kernel :1398-1471), not of how: a thread gathers
// x[a] through int32 index tables instead of multiplying by a 0/+-1 edge
// matrix, and the adjoints are written out by hand (frame_math.cuh holds the
// bond, angle, dihedral and QCP ones, reused here).
//
// The design, step by step (times in PERF.md, measured with
// probes/blocked_probe.py on an H100):
//   - staging. Frame-major rows that are 16-byte aligned are loaded 16 bytes
//     a thread, four loads in flight; other layouts element by element.
//   - pairs. Thread (atom, frame) keeps its atom in registers and walks the
//     atom's pair partners once, in a loop whose switching function and
//     minimum image were chosen outside it (blk_pair_form; the usual even
//     exponents need no square root), four partners a loop turn, each a
//     16-byte shared load of its coordinates; a feature over all pairs of a
//     run of staged atoms finds them by position on that circle with no
//     index read (the range form). Forward only, it walks the partners of
//     the pairs the atom OWNS (every pair has one owner, so a pair is
//     evaluated once) and sums s in groups of four, each group's plain sum
//     added compensated. Where a coordinate gradient is wanted it walks all
//     its partners, sums s over the owned ones in the same runs (the same
//     bits), the others to a gradient's precision only, and accumulates
//     D_k[a] = sum_partners -s'(r)/r d, which does not depend on the
//     feature's cotangent: the gather multiplies it by that cotangent after
//     the MLP has run backwards, and no pair is looked at again. D_k lives in
//     shared memory (3 n_coord n_act rows): the rounds a thread makes over
//     (atom, frame) vary with the model and the tile, so a register array
//     would need a compile-time bound, and at 8 frames a block the 125-atom
//     contact model's 27 KB still leave four blocks on an SM.
//   - bonds, angles and dihedrals, forwards and backwards, with their square
//     roots and divisions on the special-function units and a Newton step.
//     Backwards, thread (feature, frame) computes the adjoint once and adds
//     each atom's share into per-atom accumulators in shared memory. The
//     host puts the features into batches in which no two features share an
//     atom, by kind within a batch (BlockedLayout.feature_batches); a
//     barrier separates the batches, so the order of the additions is the
//     table's and the same inputs give the same bits. No float atomics.
//   - MLP layers with at least 64 inputs run register-tiled in f32: forward,
//     a thread owns 4 outputs x 2 frames and a slice of the inputs (one
//     16-byte load of weights and two shared loads per 8 multiply-adds), the
//     slices' partial sums meet in a scratch region in slice order;
//     backwards, 4 inputs x 2 frames over the transposed weights. Smaller
//     layers keep one thread per (frame, output).
//   - alignment: QCP on floats, its adjoint by the reverse pass
//     (qcp_rotation_vjp, frame_math.cuh) from the forward's Newton result.
//   - the gather: thread (atom, frame) adds its accumulators, the position
//     and alignment terms of its row of atom_ent and cotangent x D_k, and
//     stores the gradient in the output's layout.
// Every step is bound by the latency of shared and cached loads, not by
// arithmetic, so what the launchers hold on to is 32 warps an SM: four blocks
// of 256 threads, or two of 512 where shared memory allows two blocks only.
//
// Shared memory of a block: first the list of a tile's steps (its count,
// then the steps, then the layout below; blk_steps_words(m) words, sized
// by the head's depth);
// with coordination features the pair walk's partner rows xq, one 16-byte
// word per (staged atom, frame) (see blk_pair_eval); then rows of `pitch`
// floats (one float per frame of the tile, pitch odd so that both row-wise
// and frame-wise walks are bank-conflict free):
//   xs    [3 * n_act]  coordinates of the staged (active) atoms, row 3k+c
//                      (none for a model of coordination features alone)
//   feat  [n_feat]     feature columns in final order; overwritten in place
//                      by their cotangents where a gradient is formed
//   h     [sum dims]   output of every MLP layer; overwritten in place by
//                      the layer cotangents
//   z     [sum dims]   the layers' pre-activations (only where the MLP runs
//                      backwards through gelu or swish, act_needs_z)
//   st    [21 | 123]   per-frame alignment state (only with alignment)
//   spart [n_coord * n_act]      per-atom partial switching sums
//   dk    [3 * n_coord * n_act]  D_k[a] (only where gx is formed)
//   gacc  [3 * n_act]  per-atom accumulators of the feature adjoints (only
//                      where gx is formed and the model has such features)
//   scr   the tiled layers' partial sums, [slices, d_out, frames]
#pragma once

#include "frame_math.cuh"

// Threads of a block: 256 with four blocks on an SM where the block's shared
// memory lets them, and 512 with two where it does not (or where a layer's
// weight gradient fits 512 threads' registers): either way 32 warps an SM
// at 64 registers a thread. The steps are bound by the latency of shared
// and cached loads, and two blocks of 256 threads left them twice as slow.
// The kernels with alignment (128 registers and more) stay at 256.
#define MOLANN_BLK_THREADS 256
#define MOLANN_BLK_THREADS_WIDE 512
// Shared memory of a block that lets four blocks share an SM: a quarter of
// an SM's, less the kilobyte each block reserves.
#define MOLANN_BLK_SMEM_QUARTER (56 * 1024)
// An MLP layer runs register-tiled from this many inputs on.
#define MOLANN_BLK_TILED_MIN_IN 64
// The rectangle of a large layer's weight gradient that a thread of the
// backward and train kernels forms in registers from a tile's frames.
#define MOLANN_BLK_RSUM_J 4
#define MOLANN_BLK_RSUM_K 6

// Kinds of an entry of the feature batches (batch_ent) and of an atom's row
// of the gather table (atom_ent, which holds only the last two):
// kind << 28 | item.
enum { BLK_ENT_ANGLE = 0, BLK_ENT_BOND = 1, BLK_ENT_DIHEDRAL = 2,
       BLK_ENT_POS = 3, BLK_ENT_ALIGN = 4 };

// Rows of the per-frame alignment state: the centroid, H and R; where an
// adjoint is formed also gR, gH, the centroid's cotangent and the result of
// QCP's 12 Newton steps, which the reverse pass (qcp_rotation_vjp) takes.
enum { BLK_ST_C = 0, BLK_ST_H = 3, BLK_ST_R = 12, BLK_ST_FWD_ROWS = 21,
       BLK_ST_GR = 21, BLK_ST_GH = 30, BLK_ST_GC = 39, BLK_ST_LAM = 42,
       BLK_ST_ALL_ROWS = 43 };

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
  int n_layers;     // any number: the head's widths are a table
  int activation;   // MOLANN_ACT_*
  int frames;       // frames per block, a power of two
  int pitch;        // floats per shared-memory row (frames | 1)
  int n_batches;    // batches of bonds, angles and dihedrals
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
  const int* atom_ent;      // every position and alignment entry of the atom
  const int* coord_range;   // [n_coord * 2] per coordination feature (s0, n):
                            // its pairs are all pairs of the staged atoms
                            // s0..s0+n-1 (the range form), else (0, 0)
  const int* batch_ptr;     // [n_batches + 1] rows of batch_ent
  const int* batch_ent;     // bonds, angles and dihedrals by batch; no two
                            // features of a batch share an atom
  const int* head;          // [n_layers * 8] per layer d_in, d_out, w_off (its
                            // weights' offset in params), h_row (its output's
                            // first row of h), g_off (its weight gradient's
                            // offset in [loss | G]), 0, 0, 0; on the device
  const int* head_host;     // the same table in host memory, for the host's
                            // sizing of a launch (shared memory, threads)
  const int* nbr_ptr;       // [n_coord * (n_act + 1)] rows of nbr
  const int* nbr_mid;       // [n_coord * n_act] end of the partners the atom owns
  const int* nbr;           // [n_pairs * 2] pair partners of each atom, the
                            // owned pairs' first
  const float* coord_par;   // [n_coord * MOLANN_COORD_FLOATS]
  const float* ref_x;       // [n_align * 3]
  const float* params;      // per layer: W transposed, [d_in * d_out] row-major, then
                            // b [d_out], each padded to a multiple of 4 floats and
                            // the whole 16-byte aligned
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
  int acc_global;  // where the block's running sums live: BLK_SUMS_*
  float* partials;  // [blocks, 1 + G] per-block sums, then reduced by column
};

// Offsets in floats. acc: the block's running sums, backward and train
// kernels only.
// z: -1 where the kernel keeps no pre-activations.
struct BlkSmem { int xq, xs, feat, h, z, st, spart, dk, gacc, scr, acc, total; };

// Layer L of the head, from the table the host builds once per head (the
// device's copy in a kernel, one 16-byte load and one more): a step reads
// its layer's widths and offsets with no loop over the layers before it.
// With the offsets summed over the layers in every step, the peptide-like
// model's kernels ran 3-13% slower than with the widths written in.
struct BlkLayer { int d_in, d_o, w_off, h_row, g_off; };

__host__ __device__ __forceinline__ BlkLayer blk_layer(const BlockedArgs& m, int L) {
#ifdef __CUDA_ARCH__
  const int4 a = *reinterpret_cast<const int4*>(m.head + 8 * L);
  return BlkLayer{a.x, a.y, a.z, a.w, m.head[8 * L + 4]};
#else
  const int* t = m.head_host + 8 * L;
  return BlkLayer{t[0], t[1], t[2], t[3], t[4]};
#endif
}

// Width i of the head: n_feat, then each layer's output.
__host__ __device__ __forceinline__ int blk_dim(const BlockedArgs& m, int i) {
  return i == 0 ? m.n_feat : blk_layer(m, i - 1).d_o;
}

__host__ __device__ __forceinline__ bool blk_aligned(const BlockedArgs& m) {
  return m.n_align > 0;
}

__host__ __device__ __forceinline__ int blk_pad4(int n) { return (n + 3) & ~3; }

// Whether a step other than the pair walk reads the coordinate rows xs: a
// model of coordination features alone stages its atoms only as the walk's
// partner rows.
__host__ __device__ __forceinline__ bool blk_needs_rows(const BlockedArgs& m) {
  return m.n_coord == 0 || m.n_angles + m.n_bonds + m.n_dihedrals + m.n_pos + m.n_align > 0;
}

// Whether the model has features whose adjoints go through the batches.
__host__ __device__ __forceinline__ bool blk_has_scatter(const BlockedArgs& m) {
  return m.n_angles + m.n_bonds + m.n_dihedrals > 0;
}

// The steps of a tile. A kernel runs the steps of its mode in order with a
// barrier after each: forward LOAD FEAT REDUCE [QCP POS] {MLP MLP_SUM}/layer
// OUT; cv+forces goes on with BWD/layer from the last, [GR GH GC], SCATTER
// (once per batch), GATHER; the backward and train kernels run the forward
// without OUT, then SEED {PGRAD BWD}/layer from the last (the train kernel's
// loss rides in its first PGRAD), [GR GH GREF GC], SCATTER, GATHER. The
// steps in brackets exist with alignment only, and a step with nothing to
// do for the model or the call is left out (REDUCE without pairs or
// alignment, MLP_SUM of a layer that is not cut in slices, everything below
// the MLP when no adjoint is wanted): an empty step still cost its barrier, 0.02-0.06 ms a
// batch each. Thread 0 builds the list once, into the first
// blk_steps_words(m) words of the block's shared memory: the count, then
// the steps.
enum { BLK_LOAD = 0, BLK_FEAT, BLK_REDUCE, BLK_QCP, BLK_POS, BLK_MLP, BLK_MLP_SUM, BLK_OUT,
       BLK_SEED, BLK_PGRAD, BLK_BWD, BLK_GR, BLK_GH, BLK_GREF, BLK_GC,
       BLK_SCATTER, BLK_GATHER };
enum { BLK_MODE_FORWARD = 0, BLK_MODE_FORCES = 1, BLK_MODE_BACKWARD = 2, BLK_MODE_TRAIN = 3 };
struct BlkStep { int kind, arg; };  // arg: the layer or the batch

__host__ __device__ __forceinline__ BlkStep blk_step_of(int word) {
  return BlkStep{word & 255, word >> 8};
}

// How a layer d_in -> d_o runs forward on F frames with nt threads: tiles of
// 4 outputs x ft frames, the inputs cut into `slices` interleaved slices
// whose partial sums meet in the scratch region (slices == 1: none needed).
struct BlkTiling { bool tiled; int ft, n_jt, n_tiles, slices; };

__host__ __device__ inline BlkTiling blk_tiling(int d_in, int d_o, int F, int nt) {
  BlkTiling t;
  t.tiled = d_in >= MOLANN_BLK_TILED_MIN_IN;
  t.ft = F >= 2 ? 2 : 1;
  t.n_jt = (d_o + 3) / 4;
  t.n_tiles = t.n_jt * (F / t.ft);
  t.slices = nt / t.n_tiles;
  if (t.slices > d_in / 8) t.slices = d_in / 8;
  if (t.slices < 1) t.slices = 1;
  return t;
}

// The most steps a tile of any mode can have: 13 and four a layer.
__host__ __device__ __forceinline__ int blk_max_steps(const BlockedArgs& m) {
  return 13 + 4 * m.n_layers;
}

// How many times a step of the list runs, once per batch for SCATTER, its
// batch as its argument.
__host__ __device__ __forceinline__ int blk_step_reps(const BlockedArgs& m, int kind) {
  return kind == BLK_SCATTER ? m.n_batches : 1;
}

// Words of the list's place at the start of shared memory: its count, the
// steps and the block's layout (BlkSmem, which the kernels keep there and
// read as the steps need it: held in registers across the steps, its
// fields were spilled in every kernel of 64 registers), a multiple of four
// so that the rows behind it stay 16-byte aligned.
#define MOLANN_BLK_SMEM_WORDS ((int)(sizeof(BlkSmem) / sizeof(int)))
__host__ __device__ __forceinline__ int blk_steps_words(const BlockedArgs& m) {
  return (1 + blk_max_steps(m) + MOLANN_BLK_SMEM_WORDS + 3) & ~3;
}

// The block's layout in its place behind the list of steps.
__host__ __device__ __forceinline__ BlkSmem* blk_layout_slot(float* sm, const BlockedArgs& m) {
  return reinterpret_cast<BlkSmem*>(sm + 1 + blk_max_steps(m));
}

// The list of a tile's steps, kind | arg << 8 each (blk_max_steps at most);
// returns their number. `adjoint`: the backward or train call wants something
// below the MLP (gx or the ref_x gradient); `gx`: it wants gx.
__host__ __device__ inline int blk_build_steps(const BlockedArgs& m, int mode, bool adjoint,
                                               bool gx, int nt, int* out) {
  const bool al = blk_aligned(m);
  const int nl = m.n_layers;
  int n = 0;
  out[n++] = BLK_LOAD;
  out[n++] = BLK_FEAT;
  if (m.n_coord > 0 || al) out[n++] = BLK_REDUCE;
  if (al) { out[n++] = BLK_QCP; out[n++] = BLK_POS; }
  for (int L = 0; L < nl; ++L) {
    out[n++] = BLK_MLP | L << 8;
    const BlkTiling t = blk_tiling(blk_dim(m, L), blk_dim(m, L + 1), m.frames, nt);
    if (t.tiled && t.slices > 1) out[n++] = BLK_MLP_SUM | L << 8;
  }
  if (mode == BLK_MODE_FORWARD || mode == BLK_MODE_FORCES) {
    out[n++] = BLK_OUT;
    if (mode == BLK_MODE_FORWARD) return n;
    for (int L = nl - 1; L >= 0; --L) out[n++] = BLK_BWD | L << 8;
  } else {
    out[n++] = BLK_SEED;
    for (int L = nl - 1; L >= 0; --L) {
      out[n++] = BLK_PGRAD | L << 8;
      if (L > 0 || adjoint) out[n++] = BLK_BWD | L << 8;
    }
    if (!adjoint) return n;
  }
  if (al) {
    out[n++] = BLK_GR;
    out[n++] = BLK_GH;
    if (mode != BLK_MODE_FORCES) out[n++] = BLK_GREF;
  }
  if (!gx) return n;
  if (al) out[n++] = BLK_GC;
  if (m.n_batches > 0) out[n++] = BLK_SCATTER;
  out[n++] = BLK_GATHER;
  return n;
}

// fstate: room for the whole alignment state (the cotangents, QCP's Newton result)
// and for the pre-activations a backward through gelu or swish reads; gx:
// room for D_k and the per-atom accumulators.
__host__ __device__ inline BlkSmem blk_smem_at(const BlockedArgs& m, int nt, bool fstate,
                                               bool gx) {
  BlkSmem s;
  int o = blk_steps_words(m);  // the list of steps comes first
  s.xq = o;  // 16-byte aligned: the list's words are a multiple of four
  if (m.n_coord > 0) o += 4 * m.n_act * m.frames;
  s.xs = o;
  if (blk_needs_rows(m)) o += 3 * m.n_act * m.pitch;
  s.feat = o; o += m.n_feat * m.pitch;
  s.h = o;
  int hrows = 0;
  for (int L = 0; L < m.n_layers; ++L) hrows += blk_dim(m, L + 1);
  o += hrows * m.pitch;
  s.z = -1;
  if (fstate && act_needs_z(m.activation)) { s.z = o; o += hrows * m.pitch; }
  s.st = o;
  if (blk_aligned(m)) o += (fstate ? BLK_ST_ALL_ROWS : BLK_ST_FWD_ROWS) * m.pitch;
  s.spart = o; o += m.n_coord * m.n_act * m.pitch;
  s.dk = o;
  if (gx) o += 3 * m.n_coord * m.n_act * m.pitch;
  s.gacc = o;
  if (gx && blk_has_scatter(m)) o += 3 * m.n_act * m.pitch;
  s.scr = o;
  int scr = 0;
  for (int L = 0; L < m.n_layers; ++L) {
    const BlkTiling t = blk_tiling(blk_dim(m, L), blk_dim(m, L + 1), m.frames, nt);
    if (t.tiled && t.slices > 1 && t.slices * blk_dim(m, L + 1) * m.frames > scr)
      scr = t.slices * blk_dim(m, L + 1) * m.frames;
  }
  o += scr;
  s.acc = o;
  s.total = o;
  return s;
}

// The layout of the forward (forces = false) or cv+forces kernel.
__host__ __device__ inline BlkSmem blk_smem(const BlockedArgs& m, int nt, bool forces) {
  return blk_smem_at(m, nt, forces, forces);
}

// Offset of layer L's output inside the h region.
__host__ __device__ __forceinline__ int blk_h_off(const BlockedArgs& m, int L) {
  return blk_layer(m, L).h_row * m.pitch;
}

// Layer L's transposed weights inside params; its bias follows them.
__host__ __device__ __forceinline__ const float* blk_layer_w(const BlockedArgs& m, int L) {
  return m.params + blk_layer(m, L).w_off;
}

__host__ __device__ __forceinline__ int blk_out_dim(const BlockedArgs& m) {
  return m.n_layers ? blk_dim(m, m.n_layers) : m.n_feat;
}

// One step of a compensated (Kahan) sum: a switching sum runs over
// thousands of pairs and its value into the hundreds, where a plain f32
// accumulator would lose the digits the standardised MLP input needs. Both
// levels keep it, the atom's partial over its partners and the sum of the
// partials: with plain partials the error of a 7,750-pair sum read up to
// 5e-5, the whole tolerance.
__host__ __device__ __forceinline__ void blk_kahan(float v, float& acc, float& comp) {
  const float y = v - comp;
  const float t = acc + y;
  comp = (t - acc) - y;
  acc = t;
}

// ---------------------------------------------------------------------------
// The pair walk
// ---------------------------------------------------------------------------

// The instance of the pair loop for a feature: 0 the generic body (any
// exponents, any box), else 1 + 2 i + has_box for mm == 2 nn with nn = 4, 6,
// 8 (i = 0, 1, 2) and no box or an orthorhombic one: those take the form of
// the switching function that needs no square root (switch_eval_even).
// d_max stays a flag the loop reads: its test on the squared distance is
// there either way.
__host__ __device__ __forceinline__ int blk_pair_form(const CoordPar& cp) {
  if (cp.mm != 2 * cp.nn || (cp.has_box && !cp.ortho)) return 0;
  const int i = cp.nn == 4 ? 0 : cp.nn == 6 ? 1 : cp.nn == 8 ? 2 : -1;
  if (i < 0) return 0;
  return 1 + 2 * i + (cp.has_box ? 1 : 0);
}

// The partner rows of the walk: per staged atom and frame one 16-byte word
// (x, y, z, and a fourth float nobody reads), atom a of frame f at
// xq[a * frames + f]. A warp's partner load is one 16-byte shared load, 32
// neighbouring words (or two runs of 16): no bank conflicts.
#ifndef __CUDACC__
struct float4 { float x, y, z, w; };
#endif

// One partner pj of atom (xa, ya, za): s and, with kGrad, coef = s'(r)/r and
// the displacement d (kRough: coef alone, see switch_eval_even).
template <bool kGrad, int kNN, int kBox, bool kRough = false>
__host__ __device__ __forceinline__ void blk_pair_eval(const CoordPar& cp, const SwitchEven& ev,
                                                       const float4 pj, float xa, float ya,
                                                       float za, float& s, float& coef, V3& d) {
  d = min_image_as<kBox>(pj.x - xa, pj.y - ya, pj.z - za, cp);
  if (kNN > 0)
    switch_eval_even<kGrad, (kNN > 0 ? kNN : 4), kRough>(cp, ev, dot3(d, d), s, coef);
  else switch_eval<kGrad>(cp, dot3(d, d), s, coef);
}

// Where a run of partners is found: the range form steps a pointer through
// neighbouring rows (partners s0 + k of a feature over all pairs of the
// staged atoms s0..s0+n-1), the table form reads each partner's index from
// the pair operand.
struct BlkRangeCursor {
  const float4* p;
  int F;
  __host__ __device__ __forceinline__ float4 next() {
    const float4 v = *p;
    p += F;
    return v;
  }
};
struct BlkTableCursor {
  const float4* xq;
  const int* nbr;
  int F, f;
  __host__ __device__ __forceinline__ float4 next() { return xq[*nbr++ * F + f]; }
};

// cnt partners from `cur`, four at a time so that four pairs' loads are in
// flight and the loop's branch is paid once. kSum: their s in groups of
// four, a plain sum of the group and then one compensated add of it (the
// last group may be shorter); kGrad: D -= s'(r)/r d of each, to a
// gradient's precision where the run sums no s (kRough). The grouping
// depends on the run alone, so two walks that run the same partners in the
// same runs give the same sum to the last bit.
template <bool kGrad, bool kSum, int kNN, int kBox, class Cursor>
__host__ __device__ __forceinline__ void blk_pair_run(const CoordPar& cp, const SwitchEven& ev,
                                                      Cursor cur, int cnt, float xa, float ya,
                                                      float za, float& acc, float& comp,
                                                      float* D) {
  int k = 0;
  for (; k + 4 <= cnt; k += 4) {
    float s[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float coef;
      V3 d;
      blk_pair_eval<kGrad, kNN, kBox, kGrad && !kSum>(cp, ev, cur.next(), xa, ya, za, s[u],
                                                        coef, d);
      if (kGrad) { D[0] -= coef * d.x; D[1] -= coef * d.y; D[2] -= coef * d.z; }
    }
    if (kSum) blk_kahan((s[0] + s[1]) + (s[2] + s[3]), acc, comp);
  }
  if (k < cnt) {
    float g = 0.f;
    for (; k < cnt; ++k) {
      float s, coef;
      V3 d;
      blk_pair_eval<kGrad, kNN, kBox, kGrad && !kSum>(cp, ev, cur.next(), xa, ya, za, s,
                                                      coef, d);
      g += s;
      if (kGrad) { D[0] -= coef * d.x; D[1] -= coef * d.y; D[2] -= coef * d.z; }
    }
    if (kSum) blk_kahan(g, acc, comp);
  }
}

// The pairs a feature over all pairs of the staged atoms s0..s0+n-1 gives
// atom s0 + pos to own in the range form: the next h on the circle, h =
// (n - 1) / 2, and for even n the one opposite too when pos < n / 2. Every
// pair has one owner.
__host__ __device__ __forceinline__ int blk_range_owned(int pos, int n) {
  return (n - 1) / 2 + ((n % 2 == 0 && pos < n / 2) ? 1 : 0);
}

// Partners pos + 1 + first .. pos + first + cnt of the circle of n rows
// from `base` (frame f's row of atom s0), as at most two runs of
// neighbouring rows.
template <bool kGrad, bool kSum, int kNN, int kBox>
__host__ __device__ __forceinline__ void blk_range_runs(const CoordPar& cp, const SwitchEven& ev,
                                                        const float4* base, int F, int n,
                                                        int start, int cnt, float xa, float ya,
                                                        float za, float& acc, float& comp,
                                                        float* D) {
  if (start >= n) start -= n;
  const int first = cnt < n - start ? cnt : n - start;
  blk_pair_run<kGrad, kSum, kNN, kBox>(cp, ev, BlkRangeCursor{base + start * F, F}, first, xa,
                                       ya, za, acc, comp, D);
  if (cnt > first)
    blk_pair_run<kGrad, kSum, kNN, kBox>(cp, ev, BlkRangeCursor{base, F}, cnt - first, xa, ya,
                                         za, acc, comp, D);
}

// Atom a of frame f against its partners: s summed over the pairs it owns
// (compensated, in groups of four) and, with kGrad, D[c] = -sum s'(r)/r d_c
// over all its partners, the owned ones first with s. Forward only each
// pair is evaluated once, from its owner; with kGrad from both its atoms.
// kRange: the partners of a feature over all pairs of the staged atoms
// rs..rs+rn-1, found by position on that circle with no index read; else
// the partners nbr[q0..q1) of the pair operand, owned before `mid`. Both
// kernels run the owned partners in the same runs, so the forward's and the
// cv+forces kernel's sums agree to the last bit.
template <bool kGrad, int kNN, int kBox, bool kRange>
__host__ __device__ __forceinline__ void blk_pair_walk(const CoordPar& cp, const float4* xq,
                                                       int F, int f, int a, const int* nbr,
                                                       int q0, int mid, int q1, int rs, int rn,
                                                       float& s_sum, float* D) {
  const float4 own = xq[a * F + f];
  const SwitchEven ev = switch_even_r02(cp);
  float acc = 0.f, comp = 0.f;
  D[0] = 0.f; D[1] = 0.f; D[2] = 0.f;
  if (kRange) {
    const int pos = a - rs, h = blk_range_owned(pos, rn);
    const float4* base = xq + rs * F + f;
    blk_range_runs<kGrad, true, kNN, kBox>(cp, ev, base, F, rn, pos + 1, h, own.x, own.y, own.z,
                                           acc, comp, D);
    if (kGrad)
      blk_range_runs<true, false, kNN, kBox>(cp, ev, base, F, rn, pos + 1 + h, rn - 1 - h,
                                             own.x, own.y, own.z, acc, comp, D);
  } else {
    blk_pair_run<kGrad, true, kNN, kBox>(cp, ev, BlkTableCursor{xq, nbr + q0, F, f}, mid - q0,
                                         own.x, own.y, own.z, acc, comp, D);
    if (kGrad)
      blk_pair_run<true, false, kNN, kBox>(cp, ev, BlkTableCursor{xq, nbr + mid, F, f},
                                           q1 - mid, own.x, own.y, own.z, acc, comp, D);
  }
  s_sum = acc;
}

#define BLK_WALK_ARGS cp, xq, F, f, a, nbr, q0, mid, q1, rs, rn, s_sum, D
#define BLK_WALK_CASES(I, NN)                                                          \
  case 1 + 2 * I:                                                                      \
    if (range) blk_pair_walk<kGrad, NN, 0, true>(BLK_WALK_ARGS);                       \
    else blk_pair_walk<kGrad, NN, 0, false>(BLK_WALK_ARGS);                            \
    break;                                                                             \
  case 2 + 2 * I:                                                                      \
    if (range) blk_pair_walk<kGrad, NN, 1, true>(BLK_WALK_ARGS);                       \
    else blk_pair_walk<kGrad, NN, 1, false>(BLK_WALK_ARGS);                            \
    break;

// The walk in the instance `form` names (blk_pair_form), in the range form
// where `range` says so (even forms only; the generic body reads the
// table). Inlined: as a function of its own on the card (__noinline__) the
// cv+forces kernel of the 125-atom contact model took 6.24 ms against 5.01.
template <bool kGrad>
__host__ __device__ __forceinline__ void blk_pair_walk_as(int form, bool range, const CoordPar& cp,
                                                          const float4* xq, int F, int f, int a,
                                                          const int* nbr, int q0, int mid,
                                                          int q1, int rs, int rn, float& s_sum,
                                                          float* D) {
  switch (form) {
    BLK_WALK_CASES(0, 4)
    BLK_WALK_CASES(1, 6)
    BLK_WALK_CASES(2, 8)
    default: blk_pair_walk<kGrad, 0, -1, false>(BLK_WALK_ARGS);
  }
}

// ---------------------------------------------------------------------------
// Steps
// ---------------------------------------------------------------------------

// The atoms idx[0..cnt) of frame f, packed [cnt, 3] for frame_math.cuh.
__host__ __device__ __forceinline__ void blk_local_atoms(const float* xs, int FP, int f,
                                                         const int* idx, int cnt, float* loc) {
#pragma unroll
  for (int i = 0; i < cnt; ++i)
#pragma unroll
    for (int c = 0; c < 3; ++c) loc[3 * i + c] = xs[(3 * idx[i] + c) * FP + f];
}

// Coordinate jj = 3 k + c of staged atom k in frame f, into the rows (where
// a step reads them) and into the partner rows (where the model has pairs).
__host__ __device__ __forceinline__ void blk_stage(float* xs, float* xq, bool rows, int FP, int F,
                                                   int jj, int f, float v) {
  if (rows) xs[jj * FP + f] = v;
  if (xq) {
    const int k = jj / 3;
    xq[4 * (k * F + f) + jj - 3 * k] = v;
  }
}

// Four weights of consecutive outputs: one 16-byte load where the row is
// aligned (d_o a multiple of 4, the wrapper aligns params), else element by
// element with the outputs past the end read as the last.
__host__ __device__ __forceinline__ void blk_load4(const float* row, int j0, int d_o,
                                                   bool vec, float* v) {
#ifdef __CUDA_ARCH__
  if (vec) {
    const float4 t = *reinterpret_cast<const float4*>(row + j0);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
    return;
  }
#endif
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = row[j0 + i < d_o ? j0 + i : d_o - 1];
}

// kAligned must equal blk_aligned(m): a model without alignment gets a
// kernel without the QCP solve and its reverse pass, which would otherwise
// set every phase's register count. kPairs: a model without alignment that
// has coordination features gets a kernel of its own with the pair walk;
// the walk's registers (four pairs in flight) made every step of the other
// models' kernels spill. A model with alignment takes the walk's generic
// body in its own kernel either way. kForces: the step as the cv+forces
// kernel runs it (QCP's Newton result kept, D_k in FEAT, the accumulators
// zeroed in LOAD). `so` is the block's shared-memory layout; `block` the
// tile of frames.
template <bool kForces, bool kAligned, bool kPairs>
__host__ __device__ __forceinline__ void blk_phase_at(const BlockedArgs& m, const BlockedIO& io,
                                             float* sm, const BlkSmem& so, long long block,
                                             BlkStep step, int tid, int nt) {
  const int F = m.frames, FP = m.pitch, fmask = F - 1;
  int flog = 0;  // frames is a power of two: a mask and a shift split an index
  while ((1 << flog) < F) ++flog;
  float* xs = sm + so.xs;
  float* feat = sm + so.feat;
  float* hbuf = sm + so.h;
  float* st = sm + so.st;
  float* spart = sm + so.spart;
  float* dk = sm + so.dk;
  float* gacc = sm + so.gacc;
  float* scr = sm + so.scr;
  const long long f0 = block * F;
  const long long left = io.l - f0;
  const int nf = left < (long long)F ? (int)left : F;
  const bool aligned = kAligned;
  const int nl = m.n_layers;
  const int loc4[4] = {0, 1, 2, 3};
  const int c_bond = m.n_angles, c_dih = c_bond + m.n_bonds,
            c_coord = c_dih + m.n_dihedrals, c_pos = c_coord + m.n_coord;
  const int dcols = m.use_angle_value ? 1 : 2;
  const int ph = step.kind;

  if (ph == BLK_LOAD) {
    // the ragged last block repeats its last frame, so all math stays finite
    const int n3 = 3 * m.n_act;
    float* xq = (kAligned || kPairs) && m.n_coord > 0 ? sm + so.xq : nullptr;
    const bool rows = !kPairs || blk_needs_rows(m);  // a pair walk's kernel may have none
    if (io.x_sf == 1) {  // frames minor: neighbouring threads, neighbouring frames
      for (int e = tid; e < n3 * F; e += nt) {
        const int f = e & fmask, jj = e >> flog;
        const int k = jj / 3, c = jj - 3 * k;
        const int a = m.active_idx ? m.active_idx[k] : k;
        const int ff = f < nf ? f : nf - 1;
        blk_stage(xs, xq, rows, FP, F, jj, f,
                  io.x[f0 + ff + (long long)a * io.x_sa + c * io.x_sc]);
      }
    } else if (io.x_sc == 1 && io.x_sa == 3 && !m.active_idx && (n3 & 3) == 0 &&
               (io.x_sf & 3) == 0 && (reinterpret_cast<size_t>(io.x) & 15) == 0) {
      // frame major, every atom staged, rows 16-byte aligned: 16 bytes a
      // load and four loads of a thread in flight before their stores. With
      // two blocks on an SM (the backward kernel's shared memory), four
      // 4-byte loads a thread in flight left the staging at a third of
      // what four blocks reach.
      const int q4 = n3 >> 2;
      for (int e0 = tid; e0 < q4 * F; e0 += 4 * nt) {
        float v[4][4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int e = e0 + u * nt;
          if (e < q4 * F) {
            const int f = e / q4, q = e - f * q4;
            blk_load4(io.x + (f0 + (f < nf ? f : nf - 1)) * io.x_sf, 4 * q, n3, true, v[u]);
          }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int e = e0 + u * nt;
          if (e < q4 * F) {
            const int f = e / q4, q = e - f * q4;
#pragma unroll
            for (int c = 0; c < 4; ++c) blk_stage(xs, xq, rows, FP, F, 4 * q + c, f, v[u][c]);
          }
        }
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
            if (fb + u < F) blk_stage(xs, xq, rows, FP, F, jj, fb + u, v[u]);
        }
    }
    if (kForces && blk_has_scatter(m))
      for (int e = tid; e < n3 * F; e += nt) gacc[(e >> flog) * FP + (e & fmask)] = 0.f;
    return;
  }

  if (ph == BLK_FEAT) {
    const int n_items = c_coord + (aligned ? 0 : m.n_pos);
    for (int e = tid; e < n_items * F; e += nt) {
      const int f = e & fmask;
      int it = e >> flog;
      float loc[12];
      if (it < c_bond) {
        blk_local_atoms(xs, FP, f, m.angle_idx + 3 * it, 3, loc);
        feat[m.item_col[it] * FP + f] = angle_fwd<true>(loc, loc4, m.use_angle_value);
      } else if (it < c_dih) {
        blk_local_atoms(xs, FP, f, m.bond_idx + 2 * (it - c_bond), 2, loc);
        feat[m.item_col[it] * FP + f] = bond_fwd<true>(loc, loc4);
      } else if (it < c_coord) {
        blk_local_atoms(xs, FP, f, m.dihedral_idx + 4 * (it - c_dih), 4, loc);
        float out[2];
        const int cnt = dihedral_fwd<true>(loc, loc4, m.use_angle_value, out);
        feat[m.item_col[it] * FP + f] = out[0];
        if (cnt > 1) feat[(m.item_col[it] + 1) * FP + f] = out[1];
      } else {  // position without alignment
        const int p = it - c_coord;
        const int col = m.item_col[c_pos + p];
#pragma unroll
        for (int c = 0; c < 3; ++c)
          feat[(col + c) * FP + f] = xs[(3 * m.pos_idx[p] + c) * FP + f];
      }
    }
    // the pair walk: thread (atom, frame), see blk_pair_walk
    for (int k = 0; k < ((kAligned || kPairs) ? m.n_coord : 0); ++k) {
      const CoordPar cp = coord_load(m.coord_par + k * MOLANN_COORD_FLOATS);
      // a model with alignment takes the generic body: its kernels are the
      // largest to compile, and such models' pair counts are small
      const int form = kAligned ? 0 : blk_pair_form(cp);
      // the range form for a feature over all pairs of a run of staged
      // atoms, where the loop is one of the even forms
      const int rs = m.coord_range[2 * k], rn = m.coord_range[2 * k + 1];
      const bool range = form != 0 && rn > 0;
      const int* row = m.nbr_ptr + k * (m.n_act + 1);
      const int* mids = m.nbr_mid + k * m.n_act;
      const float4* xq = reinterpret_cast<const float4*>(sm + so.xq);
      for (int e = tid; e < m.n_act * F; e += nt) {
        const int f = e & fmask, a = e >> flog;
        float s = 0.f, D[3] = {0.f, 0.f, 0.f};
        if (!range || (a >= rs && a < rs + rn))  // off the range: no pairs
          blk_pair_walk_as<kForces>(form, range, cp, xq, F, f, a, m.nbr, range ? 0 : row[a],
                                    range ? 0 : mids[a], range ? 0 : row[a + 1], rs, rn, s, D);
        spart[(k * m.n_act + a) * FP + f] = s;
        if (kForces)
#pragma unroll
          for (int c = 0; c < 3; ++c) dk[((3 * k + c) * m.n_act + a) * FP + f] = D[c];
      }
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

  if (ph == BLK_REDUCE) {
    for (int e = tid; e < m.n_coord * F; e += nt) {
      const int f = e & fmask, k = e >> flog;
      float acc = 0.f, comp = 0.f;
      for (int a = 0; a < m.n_act; ++a) blk_kahan(spart[(k * m.n_act + a) * FP + f], acc, comp);
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

  if (ph == BLK_QCP) {  // thread (frame); with kForces the Newton result is kept for GH
    if (!aligned || tid >= F) return;
    const int f = tid;
    float H[3][3], R[3][3], lam0;
    for (int k = 0; k < 9; ++k) H[k / 3][k % 3] = st[(BLK_ST_H + k) * FP + f];
    qcp_rotation<float, true>(H, R, kForces ? &lam0 : nullptr);
    for (int k = 0; k < 9; ++k) st[(BLK_ST_R + k) * FP + f] = R[k / 3][k % 3];
    if (kForces) st[BLK_ST_LAM * FP + f] = lam0;
    return;
  }

  if (ph == BLK_POS) {
    if (!aligned) return;
    for (int e = tid; e < m.n_pos * F; e += nt) {
      const int f = e & fmask, p = e >> flog;
      const int a = m.pos_idx[p], col = m.item_col[c_pos + p];
      float v[3];
#pragma unroll
      for (int j = 0; j < 3; ++j) v[j] = xs[(3 * a + j) * FP + f] - st[(BLK_ST_C + j) * FP + f];
#pragma unroll
      for (int i = 0; i < 3; ++i)
        feat[(col + i) * FP + f] = v[0] * st[(BLK_ST_R + i) * FP + f] +
                                   v[1] * st[(BLK_ST_R + 3 + i) * FP + f] +
                                   v[2] * st[(BLK_ST_R + 6 + i) * FP + f];
    }
    return;
  }

  if (ph == BLK_MLP || ph == BLK_MLP_SUM) {  // layer L forward
    const int L = step.arg;
    const int d_in = blk_dim(m, L), d_o = blk_dim(m, L + 1);
    const float* w = blk_layer_w(m, L);
    const float* b = w + blk_pad4(d_o * d_in);
    const float* in = L ? hbuf + blk_h_off(m, L - 1) : feat;
    float* out = hbuf + blk_h_off(m, L);
    // the pre-activation too, where a backward through gelu or swish reads it
    float* zo = (so.z >= 0 && L < nl - 1) ? sm + so.z + blk_h_off(m, L) : nullptr;
    const BlkTiling t = blk_tiling(d_in, d_o, F, nt);
    if (ph == BLK_MLP_SUM) {  // the slices' partial sums, in slice order
      if (!t.tiled || t.slices == 1) return;
      for (int e = tid; e < d_o * F; e += nt) {
        const int f = e & fmask, j = e >> flog;
        float acc = b[j];
        for (int g = 0; g < t.slices; ++g) acc += scr[(g * d_o + j) * F + f];
        out[j * FP + f] = (L == nl - 1) ? acc : act_fwd(m.activation, acc);
        if (zo) zo[j * FP + f] = acc;
      }
      return;
    }
    if (!t.tiled) {
      // thread (frame, output), outputs fastest: a warp reads one row of
      // the transposed weights as neighbouring addresses, and its frame's
      // input as a broadcast. Eight partial sums keep eight loads in flight.
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
        if (zo) zo[j * FP + f] = acc;
      }
      return;
    }
    // thread (slice, frame pair, 4 outputs), outputs fastest: per input one
    // 16-byte load of weights and two shared loads feed 8 multiply-adds,
    // where a thread per output spent two loads on each
    const bool vec = (d_o & 3) == 0;
    for (int item = tid; item < t.n_tiles * t.slices; item += nt) {
      const int tile = item % t.n_tiles, g = item / t.n_tiles;
      const int j0 = 4 * (tile % t.n_jt), fa = t.ft * (tile / t.n_jt);
      const int fb = fa + t.ft - 1;  // == fa for one frame
      float a[4][2] = {{0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}};
      for (int k = g; k < d_in; k += t.slices) {
        float wv[4];
        blk_load4(w + k * d_o, j0, d_o, vec, wv);
        const float xa = in[k * FP + fa], xb = in[k * FP + fb];
#pragma unroll
        for (int i = 0; i < 4; ++i) { a[i][0] += wv[i] * xa; a[i][1] += wv[i] * xb; }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int j = j0 + i, f = fa + u;
          if (j >= d_o || u >= t.ft) continue;
          if (t.slices > 1) {
            scr[(g * d_o + j) * F + f] = a[i][u];
          } else {
            const float acc = b[j] + a[i][u];
            out[j * FP + f] = (L == nl - 1) ? acc : act_fwd(m.activation, acc);
            if (zo) zo[j * FP + f] = acc;
          }
        }
    }
    return;
  }

  if (ph == BLK_OUT) {  // write y; seed the output cotangent
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

  if (ph == BLK_BWD) {  // layer L backward, in place over the layer's input
    const int L = step.arg;
    const int d_in = blk_dim(m, L), d_o = blk_dim(m, L + 1);
    const float* w = blk_layer_w(m, L);  // transposed: [d_in, d_o]
    const float* g = hbuf + blk_h_off(m, L);
    float* in = L ? hbuf + blk_h_off(m, L - 1) : feat;
    // the input's pre-activation (gelu, swish); the derivative of the
    // others is read from the output stored in `in`
    const float* zi = (so.z >= 0 && L) ? sm + so.z + blk_h_off(m, L - 1) : nullptr;
    if (d_in < MOLANN_BLK_TILED_MIN_IN) {
      for (int e = tid; e < d_in * F; e += nt) {
        const int f = e & fmask, k = e >> flog;
        float acc = 0.f;
        for (int j = 0; j < d_o; ++j) acc += w[k * d_o + j] * g[j * FP + f];
        in[k * FP + f] =
            L ? acc * act_grad(m.activation, in[k * FP + f], zi ? zi[k * FP + f] : 0.f) : acc;
      }
      return;
    }
    // thread (frame pair, 4 inputs): per 4 outputs four 16-byte loads of
    // weights and 8 shared loads feed 32 multiply-adds
    const bool vec = (d_o & 3) == 0;
    const int ft = F >= 2 ? 2 : 1, n_ft = F / ft, n_kt = (d_in + 3) / 4;
    for (int item = tid; item < n_kt * n_ft; item += nt) {
      const int fa = ft * (item % n_ft), fb = fa + ft - 1, k0 = 4 * (item / n_ft);
      float a[4][2] = {{0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}};
      for (int j0 = 0; j0 < d_o; j0 += 4) {
        float gv[4][2];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int j = j0 + jj < d_o ? j0 + jj : d_o - 1;
          const float live = j0 + jj < d_o ? 1.0f : 0.0f;
          gv[jj][0] = live * g[j * FP + fa];
          gv[jj][1] = live * g[j * FP + fb];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int k = k0 + i < d_in ? k0 + i : d_in - 1;
          float wv[4];
          blk_load4(w + k * d_o, j0, d_o, vec, wv);
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            a[i][0] += wv[jj] * gv[jj][0];
            a[i][1] += wv[jj] * gv[jj][1];
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int k = k0 + i, f = fa + u;
          if (k >= d_in || u >= ft) continue;
          in[k * FP + f] = L ? a[i][u] * act_grad(m.activation, in[k * FP + f],
                                                  zi ? zi[k * FP + f] : 0.f)
                             : a[i][u];
        }
    }
    return;
  }

  if (ph == BLK_GR) {  // GR[j][i] = sum_p v_p[j] * g_p[i]
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

  if (ph == BLK_GH) {  // GH = GR : dR/dH by QCP's reverse pass, thread (frame)
    if (tid >= F) return;
    const int f = tid;
    float H[3][3], gR[3][3], R[3][3], gH[3][3];
    for (int k = 0; k < 9; ++k) {
      H[k / 3][k % 3] = st[(BLK_ST_H + k) * FP + f];
      gR[k / 3][k % 3] = st[(BLK_ST_GR + k) * FP + f];
    }
    qcp_rotation_vjp(H, gR, st[BLK_ST_LAM * FP + f], R, gH);
    for (int k = 0; k < 9; ++k) st[(BLK_ST_GH + k) * FP + f] = gH[k / 3][k % 3];
    return;
  }

  if (ph == BLK_GC) {  // the cotangent of the centroid
    for (int e = tid; e < 3 * F; e += nt) {
      const int f = e & fmask, j = e >> flog;
      float acc = 0.f;
      for (int p = 0; p < m.n_pos; ++p) {
        const int col = m.item_col[c_pos + p];
#pragma unroll
        for (int i = 0; i < 3; ++i)
          acc -= st[(BLK_ST_R + 3 * j + i) * FP + f] * feat[(col + i) * FP + f];
      }
      for (int n = 0; n < m.n_align; ++n)
#pragma unroll
        for (int q = 0; q < 3; ++q)
          acc -= st[(BLK_ST_GH + 3 * j + q) * FP + f] * m.ref_x[3 * n + q];
      st[(BLK_ST_GC + j) * FP + f] = acc;
    }
    return;
  }

  if (ph == BLK_SCATTER) {
    // thread (feature of the batch, frame): the feature's adjoint once, each
    // atom's share added to the atom's accumulators. No two features of a
    // batch share an atom and a barrier follows, so nothing races and the
    // order of the additions is the batches'.
    const int b0 = m.batch_ptr[step.arg], cnt = m.batch_ptr[step.arg + 1] - b0;
    for (int e = tid; e < cnt * F; e += nt) {
      const int f = e & fmask;
      const int ent = m.batch_ent[b0 + (e >> flog)];
      const int kind = ent >> 28, it = ent & ((1 << 28) - 1);
      float loc[12], ga[12];
#pragma unroll
      for (int c = 0; c < 12; ++c) ga[c] = 0.f;
      const int* idx;
      int cnt_atoms;
      if (kind == BLK_ENT_ANGLE) {
        idx = m.angle_idx + 3 * it; cnt_atoms = 3;
        blk_local_atoms(xs, FP, f, idx, 3, loc);
        angle_bwd<true>(loc, loc4, m.use_angle_value, feat[m.item_col[it] * FP + f], ga);
      } else if (kind == BLK_ENT_BOND) {
        idx = m.bond_idx + 2 * it; cnt_atoms = 2;
        blk_local_atoms(xs, FP, f, idx, 2, loc);
        bond_bwd<true>(loc, loc4, feat[m.item_col[c_bond + it] * FP + f], ga);
      } else {
        idx = m.dihedral_idx + 4 * it; cnt_atoms = 4;
        blk_local_atoms(xs, FP, f, idx, 4, loc);
        float gd[2];
        gd[0] = feat[m.item_col[c_dih + it] * FP + f];
        gd[1] = dcols > 1 ? feat[(m.item_col[c_dih + it] + 1) * FP + f] : 0.f;
        dihedral_bwd<true>(loc, loc4, m.use_angle_value, gd, ga);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
        if (r < cnt_atoms) {
          float* ga_at = gacc + (3 * idx[r]) * FP + f;
          ga_at[0] += ga[3 * r]; ga_at[FP] += ga[3 * r + 1]; ga_at[2 * FP] += ga[3 * r + 2];
        }
    }
    return;
  }

  if (ph != BLK_GATHER) return;
  // GATHER: thread (output atom, frame) adds its accumulators, the position
  // and alignment entries of its row, and every coordination feature's
  // cotangent times D_k; nothing is scattered here. Where the gradient is
  // frame-major ([l, n, 3], [l, 3n]) atoms run fastest across threads, so
  // that a warp's stores are one frame's neighbouring floats (with frames
  // fastest the peptide-like model's gather took 0.18 ms a 65,536-frame
  // batch for 0.07 of bytes); otherwise frames do, and a warp stores a row's
  // neighbouring frames.
  const bool scattered = blk_has_scatter(m);
  const bool atoms_fastest = io.g_sc == 1 && io.g_sa == 3;
  for (int e = tid; e < m.n_out * F; e += nt) {
    const int o = atoms_fastest ? e % m.n_out : e >> flog;
    const int f = atoms_fastest ? e / m.n_out : e & fmask;
    const int k = m.out_map ? m.out_map[o] : o;
    float g[3] = {0.f, 0.f, 0.f};
    if (k >= 0) {
      if (scattered)
#pragma unroll
        for (int c = 0; c < 3; ++c) g[c] = gacc[(3 * k + c) * FP + f];
      for (int q = m.atom_ptr[k]; q < m.atom_ptr[k + 1]; ++q) {
        const int ent = m.atom_ent[q];
        const int kind = ent >> 28, it = ent & ((1 << 28) - 1);
        if (kind == BLK_ENT_POS) {
          const int col = m.item_col[c_pos + it];
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            if (aligned)
              g[j] += st[(BLK_ST_R + 3 * j) * FP + f] * feat[col * FP + f] +
                      st[(BLK_ST_R + 3 * j + 1) * FP + f] * feat[(col + 1) * FP + f] +
                      st[(BLK_ST_R + 3 * j + 2) * FP + f] * feat[(col + 2) * FP + f];
            else
              g[j] += feat[(col + j) * FP + f];
          }
        } else {  // BLK_ENT_ALIGN: through H, and the centroid's share
#pragma unroll
          for (int i = 0; i < 3; ++i)
            g[i] += st[(BLK_ST_GH + 3 * i) * FP + f] * m.ref_x[3 * it] +
                    st[(BLK_ST_GH + 3 * i + 1) * FP + f] * m.ref_x[3 * it + 1] +
                    st[(BLK_ST_GH + 3 * i + 2) * FP + f] * m.ref_x[3 * it + 2] +
                    st[(BLK_ST_GC + i) * FP + f] / (float)m.n_align;
        }
      }
      // pairs: d s(|x_j - x_k|)/d x_k = -s'(r)/r * d summed over the atom's
      // partners is D_k of the walk; the minimum-image shift is constant
      for (int cf = 0; cf < m.n_coord; ++cf) {
        const float gc = feat[m.item_col[c_coord + cf] * FP + f];
#pragma unroll
        for (int c = 0; c < 3; ++c) g[c] += gc * dk[((3 * cf + c) * m.n_act + k) * FP + f];
      }
    }
    if (f < nf)
#pragma unroll
      for (int c = 0; c < 3; ++c)
        io.gx[(f0 + f) * io.g_sf + (long long)o * io.g_sa + c * io.g_sc] = g[c];
  }
}

// A step of the forward (kForces = false) or cv+forces kernel on its own
// shared-memory layout.
template <bool kForces, bool kAligned, bool kPairs>
__host__ __device__ inline void blk_phase(const BlockedArgs& m, const BlockedIO& io, float* sm,
                                          long long block, BlkStep step, int tid, int nt) {
  blk_phase_at<kForces, kAligned, kPairs>(m, io, sm, blk_smem(m, nt, kForces), block, step, tid,
                                          nt);
}

// Threads of a forward or cv+forces block (see MOLANN_BLK_THREADS).
__host__ __device__ inline int blk_threads(const BlockedArgs& m, bool forces) {
  if (blk_aligned(m)) return MOLANN_BLK_THREADS;
  const long long bytes = (long long)blk_smem(m, MOLANN_BLK_THREADS, forces).total * 4;
  return bytes > MOLANN_BLK_SMEM_QUARTER ? MOLANN_BLK_THREADS_WIDE : MOLANN_BLK_THREADS;
}

// ---------------------------------------------------------------------------
// The backward and train kernels: the steps above with gy (or the MSE
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
  for (int L = 0; L < m.n_layers; ++L) n += blk_dim(m, L + 1) * (blk_dim(m, L) + 1);
  return n;
}

__host__ __device__ __forceinline__ long long blk_grad_blocks(const BlockedArgs& m, long long l) {
  const long long tiles = (l + m.frames - 1) / m.frames;
  return tiles < MOLANN_BLK_GRAD_BLOCKS ? tiles : MOLANN_BLK_GRAD_BLOCKS;
}

// Whether a layer's parameter step runs in rectangles: its [d_out, d_in]
// cuts into at most nt rectangles of 4 x 6, a thread each, and is worth it
// (at least 4 nt entries).
__host__ __device__ __forceinline__ bool blk_rect_layer(int d_in, int d_o, int nt) {
  const int rects = ((d_o + MOLANN_BLK_RSUM_J - 1) / MOLANN_BLK_RSUM_J) *
                    ((d_in + MOLANN_BLK_RSUM_K - 1) / MOLANN_BLK_RSUM_K);
  return rects <= nt && d_o * d_in >= 4 * nt;
}

// Where a block's running sums [loss | G] live (BlockedIO.acc_global). In
// shared memory; or, too wide for it, in the block's row of the partials in
// device memory; or in shared memory but for the weight gradient of the
// largest layer that runs in rectangles, which lives in device memory behind
// the partials' rows, [blocks, 24, nt] floats: entry e of thread t's
// rectangle at e * nt + t, so that a warp adds a tile's term to 32
// neighbouring floats. The last is for a block that would otherwise not fit
// twice on an SM: the peptide-like model's backward kernel with gx, 141 KB
// with the 45 KB of that gradient, took 2.66 ms with one block an SM.
enum { BLK_SUMS_SHARED = 0, BLK_SUMS_ROW = 1, BLK_SUMS_RECT = 2 };

// The largest layer whose parameter step runs in rectangles (layer < 0:
// none) and its weight gradient's place [w0, w0 + wsize) in [loss | G].
struct BlkRectMap { int layer, w0, wsize; };

__host__ __device__ inline BlkRectMap blk_rect_map(const BlockedArgs& m, int nt) {
  BlkRectMap r = {-1, 0, 0};
  int off = 1 + 3 * m.n_align;
  for (int L = 0; L < m.n_layers; ++L) {
    const int d_in = blk_dim(m, L), d_o = blk_dim(m, L + 1);
    if (blk_rect_layer(d_in, d_o, nt) && d_o * d_in > r.wsize) {
      r.layer = L; r.w0 = off; r.wsize = d_o * d_in;
    }
    off += d_o * (d_in + 1);
  }
  return r;
}

// The sums a block keeps in `acc` (shared memory or its row): all of [loss |
// G], or with BLK_SUMS_RECT all but the block blk_rect_map names, the rest
// moved up (compact).
__host__ __device__ inline int blk_grad_acc_width(const BlockedArgs& m, int nt, int sums) {
  return 1 + blk_grad_size(m) - (sums == BLK_SUMS_RECT ? blk_rect_map(m, nt).wsize : 0);
}

// The layout of a backward or train block: the whole alignment state, room
// for the coordinate gradient's D_k and accumulators when gx is wanted and
// the running sums it keeps in shared memory behind it.
__host__ __device__ inline BlkSmem blk_grad_smem(const BlockedArgs& m, int nt, bool gx,
                                                 int sums) {
  BlkSmem s = blk_smem_at(m, nt, true, gx);
  if (sums != BLK_SUMS_ROW) s.total += blk_grad_acc_width(m, nt, sums);
  return s;
}

// Threads of a backward or train block (see MOLANN_BLK_THREADS).
__host__ __device__ inline int blk_grad_threads(const BlockedArgs& m, bool gx, int sums) {
  if (blk_aligned(m)) return MOLANN_BLK_THREADS;
  const long long bytes = (long long)blk_grad_smem(m, MOLANN_BLK_THREADS, gx, sums).total * 4;
  return bytes > MOLANN_BLK_SMEM_QUARTER ? MOLANN_BLK_THREADS_WIDE : MOLANN_BLK_THREADS;
}

template <bool kGx, bool kAligned>
__host__ __device__ __forceinline__ bool blk_grad_adjoint(const BlockedIO& io) {
  return kGx || (kAligned && io.want_ref != 0);
}

// Zero the block's running sums; before its first tile. `rect`: the block's
// [24, nt] floats behind the partials' rows with BLK_SUMS_RECT, else null.
__host__ __device__ inline void blk_grad_begin(const BlockedArgs& m, const BlockedIO& io,
                                               float* acc, float* rect, int tid, int nt) {
  const int width = blk_grad_acc_width(m, nt, io.acc_global);
  for (int e = tid; e < width; e += nt) acc[e] = 0.f;
  if (rect)
    for (int e = 0; e < MOLANN_BLK_RSUM_J * MOLANN_BLK_RSUM_K; ++e) rect[e * nt + tid] = 0.f;
}

// Store the block's sums into its row [loss | G] of the partials; after its
// last tile (and a barrier).
__host__ __device__ inline void blk_grad_end(const BlockedArgs& m, const BlockedIO& io,
                                             const float* acc, const float* rect, float* row,
                                             int tid, int nt) {
  if (io.acc_global == BLK_SUMS_ROW) return;
  const BlkRectMap r = blk_rect_map(m, nt);
  const int cut = rect ? r.wsize : 0;
  const int width = 1 + blk_grad_size(m) - cut;
  for (int e = tid; e < width; e += nt) row[e < r.w0 || !rect ? e : e + cut] = acc[e];
  if (!rect || r.layer < 0) return;
  const int d_in = blk_dim(m, r.layer), d_o = blk_dim(m, r.layer + 1);
  const int n_jt = (d_o + MOLANN_BLK_RSUM_J - 1) / MOLANN_BLK_RSUM_J;
  const int j0 = MOLANN_BLK_RSUM_J * (tid % n_jt), k0 = MOLANN_BLK_RSUM_K * (tid / n_jt);
  for (int i = 0; i < MOLANN_BLK_RSUM_J; ++i)
    for (int kk = 0; kk < MOLANN_BLK_RSUM_K; ++kk)
      if (j0 + i < d_o && k0 + kk < d_in)
        row[r.w0 + (j0 + i) * d_in + k0 + kk] = rect[(i * MOLANN_BLK_RSUM_K + kk) * nt + tid];
}

// kTrain: the seed is the MSE cotangent 2 (y - y_target) inv_count on the
// true frames, the loss is summed, and there is no gx. Otherwise the seed is
// gy. Frames past the end get a zero seed, and with it zero terms. `acc`
// is the block's running sums [loss | G] in shared memory (or its row of
// partials); a thread adds a tile's term, summed over the tile's frames in
// order, to each entry it owns: in a large layer a rectangle of 4 x 6
// entries (4 + 6 shared loads of a frame feed 24 multiply-adds), else
// entries t, t + nt, ... No atomics, the same bits on every launch. The
// sums stay in shared memory: kept in a thread's registers over the tiles
// (48 at 128 registers a thread, 24 at 64) the rectangle was spilled as soon
// as the kernel also formed gx, and at 64 registers the train kernel of the
// peptide-like model took 1.01-1.66 ms that way against 0.99 from shared
// memory.
// kGx: the backward kernel asked for gx (io.gx is set). A kernel of its
// own: with the gx steps and the forward-only pair walk in one kernel, the
// compiler's register allocation slowed every step (the peptide-like model's
// parameter sums alone took 2.22 ms in that kernel against 0.99 in the train
// kernel, which runs the same steps).
template <bool kTrain, bool kGx, bool kAligned, bool kPairs>
__host__ __device__ __forceinline__ void blk_grad_phase(const BlockedArgs& m, const BlockedIO& io,
                                               float* sm, const BlkSmem& so, float* acc,
                                               float* rect, long long tile, BlkStep step,
                                               int tid, int nt) {
  const int F = m.frames, FP = m.pitch, fmask = F - 1;
  int flog = 0;
  while ((1 << flog) < F) ++flog;
  const int nl = m.n_layers;
  static_assert(!(kTrain && kGx), "the train kernel forms no gx");
  const bool want_gx = kGx;
  const bool want_ref = kAligned && io.want_ref != 0;
  const bool adjoint = want_gx || want_ref;  // anything below the MLP
  const long long f0 = tile * F;
  const long long left = io.l - f0;
  const int nf = left < (long long)F ? (int)left : F;
  float* feat = sm + so.feat;
  float* hbuf = sm + so.h;
  float* last = nl ? hbuf + blk_h_off(m, nl - 1) : feat;
  const int d_out = blk_out_dim(m);

  if (kGx && step.kind != BLK_SEED && step.kind != BLK_PGRAD && step.kind != BLK_GREF) {
    // every other step as the cv+forces kernel runs it, through one call
    blk_phase_at<true, kAligned, kPairs>(m, io, sm, so, tile, step, tid, nt);
    return;
  }
  switch (step.kind) {
    // (without gx the step's kind goes on as a constant, so that each call
    // keeps only its own step of blk_phase_at)
    case BLK_LOAD:
      if (kGx) return;  // went through the call above
      blk_phase_at<false, kAligned, kPairs>(m, io, sm, so, tile, BlkStep{BLK_LOAD, 0}, tid, nt);
      return;
    case BLK_FEAT:
      if (kGx) return;  // went through the call above
      blk_phase_at<false, kAligned, kPairs>(m, io, sm, so, tile, BlkStep{BLK_FEAT, 0}, tid, nt);
      return;
    case BLK_QCP:  // the Newton result kept only where an adjoint needs it
      if (kGx) return;  // went through the call above
      if (adjoint) blk_phase_at<true, kAligned, kPairs>(m, io, sm, so, tile,
                                                        BlkStep{BLK_QCP, 0}, tid, nt);
      else blk_phase_at<false, kAligned, kPairs>(m, io, sm, so, tile, BlkStep{BLK_QCP, 0}, tid, nt);
      return;
    case BLK_REDUCE:
      if (kGx) return;  // went through the call above
      blk_phase_at<false, kAligned, kPairs>(m, io, sm, so, tile, BlkStep{BLK_REDUCE, 0}, tid, nt);
      return;
    case BLK_POS:
      if (kGx) return;  // went through the call above
      blk_phase_at<false, kAligned, kPairs>(m, io, sm, so, tile, BlkStep{BLK_POS, 0}, tid, nt);
      return;
    case BLK_MLP:
      if (kGx) return;  // went through the call above
      blk_phase_at<false, kAligned, kPairs>(m, io, sm, so, tile,
                                            BlkStep{BLK_MLP, step.arg}, tid, nt);
      return;
    case BLK_MLP_SUM:
      if (kGx) return;  // went through the call above
      blk_phase_at<false, kAligned, kPairs>(m, io, sm, so, tile,
                                            BlkStep{BLK_MLP_SUM, step.arg}, tid, nt);
      return;
    case BLK_SEED:  // the cotangent of the output, in place
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
    case BLK_BWD:  // the cotangent of the layer's input, in place
      if (kGx) return;  // went through the call above
      if (step.arg > 0 || adjoint)
        blk_phase_at<true, kAligned, kPairs>(m, io, sm, so, tile,
                                             BlkStep{BLK_BWD, step.arg}, tid, nt);
      return;
    case BLK_PGRAD: {
      // gW[j][k] += sum_f gz[j][f] a[k][f], gb[j] += sum_f gz[j][f], before
      // BWD L overwrites the layer's input a
      const int L = step.arg;
      const BlkLayer lay = blk_layer(m, L);
      const int d_in = lay.d_in, d_o = lay.d_o;
      int off = lay.g_off;
      const float* gz = hbuf + blk_h_off(m, L);
      const float* a = L ? hbuf + blk_h_off(m, L - 1) : feat;
      // with BLK_SUMS_RECT one layer's weight gradient is not in acc
      const BlkRectMap rmap = rect ? blk_rect_map(m, nt) : BlkRectMap{-1, 0, 0};
      const bool to_rect = rect && L == rmap.layer;
      if (L > rmap.layer) off -= rmap.wsize;
      if (kTrain && L == nl - 1 && tid == nt - 1) {
        // the loss, by the one thread with least to do in this step, frames
        // then columns in order, from the seeds g = 2 e inv_count in shared
        // memory (e^2 inv_count = g^2 / (4 inv_count)): a step of its own
        // for it cost a barrier, and the labels read again from device
        // memory in one thread as much as the first layer's parameter step
        float g2 = 0.f;
        for (int f = 0; f < nf; ++f)
          for (int j = 0; j < d_out; ++j) g2 += last[j * FP + f] * last[j * FP + f];
        acc[0] += g2 * (0.25f / io.inv_count);
      }
      if (blk_rect_layer(d_in, d_o, nt)) {
        // thread (4 outputs, 6 inputs): the rectangle's 4 cotangents and 6
        // activations of a frame feed 24 multiply-adds, where a thread per
        // entry spent two shared loads on each; frames in order
        const int n_jt = (d_o + MOLANN_BLK_RSUM_J - 1) / MOLANN_BLK_RSUM_J;
        const int n_kt = (d_in + MOLANN_BLK_RSUM_K - 1) / MOLANN_BLK_RSUM_K;
        if (tid < n_jt * n_kt) {  // rows past the end are read as the last and never stored
          const int j0 = MOLANN_BLK_RSUM_J * (tid % n_jt), k0 = MOLANN_BLK_RSUM_K * (tid / n_jt);
          // a full rectangle reads rows j0.., k0.. at constant offsets
          const bool full = j0 + MOLANN_BLK_RSUM_J <= d_o && k0 + MOLANN_BLK_RSUM_K <= d_in;
          const float* gz0 = gz + j0 * FP;
          const float* a0 = a + k0 * FP;
          float t[MOLANN_BLK_RSUM_J * MOLANN_BLK_RSUM_K];
#pragma unroll
          for (int e = 0; e < MOLANN_BLK_RSUM_J * MOLANN_BLK_RSUM_K; ++e) t[e] = 0.f;
          for (int f = 0; f < F; ++f) {
            float gv[MOLANN_BLK_RSUM_J], av[MOLANN_BLK_RSUM_K];
#pragma unroll
            for (int i = 0; i < MOLANN_BLK_RSUM_J; ++i)
              gv[i] = gz0[((full || j0 + i < d_o) ? i : d_o - 1 - j0) * FP + f];
#pragma unroll
            for (int kk = 0; kk < MOLANN_BLK_RSUM_K; ++kk)
              av[kk] = a0[((full || k0 + kk < d_in) ? kk : d_in - 1 - k0) * FP + f];
#pragma unroll
            for (int i = 0; i < MOLANN_BLK_RSUM_J; ++i)
#pragma unroll
              for (int kk = 0; kk < MOLANN_BLK_RSUM_K; ++kk)
                t[i * MOLANN_BLK_RSUM_K + kk] += gv[i] * av[kk];
          }
          if (to_rect) {  // entries past the layer's end are never stored
#pragma unroll
            for (int e = 0; e < MOLANN_BLK_RSUM_J * MOLANN_BLK_RSUM_K; ++e)
              rect[e * nt + tid] += t[e];
          } else {
#pragma unroll
            for (int i = 0; i < MOLANN_BLK_RSUM_J; ++i)
#pragma unroll
              for (int kk = 0; kk < MOLANN_BLK_RSUM_K; ++kk)
                if (j0 + i < d_o && k0 + kk < d_in)
                  acc[off + (j0 + i) * d_in + k0 + kk] += t[i * MOLANN_BLK_RSUM_K + kk];
          }
        }
        const int b_off = off + d_o * d_in - (to_rect ? rmap.wsize : 0);
        for (int j = tid; j < d_o; j += nt) {
          float sj = 0.f;
          for (int f = 0; f < F; ++f) sj += gz[j * FP + f];
          acc[b_off + j] += sj;
        }
        return;
      }
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
    case BLK_GR:
      if (kGx) return;  // went through the call above
      if (adjoint) blk_phase_at<true, kAligned, kPairs>(m, io, sm, so, tile,
                                                        BlkStep{BLK_GR, 0}, tid, nt);
      return;
    case BLK_GH:
      if (kGx) return;  // went through the call above
      if (adjoint) blk_phase_at<true, kAligned, kPairs>(m, io, sm, so, tile,
                                                        BlkStep{BLK_GH, 0}, tid, nt);
      return;
    case BLK_GREF: {  // g_ref[n][j] += sum_f sum_i gH[i][j] (x[a_n][i] - c_i)
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
    default:
      return;
  }
}

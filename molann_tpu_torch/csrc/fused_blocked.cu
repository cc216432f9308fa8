// The blocked fused kernels for Hopper (sm_90a), forward and cv+forces: a
// thread block per tile of frames, its threads spread over features, atoms
// and MLP tiles.
//
// Replaces two Pallas TPU kernels of molann_tpu/ops/fused_blocked.py:
//   - _blk_fwd_kernel (:1179, launched from _blk_fwd_impl :1670): values;
//   - _blk_cv_forces_kernel (:1398, launched from blocked_cv_forces :1850):
//     values plus the coordinate gradient of sum(y) or of one component.
// The backward and train kernels are in fused_blocked_grads.cu. The block's
// steps (gathers, feature math, the pair walk, QCP alignment, the MLP and
// every hand-derived adjoint) are in blocked_math.cuh, whose header says how
// each is laid out over the threads.
//
// What bounds it on this card. A peptide-like model (300 atoms, 355 feature
// columns, MLP 355 -> 32 -> 2) moves 3.6 KB of coordinates in and, with
// forces, 3.6 KB of gradient out per frame. The function needs some 31
// thousand f32 operations a frame forward and 79 thousand with forces (every
// adjoint once); device memory bounds it (0.141 ms per 65,536 frames at
// 3.35 TB/s with forces, 0.071 ms without). A condensed-phase contact model
// (125 atoms, 2 x 7,750 minimum-image pairs) moves 1.5 KB per frame against
// 15,500 switching functions of 22 to 54 operations each, s' and the adds
// into the gradient included: about 408 thousand operations a frame forward
// and 579 thousand with forces, so f32 arithmetic bounds it (0.40 and 0.57 ms
// per 65,536 frames at 67 TFLOP/s).
//
// What the design does about it. The one-thread-per-frame design of the
// unrolled kernels does not carry over: the feature vector alone would be
// 1.4 KB of local memory a thread and a pair loop would run serially. Here a
// block stages the coordinates of its tile's active atoms in shared memory
// once ([3 * n_act] rows of `frames` floats, so a frame's atoms are read
// from device memory exactly once, four rows in flight per thread), and then:
//   - thread (feature, frame) gathers its two to four atoms from shared
//     memory and writes the feature's column, its square roots and
//     divisions on the special-function units with a Newton step;
//   - thread (atom, frame) walks the atom's pair partners once with the atom
//     in registers, four partners a loop turn, each a 16-byte shared load of
//     its coordinates (partner rows staged beside the coordinate rows); a
//     feature over all pairs of a run of atoms (the contact model's shells)
//     finds them by position with no index read. Forward only the pairs the
//     atom owns (each pair once), summed in groups of four with one
//     compensated add a group; with forces all of them (each pair twice, the
//     partners it does not own to a gradient's precision only), keeping the
//     switching sum and D_k[a], the pair gradient without the feature's
//     cotangent. The loop's switching function and minimum image are chosen
//     outside it. The cut at d_max is taken on the squared distance before
//     any square root, and the divisions of a pair go to the special-
//     function units, with a Newton step. Evaluating each pair once in
//     atom-disjoint batches made the contact model's cv+forces kernel 3.6
//     times slower (PERF.md): a barrier and six shared read-modify-writes a
//     pair;
//   - the first MLP layer runs register-tiled (4 outputs x 2 frames a
//     thread over a slice of the inputs), the small layers one thread per
//     (frame, output), over weights the wrapper hands over transposed and
//     widths and offsets from a table built once per head (any depth);
//   - for the gradient, the MLP runs backwards in place (4 inputs x 2
//     frames a thread), thread (feature, frame) computes each bond, angle
//     and dihedral adjoint once and adds it into per-atom accumulators in
//     shared memory, batch by batch (no two features of a batch share an
//     atom, a batch's entries by kind), QCP's adjoint is the reverse pass
//     from the forward's Newton result, and thread (atom, frame) adds
//     accumulators, position terms and cotangent x D_k and stores, atoms
//     fastest where the gradient is frame-major. There is no float
//     atomicAdd: the same inputs give the same bits.
// Three instances of each kernel: with alignment (QCP and its reverse pass
// set its registers: 96 forward, 128 with forces, no stack), without
// alignment or pairs, and without alignment with the pair walk (whose four
// pairs in flight made every step of the other models' kernels spill). The
// last two are capped at 64 registers, so that four blocks of 256 threads
// share an SM, or two of 512 where the block's shared memory allows no more
// than two (the peptide-like model with forces: 87 KB). The list of a
// tile's steps and the block's layout sit at the start of shared memory,
// not in registers across the steps.
// Tile: 32, 16 or 8 frames, the most for which four blocks fit on an SM
// (56 KB of shared memory each), then two blocks, so that one block's
// barriers are hidden by the others; else the most that fit in 227 KB. The
// ragged last block is masked by frame index. Inputs and
// outputs are addressed through strides, so [l, n, 3], [l, 3n], [3n, l] and
// [3, n, l] are read and written in place.
//
// Measured on an H100 80GB HBM3 at 700 W, 65,536 frames, each kernel alone
// (probes/blocked_probe.py grads): the peptide-like model 0.38 ms forward
// and 1.19 ms with forces (0.43 and 1.46 before this design), the contact
// model 1.52 and 3.50 ms (1.99 and 4.22). Where the time goes, by a clock
// read after every step's barrier (probes/blocked_probe.py phases): the
// contact model is its pair walk (92%), 30-40 SASS instructions a pair
// evaluation; the peptide-like model forward is half its first layer, with
// forces a quarter its feature adjoints and a third the first layer forwards
// and backwards. PERF.md keeps the tables.
//
// Deliberately not carried over from the TPU design: the 0/+-1 edge matrix
// and its 3-pass bf16 split matmul (a thread gathers x[a] directly, in f32,
// for every precision name), the 8-row padding of every segment, d_pad and
// the permutation folded into W1 (item_col holds final columns), the chunk
// matrix C, the windowed matrix CW and their two walks (one int32 partner
// table serves resident and streamed features alike), auto_tile and the
// VMEM cost model, the single-buffered HBM x/gx DMA, and the active-atom
// gather and scatter outside the kernel (the kernel reads x[active[k]] and
// writes zeros for inactive atoms itself).

// Built once per kernel: variant v holds the instance kForces = v / 3 with
// v % 3 = 0 for a model with alignment (kAligned), 1 for one without
// alignment or pairs, 2 for one without alignment with pairs (kPairs); and
// variant 0 the functions the wrapper calls.
// nvcc-variants: MOLANN_VARIANT 6

#include <cuda_runtime.h>

#include "blocked_math.cuh"

#ifndef MOLANN_VARIANT
#error "compile with -DMOLANN_VARIANT=0..5 (ops/_build.py does)"
#endif
#define MOLANN_CAT_(a, b) a##b
#define MOLANN_CAT(a, b) MOLANN_CAT_(a, b)

namespace {

// Without alignment the bounds (512 threads, two blocks) give 64 registers,
// as four blocks of 256 would: a block of 256 threads runs the same code.
template <bool kForces, bool kAligned, bool kPairs>
__global__ void __launch_bounds__(kAligned ? MOLANN_BLK_THREADS : MOLANN_BLK_THREADS_WIDE,
                                  kAligned ? 1 : 2)
blocked_kernel(const BlockedArgs m, const BlockedIO io) {
  extern __shared__ float sm[];
  const int tid = (int)threadIdx.x, nt = (int)blockDim.x;
  int* steps = reinterpret_cast<int*>(sm);  // its count, then the steps and the layout
  if (tid == 0) {
    steps[0] = blk_build_steps(m, kForces ? BLK_MODE_FORCES : BLK_MODE_FORWARD, kForces,
                               kForces, nt, steps + 1);
    *blk_layout_slot(sm, m) = blk_smem(m, nt, kForces);
  }
  __syncthreads();
  const BlkSmem& so = *blk_layout_slot(sm, m);
  const int n_steps = steps[0];
  for (int i = 0; i < n_steps; ++i) {
    const BlkStep st = blk_step_of(steps[1 + i]);
    const int reps = blk_step_reps(m, st.kind);
    for (int b = 0; b < reps; ++b) {
      blk_phase_at<kForces, kAligned, kPairs>(m, io, sm, so, (long long)blockIdx.x,
                                              BlkStep{st.kind, reps > 1 ? b : st.arg}, tid, nt);
      __syncthreads();  // the step's barrier
    }
  }
}

template <bool kForces, bool kAligned, bool kPairs>
int launch_kernel(const BlockedArgs* m, const BlockedIO* io, void* stream) {
  const int nt = blk_threads(*m, kForces);
  const size_t smem = (size_t)blk_smem(*m, nt, kForces).total * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(blocked_kernel<kForces, kAligned, kPairs>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (io->l + m->frames - 1) / m->frames;
  blocked_kernel<kForces, kAligned, kPairs><<<(unsigned)blocks, nt, smem,
                                              (cudaStream_t)stream>>>(*m, *io);
  return (int)cudaGetLastError();
}

}  // namespace

// This variant's kernel.
extern "C" int MOLANN_CAT(molann_blocked_launch_v, MOLANN_VARIANT)(
    const BlockedArgs* m, const BlockedIO* io, void* stream) {
  return launch_kernel<(MOLANN_VARIANT / 3 != 0), (MOLANN_VARIANT % 3 == 0),
                       (MOLANN_VARIANT % 3 == 2)>(m, io, stream);
}

#if MOLANN_VARIANT == 0

extern "C" {

int molann_blocked_launch_v1(const BlockedArgs*, const BlockedIO*, void*);
int molann_blocked_launch_v2(const BlockedArgs*, const BlockedIO*, void*);
int molann_blocked_launch_v3(const BlockedArgs*, const BlockedIO*, void*);
int molann_blocked_launch_v4(const BlockedArgs*, const BlockedIO*, void*);
int molann_blocked_launch_v5(const BlockedArgs*, const BlockedIO*, void*);

// The instance for the model: 0 with alignment, 1 without alignment or
// pairs, 2 without alignment with pairs.
static int blocked_shape(const BlockedArgs* m) {
  return blk_aligned(*m) ? 0 : m->n_coord > 0 ? 2 : 1;
}

// What this library was compiled with, for the wrapper to check:
// {COORD_FLOATS, THREADS, sizeof(BlockedArgs), sizeof(BlockedIO),
// GRAD_BLOCKS}. There is no cap on the head's depth.
int molann_blocked_caps(int* out) {
  out[0] = MOLANN_COORD_FLOATS;
  out[1] = MOLANN_BLK_THREADS;
  out[2] = (int)sizeof(BlockedArgs);
  out[3] = (int)sizeof(BlockedIO);
  out[4] = MOLANN_BLK_GRAD_BLOCKS;
  return 0;
}

// Threads of one block for m->frames and m->pitch; kind as below.
int molann_blocked_threads(const BlockedArgs* m, int kind) {
  return (kind & 2) ? blk_grad_threads(*m, (kind & 1) != 0, kind >> 2)
                    : blk_threads(*m, kind != 0);
}

// Dynamic shared memory, in bytes, of one block for m->frames and m->pitch.
// kind: 0 the forward kernel, 1 cv+forces; 2 the backward and train kernels,
// plus 1 when gx is formed, plus 4 times where the running sums live
// (BLK_SUMS_*).
long long molann_blocked_smem_bytes(const BlockedArgs* m, int kind) {
  const int nt = molann_blocked_threads(m, kind);
  const BlkSmem s = (kind & 2) ? blk_grad_smem(*m, nt, (kind & 1) != 0, kind >> 2)
                               : blk_smem(*m, nt, kind != 0);
  return (long long)s.total * (long long)sizeof(float);
}

// Rows of the partials tensor [rows, 1 + G] of the backward and train
// kernels (fused_blocked_grads.cu) for l frames at m->frames frames a tile.
long long molann_blocked_partial_rows(const BlockedArgs* m, long long l) {
  return blk_grad_blocks(*m, l);
}

// y = model(x). Runs on `stream` of CUDA device `device`, allocates nothing,
// returns the launch's cudaGetLastError().
int molann_blocked_forward(const BlockedArgs* m, const BlockedIO* io, int device,
                           void* stream) {
  if (io->l <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  typedef int (*Launcher)(const BlockedArgs*, const BlockedIO*, void*);
  static const Launcher forward[3] = {molann_blocked_launch_v0, molann_blocked_launch_v1,
                                      molann_blocked_launch_v2};
  return forward[blocked_shape(m)](m, io, stream);
}

// y = model(x) and gx = d(sum y or y[:, component])/dx.
int molann_blocked_cv_forces(const BlockedArgs* m, const BlockedIO* io, int device,
                             void* stream) {
  if (io->l <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  typedef int (*Launcher)(const BlockedArgs*, const BlockedIO*, void*);
  static const Launcher forces[3] = {molann_blocked_launch_v3, molann_blocked_launch_v4,
                                     molann_blocked_launch_v5};
  return forces[blocked_shape(m)](m, io, stream);
}

}  // extern "C"

#endif  // MOLANN_VARIANT == 0

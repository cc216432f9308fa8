// The blocked fused kernels for Hopper (sm_90a): a thread block per tile of
// frames, its threads spread over features, pairs and atoms.
//
// Replaces four Pallas TPU kernels of molann_tpu/ops/fused_blocked.py:
//   - _blk_fwd_kernel (:1179, launched from _blk_fwd_impl :1670): values;
//   - _blk_cv_forces_kernel (:1398, launched from blocked_cv_forces :1850):
//     values plus the coordinate gradient of sum(y) or of one component;
//   - _blk_bwd_kernel (:1192, launched from _blk_bwd_impl :1732): the VJP of
//     the forward given gy, that is gx and the gradients of the MLP
//     parameters and of ref_x summed over all frames;
//   - _blk_train_kernel (:1285, launched from blocked_train_grads :1373):
//     the MSE loss over the true frames and its parameter (and, when asked,
//     ref_x) gradients, with no gx. The last two are described further down.
// The block's phases (gathers, feature math, switching sums, QCP alignment,
// the MLP and every hand-derived adjoint) are in blocked_math.cuh.
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
// per 65,536 frames at 67 TFLOP/s). The cv+forces kernel as written does
// more than the function needs, 139 thousand operations a frame for the
// peptide and 1.48 million for the fluid (1.8 and 2.6 times): it gathers
// where it could scatter, see below.
//
// What the design does about it. The one-thread-per-frame design of the
// unrolled kernels does not carry over: the feature vector alone would be
// 1.4 KB of local memory a thread and a pair loop would run serially. Here a
// block stages the coordinates of its tile's active atoms in shared memory
// once ([3 * n_act] rows of `frames` floats, so a frame's atoms are read
// from device memory exactly once, four rows in flight per thread), and then:
//   - thread (feature, frame) gathers its two to four atoms from shared
//     memory and writes the feature's column; index tables are int32 device
//     arrays, read as warp-wide broadcasts when the tile has 32 frames;
//   - thread (pair lane, frame) sums every P-th pair's switching function
//     in order, four pairs in flight, into compensated sums, and one thread
//     per (feature, frame) adds the P partial sums in order. The cut at
//     d_max is taken on the squared distance before any square root, and
//     the square root and the divisions of a pair go to the special-function
//     units, with a Newton step;
//   - the MLP runs on the shared feature columns, thread (frame, output),
//     over weights the wrapper hands over transposed, so that a warp reads
//     one row of them as neighbouring addresses;
//   - for the gradient, the MLP runs backwards in place, and thread (atom,
//     frame) then walks the atom's row of a host-compiled table of every
//     (feature, role) and pair partner that touches it and adds the terms
//     in table order. Nothing is scattered and there is no float atomicAdd:
//     the same inputs give the same bits. A feature's adjoint is computed
//     once per atom of the feature and a pair twice more this way, and no
//     per-edge storage is needed.
// A model without alignment gets a kernel of its own (template kAligned),
// without the QCP solve on 9-tangent duals that would otherwise set every
// phase's register count (64 against 128 for the cv+forces kernel).
// Tile: 32, 16 or 8 frames, the most for which four blocks fit on an SM
// (56 KB of shared memory each), so that one block's barriers are hidden by
// the others; else the most that fit in 227 KB; 256 threads. The ragged last
// block is masked by frame index. Inputs and outputs are addressed through
// strides, so [l, n, 3], [l, 3n], [3n, l] and [3, n, l] are read and written
// in place.
//
// Where the time goes, measured on an H100 80GB HBM3 at 700 W by building
// the kernel to stop after each phase (probes/blocked_probe.py), peptide
// model, 65,536 frames, of 1.77 ms for the cv+forces kernel: staging 0.21 ms,
// features 0.04, the first MLP layer 0.21 (one shared-memory and one cached
// load per multiply-add: the load units, not the arithmetic, are its limit),
// the MLP backwards 0.26 and the gather 1.01 (770 adjoints a frame where 237
// would do). The next steps are a first layer on the tensor cores and a
// gather that computes each feature's adjoint once (features coloured so
// that no two of a colour share an atom add into shared accumulators in a
// fixed order).
//
// Deliberately not carried over from the TPU design: the 0/+-1 edge matrix
// and its 3-pass bf16 split matmul (a thread gathers x[a] directly, in f32,
// for every precision name), the 8-row padding of every segment, d_pad and
// the permutation folded into W1 (item_col holds final columns), the chunk
// matrix C, the windowed matrix CW and their two walks (one int32 pair
// table serves resident and streamed features alike), auto_tile and the
// VMEM cost model, the single-buffered HBM x/gx DMA, and the active-atom
// gather and scatter outside the kernel (the kernel reads x[active[k]] and
// writes zeros for inactive atoms itself).

// The backward and train kernels. What bounds them on this card: the same
// coordinates in, for the backward the same gradient out, plus gy or the
// labels (8 B a frame for the peptide-like model): 7,216 and 3,616 B a
// frame, 0.141 and 0.071 ms per 65,536 frames; the contact model is bound
// by its pairs as above. The parameter gradients add one [32, 355] += [32,
// T] x [T, 355] product a tile (22,720 operations a frame, 1.5 GFLOP a
// batch, 0.02 ms) and leave the card as one row per block.
//
// What the design does about it. The TPU carried the sums over frames in
// its output refs along a sequential grid. Here a launch has a fixed number
// of blocks (MOLANN_BLK_GRAD_BLOCKS, never the card's SM count); block b
// walks tiles b, b + blocks, ... in order and keeps its running sums [loss |
// ref_x | W0 | b0 ...] in shared memory (11,459 floats for the peptide-like
// model, beside the tile's 46 KB: two blocks on an SM), thread t owning
// entries t, t + 256, ... of every tensor: after a tile's MLP has run
// backwards one layer, the thread adds to each of its entries that tile's
// term, a sum over the tile's frames in order (FFMA on the shared feature
// and cotangent rows). At the end the block stores its row of partials (24
// MB for 528 rows of the peptide-like model, against 236 MB of coordinates)
// and reduce_partials adds the rows of each column in a fixed order. No float
// atomics: the same inputs give the same bits, which a resumed training run
// relies on. A model whose sums do not fit in shared memory keeps them in its
// row of partials in device memory instead (acc_global). A model small
// enough for four blocks on an SM gets a kernel capped at 64 registers. The train kernel
// with a frozen ref_x stops after the first layer's parameter gradient: no
// feature adjoint, no dR/dH, no gather.

#include <cuda_runtime.h>

#include "blocked_math.cuh"
#include "reduce_partials.cuh"

namespace {

template <bool kForces, bool kAligned>
__global__ void __launch_bounds__(MOLANN_BLK_THREADS)
blocked_kernel(const BlockedArgs m, const BlockedIO io) {
  extern __shared__ float sm[];
  const int n_phases = blk_n_phases(m, kForces);
  for (int ph = 0; ph < n_phases; ++ph) {
    blk_phase<kForces, kAligned>(m, io, sm, (long long)blockIdx.x, ph, (int)threadIdx.x,
                                 (int)blockDim.x);
    __syncthreads();
  }
}

template <bool kForces, bool kAligned>
int launch_kernel(const BlockedArgs* m, const BlockedIO* io, void* stream) {
  const size_t smem =
      (size_t)blk_smem(*m, MOLANN_BLK_THREADS, kForces).total * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(blocked_kernel<kForces, kAligned>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (io->l + m->frames - 1) / m->frames;
  blocked_kernel<kForces, kAligned><<<(unsigned)blocks, MOLANN_BLK_THREADS, smem,
                                      (cudaStream_t)stream>>>(*m, *io);
  return (int)cudaGetLastError();
}

template <bool kForces>
int launch(const BlockedArgs* m, const BlockedIO* io, int device, void* stream) {
  if (io->l <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return blk_aligned(*m) ? launch_kernel<kForces, true>(m, io, stream)
                         : launch_kernel<kForces, false>(m, io, stream);
}

// kFour: the block's shared memory lets four blocks share an SM, so the
// registers are capped at 64 a thread to let them: the backward kernel of the
// 125-atom, 15,500-pair contact model took 12.7 ms per 65,536 frames that way
// against 17.4 ms, the train kernel 3.85 against 5.61 (H100 80GB HBM3 at 700
// W, probes/blocked_probe.py grads). Else two blocks fit at most, and the cap
// would only add spills (the peptide-like model: 7-10% slower with it).
template <bool kTrain, bool kAligned, bool kFour>
__global__ void __launch_bounds__(MOLANN_BLK_THREADS, kFour ? 4 : 2)
blocked_grads_kernel(const BlockedArgs m, const BlockedIO io, int width) {
  extern __shared__ float sm[];
  const int tid = (int)threadIdx.x, nt = (int)blockDim.x;
  const BlkSmem so = blk_grad_smem(m, nt, io.acc_global != 0);
  float* row = io.partials + (long long)blockIdx.x * width;
  float* acc = io.acc_global ? row : sm + so.acc;
  blk_grad_begin(m, acc, tid, nt);
  __syncthreads();
  const long long tiles = (io.l + m.frames - 1) / m.frames;
  const int n_phases = blk_grad_n_phases(m);
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x)
    for (int ph = 0; ph < n_phases; ++ph) {
      blk_grad_phase<kTrain, kAligned>(m, io, sm, so, acc, tile, ph, tid, nt);
      __syncthreads();
    }
  if (!io.acc_global)
    for (int e = tid; e < width; e += nt) row[e] = acc[e];
}

template <bool kTrain, bool kAligned, bool kFour>
int launch_grads_kernel(const BlockedArgs* m, const BlockedIO* io, float* out, size_t smem,
                        void* stream) {
  cudaError_t err = cudaFuncSetAttribute(blocked_grads_kernel<kTrain, kAligned, kFour>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = blk_grad_blocks(*m, io->l);
  const int width = 1 + blk_grad_size(*m);
  blocked_grads_kernel<kTrain, kAligned, kFour><<<(unsigned)blocks, MOLANN_BLK_THREADS, smem,
                                                  (cudaStream_t)stream>>>(*m, *io, width);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_reduce_partials(io->partials, out, blocks, width, (cudaStream_t)stream);
}

template <bool kTrain>
int launch_grads(const BlockedArgs* m, const BlockedIO* io, float* out, int device,
                 void* stream) {
  if (io->l <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem =
      (size_t)blk_grad_smem(*m, MOLANN_BLK_THREADS, io->acc_global != 0).total * sizeof(float);
  if (blk_aligned(*m)) return launch_grads_kernel<kTrain, true, false>(m, io, out, smem, stream);
  // a quarter of an SM's shared memory, less the kilobyte each block reserves
  return smem <= 56 * 1024 ? launch_grads_kernel<kTrain, false, true>(m, io, out, smem, stream)
                           : launch_grads_kernel<kTrain, false, false>(m, io, out, smem, stream);
}

}  // namespace

extern "C" {

// What this library was compiled with, for the wrapper to check:
// {MAX_LAYERS, COORD_FLOATS, THREADS, sizeof(BlockedArgs), sizeof(BlockedIO),
// GRAD_BLOCKS}.
int molann_blocked_caps(int* out) {
  out[0] = MOLANN_BLK_MAX_LAYERS;
  out[1] = MOLANN_COORD_FLOATS;
  out[2] = MOLANN_BLK_THREADS;
  out[3] = (int)sizeof(BlockedArgs);
  out[4] = (int)sizeof(BlockedIO);
  out[5] = MOLANN_BLK_GRAD_BLOCKS;
  return 0;
}

// Dynamic shared memory, in bytes, of one block for m->frames and m->pitch.
// kind: 0 the forward kernel, 1 cv+forces, 2 backward and train with the
// running sums in shared memory, 3 with the sums in device memory.
long long molann_blocked_smem_bytes(const BlockedArgs* m, int kind) {
  const BlkSmem s = kind >= 2 ? blk_grad_smem(*m, MOLANN_BLK_THREADS, kind == 3)
                              : blk_smem(*m, MOLANN_BLK_THREADS, kind != 0);
  return (long long)s.total * (long long)sizeof(float);
}

// Rows of the partials tensor [rows, 1 + G] of the two kernels below for l
// frames at m->frames frames a tile.
long long molann_blocked_partial_rows(const BlockedArgs* m, long long l) {
  return blk_grad_blocks(*m, l);
}

// y = model(x). Runs on `stream` of CUDA device `device`, allocates nothing,
// returns the launch's cudaGetLastError().
int molann_blocked_forward(const BlockedArgs* m, const BlockedIO* io, int device,
                           void* stream) {
  return launch<false>(m, io, device, stream);
}

// y = model(x) and gx = d(sum y or y[:, component])/dx.
int molann_blocked_cv_forces(const BlockedArgs* m, const BlockedIO* io, int device,
                             void* stream) {
  return launch<true>(m, io, device, stream);
}

// The VJP of the forward: io->gy [l, d_out] -> io->gx (skipped when null) and
// out [1 + G]: out[0] = 0, then G = [ref_x | W0 | b0 ...] summed over the
// frames (its ref_x part zero unless io->want_ref). io->partials is scratch
// of molann_blocked_partial_rows rows.
int molann_blocked_backward(const BlockedArgs* m, const BlockedIO* io, float* out, int device,
                            void* stream) {
  return launch_grads<false>(m, io, out, device, stream);
}

// out [1 + G]: out[0] = sum (y - y_target)^2 * inv_count over the frames,
// then the gradients of that loss; no gx.
int molann_blocked_train(const BlockedArgs* m, const BlockedIO* io, float* out, int device,
                         void* stream) {
  return launch_grads<true>(m, io, out, device, stream);
}

}  // extern "C"

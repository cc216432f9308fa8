// The blocked backward and train kernels for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of molann_tpu/ops/fused_blocked.py:
//   - _blk_bwd_kernel (:1192, launched from _blk_bwd_impl :1732): the VJP of
//     the forward given gy, that is gx and the gradients of the MLP
//     parameters and of ref_x summed over all frames;
//   - _blk_train_kernel (:1285, launched from blocked_train_grads :1373):
//     the MSE loss over the true frames and its parameter (and, when asked,
//     ref_x) gradients, with no gx.
// The forward and cv+forces kernels are in fused_blocked.cu; the steps of a
// tile are in blocked_math.cuh.
//
// What bounds them on this card: the coordinates in, for the backward the
// gradient out, plus gy or the labels (8 B a frame for the peptide-like
// model: 300 atoms, MLP 355 -> 32 -> 2): 7,216 and 3,616 B a frame, 0.141
// and 0.071 ms per 65,536 frames at 3.35 TB/s; the contact model (125 atoms,
// 2 x 7,750 minimum-image pairs) is bound by its pairs' arithmetic, 0.57 and
// 0.40 ms at 67 TFLOP/s. The parameter gradients add one [32, 355] += [32, T]
// x [T, 355] product a tile (22,720 operations a frame, 1.5 GFLOP a batch,
// 0.02 ms) and leave the card as one row per block.
//
// What the design does about it. The TPU carried the sums over frames in
// its output refs along a sequential grid. Here a launch has a fixed number
// of blocks (MOLANN_BLK_GRAD_BLOCKS, never the card's SM count); block b
// walks tiles b, b + blocks, ... in order and keeps its running sums.
//   - The large layer's parameter step runs in rectangles: a thread owns
//     4 x 6 entries of gW (the peptide-like model's [32, 355] cuts into 480
//     of them, for a block of 512 threads), loads the rectangle's 4
//     cotangents and 6 activations of a frame once and does its 24
//     multiply-adds from registers, frame after frame, and adds it to the
//     block's sums once a tile. The other sums [loss | ref_x | small layers
//     | biases] have thread t owning entries t, t + nt, .... The sums live
//     in shared memory; where that gradient would keep the block from
//     fitting twice on an SM it lives in device memory, a thread's rectangle
//     strided by the thread count so that a warp's adds are neighbours; sums
//     too wide for shared memory altogether live in the block's row of
//     partials (BLK_SUMS_* in blocked_math.cuh).
//   - Pairs are walked once per atom (blocked_math.cuh): where gx is wanted
//     every pair is evaluated from both its atoms, s and D_k together, and
//     the gather only multiplies; where nothing below the MLP is wanted
//     (the train kernel with a frozen ref_x) every pair is evaluated once,
//     forward only, and the tile stops after the first layer's parameter
//     step: no feature adjoint, no QCP backward, no gather.
//   - Each bond, angle and dihedral adjoint is computed once and added into
//     per-atom accumulators in shared memory batch by batch.
// At the end the block stores its row of partials and reduce_partials adds
// the rows of each column in a fixed order. No float atomics: the same
// inputs give the same bits, which a resumed training run relies on.
// Measured on an H100 80GB HBM3 at 700 W, 65,536 frames, each kernel alone
// (PERF.md has the steps): the peptide-like model's backward kernel 1.89 ms
// with gx and 0.81 for the parameter sums alone, its train kernel 0.81 ms;
// the contact model's 3.80, 1.68 and 1.69 ms, nine tenths of it the pair
// walk, which the forward and cv+forces kernels share (blocked_math.cuh).
// Instances: with alignment (128 registers, two blocks of 256 threads an
// SM); without, 64 registers, blocks of 512 threads (two an SM) for a block
// past a quarter of an SM's shared memory, else of 256 (four an SM), one
// instance for models without pairs and one with the pair walk.

// Built once per kernel: variant v holds the backward kernel with gx for
// v / 3 == 0, the backward kernel without for 1 and the train kernel for 2;
// v % 3 is 0 with alignment, 1 without alignment or pairs, 2 without
// alignment with pairs (kPairs: the pair walk's kernel). Variant 0 also
// holds the functions the wrapper calls.
// nvcc-variants: MOLANN_VARIANT 9

#include <cuda_runtime.h>

#include "blocked_math.cuh"
#include "reduce_partials.cuh"

#ifndef MOLANN_VARIANT
#error "compile with -DMOLANN_VARIANT=0..8 (ops/_build.py does)"
#endif
#define MOLANN_CAT_(a, b) a##b
#define MOLANN_CAT(a, b) MOLANN_CAT_(a, b)

namespace {

// Without alignment the bounds (512 threads, two blocks an SM) give 64
// registers, as four blocks of 256 would: blocks of 256 threads run the
// same code.
template <bool kTrain, bool kGx, bool kAligned, bool kPairs>
__global__ void __launch_bounds__(kAligned ? MOLANN_BLK_THREADS : MOLANN_BLK_THREADS_WIDE, 2)
blocked_grads_kernel(const BlockedArgs m, const BlockedIO io, int width) {
  extern __shared__ float sm[];
  const int tid = (int)threadIdx.x, nt = (int)blockDim.x;
  float* row = io.partials + (long long)blockIdx.x * width;
  float* acc = io.acc_global == BLK_SUMS_ROW
      ? row : sm + blk_grad_smem(m, nt, kGx, io.acc_global).acc;
  float* rect = io.acc_global == BLK_SUMS_RECT
      ? io.partials + (long long)gridDim.x * width +
            (long long)blockIdx.x * (MOLANN_BLK_RSUM_J * MOLANN_BLK_RSUM_K) * nt
      : nullptr;
  blk_grad_begin(m, io, acc, rect, tid, nt);
  __syncthreads();
  int* steps = reinterpret_cast<int*>(sm);  // its count, then the steps and the layout
  if (tid == 0) {
    steps[0] = blk_build_steps(m, kTrain ? BLK_MODE_TRAIN : BLK_MODE_BACKWARD,
                               blk_grad_adjoint<kGx, kAligned>(io), kGx, nt, steps + 1);
    *blk_layout_slot(sm, m) = blk_grad_smem(m, nt, kGx, io.acc_global);
  }
  __syncthreads();
  const BlkSmem& so = *blk_layout_slot(sm, m);
  const int n_steps = steps[0];
  const long long tiles = (io.l + m.frames - 1) / m.frames;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x)
    for (int i = 0; i < n_steps; ++i) {
      const BlkStep st = blk_step_of(steps[1 + i]);
      const int reps = blk_step_reps(m, st.kind);
      for (int b = 0; b < reps; ++b) {
        blk_grad_phase<kTrain, kGx, kAligned, kPairs>(m, io, sm, so, acc, rect, tile,
                                                      BlkStep{st.kind, reps > 1 ? b : st.arg},
                                                      tid, nt);
        __syncthreads();  // the step's barrier
      }
    }
  blk_grad_end(m, io, acc, rect, row, tid, nt);
}

template <bool kTrain, bool kGx, bool kAligned, bool kPairs>
int launch_grads_kernel(const BlockedArgs* m, const BlockedIO* io, float* out, int nt,
                        size_t smem, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(blocked_grads_kernel<kTrain, kGx, kAligned, kPairs>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = blk_grad_blocks(*m, io->l);
  const int width = 1 + blk_grad_size(*m);
  blocked_grads_kernel<kTrain, kGx, kAligned, kPairs>
      <<<(unsigned)blocks, nt, smem, (cudaStream_t)stream>>>(*m, *io, width);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_reduce_partials(io->partials, out, blocks, width, (cudaStream_t)stream);
}

}  // namespace

// This variant's kernel.
extern "C" int MOLANN_CAT(molann_blocked_grads_v, MOLANN_VARIANT)(
    const BlockedArgs* m, const BlockedIO* io, float* out, int nt, size_t smem,
    void* stream) {
  return launch_grads_kernel<(MOLANN_VARIANT / 3 == 2), (MOLANN_VARIANT / 3 == 0),
                             (MOLANN_VARIANT % 3 == 0), (MOLANN_VARIANT % 3 == 2)>(
      m, io, out, nt, smem, stream);
}

#if MOLANN_VARIANT == 0

extern "C" {
int molann_blocked_grads_v1(const BlockedArgs*, const BlockedIO*, float*, int, size_t, void*);
int molann_blocked_grads_v2(const BlockedArgs*, const BlockedIO*, float*, int, size_t, void*);
int molann_blocked_grads_v3(const BlockedArgs*, const BlockedIO*, float*, int, size_t, void*);
int molann_blocked_grads_v4(const BlockedArgs*, const BlockedIO*, float*, int, size_t, void*);
int molann_blocked_grads_v5(const BlockedArgs*, const BlockedIO*, float*, int, size_t, void*);
int molann_blocked_grads_v6(const BlockedArgs*, const BlockedIO*, float*, int, size_t, void*);
int molann_blocked_grads_v7(const BlockedArgs*, const BlockedIO*, float*, int, size_t, void*);
int molann_blocked_grads_v8(const BlockedArgs*, const BlockedIO*, float*, int, size_t, void*);
}

namespace {

int launch_grads(bool train, const BlockedArgs* m, const BlockedIO* io, float* out, int device,
                 void* stream) {
  if (io->l <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const bool want_gx = !train && io->gx != nullptr;
  const int nt = blk_grad_threads(*m, want_gx, io->acc_global);
  const size_t smem =
      (size_t)blk_grad_smem(*m, nt, want_gx, io->acc_global).total * sizeof(float);
  typedef int (*Launcher)(const BlockedArgs*, const BlockedIO*, float*, int, size_t, void*);
  static const Launcher variants[9] = {
      molann_blocked_grads_v0, molann_blocked_grads_v1, molann_blocked_grads_v2,
      molann_blocked_grads_v3, molann_blocked_grads_v4, molann_blocked_grads_v5,
      molann_blocked_grads_v6, molann_blocked_grads_v7, molann_blocked_grads_v8};
  // with alignment; else without pairs; else the pair walk's kernel
  const int shape = blk_aligned(*m) ? 0 : m->n_coord > 0 ? 2 : 1;
  return variants[3 * (train ? 2 : want_gx ? 0 : 1) + shape](m, io, out, nt, smem, stream);
}

}  // namespace

extern "C" {

// The VJP of the forward: io->gy [l, d_out] -> io->gx (skipped when null) and
// out [1 + G]: out[0] = 0, then G = [ref_x | W0 | b0 ...] summed over the
// frames (its ref_x part zero unless io->want_ref). io->partials is scratch
// of molann_blocked_partial_rows rows and, with BLK_SUMS_RECT, 24 floats a
// thread of every block behind them.
int molann_blocked_backward(const BlockedArgs* m, const BlockedIO* io, float* out, int device,
                            void* stream) {
  return launch_grads(false, m, io, out, device, stream);
}

// out [1 + G]: out[0] = sum (y - y_target)^2 * inv_count over the frames,
// then the gradients of that loss; no gx.
int molann_blocked_train(const BlockedArgs* m, const BlockedIO* io, float* out, int device,
                         void* stream) {
  return launch_grads(true, m, io, out, device, stream);
}

}  // extern "C"

#endif  // MOLANN_VARIANT == 0

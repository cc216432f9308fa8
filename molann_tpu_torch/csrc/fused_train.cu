// The unrolled fused training kernels for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of molann_tpu/ops/fused.py:
//   - _bwd_kernel (:586, launched from _bwd_impl :720), K2: the VJP of the
//     forward given gy, i.e. gx and the gradients of the MLP parameters and
//     of ref_x summed over all frames;
//   - _train_kernel (:900, launched from fused_train_grads :1076), K3: the
//     MSE loss over the true frames and its parameter (and, with train_ref,
//     ref_x) gradients, with no gx.
// The steps are in frame_math.cuh.
//
// What bounds it on this card. Per alanine frame (22 atoms, MLP 38 -> 5 ->
// 3) K2 reads 66 + 3 f32 and writes 66 (540 B), K3 reads 66 + 3 (276 B):
// some 0.1-0.2 ms per million frames at 3.35 TB/s. Each frame is a long
// serial scalar chain: K1's forward, then for K2 K4's adjoint (QCP's
// included), for K3 with train_ref=False only the MLP's backward; then the
// sums over frames of 223 entries (the loss, 9 of ref_x, 213 parameters).
// The first version (PR 2) ran a thread per frame with the frame's arrays
// sized by the compile-time envelope in local memory (5 KB of stack a
// thread, so the state lived in L2) and summed every entry over each warp
// with a five-step shuffle tree as the VJP produced it, one row of partials
// a warp.
//
// What the design does about it. A thread still owns a frame for its serial
// chain, but the frame's state is in the block's shared memory, rows with
// the frame index fastest, sized by the model at launch (unr_smem): no
// stack. The MLP runs backwards per frame into rows of cotangents, and the
// parameter gradients are block products over the block's frames
// (unr_param_sums: gW = dz a^T, 2 x 2 entries a thread from shared memory),
// one row of partials a block, written in full by the block. The TPU carried
// the sums over frames in its output refs along a sequential grid; Hopper
// runs blocks in no order, so reduce_partials (reduce_partials.cuh) then
// sums every column over the rows in a fixed order. No float atomics: the
// same inputs give the same bits on every launch, which a resumed training
// run relies on. The backward with gx, the backward without it and the train
// kernel are three instances, so that the ones without gx carry none of its
// registers.

#include <cuda_runtime.h>

#include "frame_math.cuh"
#include "reduce_partials.cuh"

namespace {

// kTrain = false: K2, aux = gy; kGx: it forms gx. kTrain = true: K3.
// Two threads a frame: thread t takes frame t mod F, half t / F. At most
// 128 registers, so that four blocks of 64 frames share an SM, as their
// shared memory allows (left to itself the backward with gx took 170
// registers and ran 0.256 ms on alanine against 0.148 with one thread a
// frame).
template <bool kTrain, bool kGx>
__global__ void __launch_bounds__(2 * MOLANN_UNR_MAX_FRAMES, 4)
fused_grads_kernel(const ModelArgs m, const UnrIO io) {
  extern __shared__ float sm[];
  constexpr int kMode = kTrain ? UNR_TRAIN : UNR_BACKWARD;
  const bool want_ref = io.want_ref && needs_alignment(m);
  const UnrSmem so = unr_smem(m, kMode, kGx, want_ref, io.pitch);
  const int t = threadIdx.x, nt = blockDim.x, f = t % io.frames, h = t / io.frames;
  unr_load<kGx>(m, io, sm, so, blockIdx.x, t, nt);
  __syncthreads();
  unr_feat<kGx>(m, io, sm, so, f, h);
  for (int L = 0; L < m.n_layers; ++L) {
    __syncthreads();
    unr_mlp<kMode>(m, io, sm, so, L, f, h);
  }
  __syncthreads();
  unr_seed<kMode>(m, io, sm, so, blockIdx.x, f, h);
  for (int L = m.n_layers - 1; L > 0; --L) {
    __syncthreads();
    unr_bwd(m, io, sm, so, L, f, h);
  }
  __syncthreads();
  unr_param_sums(m, io, sm, so, blockIdx.x, kMode, want_ref, t, nt);
  if (!kGx && !want_ref) return;
  __syncthreads();  // the column cotangents overwrite the columns the sums read
  unr_dcol(m, io, sm, so, f, h);
  __syncthreads();
  UnrAlignAdj a;
  unr_adj_a<kGx>(m, io, sm, so, f, h, want_ref, a);
  __syncthreads();
  unr_adj_b<kGx>(m, io, sm, so, f, h, a);
  __syncthreads();
  unr_finish<kGx>(m, io, sm, so, blockIdx.x, want_ref, t, nt);
}

template <bool kTrain, bool kGx>
cudaError_t launch(const ModelArgs& m, const UnrIO& io, float* out, cudaStream_t s) {
  const long long blocks = (io.l + io.frames - 1) / io.frames;
  cudaError_t err = unr_launch(fused_grads_kernel<kTrain, kGx>, m, io,
                               kTrain ? UNR_TRAIN : UNR_BACKWARD, kGx, blocks, s);
  if (err != cudaSuccess) return err;
  return launch_reduce_partials(io.partials, out, blocks, 1 + model_grad_size(m), s);
}

}  // namespace

extern "C" {

// Frames a block of the backward (train = 0, with or without gx) or train
// kernel takes for this model, with or without the ref_x gradient
// (unr_choose_frames): the partials need ceil(l / frames) rows of 1 + G
// floats. 0 when a frame's state does not fit.
int molann_grads_frames(const ModelArgs* m, int train, int gx, int ref) {
  return unr_choose_frames(*m, train ? UNR_TRAIN : UNR_BACKWARD, !train && gx,
                           ref && needs_alignment(*m));
}

// K2 (train = 0): x [l, 3n], gy [l, d_out] -> gx [l, 3n] where io->gx is
// set, and out [1 + G]: out[0] = 0, then G summed over the frames (its ref_x
// part zero unless io->want_ref). K3 (train = 1): x and y_target in either
// layout (io->in_t) -> out[0] = sum (y - t)^2 * inv_count, then the
// gradients of that loss. io->partials is scratch of ceil(l / io->frames)
// rows. m must be the atom form of the model's tables (slot_col unset): the
// slot form gives cudaErrorInvalidValue.
int molann_fused_grads(const ModelArgs* m, const UnrIO* io, int train, float* out,
                       int device, void* stream) {
  if (m->slot_col) return (int)cudaErrorInvalidValue;
  if (io->l <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (train) err = launch<true, false>(*m, *io, out, s);
  else if (io->gx) err = launch<false, true>(*m, *io, out, s);
  else err = launch<false, false>(*m, *io, out, s);
  return (int)err;
}

}  // extern "C"

// The unrolled fused serving kernels for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of molann_tpu/ops/fused.py:
//   - _fwd_kernel (:578, launched from _fwd_impl :681), K1: values only;
//   - _cv_forces_kernel (:1116, launched from fused_cv_forces :1340), K4:
//     values plus the coordinate gradient of sum(y) or of one component.
// The steps (per-frame QCP alignment, features, MLP and their adjoints,
// with the frame's state in shared memory) are in frame_math.cuh.
//
// What bounds it on this card. For the alanine model (22 atoms, 38 feature
// columns, MLP 38 -> 5 -> 3) the cv+forces op moves 540 B per frame from and
// to device memory (66 f32 in, 66 + 3 f32 out): ~0.16 ms per million frames
// at 3.35 TB/s. Its arithmetic is a long serial scalar chain per frame (12
// Newton steps, the 4x4 adjugate and its reverse pass, ~40 features and
// their adjoints), a few thousand FP32 operations. Measured on an H100 80GB
// HBM3 at 700 W, the first version (one thread per frame, the frame's arrays
// sized by the compile-time envelope in local memory, QCP's Jacobian by
// 9-tangent duals: 128 registers and 5 KB of stack a thread) reached ~6% of
// the DRAM bound: the chain bound it, not DRAM. The TPU design folded frames into
// (8, 128) vector tiles and baked the index tables in as immediates;
// neither carries over.
//
// What the design does about it. One thread still owns one frame, so the
// serial chain needs no cross-thread communication and the index tables are
// warp-uniform broadcast loads; but everything the frame keeps (its
// coordinates, feature columns, layer outputs and cotangents, its gradient)
// lives in the block's shared memory as rows with the frame index fastest,
// sized by the model at launch (unr_smem), so no thread has a stack; QCP's
// adjoint is a reverse pass (qcp_rotation_vjp) on registers. The
// block stages its frames with coalesced loads on both layouts and writes
// the gradient back the same way. A block takes 128 frames, or 64 or 32
// where two such blocks would not share an SM (unr_choose_frames). The
// ragged last block repeats its last frame and stores only its true frames.
// A coordination feature (at most 96 pairs in this family's envelope) is a
// loop over its pair table in the thread, in table order.

#include <cuda_runtime.h>

#include "frame_math.cuh"

namespace {

// Two threads a frame: thread t takes frame t mod F, half t / F. At most
// 128 registers, so that four blocks of 64 frames share an SM, as their
// shared memory allows (left to itself the backward with gx took 170
// registers and ran 0.256 ms on alanine against 0.148 with one thread a
// frame).
template <bool kForces>
__global__ void __launch_bounds__(2 * MOLANN_UNR_MAX_FRAMES, 4)
fused_unrolled_kernel(const ModelArgs m, const UnrIO io) {
  extern __shared__ float sm[];
  constexpr int kMode = kForces ? UNR_FORCES : UNR_FORWARD;
  const UnrSmem so = unr_smem(m, kMode, kForces, false, io.pitch);
  const int t = threadIdx.x, nt = blockDim.x, f = t % io.frames, h = t / io.frames;
  unr_load<kForces>(m, io, sm, so, blockIdx.x, t, nt);
  __syncthreads();
  unr_feat<kForces>(m, io, sm, so, f, h);
  for (int L = 0; L < m.n_layers; ++L) {
    __syncthreads();
    unr_mlp<kMode>(m, io, sm, so, L, f, h);
  }
  __syncthreads();
  unr_seed<kMode>(m, io, sm, so, blockIdx.x, f, h);
  if (!kForces) return;
  for (int L = m.n_layers - 1; L > 0; --L) {
    __syncthreads();
    unr_bwd(m, io, sm, so, L, f, h);
  }
  __syncthreads();
  unr_dcol(m, io, sm, so, f, h);
  __syncthreads();
  UnrAlignAdj a;
  unr_adj_a<true>(m, io, sm, so, f, h, false, a);
  __syncthreads();
  unr_adj_b<true>(m, io, sm, so, f, h, a);
  __syncthreads();
  unr_finish<true>(m, io, sm, so, blockIdx.x, false, t, nt);
}

}  // namespace

extern "C" {

// The envelope and struct sizes this library was compiled with, for the
// wrapper to check: {MAX_ATOMS, MAX_COLS, MAX_WIDTH, MAX_LAYERS,
// sizeof(ModelArgs), sizeof(UnrIO)}.
int molann_caps(int* out) {
  out[0] = MOLANN_MAX_ATOMS;
  out[1] = MOLANN_MAX_COLS;
  out[2] = MOLANN_MAX_WIDTH;
  out[3] = MOLANN_MAX_LAYERS;
  out[4] = (int)sizeof(ModelArgs);
  out[5] = (int)sizeof(UnrIO);
  return 0;
}

// Frames a block of the forward (forces = 0) or cv+forces kernel takes for
// this model (unr_choose_frames); 0 when its state does not fit.
int molann_fused_frames(const ModelArgs* m, int forces) {
  return forces ? unr_choose_frames(*m, UNR_FORCES, true, false)
                : unr_choose_frames(*m, UNR_FORWARD, false, false);
}

// y = model(x) and, with forces, gx = d(sum y or y[:, component])/dx, as
// UnrIO lays them out, io->frames frames a block (molann_fused_frames).
// Runs on `stream` of CUDA device `device`, allocates nothing, returns
// cudaGetLastError() of the launch.
int molann_fused_forward(const ModelArgs* m, const UnrIO* io, int forces, int device,
                         void* stream) {
  if (io->l <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (io->l + io->frames - 1) / io->frames;
  cudaStream_t s = (cudaStream_t)stream;
  err = forces ? unr_launch(fused_unrolled_kernel<true>, *m, *io, UNR_FORCES, true, blocks, s)
               : unr_launch(fused_unrolled_kernel<false>, *m, *io, UNR_FORWARD, false, blocks, s);
  return (int)err;
}

}  // extern "C"

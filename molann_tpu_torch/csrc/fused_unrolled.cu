// The unrolled fused serving kernels for Hopper (sm_90a), one thread per frame.
//
// Replaces two Pallas TPU kernels of molann_tpu/ops/fused.py:
//   - _fwd_kernel (:578, launched from _fwd_impl :681): values only;
//   - _cv_forces_kernel (:1116, launched from fused_cv_forces :1340): values
//     plus the coordinate gradient of sum(y) or of one component.
// The per-frame math (QCP alignment, features, MLP and their adjoints) is in
// frame_math.cuh.
//
// What bounds it on this card. For the alanine model (22 atoms, 38 feature
// columns, MLP 38 -> 5 -> 3) the cv+forces op moves 540 B per frame from and
// to device memory (66 f32 in, 66 + 3 f32 out): ~0.16 ms per million frames
// at 3.35 TB/s. Its arithmetic is a long serial scalar chain per frame (12
// Newton steps, the 4x4 adjugate carried with 9 tangents, ~40 features and
// their adjoints), a few thousand FP32 operations. Measured on an H100 80GB
// HBM3 at 700 W, the cv+forces kernel reaches ~6% of the DRAM bound, so
// DRAM does not bound it; what does is occupancy (168 registers, 3 blocks
// of 128 per SM) or the per-thread arrays in local memory, not yet told
// apart. The TPU design folded
// frames into (8, 128) vector tiles and baked the index tables in as
// immediates; neither carries over.
//
// What the design does about it. One thread owns one frame, so the serial
// chain needs no cross-thread communication and the index tables are
// warp-uniform broadcast loads. On the frame-major layouts ([l, 3n]) the
// block first copies its contiguous [F, 3n] slab into shared memory with
// coalesced loads, and the gradient goes back the same way; on the
// transposed layout ([3n, l]) neighbouring threads already touch
// neighbouring addresses. The ragged last block is masked by frame index, so
// no padding is needed. A coordination feature (at most 96 pairs in this
// family's envelope) is a loop over its pair table in the thread, in table
// order, forward and adjoint. Per-frame arrays are sized by the compile-time
// envelope (MOLANN_MAX_*), and live in local memory where the tables index
// them. This is the simple, right first version: it is not tuned.

#include <cuda_runtime.h>

#include "frame_math.cuh"

namespace {

constexpr int kMaxOut = MOLANN_MAX_COLS;  // widest model output (no MLP)

template <bool kForces>
__global__ void __launch_bounds__(128)
fused_unrolled_kernel(const ModelArgs m, const float* __restrict__ x,
                      float* __restrict__ y, float* __restrict__ gx,
                      long long l, int in_t, int out_t, int component) {
  extern __shared__ float slab[];
  const int n3 = 3 * m.n_atoms;
  const long long f0 = (long long)blockIdx.x * blockDim.x;
  const long long left = l - f0;
  const int nf = left < (long long)blockDim.x ? (int)left : (int)blockDim.x;
  const int t = threadIdx.x;
  const long long f = f0 + t;
  const bool live = t < nf;

  float xs[3 * MOLANN_MAX_ATOMS];
  if (!in_t) {
    const float* src = x + f0 * n3;
    for (int k = t; k < nf * n3; k += blockDim.x) slab[k] = src[k];
    __syncthreads();
    if (live)
      for (int k = 0; k < n3; ++k) xs[k] = slab[t * n3 + k];
  } else if (live) {
    for (int k = 0; k < n3; ++k) xs[k] = x[(long long)k * l + f];
  }

  float yv[kMaxOut];
  float g[3 * MOLANN_MAX_ATOMS];
  if (live) {
    if (kForces)
      frame_cv_forces(m, xs, yv, g, component);
    else
      frame_forward(m, xs, yv);
    const int d_out = model_out_dim(m);
    if (!out_t)
      for (int j = 0; j < d_out; ++j) y[f * d_out + j] = yv[j];
    else
      for (int j = 0; j < d_out; ++j) y[(long long)j * l + f] = yv[j];
  }
  if (!kForces) return;
  if (!out_t) {
    __syncthreads();  // every thread has read its row of the input slab
    if (live)
      for (int k = 0; k < n3; ++k) slab[t * n3 + k] = g[k];
    __syncthreads();
    float* dst = gx + f0 * n3;
    for (int k = t; k < nf * n3; k += blockDim.x) dst[k] = slab[k];
  } else if (live) {
    for (int k = 0; k < n3; ++k) gx[(long long)k * l + f] = g[k];
  }
}

template <bool kForces>
int launch(const ModelArgs* m, const float* x, float* y, float* gx, long long l,
           int in_t, int out_t, int component, int device, void* stream) {
  if (l <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int n3 = 3 * m->n_atoms;
  const int threads = frames_per_block(n3);
  const long long blocks = (l + threads - 1) / threads;
  const bool staged = !in_t || (kForces && !out_t);
  const size_t smem = staged ? (size_t)threads * n3 * sizeof(float) : 0;
  fused_unrolled_kernel<kForces><<<(unsigned)blocks, threads, smem,
                                   (cudaStream_t)stream>>>(
      *m, x, y, gx, l, in_t, out_t, component);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The envelope this library was compiled with, for the wrapper to check:
// {MAX_ATOMS, MAX_COLS, MAX_WIDTH, MAX_LAYERS, sizeof(ModelArgs)}.
int molann_caps(int* out) {
  out[0] = MOLANN_MAX_ATOMS;
  out[1] = MOLANN_MAX_COLS;
  out[2] = MOLANN_MAX_WIDTH;
  out[3] = MOLANN_MAX_LAYERS;
  out[4] = (int)sizeof(ModelArgs);
  return 0;
}

// y = model(x). in_t: x is [3n, l] (else [l, 3n]); out_t: y is [d_out, l]
// (else [l, d_out]). Runs on `stream` of CUDA device `device`, allocates
// nothing, returns cudaGetLastError() of the launch.
int molann_fused_forward(const ModelArgs* m, const float* x, float* y,
                         long long l, int in_t, int out_t, int device,
                         void* stream) {
  return launch<false>(m, x, y, nullptr, l, in_t, out_t, -1, device, stream);
}

// y = model(x) and gx = d(sum y or y[:, component])/dx; component < 0 means
// the sum. gx has the layout of y's frames (out_t) with 3n rows/columns.
int molann_fused_cv_forces(const ModelArgs* m, const float* x, float* y,
                           float* gx, long long l, int in_t, int out_t,
                           int component, int device, void* stream) {
  return launch<true>(m, x, y, gx, l, in_t, out_t, component, device, stream);
}

}  // extern "C"

// The unrolled fused training kernels for Hopper (sm_90a), one thread per frame.
//
// Replaces two Pallas TPU kernels of molann_tpu/ops/fused.py:
//   - _bwd_kernel (:586, launched from _bwd_impl :720), K2: the VJP of the
//     forward given gy, i.e. gx and the gradients of the MLP parameters and
//     of ref_x summed over all frames;
//   - _train_kernel (:900, launched from fused_train_grads :1076), K3: the
//     MSE loss over the true frames and its parameter (and, with train_ref,
//     ref_x) gradients, with no gx.
// The per-frame math (forward state, per-frame VJP, MSE cotangent) is in
// frame_math.cuh.
//
// What bounds it on this card. Per alanine frame (22 atoms, MLP 38 -> 5 ->
// 3) K2 reads 66 + 3 f32 and writes 66 (540 B), K3 reads 66 + 3 (276 B):
// some 0.1-0.2 ms per million frames at 3.35 TB/s. Each thread runs a long
// serial scalar chain: K1's forward, then for K2 K4's adjoint (QCP by
// Dual9 included), for K3 with train_ref=False only the MLP's backward. On
// top of that come the sums over frames: 223 entries per frame (the loss,
// 9 of ref_x, 213 parameters), each summed over the warp by a five-step
// shuffle tree. So, as for K4, the chain and the occupancy its registers
// allow bound the kernels, not DRAM.
//
// What the design does about it. One thread owns one frame, as in K1 and
// K4, with the same shared-memory staging of frame-major slabs. The TPU
// carried the sums over frames in its output refs along a sequential grid;
// Hopper runs blocks in no order. So the sum has two fixed-order passes
// and no atomics: each warp sums its 32 frames' terms of every entry with
// a shuffle tree and its lane 0 stores them as the warp's row of a
// partials tensor that the wrapper allocates; reduce_partials
// (reduce_partials.cuh) then sums every column over the rows in a fixed
// order. The same inputs give the same bits on every launch, which a
// resumed training run relies on. No
// thread keeps an array of parameter gradients (18.7K entries at the
// envelope): frame_vjp hands each term to the warp sum as it produces it.
// Lanes past the last frame recompute the block's last frame, like the
// TPU's edge padding, and their terms are masked to zero. This is the
// simple, right first version: it is not tuned.

#include <cuda_runtime.h>

#include "frame_math.cuh"
#include "reduce_partials.cuh"

namespace {

// Sums a gradient term over the warp's 32 frames by a fixed shuffle tree;
// lane 0 stores the sum at row[k]. Every lane must call it, in the same
// order: frame_vjp's control flow depends on the model only.
struct WarpSink {
  float* row;
  bool live;
  int lane;
  __host__ __device__ void operator()(int k, float v) const {
#ifdef __CUDA_ARCH__
    v = live ? v : 0.f;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0) row[k] = v;
#endif
  }
};

// One row of partials per warp: [loss | G], G as in frame_vjp.
inline int partial_width(const ModelArgs& m) { return 1 + model_grad_size(m); }

// kTrain = false: K2, aux = gy [l, d_out], x frame-major; gx may be null.
// kTrain = true: K3, aux = y_target ([l, d] or, with in_t, [d, l]); no gx.
template <bool kTrain>
__global__ void __launch_bounds__(128)
fused_grads_kernel(const ModelArgs m, const float* __restrict__ x,
                   const float* __restrict__ aux, float* __restrict__ gx,
                   float* __restrict__ partials, int width, long long l,
                   int in_t, float inv_count, int want_ref) {
  extern __shared__ float slab[];
  const int n3 = 3 * m.n_atoms;
  const long long f0 = (long long)blockIdx.x * blockDim.x;
  const long long left = l - f0;
  const int nf = left < (long long)blockDim.x ? (int)left : (int)blockDim.x;
  const int t = threadIdx.x;
  const bool live = t < nf;
  const int r = live ? t : nf - 1;  // dead lanes redo the last frame
  const long long f = f0 + r;
  const int d_out = model_out_dim(m);

  float xs[3 * MOLANN_MAX_ATOMS];
  if (!in_t) {
    const float* src = x + f0 * n3;
    for (int k = t; k < nf * n3; k += blockDim.x) slab[k] = src[k];
    __syncthreads();
    for (int k = 0; k < n3; ++k) xs[k] = slab[r * n3 + k];
  } else {
    for (int k = 0; k < n3; ++k) xs[k] = x[(long long)k * l + f];
  }

  FrameFwd st;
  const float* y = frame_fwd(m, xs, gx != nullptr || want_ref, st);
  float ga[MOLANN_MAX_COLS];
  float loss = 0.f;
  if (kTrain) {
    float tv[MOLANN_MAX_COLS];
    for (int j = 0; j < d_out; ++j)
      tv[j] = in_t ? aux[(long long)j * l + f] : aux[f * d_out + j];
    loss = mse_cotangent(y, tv, d_out, inv_count, ga);
  } else {
    for (int j = 0; j < d_out; ++j) ga[j] = aux[f * d_out + j];
  }

  const int lane = t & 31;
  float* row = partials +
               ((long long)blockIdx.x * (blockDim.x >> 5) + (t >> 5)) * width;
  WarpSink sink{row + 1, live, lane};
  sink(-1, loss);
  if (lane == 0)  // ref_x entries that frame_vjp does not produce
    for (int k = 0; k < 3 * m.n_align; ++k) row[1 + k] = 0.f;
  float g[3 * MOLANN_MAX_ATOMS];
  frame_vjp(m, xs, st, ga, gx != nullptr ? g : nullptr, want_ref != 0, sink);
  if (gx == nullptr) return;

  __syncthreads();  // every thread has read its row of the input slab
  if (live)
    for (int k = 0; k < n3; ++k) slab[t * n3 + k] = g[k];
  __syncthreads();
  float* dst = gx + f0 * n3;
  for (int k = t; k < nf * n3; k += blockDim.x) dst[k] = slab[k];
}

inline long long partial_rows(int n3, long long l) {
  const int threads = frames_per_block(n3);
  return (l + threads - 1) / threads * (threads / 32);
}

template <bool kTrain>
int launch(const ModelArgs* m, const float* x, const float* aux, float* gx,
           float* partials, float* out, long long l, int in_t,
           float inv_count, int want_ref, int device, void* stream) {
  if (l <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int n3 = 3 * m->n_atoms;
  const int threads = frames_per_block(n3);
  const long long blocks = (l + threads - 1) / threads;
  const int width = partial_width(*m);
  const size_t smem = in_t ? 0 : (size_t)threads * n3 * sizeof(float);
  cudaStream_t s = (cudaStream_t)stream;
  fused_grads_kernel<kTrain><<<(unsigned)blocks, threads, smem, s>>>(
      *m, x, aux, gx, partials, width, l, in_t, inv_count, want_ref);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_reduce_partials(partials, out, partial_rows(n3, l), width, s);
}

}  // namespace

extern "C" {

// Rows of the partials tensor [rows, 1 + G] that the two kernels below
// need for l frames of n_atoms atoms.
long long molann_partial_rows(int n_atoms, long long l) {
  return partial_rows(3 * n_atoms, l);
}

// K2. x [l, 3n], gy [l, d_out] -> gx [l, 3n] (skipped when gx is null) and
// out [1 + G]: out[0] = 0, then G summed over the frames (its ref_x part
// zero unless want_ref). partials is scratch of molann_partial_rows rows.
int molann_fused_backward(const ModelArgs* m, const float* x, const float* gy,
                          float* gx, float* partials, float* out, long long l,
                          int want_ref, int device, void* stream) {
  return launch<false>(m, x, gy, gx, partials, out, l, 0, 0.f, want_ref,
                       device, stream);
}

// K3. x [l, 3n] and y_target [l, d_out], or with in_t [3n, l] and
// [d_out, l] -> out [1 + G]: out[0] = sum (y - t)^2 * inv_count, then the
// gradients of that loss (the ref_x part zero unless want_ref).
int molann_fused_train(const ModelArgs* m, const float* x, const float* yt,
                       float* partials, float* out, long long l, int in_t,
                       float inv_count, int want_ref, int device,
                       void* stream) {
  return launch<true>(m, x, yt, nullptr, partials, out, l, in_t, inv_count,
                      want_ref, device, stream);
}

}  // extern "C"

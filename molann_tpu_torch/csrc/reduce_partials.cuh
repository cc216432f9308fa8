// The second pass of every sum over frames: the kernels that sum gradient
// terms over frames (fused_train.cu, fused_blocked.cu) write one row of
// partial sums per warp or per block, and reduce_partials adds the rows of
// every column in a fixed order. No float atomics anywhere, so the same
// inputs give the same bits on every launch, which a resumed training run
// relies on. reduce_rows also compiles with a host C++ compiler, for the CPU
// test that walks the sum in the kernel's order
// (tests/test_torch_port_blocked_math.py).
#pragma once

#ifndef __CUDACC__
#define __host__
#define __device__
#define __forceinline__ inline
#endif

#define MOLANN_REDUCE_LANES 32  // partial sums per column before the last pass

// The sum of rows y, y + MOLANN_REDUCE_LANES, ... of column c.
__host__ __device__ __forceinline__ float reduce_rows(const float* partials, long long rows,
                                                      int width, int c, int y) {
  float acc = 0.f;
  for (long long r = y; r < rows; r += MOLANN_REDUCE_LANES) acc += partials[r * width + c];
  return acc;
}

#ifdef __CUDACC__
namespace {

// out[c] = sum of partials[:, c]: thread (x, y) sums rows y, y + 32, ... of
// column 32 * blockIdx.x + x, then thread (x, 0) adds the 32 sums in the
// order of y.
__global__ void __launch_bounds__(32 * MOLANN_REDUCE_LANES)
reduce_partials(const float* __restrict__ partials, float* __restrict__ out,
                long long rows, int width) {
  __shared__ float s[MOLANN_REDUCE_LANES][33];
  const int c = blockIdx.x * 32 + threadIdx.x;
  s[threadIdx.y][threadIdx.x] = c < width ? reduce_rows(partials, rows, width, c, threadIdx.y) : 0.f;
  __syncthreads();
  if (threadIdx.y == 0 && c < width) {
    float tot = s[0][threadIdx.x];
    for (int y = 1; y < MOLANN_REDUCE_LANES; ++y) tot += s[y][threadIdx.x];
    out[c] = tot;
  }
}

inline cudaError_t launch_reduce_partials(const float* partials, float* out, long long rows,
                                          int width, cudaStream_t stream) {
  reduce_partials<<<(width + 31) / 32, dim3(32, MOLANN_REDUCE_LANES), 0, stream>>>(
      partials, out, rows, width);
  return cudaGetLastError();
}

}  // namespace
#endif

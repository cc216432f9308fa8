// The edge product D @ x of the blocked formulation, as a probe on Hopper's
// tensor cores (sm_90a).
//
// Replaces the Pallas TPU probe kernel of scripts/int8_mm_probe.py
// (make_kernel :70, pallas_call :75): out [M, N] = D [M, K] @ x [K, N] with D
// exactly 0/+-1 (an edge matrix: a row of D @ x is x[j] - x[i], or +-x[i]),
// in the six bodies of the original and a seventh:
//   f32     plain f32 multiply-adds (the original's Precision.HIGHEST);
//   bf16    one bf16 pass (:113-116);
//   int8    one int8 pass on x / 256 rounded and clipped (:118-123);
//   split3  x = hi + mid + lo in bf16, three bf16 passes added lo, mid, hi
//           (:127-137, the same as fused_blocked._split3_mm :112);
//   fixed4  x * 2^19 rounded to int32 and cut into four signed int8 digits,
//           four int8 passes recombined in f32 (:152-164);
//   fixed2  x * 2^9, two digits (:168-184);
//   gather  no product at all: each output row adds +-x[col] for the row's
//           nonzero columns, read through an int32 table. This is what the
//           blocked kernels do (blocked_math.cuh gathers x[a] directly).
// The TPU probe asked whether int8 passes beat the bf16 split on the MXU.
// Here the question is whether any tensor-core form of the edge product
// beats the direct gather.
//
// What bounds it on this card. At the probe's shapes (M 552, K 304, N
// 32,768) the function reads 40 MB of x and writes 72 MB: 0.034 ms at 3.35
// TB/s. The dense product is 11 GFLOP: 0.011 ms for one bf16 pass at 989
// TFLOP/s, 0.006 ms for one int8 pass at 1,979 TOP/s, 0.16 ms in f32 at 67
// TFLOP/s; so bytes bound every tensor-core body and operations the f32 one.
// The gather adds 5,041 values a column (the nonzeros of D at 1% density):
// bytes again.
//
// What the design does about it: little, on purpose, this is a probe. A
// block owns a strip of 64 columns of x; it converts the strip once into
// shared memory in the body's operand type, as 16 x 16 tiles (the
// quantisation and the digit split happen here, inside the kernel, as in the
// original), and its four warps then walk the 16-row tiles of D, one
// mma.sync tile product (nvcuda::wmma m16n16k16, bf16 -> f32 or s8 -> s32)
// per 16 x 16 x 16 step. D is converted once per call by a small kernel of
// its own into bf16 and int8 tiles, zero-padded to multiples of 16. Every
// tile is contiguous (leading dimension 16), so that every fragment pointer
// is 32-byte aligned. Accumulators go through a per-warp staging tile in
// shared memory, where the digits are recombined and the rows past M are
// dropped. wgmma, TMA and fp8 are left for later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using namespace nvcuda;

constexpr int kStrip = 64;         // columns of x per block
constexpr int kStripTiles = 4;     // 16-column tiles per strip
constexpr int kWarps = 4;
constexpr int kTile = 256;         // elements of a 16 x 16 tile

enum { EMM_F32 = 0, EMM_BF16 = 1, EMM_INT8 = 2, EMM_SPLIT3 = 3, EMM_FIXED4 = 4,
       EMM_FIXED2 = 5, EMM_GATHER = 6 };

// D [M, K] f32 -> bf16 and int8 tiles [Mt][Kt][16][16], zero past M and K.
__global__ void __launch_bounds__(256)
edge_mm_prepare(const float* __restrict__ D, int M, int K, int Mt, int Kt,
                __nv_bfloat16* __restrict__ Db, signed char* __restrict__ Di) {
  const long long total = (long long)Mt * Kt * kTile;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (long long)gridDim.x * blockDim.x) {
    const int in = (int)(e % kTile);
    const long long t = e / kTile;
    const int kt = (int)(t % Kt), mt = (int)(t / Kt);
    const int m = mt * 16 + in / 16, k = kt * 16 + in % 16;
    const float v = (m < M && k < K) ? D[(long long)m * K + k] : 0.f;
    Db[e] = __float2bfloat16_rn(v);
    Di[e] = (signed char)__float2int_rn(v);
  }
}

// Offset of element (k, c) of pass p in the strip's shared tiles.
__device__ __forceinline__ int strip_at(int p, int Kt, int k, int c) {
  return ((p * Kt + k / 16) * kStripTiles + c / 16) * kTile + (k % 16) * 16 + c % 16;
}

// kPasses = 1: one bf16 pass. kPasses = 3: the split, passes lo, mid, hi.
template <int kPasses>
__global__ void __launch_bounds__(32 * kWarps)
edge_mm_bf16_kernel(const __nv_bfloat16* __restrict__ Db, const float* __restrict__ x,
                    float* __restrict__ out, int M, int K, long long N, int Mt, int Kt) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* Bs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  float* stage = reinterpret_cast<float*>(Bs + kPasses * Kt * kStripTiles * kTile);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long n0 = (long long)blockIdx.x * kStrip;

  for (int e = tid; e < Kt * 16 * kStrip; e += blockDim.x) {
    const int k = e / kStrip, c = e % kStrip;
    const float v = k < K ? x[(long long)k * N + n0 + c] : 0.f;
    const __nv_bfloat16 hi = __float2bfloat16_rn(v);
    if (kPasses == 1) {
      Bs[strip_at(0, Kt, k, c)] = hi;
    } else {
      const float r = v - __bfloat162float(hi);
      const __nv_bfloat16 mid = __float2bfloat16_rn(r);
      const __nv_bfloat16 lo = __float2bfloat16_rn(r - __bfloat162float(mid));
      Bs[strip_at(0, Kt, k, c)] = lo;
      Bs[strip_at(1, Kt, k, c)] = mid;
      Bs[strip_at(2, Kt, k, c)] = hi;
    }
  }
  __syncthreads();

  float* mine = stage + warp * kTile;
  for (int mt = warp; mt < Mt; mt += kWarps)
    for (int nt = 0; nt < kStripTiles; ++nt) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.0f);
      for (int p = 0; p < kPasses; ++p)
        for (int kt = 0; kt < Kt; ++kt) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
          wmma::load_matrix_sync(a, Db + ((long long)mt * Kt + kt) * kTile, 16);
          wmma::load_matrix_sync(b, Bs + ((p * Kt + kt) * kStripTiles + nt) * kTile, 16);
          wmma::mma_sync(acc, a, b, acc);
        }
      wmma::store_matrix_sync(mine, acc, 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < kTile; e += 32) {
        const int m = mt * 16 + e / 16;
        if (m < M) out[(long long)m * N + n0 + nt * 16 + e % 16] = mine[e];
      }
      __syncwarp();
    }
}

// kDigits = 1: one pass on clip(round(x / 256)). kDigits = 4 or 2: fixed
// point at `scale`, signed digits d_k = ((xi + 128) & 0xFF) - 128, xi <- (xi -
// d_k) >> 8, one int8 pass per digit, recombined as sum p_k 256^k / scale.
template <int kDigits>
__global__ void __launch_bounds__(32 * kWarps)
edge_mm_s8_kernel(const signed char* __restrict__ Di, const float* __restrict__ x,
                  float* __restrict__ out, int M, int K, long long N, int Mt, int Kt,
                  float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  signed char* Bs = reinterpret_cast<signed char*>(smem_raw);
  int* stage = reinterpret_cast<int*>(Bs + kDigits * Kt * kStripTiles * kTile);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long n0 = (long long)blockIdx.x * kStrip;

  for (int e = tid; e < Kt * 16 * kStrip; e += blockDim.x) {
    const int k = e / kStrip, c = e % kStrip;
    const float v = k < K ? x[(long long)k * N + n0 + c] : 0.f;
    if (kDigits == 1) {
      const float q = fminf(fmaxf(rintf(v * (1.0f / 256.0f)), -127.f), 127.f);
      Bs[strip_at(0, Kt, k, c)] = (signed char)(int)q;
    } else {
      int xi = __float2int_rn(v * scale);
      for (int d = 0; d < kDigits; ++d) {
        const int dk = ((xi + 128) & 0xFF) - 128;
        Bs[strip_at(d, Kt, k, c)] = (signed char)dk;
        xi = (xi - dk) >> 8;
      }
    }
  }
  __syncthreads();

  int* mine = stage + warp * kDigits * kTile;
  const float inv_scale = 1.0f / scale;
  for (int mt = warp; mt < Mt; mt += kWarps)
    for (int nt = 0; nt < kStripTiles; ++nt) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[kDigits];
#pragma unroll
      for (int d = 0; d < kDigits; ++d) wmma::fill_fragment(acc[d], 0);
      for (int kt = 0; kt < Kt; ++kt) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> a;
        wmma::load_matrix_sync(a, Di + ((long long)mt * Kt + kt) * kTile, 16);
#pragma unroll
        for (int d = 0; d < kDigits; ++d) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::row_major> b;
          wmma::load_matrix_sync(b, Bs + ((d * Kt + kt) * kStripTiles + nt) * kTile, 16);
          wmma::mma_sync(acc[d], a, b, acc[d]);
        }
      }
#pragma unroll
      for (int d = 0; d < kDigits; ++d)
        wmma::store_matrix_sync(mine + d * kTile, acc[d], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < kTile; e += 32) {
        const int m = mt * 16 + e / 16;
        if (m >= M) continue;
        float v = (float)mine[e];
        if (kDigits > 1) {
          float weight = 256.0f;
          for (int d = 1; d < kDigits; ++d) {
            v = v + (float)mine[d * kTile + e] * weight;
            weight *= 256.0f;
          }
          v *= inv_scale;
        }
        out[(long long)m * N + n0 + nt * 16 + e % 16] = v;
      }
      __syncwarp();
    }
}

// The f32 body: a 64 x 64 output tile per block, 16 deep, 4 x 4 per thread.
__global__ void __launch_bounds__(256)
edge_mm_f32_kernel(const float* __restrict__ D, const float* __restrict__ x,
                   float* __restrict__ out, int M, int K, long long N) {
  __shared__ float As[16][65];
  __shared__ float Bs[16][64];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * 64;
  const long long n0 = (long long)blockIdx.x * 64;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += 16) {
    for (int e = tid; e < 64 * 16; e += 256) {
      const int r = e / 16, kk = e % 16;
      As[kk][r] = (m0 + r < M && k0 + kk < K) ? D[(long long)(m0 + r) * K + k0 + kk] : 0.f;
    }
    for (int e = tid; e < 16 * 64; e += 256) {
      const int kk = e / 64, c = e % 64;
      Bs[kk][c] = k0 + kk < K ? x[(long long)(k0 + kk) * N + n0 + c] : 0.f;
    }
    __syncthreads();
    for (int kk = 0; kk < 16; ++kk) {
      float a[4], b[4];
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx * 4 + j];
      for (int i = 0; i < 4; ++i)
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m < M)
      for (int j = 0; j < 4; ++j) out[(long long)m * N + n0 + tx * 4 + j] = acc[i][j];
  }
}

// The gather: row m adds, in column order, +x[c] or -x[c] for each entry
// (c + 1) * sign of its row of the table. Thread = column, 8 rows a block.
__global__ void __launch_bounds__(256)
edge_mm_gather_kernel(const int* __restrict__ row_ptr, const int* __restrict__ ent,
                      const float* __restrict__ x, float* __restrict__ out, int M,
                      long long N) {
  const long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const int m_end = min(M, (int)(blockIdx.y + 1) * 8);
  for (int m = blockIdx.y * 8; m < m_end; ++m) {
    float acc = 0.f;
    for (int q = row_ptr[m]; q < row_ptr[m + 1]; ++q) {
      const int e = ent[q];
      const float v = x[(long long)((e < 0 ? -e : e) - 1) * N + n];
      acc += e < 0 ? -v : v;
    }
    out[(long long)m * N + n] = acc;
  }
}

template <typename Kernel>
cudaError_t big_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

extern "C" {

// Elements of each scratch buffer (bf16 and int8 tiles of D) for D [M, K].
long long molann_edge_mm_scratch(int M, int K) {
  return (long long)((M + 15) / 16) * ((K + 15) / 16) * kTile;
}

// out [M, N] = D [M, K] @ x [K, N] by body `variant`; N a multiple of 64.
// Db, Di: scratch of molann_edge_mm_scratch elements (bf16, int8), used by
// the tensor-core bodies; row_ptr [M + 1], ent: the gather's table. Runs on
// `stream` of CUDA device `device`, allocates nothing, returns the first
// failing launch's cudaGetLastError().
int molann_edge_mm(int variant, const float* D, const float* x, float* out, int M, int K,
                   long long N, void* Db, void* Di, const int* row_ptr, const int* ent,
                   int device, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (N % kStrip != 0 || variant < 0 || variant > EMM_GATHER) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const int Mt = (M + 15) / 16, Kt = (K + 15) / 16;
  const unsigned strips = (unsigned)(N / kStrip);
  if (variant == EMM_F32) {
    edge_mm_f32_kernel<<<dim3(strips, (M + 63) / 64), 256, 0, s>>>(D, x, out, M, K, N);
    return (int)cudaGetLastError();
  }
  if (variant == EMM_GATHER) {
    edge_mm_gather_kernel<<<dim3((unsigned)((N + 255) / 256), (M + 7) / 8), 256, 0, s>>>(
        row_ptr, ent, x, out, M, N);
    return (int)cudaGetLastError();
  }
  edge_mm_prepare<<<264, 256, 0, s>>>(D, M, K, Mt, Kt, (__nv_bfloat16*)Db, (signed char*)Di);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t tiles = (size_t)Kt * kStripTiles * kTile;  // elements of one pass
  if (variant == EMM_BF16 || variant == EMM_SPLIT3) {
    const int passes = variant == EMM_BF16 ? 1 : 3;
    const size_t smem = passes * tiles * sizeof(__nv_bfloat16) + kWarps * kTile * sizeof(float);
    if (passes == 1) {
      if ((err = big_smem(edge_mm_bf16_kernel<1>, smem)) != cudaSuccess) return (int)err;
      edge_mm_bf16_kernel<1><<<strips, 32 * kWarps, smem, s>>>(
          (const __nv_bfloat16*)Db, x, out, M, K, N, Mt, Kt);
    } else {
      if ((err = big_smem(edge_mm_bf16_kernel<3>, smem)) != cudaSuccess) return (int)err;
      edge_mm_bf16_kernel<3><<<strips, 32 * kWarps, smem, s>>>(
          (const __nv_bfloat16*)Db, x, out, M, K, N, Mt, Kt);
    }
    return (int)cudaGetLastError();
  }
  const int digits = variant == EMM_INT8 ? 1 : variant == EMM_FIXED4 ? 4 : 2;
  const size_t smem = digits * tiles + (size_t)kWarps * digits * kTile * sizeof(int);
  const signed char* di = (const signed char*)Di;
  if (digits == 1) {
    if ((err = big_smem(edge_mm_s8_kernel<1>, smem)) != cudaSuccess) return (int)err;
    edge_mm_s8_kernel<1><<<strips, 32 * kWarps, smem, s>>>(di, x, out, M, K, N, Mt, Kt, 1.0f);
  } else if (digits == 4) {
    // |x| < 64: x * 2^19 fits an int32 with all of f32's 24 bits
    if ((err = big_smem(edge_mm_s8_kernel<4>, smem)) != cudaSuccess) return (int)err;
    edge_mm_s8_kernel<4><<<strips, 32 * kWarps, smem, s>>>(di, x, out, M, K, N, Mt, Kt,
                                                           524288.0f);
  } else {
    if ((err = big_smem(edge_mm_s8_kernel<2>, smem)) != cudaSuccess) return (int)err;
    edge_mm_s8_kernel<2><<<strips, 32 * kWarps, smem, s>>>(di, x, out, M, K, N, Mt, Kt, 512.0f);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"

// The edge product D @ x of the blocked formulation, as a probe on Hopper
// (sm_90a): tensor-core bodies against FFMA and a direct gather.
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
// 32,768) the function reads 39.8 MB of x and D's prepared form (the
// tensor-core image 184 KB, the gather's table 6.7 KB, D transposed 0.70 MB)
// and writes 72.4 MB: 0.0335 ms at 3.35 TB/s (0.0337 with D in f32). The
// dense product is 11.0 GFLOP: 0.011 ms for one bf16 pass at 989 TFLOP/s,
// 0.0334 ms for split3's three, 0.006 ms for one int8 pass at 1,979 TOP/s,
// 0.011 ms for fixed4's four, 0.165 ms in f32 at 67 TFLOP/s; so bytes
// bound every tensor-core body and the gather (D at 1%
// has 1,113 nonzeros, about 2 a row: 36 M additions), operations the f32 one.
//
// What the design does about it. Every byte of x is read from device memory
// once and every byte of out written once, in whole 32-byte sectors;
// everything else is made on the chip (times and the alternatives measured:
// PERF.md, probes/edge_mm_probe.py):
//   - D is prepared once, on the host, not once a call (the probe's
//     prepare_edge_matrix): the tensor-core bodies' one image (edge_mm_maps.cuh:
//     16 bytes a lane a 16 x 32 tile, a byte an entry that reads as 64 d
//     for the int8 bodies and as the high byte of bf16(2 d) for the bf16
//     ones; exact for 0/+-1), D transposed in f32 for the f32 body, and the
//     gather's table.
//   - tensor-core bodies (mma.sync m16n8k16 bf16 and m16n8k32 s8): one
//     persistent block an SM holds the whole image of D in shared memory
//     (184 KB at the probe's shape) and its warps (16; 8 for split3, whose x
//     takes 120 registers) walk column tiles of 16 columns (8 for split3 and
//     fixed4). A warp loads its tile of x for all of K straight into
//     registers in the B operand's layout (8 bytes a lane where it has two
//     8-column tiles; every load instruction fills whole sectors), splits or
//     quantises it there, once, and walks every 16-row tile of D with it,
//     two at a time (three for split3), reading each fragment of D from
//     shared memory once and using it for every column and every pass or
//     digit; neither the passes nor the digits ever sit in shared memory.
//     The next column tile is prefetched into L2 while the products run.
//     Each pass or digit keeps its own accumulator: split3 adds (lo + mid) +
//     hi at the end, the digits recombine in f32, lowest first; out is stored 16 bytes
//     a lane (8 for one 8-column tile), streaming past L1. The one-pass
//     bodies and fixed2 run at 63-77% of the byte bound, as fast with x
//     cold as with x left in L2 by the call before; split3 and fixed4
//     are held by the instruction stream around their products (D's image
//     read and widened, the epilogue) at two to four warps a scheduler, not
//     by the bytes nor by the products alone.
//   - f32: FFMA tiles of 64 x 128 (M 552 in nine, 4.3% padding), warp tiles
//     of 32 x 64, 8 x 8 a thread, 16-deep steps staged by cp.async into a
//     ring of three buffers with one barrier a step, 16-byte shared-memory
//     reads, four blocks an SM; each output's sum runs k = 0, 1, ... by fmaf.
//   - gather: a block stages its strip of 32 columns of x (K x 128 bytes)
//     and the table in shared memory, then forms all M rows of the strip, 8
//     threads a row, 16 bytes a thread; x leaves device memory once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "edge_mm_maps.cuh"

namespace {

enum { EMM_F32 = 0, EMM_BF16 = 1, EMM_INT8 = 2, EMM_SPLIT3 = 3, EMM_FIXED4 = 4,
       EMM_FIXED2 = 5, EMM_GATHER = 6 };

constexpr int kMaxChunks = 10;   // 32-deep chunks of K a warp holds: K <= 320
constexpr int kMtMultiple = 6;   // the image's 16-row tiles: a multiple of every body's kMT
// the f32 body's tile: warps of 32 x 64, kF32WarpsM of them down, kF32WarpsN across
constexpr int kF32WarpsM = 2, kF32WarpsN = 2, kF32BM = 32 * kF32WarpsM, kF32BN = 64 * kF32WarpsN,
              kF32BK = 16, kF32Threads = 32 * kF32WarpsM * kF32WarpsN, kF32Stages = 3;
constexpr int kGatherCols = 32, kGatherThreads = 256;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint4& a, unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}
__device__ __forceinline__ unsigned pack_s8(const int (&q)[4]) {
  return (unsigned)(q[0] & 0xFF) | (unsigned)(q[1] & 0xFF) << 8 | (unsigned)(q[2] & 0xFF) << 16 |
         (unsigned)(q[3] & 0xFF) << 24;
}

// The shape of a tensor-core body: passes (or digits), 8-column tiles a
// warp, 32-bit registers of x a (chunk, column tile, pass), warps a block
// (as many as its registers let one block an SM have), tiles of D at once
// (PERF.md: the choices measured against their alternatives).
template <int kBody>
struct Tc {
  static constexpr bool kBf16 = kBody == EMM_BF16 || kBody == EMM_SPLIT3;
  static constexpr int kPasses =
      kBody == EMM_SPLIT3 ? 3 : kBody == EMM_FIXED4 ? 4 : kBody == EMM_FIXED2 ? 2 : 1;
  static constexpr int kNT = (kBody == EMM_SPLIT3 || kBody == EMM_FIXED4) ? 1 : 2;
  static constexpr int kXRegs = kBf16 ? 4 : 2;
  static constexpr int kWarps = kBody == EMM_SPLIT3 ? 8 : 16;
  // 16-row tiles of D a warp multiplies at once
  static constexpr int kMT = kBody == EMM_SPLIT3 ? 3 : 2;
  using Acc = typename std::conditional<kBf16, float, int>::type;
};

// x's B operands of column tile `tile` for all of K, split or quantised:
// xq[c][j][p][r] is register r of pass p, chunk c, 8-column tile j.
template <int kBody>
__device__ __forceinline__ void load_x(
    unsigned (&xq)[kMaxChunks][Tc<kBody>::kNT][Tc<kBody>::kPasses][Tc<kBody>::kXRegs],
    const float* __restrict__ x, int K, long long N, long long tile, int lane, int Kc) {
  using S = Tc<kBody>;
  // both column tiles' columns of this lane side by side (emm_tile_col)
  const float* col = x + tile * (8 * S::kNT) + emm_tile_col(emm_b_col(lane), 0, S::kNT);
#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c) {
    if (c >= Kc) break;
    float v[S::kNT][2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = 32 * c + emm_b_row(lane, h, i);
        if constexpr (S::kNT == 2) {
          const float2 p = k < K ? __ldcs(reinterpret_cast<const float2*>(col + (long long)k * N))
                                 : make_float2(0.f, 0.f);
          v[0][h][i] = p.x;
          v[1][h][i] = p.y;
        } else {
          v[0][h][i] = k < K ? __ldcs(col + (long long)k * N) : 0.f;
        }
      }
#pragma unroll
    for (int j = 0; j < S::kNT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float* w = v[j][h];
        if constexpr (kBody == EMM_BF16) {
          xq[c][j][0][2 * h] = pack_bf16(w[0], w[1]);
          xq[c][j][0][2 * h + 1] = pack_bf16(w[2], w[3]);
        } else if constexpr (kBody == EMM_SPLIT3) {
          float lo[4], mid[4], hi[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const __nv_bfloat16 bh = __float2bfloat16_rn(w[i]);
            const float r = w[i] - __bfloat162float(bh);
            const __nv_bfloat16 bm = __float2bfloat16_rn(r);
            hi[i] = __bfloat162float(bh);
            mid[i] = __bfloat162float(bm);
            lo[i] = r - mid[i];  // rounded to bf16 by pack_bf16
          }
          xq[c][j][0][2 * h] = pack_bf16(lo[0], lo[1]);
          xq[c][j][0][2 * h + 1] = pack_bf16(lo[2], lo[3]);
          xq[c][j][1][2 * h] = pack_bf16(mid[0], mid[1]);
          xq[c][j][1][2 * h + 1] = pack_bf16(mid[2], mid[3]);
          xq[c][j][2][2 * h] = pack_bf16(hi[0], hi[1]);
          xq[c][j][2][2 * h + 1] = pack_bf16(hi[2], hi[3]);
        } else if constexpr (kBody == EMM_INT8) {
          int q[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            q[i] = (int)fminf(fmaxf(rintf(w[i] * (1.0f / 256.0f)), -127.f), 127.f);
          xq[c][j][0][h] = pack_s8(q);
        } else {
          // fixed point at 2^19 (four digits) or 2^9 (two): signed digits
          // d = ((xi + 128) & 0xFF) - 128, xi <- (xi - d) >> 8
          const float scale = kBody == EMM_FIXED4 ? 524288.0f : 512.0f;
          int xi[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) xi[i] = __float2int_rn(w[i] * scale);
#pragma unroll
          for (int d = 0; d < S::kPasses; ++d) {
            int q[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              q[i] = ((xi[i] + 128) & 0xFF) - 128;
              xi[i] = (xi[i] - q[i]) >> 8;
            }
            xq[c][j][d][h] = pack_s8(q);
          }
        }
      }
  }
}

// One product into an accumulator.
template <int kBody>
__device__ __forceinline__ void product(typename Tc<kBody>::Acc (&c)[4], const unsigned* a,
                                        unsigned b0, unsigned b1) {
  if constexpr (Tc<kBody>::kBf16) {
    mma_bf16(c, *reinterpret_cast<const unsigned(*)[4]>(a), b0, b1);
  } else {
    mma_s8(c, make_uint4(a[0], a[1], a[2], a[3]), b0, b1);
  }
}

// One persistent block an SM: D's image in shared memory, warps walking
// column tiles with x in registers (see the header comment).
template <int kBody>
__global__ void __launch_bounds__(32 * Tc<kBody>::kWarps, 1)
edge_mm_tc_kernel(const uint4* __restrict__ image, const float* __restrict__ x,
                  float* __restrict__ out, int M, int K, long long N, int Mt, int Kc) {
  using S = Tc<kBody>;
  using Acc = typename S::Acc;
  extern __shared__ uint4 ds[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int image_n = Mt * Kc * 32;
  for (int e = tid; e < image_n; e += blockDim.x) cp_async16(ds + e, image + e, 16);
  cp_async_commit();

  const long long tiles = N / (8 * S::kNT);
  const long long stride = (long long)gridDim.x * S::kWarps;
  long long tile = (long long)blockIdx.x * S::kWarps + warp;
  unsigned xq[kMaxChunks][S::kNT][S::kPasses][S::kXRegs];
  if (tile < tiles) load_x<kBody>(xq, x, K, N, tile, lane, Kc);
  cp_async_wait<0>();
  __syncthreads();

  for (; tile < tiles; tile += stride) {
    // the next column tile into L2 while this one's products run
    if (tile + stride < tiles) {
      const float* nx = x + (tile + stride) * (8 * S::kNT);
      for (int k = lane; k < K; k += 32)
#pragma unroll
        for (int j = 0; j < S::kNT; ++j)
          asm volatile("prefetch.global.L2 [%0];\n" ::"l"(nx + (long long)k * N + 8 * j));
    }
    float* o = out + tile * (8 * S::kNT);
    for (int mt0 = 0; mt0 < Mt; mt0 += S::kMT) {
      Acc acc[S::kMT][S::kNT][S::kPasses][4];
#pragma unroll
      for (int i = 0; i < S::kMT; ++i)
#pragma unroll
        for (int j = 0; j < S::kNT; ++j)
#pragma unroll
          for (int p = 0; p < S::kPasses; ++p)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][j][p][e] = 0;
#pragma unroll
      for (int c = 0; c < kMaxChunks; ++c) {
        if (c >= Kc) break;
        unsigned a[S::kMT][4];
#pragma unroll
        for (int i = 0; i < S::kMT; ++i) {
          const uint4 w = ds[emm_image_at(mt0 + i, c, Kc, lane)];
          a[i][0] = w.x;
          a[i][1] = w.y;
          a[i][2] = w.z;
          a[i][3] = w.w;
        }
        // every accumulator once before any of them again: the products
        // between two on one accumulator hide the latency of the first
        if constexpr (S::kBf16) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            unsigned ab[S::kMT][4];
#pragma unroll
            for (int i = 0; i < S::kMT; ++i) emm_widen(a[i], h, ab[i]);
#pragma unroll
            for (int i = 0; i < S::kMT; ++i)
#pragma unroll
              for (int j = 0; j < S::kNT; ++j)
#pragma unroll
                for (int p = 0; p < S::kPasses; ++p)
                  product<kBody>(acc[i][j][p], ab[i], xq[c][j][p][2 * h], xq[c][j][p][2 * h + 1]);
          }
        } else {
#pragma unroll
          for (int i = 0; i < S::kMT; ++i)
#pragma unroll
            for (int j = 0; j < S::kNT; ++j)
#pragma unroll
              for (int p = 0; p < S::kPasses; ++p)
                product<kBody>(acc[i][j][p], a[i], xq[c][j][p][0], xq[c][j][p][1]);
        }
      }
      // epilogue: passes and digits combined; a row's columns of this lane
      // (emm_tile_col) are side by side: 16 bytes a lane (8 for one tile)
#pragma unroll
      for (int i = 0; i < S::kMT; ++i)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int m = 16 * (mt0 + i) + emm_c_row(lane, 2 * half);
          if (m >= M) continue;
          float v[S::kNT][2];
#pragma unroll
          for (int j = 0; j < S::kNT; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int el = 2 * half + e;
              if constexpr (kBody == EMM_BF16) {
                v[j][e] = 0.5f * acc[i][j][0][el];
              } else if constexpr (kBody == EMM_SPLIT3) {
                v[j][e] = 0.5f * ((acc[i][j][0][el] + acc[i][j][1][el]) + acc[i][j][2][el]);
              } else if constexpr (kBody == EMM_INT8) {
                v[j][e] = (float)acc[i][j][0][el] * (1.0f / kEmmS8One);
              } else {
                float s = (float)acc[i][j][0][el], weight = 256.0f;
#pragma unroll
                for (int d = 1; d < S::kPasses; ++d) {
                  s = s + (float)acc[i][j][d][el] * weight;
                  weight *= 256.0f;
                }
                v[j][e] = s * ((kBody == EMM_FIXED4 ? 1.0f / 524288.0f : 1.0f / 512.0f) / kEmmS8One);
              }
            }
          float* row = o + (long long)m * N + emm_tile_col(emm_c_col(lane, 0), 0, S::kNT);
          if constexpr (S::kNT == 2)
            __stcs(reinterpret_cast<float4*>(row), make_float4(v[0][0], v[1][0], v[0][1], v[1][1]));
          else
            __stcs(reinterpret_cast<float2*>(row), make_float2(v[0][0], v[0][1]));
        }
    }
    if (tile + stride < tiles) load_x<kBody>(xq, x, K, N, tile + stride, lane, Kc);
  }
}

// The f32 body: an out tile of kF32BM x kF32BN a block, in warp tiles of 32 x
// 64 (lane (r, c) = (lane / 8, lane % 8) owns rows 4r + i and 16 + 4r + i,
// columns 4c + j and 32 + 4c + j, i, j < 4), K in 16-deep steps staged by
// cp.async into a ring of buffers. dt is D transposed [K, mpad], zero past M.
__global__ void __launch_bounds__(kF32Threads, 4)
edge_mm_f32_kernel(const float* __restrict__ dt, int mpad, const float* __restrict__ x,
                   float* __restrict__ out, int M, int K, long long N) {
  __shared__ __align__(16) float As[kF32Stages][kF32BK][kF32BM];
  __shared__ __align__(16) float Bs[kF32Stages][kF32BK][kF32BN];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = 32 * (warp / kF32WarpsN), wn = 64 * (warp % kF32WarpsN), r = lane >> 3,
            c = lane & 7;
  const int m0 = blockIdx.x * kF32BM;
  const long long n0 = (long long)blockIdx.y * kF32BN;
  auto stage = [&](int buf, int k0) {
    for (int e = tid; e < kF32BK * (kF32BM / 4); e += kF32Threads) {
      const int rr = e / (kF32BM / 4), q = e % (kF32BM / 4), k = k0 + rr;
      const bool ok = k < K && m0 + 4 * q < mpad;
      cp_async16(&As[buf][rr][4 * q], dt + (ok ? (long long)k * mpad + m0 + 4 * q : 0),
                 ok ? 16 : 0);
    }
    for (int e = tid; e < kF32BK * (kF32BN / 4); e += kF32Threads) {
      const int rr = e / (kF32BN / 4), q = e % (kF32BN / 4), k = k0 + rr;
      const long long n = n0 + 4 * q;
      const bool ok = k < K && n < N;
      cp_async16(&Bs[buf][rr][4 * q], x + (ok ? (long long)k * N + n : 0), ok ? 16 : 0);
    }
  };
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  const int steps = (K + kF32BK - 1) / kF32BK;
  // a ring of kF32Stages buffers, one barrier a step: after it every warp is
  // done with the buffer the step's load refills
#pragma unroll
  for (int st = 0; st < kF32Stages - 1; ++st) {
    if (st < steps) stage(st, st * kF32BK);
    cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<kF32Stages - 2>();
    __syncthreads();
    const int next = s + kF32Stages - 1;
    if (next < steps) stage(next % kF32Stages, next * kF32BK);
    cp_async_commit();
    const int buf = s % kF32Stages;
#pragma unroll
    for (int kk = 0; kk < kF32BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][kk][wm + 4 * r]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[buf][kk][wm + 16 + 4 * r]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[buf][kk][wn + 4 * c]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[buf][kk][wn + 32 + 4 * c]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + wm + (i < 4 ? 4 * r + i : 16 + 4 * r + i - 4);
    if (m >= M) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long n = n0 + wn + 32 * half + 4 * c;
      if (n < N)
        __stcs(reinterpret_cast<float4*>(out + (long long)m * N + n),
               make_float4(acc[i][4 * half], acc[i][4 * half + 1], acc[i][4 * half + 2],
                           acc[i][4 * half + 3]));
    }
  }
}

// The gather: a block's strip of 32 columns of x and, where it fits, the
// table (row_ptr [M + 1], then ent [nnz]: (col + 1) * sign, row after row in
// column order) in shared memory; row m adds +-x[col] in column order, 8
// threads a row.
__global__ void __launch_bounds__(kGatherThreads)
edge_mm_gather_kernel(const int* __restrict__ row_ptr, const int* __restrict__ ent, int nnz,
                      int stage_table, const float* __restrict__ x, float* __restrict__ out,
                      int M, int K, long long N) {
  extern __shared__ float4 gs4[];
  float* xs = reinterpret_cast<float*>(gs4);
  const int tid = threadIdx.x;
  const long long n0 = (long long)blockIdx.x * kGatherCols;
  for (int e = tid; e < K * (kGatherCols / 4); e += kGatherThreads) {
    const int k = e / (kGatherCols / 4), q = e % (kGatherCols / 4);
    cp_async16(xs + k * kGatherCols + 4 * q, x + (long long)k * N + n0 + 4 * q, 16);
  }
  cp_async_commit();
  const int* rp = row_ptr;
  const int* en = ent;
  if (stage_table) {
    int* t = reinterpret_cast<int*>(xs + K * kGatherCols);
    for (int e = tid; e <= M; e += kGatherThreads) t[e] = row_ptr[e];
    for (int e = tid; e < nnz; e += kGatherThreads) t[M + 1 + e] = ent[e];
    rp = t;
    en = t + M + 1;
  }
  cp_async_wait<0>();
  __syncthreads();
  const int q = tid % (kGatherCols / 4);
  for (int m = tid / (kGatherCols / 4); m < M; m += kGatherThreads / (kGatherCols / 4)) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int p = rp[m]; p < rp[m + 1]; ++p) {
      const int e = en[p];
      const float4 v = *reinterpret_cast<const float4*>(xs + ((e < 0 ? -e : e) - 1) * kGatherCols +
                                                        4 * q);
      if (e < 0) {
        acc.x -= v.x; acc.y -= v.y; acc.z -= v.z; acc.w -= v.w;
      } else {
        acc.x += v.x; acc.y += v.y; acc.z += v.z; acc.w += v.w;
      }
    }
    __stcs(reinterpret_cast<float4*>(out + (long long)m * N + n0 + 4 * q), acc);
  }
}

constexpr size_t kSmemMax = 232448;  // shared memory a block can have

// The gather's shared memory: x's strip, and the table where both fit.
bool gather_stages_table(int M, int K, int nnz) {
  return ((size_t)K * kGatherCols + (size_t)(M + 1) + (size_t)nnz) * 4 <= kSmemMax;
}
size_t gather_smem(int M, int K, int nnz) {
  return ((size_t)K * kGatherCols +
          (gather_stages_table(M, K, nnz) ? (size_t)(M + 1) + (size_t)nnz : 0)) * 4;
}

size_t image_bytes(int Mt, int Kc) { return (size_t)Mt * Kc * 512; }

// Kernel, threads, dynamic shared memory and blocks per launch of body
// `variant`; fills the launch's attributes once.
struct Launch {
  const void* fn;
  int threads;
  size_t smem;
};

Launch launch_of(int variant, int M, int K, int nnz) {
  const int Mt = ((M + 15) / 16 + kMtMultiple - 1) / kMtMultiple * kMtMultiple,
            Kc = (K + 31) / 32;
  switch (variant) {
    case EMM_F32: return {(const void*)edge_mm_f32_kernel, kF32Threads, 0};
    case EMM_GATHER:
      return {(const void*)edge_mm_gather_kernel, kGatherThreads, gather_smem(M, K, nnz)};
    case EMM_BF16: return {(const void*)edge_mm_tc_kernel<EMM_BF16>, 32 * Tc<EMM_BF16>::kWarps, image_bytes(Mt, Kc)};
    case EMM_INT8: return {(const void*)edge_mm_tc_kernel<EMM_INT8>, 32 * Tc<EMM_INT8>::kWarps, image_bytes(Mt, Kc)};
    case EMM_SPLIT3:
      return {(const void*)edge_mm_tc_kernel<EMM_SPLIT3>, 32 * Tc<EMM_SPLIT3>::kWarps, image_bytes(Mt, Kc)};
    case EMM_FIXED4:
      return {(const void*)edge_mm_tc_kernel<EMM_FIXED4>, 32 * Tc<EMM_FIXED4>::kWarps, image_bytes(Mt, Kc)};
    default:
      return {(const void*)edge_mm_tc_kernel<EMM_FIXED2>, 32 * Tc<EMM_FIXED2>::kWarps, image_bytes(Mt, Kc)};
  }
}

int sm_count(int device) {
  static int counts[64] = {};
  if (device < 0 || device >= 64) return 132;
  if (counts[device] == 0)
    cudaDeviceGetAttribute(&counts[device], cudaDevAttrMultiProcessorCount, device);
  return counts[device] > 0 ? counts[device] : 132;
}

}  // namespace

extern "C" {

// Constants the host's preparation of D must agree with: 32-deep chunks a
// warp holds (K <= 32 * this), m-tiles of the image a multiple of this, the
// f32 body's rows a tile (mpad a multiple of it), the gather's columns a
// block.
int molann_edge_mm_caps(int* out) {
  out[0] = kMaxChunks;
  out[1] = kMtMultiple;
  out[2] = kF32BM;
  out[3] = kGatherCols;
  return 0;
}

// Registers a thread, shared memory a block (static + dynamic), blocks an
// SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor) and threads a block of
// body `variant` at D [M, K] with nnz nonzeros: out[0..3].
int molann_edge_mm_resources(int variant, int M, int K, int nnz, int device, int* out) {
  if (variant < 0 || variant > EMM_GATHER) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Launch l = launch_of(variant, M, K, nnz);
  if ((err = cudaFuncSetAttribute(l.fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)l.smem)) != cudaSuccess)
    return (int)err;
  cudaFuncAttributes attr;
  if ((err = cudaFuncGetAttributes(&attr, l.fn)) != cudaSuccess) return (int)err;
  int blocks = 0;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, l.fn, l.threads, l.smem)) !=
      cudaSuccess)
    return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)(attr.sharedSizeBytes + l.smem);
  out[2] = blocks;
  out[3] = l.threads;
  return 0;
}

// out [M, N] = D [M, K] @ x [K, N] by body `variant`, N a multiple of 64,
// from D's prepared forms: `image` (the tensor-core bodies' codes,
// edge_mm_maps.cuh; [Mt][Kc][32] x 16 bytes), `dt` (D transposed [K, mpad],
// f32) and the gather's table (row_ptr [M + 1], ent [nnz]). Runs on `stream`
// of CUDA device `device`, allocates nothing, returns the launch's
// cudaGetLastError() (cudaErrorInvalidValue for what it does not take).
int molann_edge_mm(int variant, const void* image, const float* dt, int mpad, const int* row_ptr,
                   const int* ent, int nnz, const float* x, float* out, int M, int K, long long N,
                   int device, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (N % 64 != 0 || variant < 0 || variant > EMM_GATHER || K <= 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const Launch l = launch_of(variant, M, K, nnz);
  if (variant == EMM_F32) {
    if (mpad % 4 != 0 || mpad < M) return (int)cudaErrorInvalidValue;
    edge_mm_f32_kernel<<<dim3((M + kF32BM - 1) / kF32BM, (unsigned)((N + kF32BN - 1) / kF32BN)),
                         kF32Threads, 0, s>>>(dt, mpad, x, out, M, K, N);
    return (int)cudaGetLastError();
  }
  if ((err = cudaFuncSetAttribute(l.fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)l.smem)) != cudaSuccess)
    return (int)err;
  if (variant == EMM_GATHER) {
    edge_mm_gather_kernel<<<(unsigned)(N / kGatherCols), kGatherThreads, l.smem, s>>>(
        row_ptr, ent, nnz, gather_stages_table(M, K, nnz) ? 1 : 0, x, out, M, K, N);
    return (int)cudaGetLastError();
  }
  const int Mt = ((M + 15) / 16 + kMtMultiple - 1) / kMtMultiple * kMtMultiple,
            Kc = (K + 31) / 32;
  if (Kc > kMaxChunks) return (int)cudaErrorInvalidValue;
  const int nt = (variant == EMM_SPLIT3 || variant == EMM_FIXED4) ? 1 : 2;
  const int warps = l.threads / 32;
  const long long warp_tiles = N / (8 * nt);
  const long long want = (warp_tiles + warps - 1) / warps;
  const unsigned grid = (unsigned)(want < sm_count(device) ? want : sm_count(device));
  const uint4* img = (const uint4*)image;
  switch (variant) {
    case EMM_BF16:
      edge_mm_tc_kernel<EMM_BF16><<<grid, l.threads, l.smem, s>>>(img, x, out, M, K, N, Mt, Kc);
      break;
    case EMM_INT8:
      edge_mm_tc_kernel<EMM_INT8><<<grid, l.threads, l.smem, s>>>(img, x, out, M, K, N, Mt, Kc);
      break;
    case EMM_SPLIT3:
      edge_mm_tc_kernel<EMM_SPLIT3><<<grid, l.threads, l.smem, s>>>(img, x, out, M, K, N, Mt, Kc);
      break;
    case EMM_FIXED4:
      edge_mm_tc_kernel<EMM_FIXED4><<<grid, l.threads, l.smem, s>>>(img, x, out, M, K, N, Mt, Kc);
      break;
    default:
      edge_mm_tc_kernel<EMM_FIXED2><<<grid, l.threads, l.smem, s>>>(img, x, out, M, K, N, Mt, Kc);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"

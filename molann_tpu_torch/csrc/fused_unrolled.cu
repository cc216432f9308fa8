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
// columns, MLP 38 -> 5 -> 3) the cv+forces op on [3n, l] frames moves 492 B
// a frame from and to device memory (the 54 f32 of the 18 atoms the
// features read, 66 + 3 f32 out; 540 B on [l, n, 3], where the 4 atoms
// nothing reads share 32-byte sectors with atoms read): ~0.15 ms per
// million frames at 3.35 TB/s. Its arithmetic is a long serial scalar chain per frame (12
// Newton steps, the 4x4 adjugate and its reverse pass, ~40 features and
// their adjoints), a few thousand FP32 operations. Measured on an H100 80GB
// HBM3 at 700 W, the first version (one thread per frame, the frame's arrays
// sized by the compile-time envelope in local memory, QCP's Jacobian by
// 9-tangent duals: 128 registers and 5 KB of stack a thread) reached ~6% of
// the DRAM bound: the chain bound it, not DRAM. The TPU design folded frames into
// (8, 128) vector tiles and baked the index tables in as immediates;
// neither carries over. This design (H100 80GB HBM3, 700 W): K4 about
// 0.047 ms a 65,536-frame batch on [3n, l] (bound 0.0096), K1 0.019 on
// [l, n, 3] (bound 0.0054), the bench op 0.77 ms on 1,048,576 frames (20%
// of its bound); at half the warps an SM 1.75 times slower: bound by latency,
// with registers (128) and shared memory (113 floats a frame on alanine)
// both holding it to 16 warps an SM.
//
// What the design does about it. A warp takes 32 frames, one thread a
// frame, and walks tiles of 32 frames on its own (uw_* in frame_math.cuh):
// the serial chain of a frame needs no other thread, so no block barrier
// holds a frame back, and only the staging and the gradient store pass
// values between the warp's threads (__syncwarp). The frame's state is the
// thread's own, contiguous in shared memory at an odd pitch (conflict-free
// for the 32 threads of a warp); it keeps only the atoms the features read
// (18 of alanine's 22), the first layer's input columns (whose place the
// gradient takes once the layer has read them) and the hidden layers'
// outputs: 113 floats a frame for K4 on alanine, 97 for K1, where the
// two-threads-a-frame blocks of the earlier design kept 184 and 112. The
// output's cotangent is the constant seed and a column's cotangent W0^T dz0
// is formed where its adjoint reads it; QCP's rotation and Newton result
// stay in registers from the forward to the adjoint. With 228 KB of shared
// memory taken, L1 keeps 28 KB, which the weights and index tables need:
// the gradient and outputs are stored, and [3n, l] frames loaded, without
// a line in L1 (with the lines K4 on [l, n, 3] 40% and the bench op 12-17%
// slower); [l, 3n] frames are staged by asynchronous copies (cp.async),
// which K1 needs (by loads it is 17% slower). The grid is sized to
// the warps the card holds (cudaOccupancyMaxActiveBlocksPerMultiprocessor,
// with the warps a block that hold the most, asked once by the wrapper
// through molann_fused_grid), and each warp walks the
// tiles from its own by the grid's stride: no second wave of blocks that
// is mostly empty. The ragged last tile repeats its last frame and stores
// only its true frames. A coordination feature (at most 96 pairs in this
// family's envelope) is a loop over its pair table in the thread, in table
// order.

#include <cuda_runtime.h>

#include "frame_math.cuh"

namespace {

// At most 128 registers, so that 16 warps share an SM, as the alanine
// model's state allows (113 floats a frame: 14.5 KB a warp).
template <bool kForces>
__global__ void __launch_bounds__(32 * MOLANN_UW_MAX_WARPS, 1)
fused_unrolled_kernel(const ModelArgs m, const UnrIO io) {
  extern __shared__ float sm[];
  const UwLayout o = uw_layout(m, kForces);
  const int lane = threadIdx.x & 31, wpb = blockDim.x >> 5;
  float* ws = sm + (threadIdx.x >> 5) * MOLANN_UW_FRAMES * o.pitch;
  float* st = ws + lane * o.pitch;
  const long long tiles = (io.l + MOLANN_UW_FRAMES - 1) / MOLANN_UW_FRAMES;
  const bool with_z = act_needs_z(m.activation);
  for (long long tile = (long long)blockIdx.x * wpb + (threadIdx.x >> 5); tile < tiles;
       tile += (long long)gridDim.x * wpb) {
    const long long fr = tile * MOLANN_UW_FRAMES + lane;
    UwAlign al;
    __syncwarp();  // the last tile's store has read the frames the load overwrites
    uw_load(m, io, ws, o, tile, lane);
    uw_wait();
    uw_feat(m, st, o, al);
    uw_mlp(m, io, st, o, fr, kForces && with_z);
    if (!kForces) continue;
    uw_bwd(m, io, st, o);
    uw_adj_feat(m, io, st, o);
    uw_adj_align(m, io, st, o, al);
    __syncwarp();
    uw_store(m, io, ws, o, tile, lane);
  }
}

// The block of 1 to MOLANN_UW_MAX_WARPS warps that lets an SM hold the most
// warps of one kernel and state size on one device (the 1 KB each block
// reserves decides it where shared memory is the limit): out = {warps a
// block, blocks an SM, SMs}. The kernel's dynamic shared memory limit is
// set to the most a block may take, once and never lowered, so that a
// query on one thread does not shrink what a launch on another needs.
template <bool kForces>
cudaError_t uw_grid(int device, int pitch, int* out) {
  int sms = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(fused_unrolled_kernel<kForces>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, MOLANN_UW_SMEM);
  if (err != cudaSuccess) return err;
  const int warp_bytes = MOLANN_UW_FRAMES * pitch * (int)sizeof(float);
  int wpb = 0, per_sm = 0;
  for (int w = 1; w <= MOLANN_UW_MAX_WARPS && w * warp_bytes <= MOLANN_UW_SMEM; ++w) {
    int nb = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, fused_unrolled_kernel<kForces>,
                                                        32 * w, w * warp_bytes);
    if (err != cudaSuccess) return err;
    if (nb * w > wpb * per_sm) {
      wpb = w;
      per_sm = nb;
    }
  }
  if (!wpb) return cudaErrorInvalidConfiguration;
  out[0] = wpb;
  out[1] = per_sm;
  out[2] = sms;
  return cudaSuccess;
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

// The grid of the forward (forces = 0) or cv+forces kernel for this model
// (the slot form of its tables) on `device`, as uw_grid: out = {warps a
// block, blocks an SM, SMs}. cudaErrorInvalidConfiguration where a warp's
// state does not fit a block. Sets the kernel's shared memory limit on
// `device`, which molann_fused_forward needs.
int molann_fused_grid(const ModelArgs* m, int forces, int device, int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int pitch = uw_layout(*m, forces != 0).pitch;
  return (int)(forces ? uw_grid<true>(device, pitch, out) : uw_grid<false>(device, pitch, out));
}

// y = model(x) and, with forces, gx = d(sum y or y[:, component])/dx, as
// UnrIO lays them out (io->frames and io->pitch are set here), on blocks of
// `warps` warps, at most `blocks` of them (molann_fused_grid's warps a
// block, and its blocks an SM times SMs). m must be the slot form of the
// model's tables (slot_col set): the atom form gives
// cudaErrorInvalidValue, a state past a block's shared memory
// cudaErrorInvalidConfiguration. Runs on `stream` of CUDA device `device`,
// allocates nothing, returns cudaGetLastError() of the launch.
int molann_fused_forward(const ModelArgs* m, const UnrIO* io, int forces, int warps, int blocks,
                         int device, void* stream) {
  if (!m->slot_col) return (int)cudaErrorInvalidValue;
  UnrIO t = *io;
  t.frames = MOLANN_UW_FRAMES;
  t.pitch = uw_layout(*m, forces != 0).pitch;
  const int smem = warps * MOLANN_UW_FRAMES * t.pitch * (int)sizeof(float);
  if (warps < 1 || warps > MOLANN_UW_MAX_WARPS || blocks < 1 || smem > MOLANN_UW_SMEM)
    return (int)cudaErrorInvalidConfiguration;
  if (t.l <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (t.l + MOLANN_UW_FRAMES - 1) / MOLANN_UW_FRAMES;
  const long long want = (tiles + warps - 1) / warps;
  const unsigned grid = (unsigned)(want < blocks ? want : blocks);
  cudaStream_t s = (cudaStream_t)stream;
  if (forces)
    fused_unrolled_kernel<true><<<grid, 32 * warps, smem, s>>>(*m, t);
  else
    fused_unrolled_kernel<false><<<grid, 32 * warps, smem, s>>>(*m, t);
  return (int)cudaGetLastError();
}

}  // extern "C"

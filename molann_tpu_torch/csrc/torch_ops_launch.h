// C interface between the torch custom ops of the engine artifact
// (torch_ops_cuda.cpp, which includes PyTorch's headers) and the launches
// of the fused kernels (torch_ops_launch.cpp, which includes the kernels'
// own headers and no PyTorch or CUDA header: blocked_math.cuh defines a host
// float4 that cuda_runtime.h would define again).
#ifndef MOLANN_TORCH_OPS_LAUNCH_H_
#define MOLANN_TORCH_OPS_LAUNCH_H_

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

// Codes of the op layer, below 0; a code above 0 is a cudaError_t.
enum {
  MOLANN_OP_BAD_META = -1,     // meta of another format, length or size
  MOLANN_OP_BAD_CAPS = -2,     // the kernel library's caps or struct sizes differ
  MOLANN_OP_NO_TILE = -3,      // one frame does not fit a block's shared memory
  MOLANN_OP_NO_BATCHES = -4,   // no batches of features for the tile's threads
  MOLANN_OP_BAD_OPERAND = -5,  // the pair operand's length is not the model's
};

// What a code means, for an error message.
const char* molann_op_message(int rc);

// The input's atoms, the output's width and the pair operand's length of
// an artifact's meta (blocked = 0: the unrolled format, 1: the blocked one).
int molann_op_shape(const int64_t* meta, int n_meta, int blocked, int64_t* n_atoms,
                    int64_t* d_out, int64_t* n_pairs);

// y [l, d_out] = model(x [l, n, 3]) and, with forces, gx [l, n, 3] =
// d(sum y)/dx, through K1 (forces = 0) or K4 on the tables of an unrolled
// artifact (ops/fused.py artifact_tables): device pointers all, launched on
// `stream` of CUDA device `device`. Returns 0 or a code above.
int molann_op_unrolled(const int64_t* meta, int n_meta, const int* ints, const float* floats,
                       const float* x, float* y, float* gx, int64_t l, int forces, int device,
                       void* stream);

// The same through K6 (forces = 0) or K8 on the tables of a blocked
// artifact (ops/fused_blocked.py artifact_tables); pairs is the pair
// operand (null where the model has no coordination feature).
int molann_op_blocked(const int64_t* meta, int n_meta, const int* ints, const float* floats,
                      const int* pairs, const float* x, float* y, float* gx, int64_t l,
                      int forces, int device, void* stream);

#ifdef __cplusplus
}  // extern "C"
#endif

#endif  // MOLANN_TORCH_OPS_LAUNCH_H_

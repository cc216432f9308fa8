// C ABI of the native trajectory loader (traj_loader.cpp).
// Consumed via ctypes from Python (molann_tpu_torch/io/native_loader.py).
#ifndef MOLANN_TPU_TRAJ_LOADER_H_
#define MOLANN_TPU_TRAJ_LOADER_H_

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

// Last error message for the calling thread (valid until the next call).
const char* tl_last_error();

// Open a trajectory (.npy / .dcd / .trr / .xtc / Amber .nc, auto-detected
// by magic).
// Returns an opaque handle (NULL on error) and fills frame geometry.
void* tl_open(const char* path, int64_t* out_n_frames,
              int64_t* out_floats_per_frame);

void tl_close(void* handle);

// Gather `count` frames by index into `out` ([count, floats_per_frame],
// packed atom-major float32). Returns 0, or -1 on error.
int tl_read_batch(void* handle, const int64_t* indices, int64_t count,
                  float* out, int n_threads);

// Contiguous range read. Returns 0, or -1 on error.
int tl_read_range(void* handle, int64_t start, int64_t count, float* out);

// Queue asynchronous page prefetch of the given frames.
void tl_prefetch(void* handle, const int64_t* indices, int64_t count);

#ifdef __cplusplus
}  // extern "C"
#endif

#endif  // MOLANN_TPU_TRAJ_LOADER_H_

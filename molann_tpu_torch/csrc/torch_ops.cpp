// The torch custom ops of the engine artifact: their schemas and the
// launch counts. Built by g++ against PyTorch alone (ops/_build.py
// load_op_library), so that an artifact that calls the ops can be
// scripted, saved and loaded on a machine without a card or nvcc.
//
// Each op is one hand-written CUDA kernel of molann_tpu_torch/csrc, run on
// the tables an artifact carries (io/export.py; the tables come from
// ops/fused.py and ops/fused_blocked.py artifact_tables):
//   unrolled_forward   K1, fused_unrolled.cu (molann_fused_forward, forces 0),
//                      replaces molann_tpu/ops/fused.py:578 _fwd_kernel;
//   unrolled_cv_forces K4, the same entry point with forces 1,
//                      replaces molann_tpu/ops/fused.py:1116 _cv_forces_kernel;
//   blocked_forward    K6, fused_blocked.cu molann_blocked_forward,
//                      replaces molann_tpu/ops/fused_blocked.py:1179;
//   blocked_cv_forces  K8, fused_blocked.cu molann_blocked_cv_forces,
//                      replaces molann_tpu/ops/fused_blocked.py:1398.
// Their CUDA implementations are in torch_ops_cuda.cpp, a library of its
// own that links this one. There is no CPU implementation: on CPU tensors
// the dispatcher refuses the call, as the JAX package's TPU-only fused
// artifact refuses a CPU.
//
// launch_counts() -> int64 [4]: the launches each op made in this process,
// in the order above (the ops count where a kernel is launched, not for an
// empty batch); reset_launch_counts() sets them to 0.

#include <atomic>

#include <ATen/core/Tensor.h>
#include <ATen/ops/empty.h>
#include <torch/library.h>

namespace {

std::atomic<int64_t> g_launches[4];

at::Tensor launch_counts() {
  at::Tensor out = at::empty({4}, at::kLong);
  int64_t* p = out.data_ptr<int64_t>();
  for (int i = 0; i < 4; ++i) p[i] = g_launches[i].load();
  return out;
}

void reset_launch_counts() {
  for (auto& c : g_launches) c.store(0);
}

}  // namespace

// One launch of op `op` (0-3, the order above), from the CUDA library.
extern "C" void molann_torch_ops_counted(int op) { g_launches[op].fetch_add(1); }

TORCH_LIBRARY(molann_tpu_torch, m) {
  m.def("unrolled_forward(Tensor x, Tensor ints, Tensor floats, int[] meta) -> Tensor");
  m.def("unrolled_cv_forces(Tensor x, Tensor ints, Tensor floats, int[] meta) -> (Tensor, Tensor)");
  m.def(
      "blocked_forward(Tensor x, Tensor ints, Tensor floats, Tensor pairs, int[] meta) -> Tensor");
  m.def(
      "blocked_cv_forces(Tensor x, Tensor ints, Tensor floats, Tensor pairs, int[] meta) -> "
      "(Tensor, Tensor)");
  m.def("launch_counts() -> Tensor", &launch_counts);
  m.def("reset_launch_counts() -> ()", &reset_launch_counts);
}

// CUDA implementations of the engine artifact's torch custom ops (schemas
// in torch_ops.cpp): K1, K4, K6 and K8 as torch.ops.molann_tpu_torch.*.
//
// Built by g++ against PyTorch, with the CUDA toolkit's headers for
// c10/cuda (ops/_build.py load_op_library), linked with torch_ops_launch.cpp, the
// schema library and the kernel library that ops/_build.py load_library
// builds with nvcc. No kernel body is here: each op checks its tensors,
// allocates the outputs, and hands the addresses to torch_ops_launch.cpp,
// which launches the kernel on PyTorch's current stream of the input's
// device, the stream the Python route launches on. The op then counts the
// launch. Inputs are x [l, n_atoms, 3] float32, contiguous, on a CUDA
// device, and the artifact's tables on the same device; the outputs are
// y [l, d_out] and, for the cv+forces ops, gx [l, n_atoms, 3], the
// gradient of sum(y).

#include <ATen/core/Tensor.h>
#include <ATen/ops/empty.h>
#include <c10/cuda/CUDAStream.h>
#include <torch/library.h>

#include <tuple>

#include "torch_ops_launch.h"

extern "C" void molann_torch_ops_counted(int op);  // torch_ops.cpp

namespace {

enum Op { kUnrolledForward, kUnrolledCvForces, kBlockedForward, kBlockedCvForces };
const char* const kNames[] = {"unrolled_forward", "unrolled_cv_forces", "blocked_forward",
                              "blocked_cv_forces"};

void check_rc(int rc, Op op) {
  TORCH_CHECK(rc == 0, "molann_tpu_torch::", kNames[op], " failed: ",
              rc < 0 ? molann_op_message(rc) : "cudaError", " ", rc);
}

void check_table(const at::Tensor& t, const at::Tensor& x, at::ScalarType type, const char* what,
                 Op op) {
  TORCH_CHECK(t.device() == x.device(), "molann_tpu_torch::", kNames[op], ": ", what, " is on ",
              t.device(), ", x on ", x.device(), " (move the artifact with .to(device))");
  TORCH_CHECK(t.scalar_type() == type && t.is_contiguous(), "molann_tpu_torch::", kNames[op],
              ": ", what, " must be contiguous ", type);
}

// Checks the call and allocates its outputs: (y, gx or undefined, n_pairs).
std::tuple<at::Tensor, at::Tensor, int64_t> prepare(const at::Tensor& x, const at::Tensor& ints,
                                                    const at::Tensor& floats,
                                                    c10::IntArrayRef meta, Op op) {
  const bool blocked = op == kBlockedForward || op == kBlockedCvForces;
  const bool forces = op == kUnrolledCvForces || op == kBlockedCvForces;
  int64_t n_atoms = 0, d_out = 0, n_pairs = 0;
  check_rc(molann_op_shape(meta.data(), (int)meta.size(), blocked, &n_atoms, &d_out, &n_pairs),
           op);
  TORCH_CHECK(x.is_cuda(), "molann_tpu_torch::", kNames[op], ": x must be a CUDA tensor");
  TORCH_CHECK(x.scalar_type() == at::kFloat && x.is_contiguous(), "molann_tpu_torch::",
              kNames[op], ": x must be contiguous float32");
  TORCH_CHECK(x.dim() == 3 && x.size(1) == n_atoms && x.size(2) == 3, "molann_tpu_torch::",
              kNames[op], ": x must be [l, ", n_atoms, ", 3], got ", x.sizes());
  check_table(ints, x, at::kInt, "ints", op);
  check_table(floats, x, at::kFloat, "floats", op);
  const int64_t l = x.size(0);
  at::Tensor y = at::empty({l, d_out}, x.options());
  at::Tensor gx = forces ? at::empty({l, n_atoms, 3}, x.options()) : at::Tensor();
  return {y, gx, n_pairs};
}

std::tuple<at::Tensor, at::Tensor> unrolled(const at::Tensor& x, const at::Tensor& ints,
                                            const at::Tensor& floats, c10::IntArrayRef meta,
                                            Op op) {
  auto [y, gx, n_pairs] = prepare(x, ints, floats, meta, op);
  (void)n_pairs;
  const int64_t l = x.size(0);
  if (l == 0) return {y, gx};
  const bool forces = op == kUnrolledCvForces;
  const int device = x.get_device();
  check_rc(molann_op_unrolled(meta.data(), (int)meta.size(), ints.data_ptr<int>(),
                              floats.data_ptr<float>(), x.data_ptr<float>(),
                              y.data_ptr<float>(), forces ? gx.data_ptr<float>() : nullptr, l,
                              forces, device, c10::cuda::getCurrentCUDAStream(device).stream()),
           op);
  molann_torch_ops_counted(op);
  return {y, gx};
}

std::tuple<at::Tensor, at::Tensor> blocked(const at::Tensor& x, const at::Tensor& ints,
                                           const at::Tensor& floats, const at::Tensor& pairs,
                                           c10::IntArrayRef meta, Op op) {
  auto [y, gx, n_pairs] = prepare(x, ints, floats, meta, op);
  if (n_pairs) {
    check_table(pairs, x, at::kInt, "pairs", op);
    TORCH_CHECK(pairs.numel() == n_pairs, "molann_tpu_torch::", kNames[op], ": pairs has ",
                pairs.numel(), " entries, the model's pair operand ", n_pairs);
  }
  const int64_t l = x.size(0);
  if (l == 0) return {y, gx};
  const bool forces = op == kBlockedCvForces;
  const int device = x.get_device();
  check_rc(molann_op_blocked(meta.data(), (int)meta.size(), ints.data_ptr<int>(),
                             floats.data_ptr<float>(), n_pairs ? pairs.data_ptr<int>() : nullptr,
                             x.data_ptr<float>(), y.data_ptr<float>(),
                             forces ? gx.data_ptr<float>() : nullptr, l, forces, device,
                             c10::cuda::getCurrentCUDAStream(device).stream()),
           op);
  molann_torch_ops_counted(op);
  return {y, gx};
}

at::Tensor unrolled_forward(const at::Tensor& x, const at::Tensor& ints, const at::Tensor& floats,
                            c10::IntArrayRef meta) {
  return std::get<0>(unrolled(x, ints, floats, meta, kUnrolledForward));
}

std::tuple<at::Tensor, at::Tensor> unrolled_cv_forces(const at::Tensor& x, const at::Tensor& ints,
                                                      const at::Tensor& floats,
                                                      c10::IntArrayRef meta) {
  return unrolled(x, ints, floats, meta, kUnrolledCvForces);
}

at::Tensor blocked_forward(const at::Tensor& x, const at::Tensor& ints, const at::Tensor& floats,
                           const at::Tensor& pairs, c10::IntArrayRef meta) {
  return std::get<0>(blocked(x, ints, floats, pairs, meta, kBlockedForward));
}

std::tuple<at::Tensor, at::Tensor> blocked_cv_forces(const at::Tensor& x, const at::Tensor& ints,
                                                     const at::Tensor& floats,
                                                     const at::Tensor& pairs,
                                                     c10::IntArrayRef meta) {
  return blocked(x, ints, floats, pairs, meta, kBlockedCvForces);
}

}  // namespace

TORCH_LIBRARY_IMPL(molann_tpu_torch, CUDA, m) {
  m.impl("unrolled_forward", &unrolled_forward);
  m.impl("unrolled_cv_forces", &unrolled_cv_forces);
  m.impl("blocked_forward", &blocked_forward);
  m.impl("blocked_cv_forces", &blocked_cv_forces);
}

// serve_torch: a no-Python serving container for molann_tpu_torch models.
//
// Loads an engine artifact (io/export.py export_artifact, or any
// TorchScript module that maps frames [l, n, 3] to CVs [l, d], such as a
// reference-layout export) with LibTorch and runs a trajectory through it:
// the way the reference's downstream engines load a .pt from C++ (reference
// README.rst:51). The counterpart of native/serve_pjrt.cpp, on one device.
//
//   serve_torch <artifact.pt> <traj> <out.npy> [batch] [--ops <lib.so>]...
//               [--device cuda|cpu] [--verbose]
//
// <traj>: any format the port's native loader reads (traj_loader.cpp):
// .npy, CHARMM/NAMD .dcd, GROMACS .trr and .xtc. out.npy: float32
// [n_frames, d] CV values. An artifact that returns (cvs, gradients) also
// gets the coordinate gradients [n_frames, 3n] (forces are their negative)
// written next to out.npy with a .grad.npy suffix. [batch] defaults to the
// artifact's fixed batch (its batch_size attribute) or 65536; every batch
// is read, padded with its last frame up to the batch (only the tail pays),
// copied to the device, run and copied back. --ops loads a library of
// custom ops before the artifact: a fused artifact calls
// torch.ops.molann_tpu_torch.*, whose CUDA implementations are the library
// ops/_build.py load_op_library builds (it loads the schemas and the
// kernels itself); without it loading a fused artifact fails. --device
// defaults to cuda and fails where there is no card. --verbose prints
// where the time went (read, copy in, run, copy out, store; each stage
// ended by a synchronise, the first batch's run, which loads the kernels
// and optimizes the TorchScript graph, also on its own) and the ops'
// launch counts. Gradient mode stays on: an eager gradient artifact takes
// torch.autograd.grad inside its forward.
//
// Build: ops/_build.py build_serve_torch (g++ against LibTorch).

#include <ATen/core/dispatch/Dispatcher.h>
#include <torch/cuda.h>
#include <torch/script.h>

#include <dlfcn.h>

#include <algorithm>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <exception>
#include <string>
#include <vector>

#include "traj_loader.h"

namespace {

[[noreturn]] void die(const std::string& msg) {
  std::fprintf(stderr, "serve_torch: %s\n", msg.c_str());
  std::exit(1);
}

double seconds_since(std::chrono::steady_clock::time_point t0) {
  return std::chrono::duration<double>(std::chrono::steady_clock::now() - t0).count();
}

void write_npy(const std::string& path, const float* data, int64_t rows, int64_t cols) {
  char dict[128];
  int n = std::snprintf(dict, sizeof(dict),
                        "{'descr': '<f4', 'fortran_order': False, 'shape': (%lld, %lld), }",
                        static_cast<long long>(rows), static_cast<long long>(cols));
  int total = ((10 + n + 1 + 63) / 64) * 64;  // newline-terminated, 64-padded
  std::string header(dict, n);
  header.append(total - 10 - n - 1, ' ');
  header.push_back('\n');
  FILE* f = std::fopen(path.c_str(), "wb");
  if (!f) die("cannot write " + path);
  uint16_t hlen = static_cast<uint16_t>(header.size());
  std::fwrite("\x93NUMPY\x01\x00", 1, 8, f);
  std::fwrite(&hlen, 2, 1, f);
  std::fwrite(header.data(), 1, header.size(), f);
  std::fwrite(data, sizeof(float), static_cast<size_t>(rows * cols), f);
  if (std::fclose(f) != 0) die("cannot write " + path);
}

// The launch counts of the artifact's ops, or an empty vector where no op
// library is loaded.
std::vector<int64_t> launch_counts() {
  auto op = c10::Dispatcher::singleton().findSchema({"molann_tpu_torch::launch_counts", ""});
  if (!op) return {};
  at::Tensor c = op->typed<at::Tensor()>().call();
  return std::vector<int64_t>(c.data_ptr<int64_t>(), c.data_ptr<int64_t>() + c.numel());
}

}  // namespace

int main(int argc, char** argv) {
  std::vector<std::string> pos, ops;
  std::string device_name = "cuda";
  bool verbose = false;
  for (int i = 1; i < argc; i++) {
    const std::string a = argv[i];
    if (a == "--ops" && i + 1 < argc) {
      ops.push_back(argv[++i]);
    } else if (a == "--device" && i + 1 < argc) {
      device_name = argv[++i];
    } else if (a == "--verbose") {
      verbose = true;
    } else if (a.rfind("--", 0) == 0) {
      die("unknown option " + a);
    } else {
      pos.push_back(a);
    }
  }
  if (pos.size() < 3 || pos.size() > 4) {
    std::fprintf(stderr,
                 "usage: %s <artifact.pt> <traj> <out.npy> [batch] [--ops <lib.so>]... "
                 "[--device cuda|cpu] [--verbose]\n",
                 argv[0]);
    return 2;
  }
  if (device_name != "cuda" && device_name != "cpu") die("--device must be cuda or cpu");
  const bool cuda = device_name == "cuda";
  if (cuda && !torch::cuda::is_available())
    die("no CUDA device: --device cuda (the default) needs a card; pass --device cpu for the host");
  const torch::Device device = cuda ? torch::Device(torch::kCUDA, 0) : torch::Device(torch::kCPU);

  for (const std::string& lib : ops) {
    if (!dlopen(lib.c_str(), RTLD_NOW | RTLD_GLOBAL))
      die("cannot load op library " + lib + ": " + dlerror());
  }
  torch::jit::script::Module module;
  try {
    module = torch::jit::load(pos[0], device);
  } catch (const c10::Error& e) {
    die("cannot load " + pos[0] + " (a fused artifact needs --ops <op library>): " +
        e.what_without_backtrace());
  } catch (const std::exception& e) {
    die("cannot load " + pos[0] + " (a fused artifact needs --ops <op library>): " + e.what());
  }
  int64_t fixed = 0;
  if (module.hasattr("batch_size")) fixed = module.attr("batch_size").toInt();
  int64_t B = fixed > 0 ? fixed : 65536;
  if (pos.size() == 4) {
    B = std::atoll(pos[3].c_str());
    if (B <= 0) die("batch must be a positive integer");
    if (fixed > 0 && B != fixed)
      die("the artifact takes batches of " + std::to_string(fixed) + " frames, not " + pos[3]);
  }

  int64_t n_frames = 0, fpf = 0;
  void* ldr = tl_open(pos[1].c_str(), &n_frames, &fpf);
  if (!ldr) die(std::string("open trajectory: ") + tl_last_error());
  const int64_t n_atoms = fpf / 3;
  if (n_frames <= 0) die("the trajectory has no frames");
  std::fprintf(stderr, "trajectory: %lld frames x %lld atoms; batch %lld on %s\n",
               static_cast<long long>(n_frames), static_cast<long long>(n_atoms),
               static_cast<long long>(B), device.str().c_str());

  const std::vector<int64_t> counts0 = launch_counts();
  std::vector<float> host(static_cast<size_t>(B * fpf));
  std::vector<float> out_all, grad_all;
  int64_t d_out = -1;
  bool want_grad = false;
  double read_s = 0, in_s = 0, run_s = 0, first_run_s = 0, out_s = 0, store_s = 0;
  const auto t_serve0 = std::chrono::steady_clock::now();
  for (int64_t start = 0; start < n_frames; start += B) {
    const int64_t take = std::min(B, n_frames - start);
    auto t0 = std::chrono::steady_clock::now();
    if (tl_read_range(ldr, start, take, host.data()) != 0)
      die(std::string("read trajectory: ") + tl_last_error());
    for (int64_t r = take; r < B; r++)  // pad the tail with its last frame
      std::memcpy(host.data() + r * fpf, host.data() + (take - 1) * fpf, fpf * sizeof(float));
    read_s += seconds_since(t0);

    t0 = std::chrono::steady_clock::now();
    at::Tensor x = torch::from_blob(host.data(), {B, n_atoms, 3}, torch::kFloat).to(device);
    if (cuda) torch::cuda::synchronize();
    in_s += seconds_since(t0);

    t0 = std::chrono::steady_clock::now();
    c10::IValue res;
    try {
      res = module.forward({x});
    } catch (const c10::Error& e) {
      die(std::string("artifact failed: ") + e.what_without_backtrace());
    } catch (const std::exception& e) {
      die(std::string("artifact failed: ") + e.what());
    }
    if (cuda) torch::cuda::synchronize();
    if (start == 0) first_run_s = seconds_since(t0);
    run_s += seconds_since(t0);

    t0 = std::chrono::steady_clock::now();
    at::Tensor y, g;
    if (res.isTuple()) {
      const auto& el = res.toTupleRef().elements();
      if (el.size() != 2) die("the artifact returns a tuple of " + std::to_string(el.size()));
      y = el[0].toTensor().detach().to(torch::kCPU).contiguous();
      g = el[1].toTensor().detach().to(torch::kCPU).contiguous();
    } else {
      y = res.toTensor().detach().to(torch::kCPU).contiguous();
    }
    out_s += seconds_since(t0);

    t0 = std::chrono::steady_clock::now();
    if (d_out < 0) {
      d_out = y.size(1);
      want_grad = g.defined();
      out_all.resize(static_cast<size_t>(n_frames * d_out));
      if (want_grad) grad_all.resize(static_cast<size_t>(n_frames * fpf));
    }
    if (y.dim() != 2 || y.size(0) != B || y.size(1) != d_out || y.scalar_type() != torch::kFloat)
      die("the artifact's output is not float32 [batch, d]");
    std::memcpy(out_all.data() + start * d_out, y.data_ptr<float>(),
                static_cast<size_t>(take * d_out) * sizeof(float));
    if (want_grad) {
      if (g.numel() != B * fpf || g.scalar_type() != torch::kFloat)
        die("the artifact's gradient is not float32 [batch, n, 3]");
      std::memcpy(grad_all.data() + start * fpf, g.data_ptr<float>(),
                  static_cast<size_t>(take * fpf) * sizeof(float));
    }
    store_s += seconds_since(t0);
  }
  const double serve_s = seconds_since(t_serve0);
  std::fprintf(stderr, "served %lld frames in %.6f s (%.6g frames/s, %s)\n",
               static_cast<long long>(n_frames), serve_s, n_frames / serve_s,
               device.str().c_str());
  if (verbose) {
    std::fprintf(stderr,
                 "timing: read %.6f s, copy in %.6f s, run %.6f s (the first batch %.6f s), "
                 "copy out %.6f s, store %.6f s\n",
                 read_s, in_s, run_s, first_run_s, out_s, store_s);
    const std::vector<int64_t> counts = launch_counts();
    if (counts.size() == 4 && counts0.size() == 4)
      std::fprintf(stderr,
                   "launches: unrolled_forward %lld, unrolled_cv_forces %lld, blocked_forward "
                   "%lld, blocked_cv_forces %lld\n",
                   static_cast<long long>(counts[0] - counts0[0]),
                   static_cast<long long>(counts[1] - counts0[1]),
                   static_cast<long long>(counts[2] - counts0[2]),
                   static_cast<long long>(counts[3] - counts0[3]));
  }
  tl_close(ldr);
  write_npy(pos[2], out_all.data(), n_frames, d_out);
  std::fprintf(stderr, "wrote %s: [%lld, %lld]\n", pos[2].c_str(),
               static_cast<long long>(n_frames), static_cast<long long>(d_out));
  if (want_grad) {
    std::string gpath = pos[2];
    const size_t dot = gpath.rfind(".npy");
    gpath = (dot == std::string::npos ? gpath : gpath.substr(0, dot)) + ".grad.npy";
    write_npy(gpath, grad_all.data(), n_frames, fpf);
    std::fprintf(stderr, "wrote %s: [%lld, %lld]\n", gpath.c_str(),
                 static_cast<long long>(n_frames), static_cast<long long>(fpf));
  }
  return 0;
}

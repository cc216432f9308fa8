// serve_torch: a no-Python serving container for molann_tpu_torch models.
//
// Loads an engine artifact (io/export.py export_artifact, or any
// TorchScript module that maps frames [l, n, 3] to CVs [l, d], such as a
// reference-layout export) with LibTorch and runs a trajectory through it:
// the way the reference's downstream engines load a .pt from C++ (reference
// README.rst:51). The counterpart of native/serve_pjrt.cpp.
//
//   serve_torch <artifact.pt> <traj> <out.npy> [batch] [--ops <lib.so>]...
//               [--device cuda|cpu] [--in-flight K] [--verbose]
//
// <traj>: any format the port's native loader reads (traj_loader.cpp):
// .npy, CHARMM/NAMD .dcd, GROMACS .trr and .xtc. out.npy: float32
// [n_frames, d] CV values. An artifact that returns (cvs, gradients) also
// gets the coordinate gradients [n_frames, 3n] (forces are their negative)
// written next to out.npy with a .grad.npy suffix. [batch] defaults to the
// artifact's fixed batch (its batch_size attribute) or 65536; every batch
// is read, padded with its last frame up to the batch (only the tail pays),
// copied to the device, run and copied back.
//
// On the card, batches go round robin over every visible CUDA device, with
// K batches in flight on each (--in-flight, default 2), as serve_pjrt does:
// each in-flight batch has pinned host staging and a device input buffer,
// each device a copy stream and a run stream; the copy in runs on the copy
// stream, the artifact and the copy out on the run stream after an event,
// and the host waits only for a batch's last event before it reuses its
// buffers, storing its outputs in batch order. The artifact is loaded once
// per device. --device cpu runs the batches one after another. --ops loads a library of
// custom ops before the artifact: a fused artifact calls
// torch.ops.molann_tpu_torch.*, whose CUDA implementations are the library
// ops/_build.py load_op_library builds (it loads the schemas and the
// kernels itself); without it loading a fused artifact fails. --device
// defaults to cuda and fails where there is no card. --verbose prints
// where the time went (on the host: read and store; on the card, sums of
// CUDA event times: copy in, run, copy out, which overlap across batches;
// on the host side the first call of the artifact, which optimizes the
// TorchScript graph, on its own), the devices and batches in flight, and
// the ops' launch counts. Gradient mode stays on: an eager gradient
// artifact takes torch.autograd.grad inside its forward.
//
// Build: ops/_build.py build_serve_torch (g++ against LibTorch).

#include <ATen/core/dispatch/Dispatcher.h>
#include <c10/core/Event.h>
#include <c10/core/Stream.h>
#include <c10/core/StreamGuard.h>
#include <c10/core/impl/DeviceGuardImplInterface.h>
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
#include <memory>
#include <string>
#include <utility>
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

torch::jit::script::Module load_module(const std::string& path, const torch::Device& device) {
  try {
    return torch::jit::load(path, device);
  } catch (const c10::Error& e) {
    die("cannot load " + path + " (a fused artifact needs --ops <op library>): " +
        e.what_without_backtrace());
  } catch (const std::exception& e) {
    die("cannot load " + path + " (a fused artifact needs --ops <op library>): " + e.what());
  }
}

// The artifact on one batch: (cvs, gradients or an undefined tensor).
std::pair<at::Tensor, at::Tensor> run_artifact(torch::jit::script::Module& module,
                                               const at::Tensor& x) {
  c10::IValue res;
  try {
    res = module.forward({x});
  } catch (const c10::Error& e) {
    die(std::string("artifact failed: ") + e.what_without_backtrace());
  } catch (const std::exception& e) {
    die(std::string("artifact failed: ") + e.what());
  }
  if (!res.isTuple()) return {res.toTensor().detach(), at::Tensor()};
  const auto& el = res.toTupleRef().elements();
  if (el.size() != 2) die("the artifact returns a tuple of " + std::to_string(el.size()));
  return {el[0].toTensor().detach(), el[1].toTensor().detach()};
}

// The outputs of every frame, stored batch by batch in batch order.
struct Store {
  int64_t n_frames, fpf, B;
  int64_t d_out = -1;
  bool want_grad = false;
  std::vector<float> out_all, grad_all;

  // y [B, d] and g (undefined, or B * fpf floats) on the host, contiguous
  void put(const at::Tensor& y, const at::Tensor& g, int64_t start, int64_t take) {
    if (d_out < 0) {
      if (y.dim() != 2) die("the artifact's output is not float32 [batch, d]");
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
      if (!g.defined() || g.numel() != B * fpf || g.scalar_type() != torch::kFloat)
        die("the artifact's gradient is not float32 [batch, n, 3]");
      std::memcpy(grad_all.data() + start * fpf, g.data_ptr<float>(),
                  static_cast<size_t>(take * fpf) * sizeof(float));
    }
  }
};

// Read frames [start, start + take) into host (B frames), padding the tail
// with its last frame.
void read_batch(void* ldr, int64_t start, int64_t take, int64_t B, int64_t fpf, float* host) {
  if (tl_read_range(ldr, start, take, host) != 0)
    die(std::string("read trajectory: ") + tl_last_error());
  for (int64_t r = take; r < B; r++)
    std::memcpy(host + r * fpf, host + (take - 1) * fpf, fpf * sizeof(float));
}

struct Times {
  double read = 0, in = 0, run = 0, first_call = 0, out = 0, store = 0;
};

// --device cpu: one batch after another.
void serve_serial(torch::jit::script::Module& module, void* ldr, Store& st, int64_t n_atoms,
                  Times& t) {
  std::vector<float> host(static_cast<size_t>(st.B * st.fpf));
  for (int64_t start = 0; start < st.n_frames; start += st.B) {
    const int64_t take = std::min(st.B, st.n_frames - start);
    auto t0 = std::chrono::steady_clock::now();
    read_batch(ldr, start, take, st.B, st.fpf, host.data());
    t.read += seconds_since(t0);
    t0 = std::chrono::steady_clock::now();
    at::Tensor x = torch::from_blob(host.data(), {st.B, n_atoms, 3}, torch::kFloat).clone();
    t.in += seconds_since(t0);
    t0 = std::chrono::steady_clock::now();
    auto [y, g] = run_artifact(module, x);
    if (start == 0) t.first_call = seconds_since(t0);
    t.run += seconds_since(t0);
    t0 = std::chrono::steady_clock::now();
    y = y.contiguous();
    if (g.defined()) g = g.contiguous();
    t.out += seconds_since(t0);
    t0 = std::chrono::steady_clock::now();
    st.put(y, g, start, take);
    t.store += seconds_since(t0);
  }
}

// One batch in flight: its pinned staging, device input, outputs and events.
struct Slot {
  at::Tensor pinned_in, dev_in, y_dev, g_dev, y_host, g_host;
  c10::Event in0{c10::DeviceType::CUDA, c10::EventFlag::BACKEND_DEFAULT};
  c10::Event in1{c10::DeviceType::CUDA, c10::EventFlag::BACKEND_DEFAULT};
  c10::Event run0{c10::DeviceType::CUDA, c10::EventFlag::BACKEND_DEFAULT};
  c10::Event run1{c10::DeviceType::CUDA, c10::EventFlag::BACKEND_DEFAULT};
  c10::Event done{c10::DeviceType::CUDA, c10::EventFlag::BACKEND_DEFAULT};
  int64_t start = 0, take = 0;
  bool busy = false;
};

struct Card {
  torch::jit::script::Module module;
  c10::Stream copy, run;
};

c10::Stream pool_stream(int device) {
  return c10::impl::getDeviceGuardImpl(c10::DeviceType::CUDA)
      ->getStreamFromGlobalPool(c10::Device(c10::DeviceType::CUDA, device), false);
}

// The card: batches round robin over the devices, in_flight on each.
void serve_pipelined(std::vector<Card>& cards, int64_t in_flight, void* ldr, Store& st,
                     int64_t n_atoms, Times& t) {
  const int64_t n_dev = static_cast<int64_t>(cards.size());
  std::vector<std::unique_ptr<Slot>> slots;
  for (int64_t i = 0; i < n_dev * in_flight; i++) {
    const int d = static_cast<int>(i / in_flight);
    auto s = std::make_unique<Slot>();
    s->pinned_in = torch::empty({st.B, n_atoms, 3},
                                torch::TensorOptions().dtype(torch::kFloat).pinned_memory(true));
    s->dev_in = torch::empty({st.B, n_atoms, 3}, torch::TensorOptions()
                                                     .dtype(torch::kFloat)
                                                     .device(torch::kCUDA, d));
    slots.push_back(std::move(s));
  }
  auto finish = [&](Slot& s) {
    s.done.synchronize();
    t.in += s.in0.elapsedTime(s.in1) / 1e3;
    t.run += s.run0.elapsedTime(s.run1) / 1e3;
    t.out += s.run1.elapsedTime(s.done) / 1e3;
    const auto t0 = std::chrono::steady_clock::now();
    st.put(s.y_host, s.g_host, s.start, s.take);
    t.store += seconds_since(t0);
    s.y_dev = s.g_dev = at::Tensor();
    s.busy = false;
  };
  const int64_t n_batches = (st.n_frames + st.B - 1) / st.B;
  for (int64_t bi = 0; bi < n_batches; bi++) {
    const int64_t d = bi % n_dev;
    Card& card = cards[d];
    Slot& s = *slots[d * in_flight + (bi / n_dev) % in_flight];
    if (s.busy) finish(s);  // the batch n_dev * in_flight before this one
    s.start = bi * st.B;
    s.take = std::min(st.B, st.n_frames - s.start);
    auto t0 = std::chrono::steady_clock::now();
    read_batch(ldr, s.start, s.take, st.B, st.fpf, s.pinned_in.data_ptr<float>());
    t.read += seconds_since(t0);
    {
      c10::StreamGuard guard(card.copy);
      s.in0.record(card.copy);
      s.dev_in.copy_(s.pinned_in, /*non_blocking=*/true);
      s.in1.record(card.copy);
    }
    s.in1.block(card.run);
    {
      c10::StreamGuard guard(card.run);
      s.run0.record(card.run);
      t0 = std::chrono::steady_clock::now();
      auto [y, g] = run_artifact(card.module, s.dev_in);
      if (bi == 0) t.first_call = seconds_since(t0);
      s.run1.record(card.run);
      s.y_dev = y.contiguous();
      s.g_dev = g.defined() ? g.contiguous() : g;
      auto pinned = [](const at::Tensor& like) {
        return torch::empty(like.sizes(),
                            torch::TensorOptions().dtype(like.dtype()).pinned_memory(true));
      };
      if (!s.y_host.defined() || s.y_host.sizes() != s.y_dev.sizes()) s.y_host = pinned(s.y_dev);
      s.y_host.copy_(s.y_dev, /*non_blocking=*/true);
      if (s.g_dev.defined()) {
        if (!s.g_host.defined() || s.g_host.sizes() != s.g_dev.sizes()) s.g_host = pinned(s.g_dev);
        s.g_host.copy_(s.g_dev, /*non_blocking=*/true);
      } else {
        s.g_host = at::Tensor();
      }
      s.done.record(card.run);
    }
    s.busy = true;
  }
  // the batches still in flight, in batch order
  for (int64_t bi = std::max<int64_t>(0, n_batches - n_dev * in_flight); bi < n_batches; bi++) {
    Slot& s = *slots[(bi % n_dev) * in_flight + (bi / n_dev) % in_flight];
    if (s.busy) finish(s);
  }
}

}  // namespace

int main(int argc, char** argv) {
  std::vector<std::string> pos, ops;
  std::string device_name = "cuda";
  bool verbose = false;
  int64_t in_flight = 2;
  for (int i = 1; i < argc; i++) {
    const std::string a = argv[i];
    if (a == "--ops" && i + 1 < argc) {
      ops.push_back(argv[++i]);
    } else if (a == "--device" && i + 1 < argc) {
      device_name = argv[++i];
    } else if (a == "--in-flight" && i + 1 < argc) {
      in_flight = std::atoll(argv[++i]);
      if (in_flight <= 0) die("--in-flight must be a positive integer");
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
                 "[--device cuda|cpu] [--in-flight K] [--verbose]\n",
                 argv[0]);
    return 2;
  }
  if (device_name != "cuda" && device_name != "cpu") die("--device must be cuda or cpu");
  const bool cuda = device_name == "cuda";
  if (cuda && !torch::cuda::is_available())
    die("no CUDA device: --device cuda (the default) needs a card; pass --device cpu for the host");
  const int n_dev = cuda ? static_cast<int>(torch::cuda::device_count()) : 1;

  for (const std::string& lib : ops) {
    if (!dlopen(lib.c_str(), RTLD_NOW | RTLD_GLOBAL))
      die("cannot load op library " + lib + ": " + dlerror());
  }
  std::vector<Card> cards;
  torch::jit::script::Module host_module;
  if (cuda) {
    for (int d = 0; d < n_dev; d++)
      cards.push_back(Card{load_module(pos[0], torch::Device(torch::kCUDA, d)), pool_stream(d),
                           pool_stream(d)});
  } else {
    host_module = load_module(pos[0], torch::Device(torch::kCPU));
  }
  torch::jit::script::Module& first = cuda ? cards[0].module : host_module;
  int64_t fixed = 0;
  if (first.hasattr("batch_size")) fixed = first.attr("batch_size").toInt();
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
  const std::string where = cuda ? std::to_string(n_dev) + " cuda device(s), " +
                                       std::to_string(in_flight) + " batches in flight on each"
                                 : std::string("cpu");
  std::fprintf(stderr, "trajectory: %lld frames x %lld atoms; batch %lld on %s\n",
               static_cast<long long>(n_frames), static_cast<long long>(n_atoms),
               static_cast<long long>(B), where.c_str());

  const std::vector<int64_t> counts0 = launch_counts();
  Store st{n_frames, fpf, B};
  Times t;
  const auto t_serve0 = std::chrono::steady_clock::now();
  if (cuda) {
    serve_pipelined(cards, in_flight, ldr, st, n_atoms, t);
  } else {
    serve_serial(host_module, ldr, st, n_atoms, t);
  }
  const double serve_s = seconds_since(t_serve0);
  std::fprintf(stderr, "served %lld frames in %.6f s (%.6g frames/s, %s)\n",
               static_cast<long long>(n_frames), serve_s, n_frames / serve_s, where.c_str());
  if (verbose) {
    std::fprintf(stderr,
                 "timing: read %.6f s, copy in %.6f s, run %.6f s (the first call %.6f s), "
                 "copy out %.6f s, store %.6f s (%s: copy in, run and copy out are %s)\n",
                 t.read, t.in, t.run, t.first_call, t.out, t.store, where.c_str(),
                 cuda ? "sums of CUDA event times, overlapping across batches"
                      : "host times");
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
  write_npy(pos[2], st.out_all.data(), n_frames, st.d_out);
  std::fprintf(stderr, "wrote %s: [%lld, %lld]\n", pos[2].c_str(),
               static_cast<long long>(n_frames), static_cast<long long>(st.d_out));
  if (st.want_grad) {
    std::string gpath = pos[2];
    const size_t dot = gpath.rfind(".npy");
    gpath = (dot == std::string::npos ? gpath : gpath.substr(0, dot)) + ".grad.npy";
    write_npy(gpath, st.grad_all.data(), n_frames, fpf);
    std::fprintf(stderr, "wrote %s: [%lld, %lld]\n", gpath.c_str(),
                 static_cast<long long>(n_frames), static_cast<long long>(fpf));
  }
  return 0;
}

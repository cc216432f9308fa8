"""The unrolled kernels' times on the alanine model, on one CUDA card.

    python molann_tpu_torch/probes/unrolled_probe.py [tag]

Prints one JSON line: the mean CUDA-event time of one call, after five
warm-up calls, of the forward (K1), cv+forces (K4, ``[l, n, 3]`` and
``[3n, l]``), backward (K2, as ``torch.autograd.grad`` through a retained
graph) and train (K3, both layouts) kernels on one 65,536-frame batch of
``alanine_model()`` (weights from seed 0, frames from seed 3), and each
kernel's own time by name from ``torch.profiler`` over 20 calls of each.
The event times include the wrappers' host work, which for K1 and K2 is
most of them; the profiler's are the kernels alone.

Run as a file it imports ``molann_tpu_torch`` from the current directory,
not from beside itself. So two commits compare in one call on one card:
unpack the other commit into a directory git ignores (``git archive``),
and run this same file from both roots in turns (parent, change, change,
parent), with a tag to tell the lines apart.
"""

import json
import sys

import numpy as np
import torch

BATCH = 65536


def cuda_ms(fn, reps=100):
    for _ in range(5):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main(argv):
    from torch.profiler import ProfilerActivity, profile

    from molann_tpu_torch.ops import fused as F
    from molann_tpu_torch.systems import alanine_model

    if not torch.cuda.is_available():
        raise SystemExit("unrolled_probe: no CUDA card")
    dev = torch.device("cuda:0")
    model, u = alanine_model(generator=torch.Generator().manual_seed(0),
                             device=dev)
    n = u.atoms.n_atoms
    x = torch.as_tensor((u.atoms.positions[None] + 0.05 * np.random.default_rng(
        3).normal(size=(BATCH, n, 3))).astype(np.float32), device=dev)
    xt = x.reshape(BATCH, 3 * n).T.contiguous()
    gy = torch.as_tensor(np.random.default_rng(7).normal(
        size=(BATCH, 3)).astype(np.float32), device=dev)
    gyt = gy.T.contiguous()
    xg = x.clone().requires_grad_(True)
    yk = F.fused_model_forward(model, xg)
    leaves = [xg, *model.parameters()]

    def backward():
        return torch.autograd.grad(yk, leaves, gy, retain_graph=True)

    with torch.no_grad():
        k1 = cuda_ms(lambda: F.fused_model_forward(model, x))
    out = {
        "tag": argv[0] if argv else "", "K1 ms": k1,
        "K4 [l, n, 3] ms": cuda_ms(lambda: F.fused_cv_forces(model, x)),
        "K4 [3n, l] ms": cuda_ms(lambda: F.fused_cv_forces(
            model, xt, transposed_input=True)),
        "K2 ms": cuda_ms(backward),
        "K3 [3n, l] ms": cuda_ms(lambda: F.fused_train_grads(
            model, xt, gyt, transposed_input=True)),
        "K3 [l, n, 3] ms": cuda_ms(lambda: F.fused_train_grads(model, x, gy)),
    }
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            with torch.no_grad():
                F.fused_model_forward(model, x)
            F.fused_cv_forces(model, x)
            backward()
            F.fused_train_grads(model, x, gy)
        torch.cuda.synchronize()
    names = {"fused_unrolled_kernel<false>": "K1", "fused_unrolled_kernel<true>":
             "K4", "fused_grads_kernel<false>": "K2",
             "fused_grads_kernel<true>": "K3", "reduce_partials": "reduce"}
    for event in prof.key_averages():
        for key, name in names.items():
            if key in event.key:
                total = getattr(event, "device_time_total", None)
                if total is None:
                    total = event.cuda_time_total
                out[f"{name} kernel alone ms"] = total / event.count / 1e3
    print(json.dumps(out))


if __name__ == "__main__":
    sys.path.insert(0, ".")
    main(sys.argv[1:])

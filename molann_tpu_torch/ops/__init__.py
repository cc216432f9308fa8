"""Tensor ops of the port: feature math, Kabsch alignment, and the fused
serving ops with their CUDA kernels (:mod:`.fused` for small systems,
:mod:`.fused_blocked` for large and condensed-phase ones)."""

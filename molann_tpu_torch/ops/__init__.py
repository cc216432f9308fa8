"""Tensor ops of the port: feature math, Kabsch alignment, and the fused
serving ops with their CUDA kernels (:mod:`.fused`)."""

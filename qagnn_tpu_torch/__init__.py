"""qagnn_tpu_torch: the PyTorch / CUDA (H100) port of qagnn_tpu.

Module names match the JAX package so each counterpart is easy to find.
The package imports torch and numpy only; its hand-written CUDA kernels
live in `csrc/` and are built with nvcc on first use
(qagnn_tpu_torch.ops._build).
"""

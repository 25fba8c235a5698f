"""PyTorch / CUDA port of the DGSU system, for an NVIDIA H100.

Beside the JAX reference package `repro`, this package imports `torch` and
nothing of `repro` or `jax`. Its layout mirrors the reference's; the CUDA
kernels that replace the reference's TPU kernels live in
`repro_torch/kernels/csrc/` and are built with `nvcc` at first use.
"""

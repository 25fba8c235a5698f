"""Hand-written CUDA kernels (csrc/), their plain PyTorch versions (ref.py),
the nvcc build (build.py) and the dispatching wrappers (ops.py)."""

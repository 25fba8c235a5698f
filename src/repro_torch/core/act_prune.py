"""Block activation pruning (ZeBRA [11], paper §III-A.2).

Zero every `block`-wide run of channels whose max |x| is below the
threshold. Paper settings: block=2, threshold=0.15. The op runs through the
kernel wrapper `kernels.ops.block_act_prune`: on a CUDA tensor it launches
the CUDA kernel (forward and backward), on a CPU tensor it runs the plain
version. There is no switch between the two.
"""
from __future__ import annotations

from functools import partial

import torch

from repro_torch.kernels.ops import block_act_prune


def make_act_pruner(threshold: float = 0.15, block: int = 2):
    """The pruner the CNN's forward applies after every ReLU6."""
    return partial(block_act_prune, threshold=threshold, block=block)


def block_sparsity(x, threshold: float = 0.15, block: int = 2) -> torch.Tensor:
    """Fraction of zeroed blocks (the paper's activation-sparsity metric)."""
    c = x.shape[-1]
    xb = x.reshape(x.shape[:-1] + (c // block, block))
    pruned = xb.abs().amax(dim=-1) < threshold
    return pruned.float().mean()


__all__ = ["block_act_prune", "block_sparsity", "make_act_pruner"]

"""The paper's contribution: dynamic gradient sparse update.

- sparse_update: sparse matmul (compact dW for selected channel blocks),
  frozen/trainable layer-stack splitting
- selection: later-layers-first + constant-ratio channel-block selection
- schedule: Algorithm 1's fixed/dynamic/fixed three-phase schedule
- memory: per-device training-memory model and the budget solver
"""
from repro_torch.core.sparse_update import (SelSpec, merge_stack, smm,
                                            split_stack)

__all__ = ["SelSpec", "merge_stack", "smm", "split_stack"]

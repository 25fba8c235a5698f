"""Arch registry: abstract params (shapes without allocating), used by the
selection planner and the memory model."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T


def abstract_params(cfg: ModelConfig):
    """The param tree on the `meta` device: shapes and dtypes only."""
    return T.init_params(cfg, device="meta")

"""Shared model utilities: parameter init from an explicit `torch.Generator`.

Parameters are drawn on the device the generator (or `device`) names; the
`meta` device gives shapes without allocating (see `registry`). The port's
draws differ from the reference's `jax.random` ones for the same seed, so
tests that compare the two packages carry the reference's parameters over
with `repro_torch.bridge`.
"""
from __future__ import annotations

import math

import torch


def dense_init(gen, shape, in_axis=0, dtype=torch.float32, scale: float = 1.0,
               device="cuda"):
    """Truncated-normal fan-in init (matches common LM init), drawn in fp32
    and cast to `dtype`."""
    fan_in = shape[in_axis] if in_axis is not None else math.prod(shape[:-1])
    std = scale / math.sqrt(fan_in)
    t = torch.empty(shape, dtype=torch.float32, device=device)
    if t.device.type != "meta":
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (t * std).to(dtype)


def embed_init(gen, shape, dtype=torch.float32, device="cuda"):
    t = torch.empty(shape, dtype=torch.float32, device=device)
    if t.device.type != "meta":
        t.normal_(0.0, 1.0, generator=gen)
    return (t * 0.02).to(dtype)

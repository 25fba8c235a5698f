"""Token sampling for the serving engine: greedy and temperature.

`temperature` <= 0 means greedy argmax (the first index among equal maxima,
as `jnp.argmax`); > 0 scales the logits and draws from the categorical with
an explicit `torch.Generator`, which the engine owns and advances, so
consecutive steps never reuse randomness. The port cannot replay
`jax.random`: its draws are checked by their properties (one seed, one
sequence; another seed, another sequence), not draw for draw.
"""
from __future__ import annotations

from typing import Optional

import torch


def sample_token(logits, generator: Optional[torch.Generator] = None,
                 temperature: float = 0.0):
    """logits [B, V] -> token ids [B] (int32)."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)

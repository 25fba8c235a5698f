"""Shared model utilities: parameter init from an explicit `torch.Generator`,
and the linear primitives the serving path is built from.

Parameters are drawn on the device the generator (or `device`) names; the
`meta` device gives shapes without allocating (see `registry`). The port's
draws differ from the reference's `jax.random` ones for the same seed, so
tests that compare the two packages carry the reference's parameters over
with `repro_torch.bridge`.

`col_matmul` / `row_matmul` / `vocab_parallel_gather` are the reference's
parallel primitives. Off a mesh they are their single-device forms
(`smm(x, w)` plus a per-user compact delta, `delta_matmul_add`; an
embedding lookup). On a rank of a process mesh (`sharding.model_group()`)
they take the collective a weight that arrived sharded needs, found by
its shape: a weight that arrived whole (its dim did not divide the model
axis) takes none. The collective in front of a column-parallel block
(`sharding.copy_to_model`, all-reduce backward) is the block's caller's:
one for all of a block's column-parallel products. Per-user deltas on
sharded weights (`_delta_local_col`) come with sharded serving (ROADMAP
item 14b).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch import sharding as SH
from repro_torch.core.sparse_update import smm


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


def last_valid(x, length):
    """x[:, length-1] per row ([B, S, ...] -> [B, ...]); x[:, -1] when
    `length` is None (serving chunks are padded to a fixed shape: the last
    VALID position is per-row data, not the last array position)."""
    if length is None:
        return x[:, -1]
    index = (length.long() - 1).reshape((-1, 1) + (1,) * (x.dim() - 2))
    index = index.expand((x.shape[0], 1) + tuple(x.shape[2:]))
    return torch.gather(x, 1, index)[:, 0]


def delta_matmul_add(y, x, delta, name: str):
    """Per-user compact-delta correction applied at matmul time.

    `y = smm(x, w)` already holds the base-model projection; this adds the
    user contribution `x @ delta` into ONLY the selected output-channel
    blocks (the gather-add dual of `scatter_param_blocks`), so no dense
    per-user weight copy ever exists. Zero-valued rows are an exact no-op.

      y      [B, S, N]
      delta["val"][name]  [B, d_in, n_shards, n_sel, block]  fp32
      delta["idx"][name]  [B, n_shards, n_sel]               int32

    The reference adds with `.at[...].add`; here the selected blocks are
    gathered, added in fp32 and written back without accumulation: block ids
    never repeat within a (row, shard), so the result is the reference's and
    no atomic scatter-add (whose order changes run to run on the card) is
    involved.
    """
    if delta is None or name not in delta["val"]:
        return y
    val, idx = delta["val"][name], delta["idx"][name]
    b, s, n = y.shape
    n_shards, n_sel, block = val.shape[-3:]
    n_blocks = n // (n_shards * block)
    extra = torch.einsum("bsk,bkhjc->bshjc", x.float(), val.float())
    yb = y.float().reshape(b, s, n_shards, n_blocks, block)
    index = idx.long()[:, None, :, :, None].expand(b, s, n_shards, n_sel,
                                                   block)
    yb = yb.scatter(3, index, torch.gather(yb, 3, index) + extra)
    return yb.reshape(b, s, n).to(y.dtype)


def _no_sharded_delta(w, delta, name: str, full: int, dim: int) -> None:
    if delta is not None and name in delta["val"] and full is not None \
            and w.shape[dim] != full and SH.model_group() is not None:
        raise NotImplementedError(
            f"a per-user delta on the sharded weight {name!r}: sharded "
            f"serving is ROADMAP item 14b")


def col_matmul(x, w, sel, name: str, delta=None, *,
               full_out: Optional[int] = None):
    """Column-parallel linear: the weight split on its OUTPUT axis, so the
    local product needs no collective and the result stays split on its
    last axis. `smm(x, w)` plus the rider delta of `name`, if any."""
    _no_sharded_delta(w, delta, name, full_out, -1)
    return delta_matmul_add(smm(x, w, sel, name), x, delta, name)


def row_matmul(x, w, sel, name: str, delta=None, *,
               full_in: Optional[int] = None):
    """Row-parallel linear: the weight split on its INPUT axis (x holds
    the matching slice), and one all-reduce over the model group
    (`psum_mapped`) reassembles the output. Off a mesh, or for a weight
    that arrived whole (`w.shape[-2] == full_in`), `smm(x, w)` plus the
    rider delta."""
    _no_sharded_delta(w, delta, name, full_in, -2)
    y = delta_matmul_add(smm(x, w, sel, name), x, delta, name)
    if full_in is not None and w.shape[-2] != full_in:
        SH.require_model_group(f"row-parallel weight {name!r}")
        return SH.psum_mapped(y)
    return y


def vocab_parallel_gather(emb, ids, vocab_size: int):
    """Embedding lookup on a vocab-sharded table: the rank gathers the rows
    it owns (other ids read row 0, masked to exact zero) and an all-reduce
    over the model group reassembles the rows: each token's row lives on
    one rank, so the sum is exact. A plain lookup off a mesh or when the
    table arrived whole."""
    v_loc = emb.shape[0]
    if v_loc == vocab_size:
        return F.embedding(ids.long(), emb)
    SH.require_model_group("the token table")
    local = ids.long() - SH.model_index() * v_loc
    own = (local >= 0) & (local < v_loc)
    rows = F.embedding(torch.where(own, local, 0), emb)
    rows = torch.where(own[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                         device=rows.device))
    return SH.psum_mapped(rows)

"""Shared model utilities: parameter init from an explicit `torch.Generator`,
and the linear primitives the serving path is built from.

Parameters are drawn on the device the generator (or `device`) names; the
`meta` device gives shapes without allocating (see `registry`). The port's
draws differ from the reference's `jax.random` ones for the same seed, so
tests that compare the two packages carry the reference's parameters over
with `repro_torch.bridge`.

`col_matmul` / `row_matmul` / `vocab_parallel_gather` /
`vocab_parallel_logits` are the reference's parallel primitives. Off a
mesh they are their single-device forms (`smm(x, w)` plus a per-user
compact delta, `delta_matmul_add`; an embedding lookup; the head's
product). On a rank of a process mesh (`sharding.model_group()`) they take
the collective a weight that arrived sharded needs, found by its shape: a
weight that arrived whole (its dim did not divide the model axis) takes
none. The collective in front of a column-parallel block
(`sharding.copy_to_model`, all-reduce backward) is the block's caller's:
one for all of a block's column-parallel products. A per-user delta stays
whole on every rank: a column-parallel product adds the selected blocks
the rank owns (`_delta_local_col`), a row-parallel one its rows of the
delta's d_in before the all-reduce.
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


def _delta_one(name: str, val, idx):
    return {"val": {name: val}, "idx": {name: idx}}


def _delta_local_col(y, x, delta, name: str, full_out: int):
    """A compact delta on a COLUMN-sharded product: the rank adds only the
    selected blocks it owns (no collective), each the single-device
    `delta_matmul_add`'s value. Three layouts, the reference's:

    - the selection's shards line up with the model axis (n_shards a
      multiple of the ranks): the rank's shards of idx / val;
    - one shard of global block ids: the ids the rank owns, made local;
      the others are sent to a spare block past the rank's columns and cut
      off (the port's scatter writes, so masked ids must not collide with
      a real one, as the reference's zero-add to block 0 may);
    - a block width that does not divide the rank's columns: the delta
      into a full-width zero buffer, and the rank's columns of it added
      (y + (0 + e) == y + e in fp32)."""
    val, idx = delta["val"][name], delta["idx"][name]
    n_loc = y.shape[-1]
    tp = full_out // n_loc
    shard = SH.model_index()
    n_shards, n_sel, block = val.shape[-3:]
    if n_shards % tp == 0:
        k = n_shards // tp
        return delta_matmul_add(
            y, x, _delta_one(name, val[..., shard * k:(shard + 1) * k, :, :],
                             idx[..., shard * k:(shard + 1) * k, :]), name)
    if n_shards == 1 and n_loc % block == 0:
        bps = n_loc // block
        own = (idx.long() // bps) == shard                  # [B, 1, n_sel]
        idx_loc = torch.where(own, idx.long() - shard * bps, bps)
        y_pad = F.pad(y, (0, block))
        y_pad = delta_matmul_add(y_pad, x, _delta_one(name, val, idx_loc),
                                 name)
        return y_pad[..., :n_loc]
    yf = delta_matmul_add(y.new_zeros(y.shape[:-1] + (full_out,),
                                      dtype=torch.float32), x, delta, name)
    corr = yf[..., shard * n_loc:(shard + 1) * n_loc]
    return (y.float() + corr).to(y.dtype)


def col_matmul(x, w, sel, name: str, delta=None, *,
               full_out: Optional[int] = None):
    """Column-parallel linear: the weight split on its OUTPUT axis, so the
    local product needs no collective and the result stays split on its
    last axis. `smm(x, w)` plus the rider delta of `name`, if any: on a
    weight that arrived sharded (`w.shape[-1] != full_out` on a mesh), the
    blocks of it the rank owns."""
    y = smm(x, w, sel, name)
    if delta is None or name not in delta["val"]:
        return y
    if SH.model_group() is None or full_out is None \
            or w.shape[-1] == full_out:
        return delta_matmul_add(y, x, delta, name)
    return _delta_local_col(y, x, delta, name, full_out)


def row_matmul(x, w, sel, name: str, delta=None, *,
               full_in: Optional[int] = None):
    """Row-parallel linear: the weight split on its INPUT axis (x holds
    the matching slice), and one all-reduce over the model group
    (`psum_mapped`) reassembles the output. A delta contracts over the
    split axis, so the rank applies its d_in rows of it before the
    all-reduce. Off a mesh, or for a weight that arrived whole
    (`w.shape[-2] == full_in`), `smm(x, w)` plus the rider delta."""
    y = smm(x, w, sel, name)
    sharded = full_in is not None and w.shape[-2] != full_in
    if sharded:
        SH.require_model_group(f"row-parallel weight {name!r}")
    if delta is not None and name in delta["val"]:
        if sharded:
            d_loc = w.shape[-2]
            lo = SH.model_index() * d_loc
            delta = _delta_one(name, delta["val"][name][:, lo:lo + d_loc],
                               delta["idx"][name])
        y = delta_matmul_add(y, x, delta, name)
    return SH.psum_mapped(y) if sharded else y


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


def vocab_parallel_logits(x, w_head, vocab_size: int):
    """[..., d] x [d, V] -> [..., V] fp32 logits (upcast first: the
    reference's preferred_element_type). On a vocab-sharded head the rank
    takes its [..., V/n] product and one all-gather over the model group
    puts the columns back in rank order, the values the whole product
    gives."""
    logits = torch.matmul(x.float(), w_head.float())
    if w_head.shape[-1] == vocab_size:
        return logits
    SH.require_model_group("the LM head")
    return SH.all_gather_mapped(logits, logits.dim() - 1, "logits")

"""Serving paths for the dense family: prefill (full prompt -> cache + last
logits), single-token decode against a contiguous cache (the oracle), and
`paged_step`, s >= 1 tokens per row against paged KV pools (what the serve
engine runs).

Caches follow the reference's layout: per segment, trees whose leaves are
stacked along the layer axis [steps, ...], and a segment runs as a Python
loop over its layers.

Cache families. Every mixer's serve cache plays one of three roles in the
reference (`_paged_layout`): `paged` (window-free attention: token rows in
shared page pools), `ring` (sliding-window attention: per-slot ring
buffers) and `state` (mamba / rwkv: per-slot recurrent state). The port has
the `paged` family; the others, the MoE, gemma and jamba blocks, raise
`NotImplementedError` naming the ROADMAP item that brings them, as do the
sharded step and the spill helpers.

The serve engine splits per-layer caches into two trees: `state` (per-slot
leaves [steps, B, ...], empty for the paged family) and `pools` (for every
paged layer a physical token-row pool [steps, num_pages * page_size, Hkv, D]
shared by all slots; one page id indexes every layer's pool).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.sparse_update import tree_map
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.common import last_valid

# queue A items of ROADMAP.md that bring what this module refuses
_RING = "ring (sliding-window) caches: ROADMAP queue A item 12"
_LATER = {
    "moe": "MoE decoding: ROADMAP queue A items 12-13",
    "gemma_super": "gemma decoding (the super-block's ring caches): "
                   "ROADMAP queue A item 12",
    "jamba_super": "jamba decoding (mamba state caches, MoE): ROADMAP "
                   "queue A item 12",
    "rwkv": "rwkv state caches: ROADMAP queue A item 12",
}


def _refuse(kind: str):
    raise NotImplementedError(f"{_LATER.get(kind, kind)} (not ported yet)")


def _cache_dtype(cfg) -> torch.dtype:
    return T.dtype_of(cfg)


def _layer(tree, i: int):
    """Layer i of a stacked tree (views)."""
    return tree_map(lambda a: a[i], tree)


def _logits(cfg, params, x):
    """[..., d] -> [..., V] fp32 (the reference's preferred_element_type:
    bf16 products are exact in fp32, so upcasting first gives its sums)."""
    w_head = T.lm_head_weight(cfg, (params, None))
    return torch.matmul(x.float(), w_head.float())


# ---------------------------------------------------------------------------
# contiguous caches (the oracle) and row ops
# ---------------------------------------------------------------------------

def _check_family(cfg, kind: str) -> None:
    """Raise for a layer kind or cache family the port does not serve yet:
    it serves window-free dense layers."""
    if kind != "dense":
        _refuse(kind)
    if cfg.attn_pattern != "full" or cfg.sliding_window:
        raise NotImplementedError(_RING + " (not ported yet)")


def init_cache(cfg, batch: int, seq_len: int, device="cuda"):
    """Stacked contiguous caches per segment (leading axis = layers)."""
    cache = {}
    for seg in T.segment_layout(cfg):
        _check_family(cfg, seg.kind)
        one = L.init_kv_cache(cfg, batch, seq_len, _cache_dtype(cfg), device)
        cache[seg.name] = tree_map(
            lambda a: a.expand((seg.steps,) + tuple(a.shape)).clone(), one)
    return cache


# Every per-slot leaf is shaped [steps, batch, ...], so a slot is batch row
# `row` of every leaf. The port's row ops work in place where the
# reference's are functional: extract is a view, insert and reset write the
# row and return the same tree.

def cache_extract_row(cache, row: int):
    """Batch row `row` of every leaf, keeping a batch dim of 1 (views)."""
    return tree_map(lambda a: a[:, row:row + 1], cache)


def cache_insert_row(cache, row_cache, row: int):
    """Write a batch=1 tree into batch row `row` of every leaf, in place;
    the whole row is overwritten, so a dirty slot is fully recycled."""
    def ins(dst, src):
        # a smaller update would silently partial-write the row
        assert src.shape[1] == 1 and src.shape[0] == dst.shape[0] \
            and src.shape[2:] == dst.shape[2:], (src.shape, dst.shape)
        dst[:, row:row + 1].copy_(src)
        return dst
    return tree_map(ins, cache, row_cache)


def cache_reset_row(cache, row: int):
    """Zero batch row `row` of every leaf (slot back to its init state), in
    place."""
    def rst(a):
        a[:, row:row + 1].zero_()
        return a
    return tree_map(rst, cache)


# ---------------------------------------------------------------------------
# paged serving caches
# ---------------------------------------------------------------------------

def _paged_layout(cfg, kind: str):
    """(sub_name | None, 'paged'|'ring'|'state') for each sublayer mixer."""
    _check_family(cfg, kind)
    return [(None, "paged")]


def has_paged_layers(cfg) -> bool:
    return any(role == "paged"
               for seg in T.segment_layout(cfg)
               for _, role in _paged_layout(cfg, seg.kind))


def has_state_layers(cfg) -> bool:
    """True when any mixer keeps non-position-addressed cache (ring or
    recurrent state); always False for the families the port serves."""
    return any(role != "paged"
               for seg in T.segment_layout(cfg)
               for _, role in _paged_layout(cfg, seg.kind))


def init_serve_cache(cfg, batch: int, max_len: int, num_pages: int,
                     page_size: int, device="cuda"):
    """Returns (state, pools): the per-slot state tree (empty for the paged
    family; `batch` and `max_len` size the ring and state families to come)
    and the shared page pools [steps, num_pages * page_size, Hkv, D], per
    segment."""
    state, pools = {}, {}
    for seg in T.segment_layout(cfg):
        _check_family(cfg, seg.kind)
        shape = (seg.steps, num_pages * page_size, cfg.num_kv_heads,
                 cfg.resolved_head_dim)
        state[seg.name] = {}
        pools[seg.name] = {
            key: torch.zeros(shape, dtype=_cache_dtype(cfg), device=device)
            for key in ("k", "v")}
    return state, pools


def copy_pool_rows(pools, src_row: int, dst_row: int, n: int):
    """Copy `n` physical token rows src -> dst in EVERY layer's pool (the
    device half of a copy-on-write split), in place; returns `pools`."""
    def cp(a):
        a[:, dst_row:dst_row + n] = a[:, src_row:src_row + n]
        return a
    return tree_map(cp, pools)


def read_pool_rows(pools, src_row: int, n: int):
    raise NotImplementedError("the host spill tier: ROADMAP queue A item 13 "
                              "(not ported yet)")


def write_pool_rows(pools, rows, dst_row: int):
    raise NotImplementedError("the host spill tier: ROADMAP queue A item 13 "
                              "(not ported yet)")


def make_sharded_paged_step(*args, **kwargs):
    raise NotImplementedError("sharded serving: ROADMAP queue A item 14 "
                              "(not ported yet)")


def _delta_sub(delta, *path):
    """Slice a per-layer delta tree ({"idx": ..., "val": ...}, leaves keyed
    by the same sublayer path as the params) down to one sublayer's
    {leaf -> tensor} dicts; None when that sublayer carries no delta."""
    if delta is None:
        return None
    idx, val = delta["idx"], delta["val"]
    for name in path:
        if not isinstance(idx, dict) or name not in idx:
            return None
        idx, val = idx[name], val[name]
    if not idx:
        return None
    return {"idx": idx, "val": val}


def _paged_block(cfg, kind: str, p, x, start, active, length, st_c, pl_c,
                 page_table, page_size: int, delta=None):
    """One layer of `paged_step`. `delta` carries this layer's per-row
    compact weight deltas; covered projections apply them as a gather-add
    at matmul time. Returns (x, state out, pool out)."""
    _check_family(cfg, kind)
    h = L.apply_norm(p["attn_ln"], x)
    a, pool = L.chunk_paged_attention(
        p["attn"], cfg, h, start, active, pl_c, page_table,
        page_size=page_size, length=length, delta=_delta_sub(delta, "attn"))
    x = x + a
    h = L.apply_norm(p["mlp_ln"], x)
    x = x + L.apply_mlp(p["mlp"], cfg, h, delta=_delta_sub(delta, "mlp"))
    return x, st_c, pool


def paged_step(cfg, params, batch, state, pools, page_table, *,
               page_size: int, deltas=None):
    """s >= 1 tokens per batch row against the paged serve caches.

    batch: {"tokens" [B,S] | "embeds" [B,S,d], "start" [B], "active" [B]
    bool, "length" [B] (optional, default S)}. `start` is the per-row token
    count already cached; rows with active=False keep all their state
    (their pool writes are dropped inside the attention). `length` lets the
    engine pad every prefill chunk to one page-sized shape; padded
    positions write nothing and the logits are taken at each row's
    position length-1.

    `deltas` (optional) is {seg_name: {"idx": ..., "val": ...}} of per-user
    compact weight deltas whose leaves are [steps, B, ...]; each batch row
    applies its own delta as a gather-add inside the covered matmuls. Zero
    rows are exact no-ops.
    Returns (last-valid-position logits [B, V] fp32, state, pools); the
    pools are new tensors, the ones passed in are not written.
    """
    start, active = batch["start"], batch["active"]
    length = batch.get("length")
    x = T.embed_tokens(cfg, (params, None), batch)
    new_pools = {}
    for seg in T.segment_layout(cfg):
        stack = params["segments"][seg.name]
        d_seg = None if deltas is None else deltas.get(seg.name)
        outs = []
        for i in range(seg.steps):
            x, _, pl_out = _paged_block(
                cfg, seg.kind, _layer(stack, i), x, start, active, length,
                None, _layer(pools[seg.name], i), page_table, page_size,
                delta=None if d_seg is None else _layer(d_seg, i))
            outs.append(pl_out)
        new_pools[seg.name] = tree_map(lambda *a: torch.stack(a), *outs)
    x = L.apply_norm(T._pick(params, None, "final_norm"), x)
    return _logits(cfg, params, last_valid(x, length)), state, new_pools


# ---------------------------------------------------------------------------
# decode step (contiguous cache)
# ---------------------------------------------------------------------------

def _decode_block(cfg, kind: str, p, x, positions, cache):
    _check_family(cfg, kind)
    h = L.apply_norm(p["attn_ln"], x)
    a, cache = L.decode_attention(p["attn"], cfg, h, positions, cache)
    x = x + a
    h = L.apply_norm(p["mlp_ln"], x)
    return x + L.apply_mlp(p["mlp"], cfg, h), cache


def decode_step(cfg, params, batch, cache):
    """One token for the whole batch.

    batch: {"tokens" [B,1] | "embeds" [B,1,d], "positions" [B,1] ([3,B,1]
    for M-RoPE)}.
    Returns (logits [B, V] fp32, new_cache)."""
    positions = batch.get("positions")
    if positions is None:
        raise ValueError("decode_step requires explicit positions")
    x = T.embed_tokens(cfg, (params, None), batch)
    new_cache = {}
    for seg in T.segment_layout(cfg):
        stack = params["segments"][seg.name]
        outs = []
        for i in range(seg.steps):
            x, c_out = _decode_block(cfg, seg.kind, _layer(stack, i), x,
                                     positions, _layer(cache[seg.name], i))
            outs.append(c_out)
        new_cache[seg.name] = tree_map(lambda *a: torch.stack(a), *outs)
    x = L.apply_norm(T._pick(params, None, "final_norm"), x)
    return _logits(cfg, params, x)[:, -1], new_cache


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------

def prefill(cfg, params, batch, pad_to: int = 0):
    """Run the full prompt (`batch` as `transformer.forward`'s), returning
    (last-token logits [B, V] fp32, contiguous cache padded to `pad_to`
    positions)."""
    x = T.embed_tokens(cfg, (params, None), batch)
    b, s = x.shape[0], x.shape[1]
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(s, device=x.device).expand(b, s)
    pad_to = max(pad_to, s)
    cache = {}
    for seg in T.segment_layout(cfg):
        stack = params["segments"][seg.name]
        outs = []
        for i in range(seg.steps):
            x, c_out = _prefill_block(cfg, seg.kind, _layer(stack, i), x,
                                      positions, pad_to)
            outs.append(c_out)
        cache[seg.name] = tree_map(lambda *a: torch.stack(a), *outs)
    x = L.apply_norm(T._pick(params, None, "final_norm"), x)
    return _logits(cfg, params, x[:, -1]), cache


def _pad_cache(k, pad_to: int):
    b, s, h, d = k.shape
    if pad_to <= s:
        return k
    return F.pad(k, (0, 0, 0, 0, 0, pad_to - s))


def _prefill_attn(cfg, p, x, positions, pad_to: int):
    b, s, _ = x.shape
    q, k, v = L._qkv(p, cfg, x, positions)
    if s > L.FLASH_THRESHOLD:
        out = L._sdpa_flash(q, k, v)
    else:
        out = L._sdpa_dense(q, k, v)
    out = out.reshape(b, s, -1)
    out = torch.matmul(out, p["wo"])
    dt = _cache_dtype(cfg)
    cache = {"k": _pad_cache(k, pad_to).to(dt),
             "v": _pad_cache(v, pad_to).to(dt),
             "pos": torch.full((b,), s, dtype=torch.int32, device=x.device)}
    return out, cache


def _prefill_block(cfg, kind: str, p, x, positions, pad_to: int):
    _check_family(cfg, kind)
    h = L.apply_norm(p["attn_ln"], x)
    a, cache = _prefill_attn(cfg, p["attn"], h, positions, pad_to)
    x = x + a
    h = L.apply_norm(p["mlp_ln"], x)
    return x + L.apply_mlp(p["mlp"], cfg, h), cache

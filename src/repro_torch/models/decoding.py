"""Serving paths for every model family: prefill (full prompt -> cache +
last logits), single-token decode against a contiguous cache (the oracle),
and `paged_step`, s >= 1 tokens per row against the paged serve caches
(what the serve engine runs).

Caches follow the reference's layout: per segment, trees whose leaves are
stacked along the layer axis [steps, ...], and a segment runs as a Python
loop over its layers.

Cache families. Every mixer's serve cache plays one of three roles
(`_paged_layout`): `paged` (window-free attention: token rows in shared
page pools), `ring` (sliding-window attention: per-slot ring buffers of
min(window, max_len) slots) and `state` (mamba / rwkv: per-slot O(1)
recurrent state). `CACHE_FAMILIES` describes each role's per-row snapshot
(the unit a prefix cache would store at a page boundary) and
`snapshot_row_bytes` prices one slot's; the prefix caches themselves, the
spill helpers and the sharded step come with ROADMAP queue A items 13 and
14 and raise until then.

The serve engine splits per-layer caches into two trees: `state` (per-slot
leaves [steps, B, ...]: ring k/v and recurrent state) and `pools` (for
every paged layer a physical token-row pool [steps, num_pages * page_size,
Hkv, D] shared by all slots; one page id indexes every layer's pool).
Neither keeps empty subtrees for the sublayers of a super-block that have
none.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core.sparse_update import tree_map
from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models import moe as MOE
from repro_torch.models import rwkv6 as R
from repro_torch.models import transformer as T
from repro_torch.models.common import last_valid


def _cache_dtype(cfg) -> torch.dtype:
    return T.dtype_of(cfg)


def _layer(tree, i: int):
    """Layer i of a stacked tree (views)."""
    return tree_map(lambda a: a[i], tree)


def _stack(trees: list):
    """Per-layer trees -> one tree stacked along a new leading axis."""
    return tree_map(lambda *a: torch.stack(a), *trees)


def _zeros_like_stacked(one, steps: int, device):
    """Zero leaves [steps, *shape] for a one-layer tree of meta tensors."""
    return tree_map(lambda a: torch.zeros((steps,) + tuple(a.shape),
                                          dtype=a.dtype, device=device), one)


def _logits(cfg, params, x):
    """[..., d] -> [..., V] fp32 (the reference's preferred_element_type:
    bf16 products are exact in fp32, so upcasting first gives its sums)."""
    w_head = T.lm_head_weight(cfg, (params, None))
    return torch.matmul(x.float(), w_head.float())


def _period(cfg) -> int:
    """Layers of a gemma super-block: L local + G global."""
    _, l, g = cfg.attn_pattern.split(":")
    return int(l) + int(g)


# ---------------------------------------------------------------------------
# contiguous caches (the oracle) and row ops
# ---------------------------------------------------------------------------

def _step_cache(cfg, kind: str, batch: int, seq_len: int, device):
    """One layer's (one scan step's) contiguous cache."""
    dt = _cache_dtype(cfg)
    kv = lambda window: L.init_kv_cache(cfg, batch, seq_len, dt, device,
                                        window=window)
    if kind == "dense":
        return kv(T._window_for(cfg, "dense", 0))
    if kind == "moe":
        return kv(0)
    if kind == "gemma_super":
        return {f"sub{i}": kv(T._window_for(cfg, kind, i))
                for i in range(_period(cfg))}
    if kind == "jamba_super":
        attn_pos = cfg.attn_every // 2
        return {f"sub{i}": kv(0) if i == attn_pos
                else M.init_mamba_cache(cfg, batch, dt, device)
                for i in range(cfg.attn_every)}
    if kind == "rwkv":
        return R.init_rwkv_cache(cfg, batch, dt, device)
    raise ValueError(kind)


def init_cache(cfg, batch: int, seq_len: int, device="cuda"):
    """Stacked contiguous caches per segment (leading axis = layers)."""
    return {seg.name: _zeros_like_stacked(
                _step_cache(cfg, seg.kind, batch, seq_len, "meta"),
                seg.steps, device)
            for seg in T.segment_layout(cfg)}


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
    if kind in ("dense", "moe"):
        window = T._window_for(cfg, kind, 0) if kind == "dense" else 0
        return [(None, "ring" if window > 0 else "paged")]
    if kind == "gemma_super":
        return [(f"sub{i}", "ring" if T._window_for(cfg, kind, i) > 0
                 else "paged") for i in range(_period(cfg))]
    if kind == "jamba_super":
        attn_pos = cfg.attn_every // 2
        return [(f"sub{i}", "paged" if i == attn_pos else "state")
                for i in range(cfg.attn_every)]
    if kind == "rwkv":
        return [(None, "state")]
    raise ValueError(kind)


def has_paged_layers(cfg) -> bool:
    return any(role == "paged"
               for seg in T.segment_layout(cfg)
               for _, role in _paged_layout(cfg, seg.kind))


def has_state_layers(cfg) -> bool:
    """True when any mixer keeps a non-position-addressed cache (ring or
    recurrent state): prefix reuse for such a config needs per-row state
    snapshots at page boundaries, not just shared pages."""
    return any(role != "paged"
               for seg in T.segment_layout(cfg)
               for _, role in _paged_layout(cfg, seg.kind))


class CacheFamily:
    """One cache role's contract with the prefix-reuse stack: what its
    per-row unit of reuse looks like. `snapshot_leaves(cfg, kind, sub,
    max_len, dtype)` returns a nested dict of (shape, dtype) specs, the
    leaves `cache_extract_row` yields for one slot of this family (empty
    for `paged`, whose unit of reuse is the shared page itself). It prices
    and describes a snapshot; it never moves data."""

    def __init__(self, role: str, leaves):
        self.role = role
        self._leaves = leaves

    def snapshot_leaves(self, cfg, kind: str, sub: int, max_len: int, dtype):
        return self._leaves(cfg, kind, sub, max_len, dtype)


CACHE_FAMILIES = {
    "paged": CacheFamily("paged", lambda cfg, kind, sub, max_len, dt: {}),
    "ring": CacheFamily(
        "ring", lambda cfg, kind, sub, max_len, dt:
        L.ring_snapshot_leaves(cfg, T._window_for(cfg, kind, sub), max_len,
                               dt)),
    "state": CacheFamily(
        "state", lambda cfg, kind, sub, max_len, dt:
        R.rwkv_snapshot_leaves(cfg, dt) if kind == "rwkv"
        else M.mamba_snapshot_leaves(cfg, dt)),
}


def _spec_leaves(tree) -> list:
    """The (shape, dtype) leaves of a snapshot spec."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _spec_leaves(v)]
    return [tree]


def snapshot_row_bytes(cfg, max_len: int) -> int:
    """Host bytes of ONE slot's recurrent-state snapshot (every non-paged
    mixer's leaves across all layers): the budget unit of a prefix cache's
    snapshot LRU."""
    dt = _cache_dtype(cfg)
    total = 0
    for seg in T.segment_layout(cfg):
        for i, (_, role) in enumerate(_paged_layout(cfg, seg.kind)):
            spec = CACHE_FAMILIES[role].snapshot_leaves(cfg, seg.kind, i,
                                                        max_len, dt)
            for shape, leaf_dt in _spec_leaves(spec):
                total += seg.steps * math.prod(shape) * leaf_dt.itemsize
    return total


def _serve_leaf(cfg, role: str, batch: int, max_len: int, kind: str,
                sub: int, pool_rows: int, device):
    """(per-slot state, pool) of one sublayer mixer."""
    dt = _cache_dtype(cfg)
    zeros = lambda rows: torch.zeros(
        rows + (cfg.num_kv_heads, cfg.resolved_head_dim), dtype=dt,
        device=device)
    if role == "ring":
        size = min(T._window_for(cfg, kind, sub), max_len)
        return {"k": zeros((batch, size)), "v": zeros((batch, size))}, {}
    if role == "paged":
        return {}, {"k": zeros((pool_rows,)), "v": zeros((pool_rows,))}
    if kind == "rwkv":
        return R.init_rwkv_cache(cfg, batch, dt, device), {}
    return M.init_mamba_cache(cfg, batch, dt, device), {}


def init_serve_cache(cfg, batch: int, max_len: int, num_pages: int,
                     page_size: int, device="cuda"):
    """Returns (state, pools): the per-slot state tree (ring buffers and
    recurrent state, [steps, batch, ...]) and the shared page pools
    [steps, num_pages * page_size, Hkv, D], per segment, with the
    reference's tree structure (no empty subdicts)."""
    pool_rows = num_pages * page_size
    state, pools = {}, {}
    for seg in T.segment_layout(cfg):
        st_one, pl_one = {}, {}
        for i, (sub, role) in enumerate(_paged_layout(cfg, seg.kind)):
            st, pl = _serve_leaf(cfg, role, batch, max_len, seg.kind, i,
                                 pool_rows, "meta")
            if sub is None:
                st_one, pl_one = st, pl
            else:
                if st:
                    st_one[sub] = st
                if pl:
                    pl_one[sub] = pl
        state[seg.name] = _zeros_like_stacked(st_one, seg.steps, device)
        pools[seg.name] = _zeros_like_stacked(pl_one, seg.steps, device)
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
                 page_table, page_size: int, delta=None,
                 flash_decode: bool = False):
    """One layer of `paged_step`; mirrors `_decode_block` for s >= 1.
    `delta` carries this layer's per-row compact weight deltas; covered
    attention / MLP projections apply them as a gather-add at matmul time
    (MoE experts and mamba / rwkv mixers carry none). Returns (x, state
    out, pool out)."""
    def attn(sub_p, h, role, window, st, pl, d=None):
        if role == "ring":
            return L.chunk_ring_attention(sub_p, cfg, h, start, active, st,
                                          window=window, length=length,
                                          delta=d)
        return L.chunk_paged_attention(sub_p, cfg, h, start, active, pl,
                                       page_table, page_size=page_size,
                                       length=length, delta=d,
                                       flash_decode=flash_decode)

    if kind in ("dense", "moe"):
        window = T._window_for(cfg, kind, 0) if kind == "dense" else 0
        role = "ring" if window > 0 else "paged"
        h = L.apply_norm(p["attn_ln"], x)
        a, c_out = attn(p["attn"], h, role, window, st_c, pl_c,
                        _delta_sub(delta, "attn"))
        x = x + a
        h = L.apply_norm(p["mlp_ln"], x)
        if kind == "moe":
            y, _ = MOE.apply_moe(p["moe"], cfg, h)
        else:
            y = L.apply_mlp(p["mlp"], cfg, h, delta=_delta_sub(delta, "mlp"))
        x = x + y
        return (x, c_out, {}) if role == "ring" else (x, {}, c_out)
    if kind == "gemma_super":
        new_st, new_pl = {}, {}
        for i, (sub, role) in enumerate(_paged_layout(cfg, kind)):
            sp = p[sub]
            h = L.apply_norm(sp["attn_ln"], x)
            a, c_out = attn(sp["attn"], h, role, T._window_for(cfg, kind, i),
                            st_c.get(sub), pl_c.get(sub),
                            _delta_sub(delta, sub, "attn"))
            (new_st if role == "ring" else new_pl)[sub] = c_out
            x = x + a
            h = L.apply_norm(sp["mlp_ln"], x)
            x = x + L.apply_mlp(sp["mlp"], cfg, h,
                                delta=_delta_sub(delta, sub, "mlp"))
        return x, new_st, new_pl
    if kind == "jamba_super":
        attn_pos = cfg.attn_every // 2
        new_st, new_pl = {}, {}
        for i in range(cfg.attn_every):
            sub = f"sub{i}"
            sp = p[sub]
            h = L.apply_norm(sp["mixer_ln"], x)
            if i == attn_pos:
                a, new_pl[sub] = attn(sp["attn"], h, "paged", 0, None,
                                      pl_c[sub],
                                      _delta_sub(delta, sub, "attn"))
            else:
                a, new_st[sub] = M.apply_mamba(sp["mamba"], cfg, h,
                                               cache=st_c[sub], length=length)
            x = x + a
            h = L.apply_norm(sp["ffn_ln"], x)
            if T._moe_at(cfg, i):
                y, _ = MOE.apply_moe(sp["moe"], cfg, h)
            else:
                y = L.apply_mlp(sp["mlp"], cfg, h,
                                delta=_delta_sub(delta, sub, "mlp"))
            x = x + y
        return x, new_st, new_pl
    if kind == "rwkv":
        h = L.apply_norm(p["time_ln"], x)
        y, tc = R.apply_time_mix(p["time"], cfg, h, cache=st_c["time"],
                                 length=length)
        x = x + y
        h = L.apply_norm(p["chan_ln"], x)
        y, cc = R.apply_channel_mix(p["chan"], cfg, h, cache=st_c["chan"],
                                    length=length)
        return x + y, {"time": tc, "chan": cc}, {}
    raise ValueError(kind)


def paged_step(cfg, params, batch, state, pools, page_table, *,
               page_size: int, deltas=None, flash_decode: bool = False):
    """s >= 1 tokens per batch row against the paged serve caches.

    batch: {"tokens" [B,S] | "embeds" [B,S,d], "start" [B], "active" [B]
    bool, "length" [B] (optional, default S)}. `start` is the per-row token
    count already cached; rows with active=False keep all their state (the
    per-row leaves are row-selected here, their pool writes dropped inside
    the attention). `length` lets the engine pad every prefill chunk to one
    page-sized shape; padded positions write nothing, leave recurrent state
    as it was, and the logits are taken at each row's position length-1.
    flash_decode: paged layers take their softmax page by page
    (`layers._grouped_scores_split`).

    `deltas` (optional) is {seg_name: {"idx": ..., "val": ...}} of per-user
    compact weight deltas whose leaves are [steps, B, ...]; each batch row
    applies its own delta as a gather-add inside the covered matmuls. Zero
    rows are exact no-ops.
    Returns (last-valid-position logits [B, V] fp32, state, pools); both
    trees are new tensors, the ones passed in are not written.
    """
    start, active = batch["start"], batch["active"]
    length = batch.get("length")
    x = T.embed_tokens(cfg, (params, None), batch)

    def merge(new, old):
        return tree_map(lambda n, o: torch.where(
            active.reshape((-1,) + (1,) * (n.dim() - 1)), n, o), new, old)

    new_state, new_pools = {}, {}
    for seg in T.segment_layout(cfg):
        stack = params["segments"][seg.name]
        d_seg = None if deltas is None else deltas.get(seg.name)
        st_outs, pl_outs = [], []
        # a segment of paged layers only keeps no state: {} stands for it
        st_seg = state.get(seg.name, {})
        for i in range(seg.steps):
            st_l = _layer(st_seg, i)
            x, st_out, pl_out = _paged_block(
                cfg, seg.kind, _layer(stack, i), x, start, active, length,
                st_l, _layer(pools[seg.name], i), page_table, page_size,
                delta=None if d_seg is None else _layer(d_seg, i),
                flash_decode=flash_decode)
            st_outs.append(merge(st_out, st_l))
            pl_outs.append(pl_out)
        new_state[seg.name] = _stack(st_outs)
        new_pools[seg.name] = _stack(pl_outs)
    x = L.apply_norm(T._pick(params, None, "final_norm"), x)
    return _logits(cfg, params, last_valid(x, length)), new_state, new_pools


# ---------------------------------------------------------------------------
# decode step (contiguous cache)
# ---------------------------------------------------------------------------

def _decode_block(cfg, kind: str, p, x, positions, cache):
    if kind in ("dense", "moe"):
        window = T._window_for(cfg, kind, 0) if kind == "dense" else 0
        h = L.apply_norm(p["attn_ln"], x)
        a, cache = L.decode_attention(p["attn"], cfg, h, positions, cache,
                                      window=window)
        x = x + a
        h = L.apply_norm(p["mlp_ln"], x)
        if kind == "moe":
            y, _ = MOE.apply_moe(p["moe"], cfg, h)
        else:
            y = L.apply_mlp(p["mlp"], cfg, h)
        return x + y, cache
    if kind == "gemma_super":
        new_cache = {}
        for i in range(_period(cfg)):
            sub, name = p[f"sub{i}"], f"sub{i}"
            h = L.apply_norm(sub["attn_ln"], x)
            a, new_cache[name] = L.decode_attention(
                sub["attn"], cfg, h, positions, cache[name],
                window=T._window_for(cfg, kind, i))
            x = x + a
            h = L.apply_norm(sub["mlp_ln"], x)
            x = x + L.apply_mlp(sub["mlp"], cfg, h)
        return x, new_cache
    if kind == "jamba_super":
        attn_pos = cfg.attn_every // 2
        new_cache = {}
        for i in range(cfg.attn_every):
            sub, name = p[f"sub{i}"], f"sub{i}"
            h = L.apply_norm(sub["mixer_ln"], x)
            if i == attn_pos:
                a, new_cache[name] = L.decode_attention(
                    sub["attn"], cfg, h, positions, cache[name])
            else:
                a, new_cache[name] = M.apply_mamba(sub["mamba"], cfg, h,
                                                   cache=cache[name])
            x = x + a
            h = L.apply_norm(sub["ffn_ln"], x)
            if T._moe_at(cfg, i):
                y, _ = MOE.apply_moe(sub["moe"], cfg, h)
            else:
                y = L.apply_mlp(sub["mlp"], cfg, h)
            x = x + y
        return x, new_cache
    if kind == "rwkv":
        h = L.apply_norm(p["time_ln"], x)
        y, tc = R.apply_time_mix(p["time"], cfg, h, cache=cache["time"])
        x = x + y
        h = L.apply_norm(p["chan_ln"], x)
        y, cc = R.apply_channel_mix(p["chan"], cfg, h, cache=cache["chan"])
        return x + y, {"time": tc, "chan": cc}
    raise ValueError(kind)


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
        new_cache[seg.name] = _stack(outs)
    x = L.apply_norm(T._pick(params, None, "final_norm"), x)
    return _logits(cfg, params, x)[:, -1], new_cache


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------

def prefill(cfg, params, batch, pad_to: int = 0):
    """Run the full prompt (`batch` as `transformer.forward`'s), returning
    (last-token logits [B, V] fp32, contiguous cache padded to `pad_to`
    positions). Attention layers write their keys and values (ring-packed
    for windowed layers); mamba and rwkv layers keep their final state."""
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
        cache[seg.name] = _stack(outs)
    x = L.apply_norm(T._pick(params, None, "final_norm"), x)
    return _logits(cfg, params, x[:, -1]), cache


def _ring_pack(k, window: int):
    """The last `window` positions of k [B, S, H, D] packed into a ring of
    exactly `window` slots (position p at slot p % window), zeros in the
    slots no position reached."""
    b, s, h, d = k.shape
    out = k.new_zeros((b, window, h, d))
    n = min(s, window)
    slots = torch.arange(s - n, s, device=k.device) % window
    out[:, slots] = k[:, s - n:]
    return out


def _pad_cache(k, pad_to: int):
    b, s, h, d = k.shape
    if pad_to <= s:
        return k
    return F.pad(k, (0, 0, 0, 0, 0, pad_to - s))


def _prefill_attn(cfg, p, x, positions, window: int, pad_to: int):
    b, s, _ = x.shape
    q, k, v = L._qkv(p, cfg, x, positions)
    if s > L.FLASH_THRESHOLD:
        out = L._sdpa_flash(q, k, v, window)
    else:
        out = L._sdpa_dense(q, k, v, window)
    out = out.reshape(b, s, -1)
    out = torch.matmul(out, p["wo"])
    dt = _cache_dtype(cfg)
    if window > 0:
        # the ring is capped at the cache's capacity, as `init_kv_cache`
        # sizes it, so a prefill row inserts into an init_cache'd batch
        w = min(window, pad_to)
        kc, vc = _ring_pack(k, w), _ring_pack(v, w)
    else:
        kc, vc = _pad_cache(k, pad_to), _pad_cache(v, pad_to)
    cache = {"k": kc.to(dt), "v": vc.to(dt),
             "pos": torch.full((b,), s, dtype=torch.int32, device=x.device)}
    return out, cache


def _prefill_block(cfg, kind: str, p, x, positions, pad_to: int):
    """One layer of `prefill`. The mamba and rwkv states come from the
    mixers' serving forms run from a zero cache over the whole prompt (the
    reference recomputes them in separate passes; the results agree, the
    conv tail of a prompt shorter than d_conv - 1 left-padded with zeros)."""
    b = x.shape[0]
    dt = _cache_dtype(cfg)
    if kind in ("dense", "moe"):
        window = T._window_for(cfg, kind, 0) if kind == "dense" else 0
        h = L.apply_norm(p["attn_ln"], x)
        a, cache = _prefill_attn(cfg, p["attn"], h, positions, window, pad_to)
        x = x + a
        h = L.apply_norm(p["mlp_ln"], x)
        if kind == "moe":
            y, _ = MOE.apply_moe(p["moe"], cfg, h)
        else:
            y = L.apply_mlp(p["mlp"], cfg, h)
        return x + y, cache
    if kind == "gemma_super":
        caches = {}
        for i in range(_period(cfg)):
            sub = p[f"sub{i}"]
            h = L.apply_norm(sub["attn_ln"], x)
            a, caches[f"sub{i}"] = _prefill_attn(
                cfg, sub["attn"], h, positions, T._window_for(cfg, kind, i),
                pad_to)
            x = x + a
            h = L.apply_norm(sub["mlp_ln"], x)
            x = x + L.apply_mlp(sub["mlp"], cfg, h)
        return x, caches
    if kind == "jamba_super":
        attn_pos = cfg.attn_every // 2
        caches = {}
        for i in range(cfg.attn_every):
            sub = p[f"sub{i}"]
            h = L.apply_norm(sub["mixer_ln"], x)
            if i == attn_pos:
                a, caches[f"sub{i}"] = _prefill_attn(cfg, sub["attn"], h,
                                                     positions, 0, pad_to)
            else:
                a, caches[f"sub{i}"] = M.apply_mamba(
                    sub["mamba"], cfg, h,
                    cache=M.init_mamba_cache(cfg, b, dt, x.device))
            x = x + a
            h = L.apply_norm(sub["ffn_ln"], x)
            if T._moe_at(cfg, i):
                y, _ = MOE.apply_moe(sub["moe"], cfg, h)
            else:
                y = L.apply_mlp(sub["mlp"], cfg, h)
            x = x + y
        return x, caches
    if kind == "rwkv":
        zero = R.init_rwkv_cache(cfg, b, dt, x.device)
        h = L.apply_norm(p["time_ln"], x)
        y, tc = R.apply_time_mix(p["time"], cfg, h, cache=zero["time"])
        x = x + y
        h = L.apply_norm(p["chan_ln"], x)
        y, cc = R.apply_channel_mix(p["chan"], cfg, h, cache=zero["chan"])
        return x + y, {"time": tc, "chan": cc}
    raise ValueError(kind)

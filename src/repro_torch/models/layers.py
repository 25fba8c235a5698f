"""Core layers: norms (incl. the CNN's GroupNorm), RoPE, GQA attention
(dense causal / sliding window, cached decode, chunked paged serving), MLP
variants.

Params are plain dicts of tensors with the reference package's key names.
Matmuls that take part in the sparse update go through
`repro_torch.core.sparse_update.smm`, so the backward pass skips unselected
output-channel blocks. The numerics follow the reference: norms and RoPE in
fp32, attention scores in fp32 (its `preferred_element_type`), probabilities
cast to the activation dtype before the PV product.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.sparse_update import smm
from repro_torch.models.common import col_matmul, dense_init, row_matmul

# sequences longer than this take the reference's flash path, which comes
# with a later slice of the port
FLASH_THRESHOLD = 2048


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def init_norm(d: int, kind: str, dtype, device="cuda"):
    if kind == "rmsnorm":
        return {"scale": torch.ones((d,), dtype=dtype, device=device)}
    if kind == "layernorm":
        return {"scale": torch.ones((d,), dtype=dtype, device=device),
                "bias": torch.zeros((d,), dtype=dtype, device=device)}
    raise ValueError(kind)


def apply_norm(p, x, eps: float = 1e-6):
    xf = x.float()
    if "bias" in p:  # layernorm
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * p["scale"].float() + p["bias"].float()
    else:  # rmsnorm
        ms = (xf * xf).mean(-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * p["scale"].float()
    return y.to(x.dtype)


def init_group_norm(c: int, dtype, device="cuda"):
    return {"scale": torch.ones((c,), dtype=dtype, device=device),
            "bias": torch.zeros((c,), dtype=dtype, device=device)}


def apply_group_norm(p, x, groups: int, eps: float = 1e-5):
    """x: [B, H, W, C] (NHWC); statistics in fp32 over (H, W, C / groups)."""
    b, h, w, c = x.shape
    xf = x.float().reshape(b, h, w, groups, c // groups)
    mu = xf.mean(dim=(1, 2, 4), keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=(1, 2, 4), keepdim=True)
    y = ((xf - mu) * torch.rsqrt(var + eps)).reshape(b, h, w, c)
    y = y * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, device="cpu"):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x, positions, theta: float):
    """x: [..., S, H, D]; positions: broadcastable to [..., S]. Rotates the
    two halves of D (not interleaved pairs), as the reference does."""
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, x.device)                # [D/2]
    angles = positions[..., None].float() * freqs               # [..., S, D/2]
    cos = torch.cos(angles)[..., :, None, :]                    # [..., S, 1, D/2]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def init_attention(gen, cfg, dtype, device="cuda"):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    init = lambda shape: dense_init(gen, shape, dtype=dtype, device=device)
    return {
        "wq": init((d, cfg.num_heads * hd)),
        "wk": init((d, cfg.num_kv_heads * hd)),
        "wv": init((d, cfg.num_kv_heads * hd)),
        "wo": init((cfg.num_heads * hd, d)),
    }


def _qkv(p, cfg, x, positions, sel=None, delta=None):
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q = col_matmul(x, p["wq"], sel, "wq", delta).reshape(b, s, -1, hd)
    k = col_matmul(x, p["wk"], sel, "wk", delta).reshape(b, s, -1, hd)
    v = col_matmul(x, p["wv"], sel, "wv", delta).reshape(b, s, -1, hd)
    if getattr(cfg, "mrope", False):
        raise NotImplementedError("M-RoPE comes with the qwen2-vl slice")
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _expand_kv(k, hq: int):
    """GQA expansion [B,S,Hkv,D] -> [B,S,Hq,D]: query head h reads kv head
    h // (hq // hkv). Written as expand + reshape, not index_select: the
    backward is then a plain sum over each kv head's query heads, where
    index_select's CUDA backward adds with atomics in no fixed order and
    makes the gradient differ from run to run."""
    b, s, hkv, d = k.shape
    if hkv == hq:
        return k
    rep = hq // hkv
    return k[:, :, :, None, :].expand(b, s, hkv, rep, d).reshape(b, s, hq, d)


def _sdpa_dense(q, k, v, window: int = 0):
    """Materialized causal attention. q: [B,S,Hq,D], k, v: [B,S,Hkv,D]."""
    _, s, hq, dd = q.shape
    k = _expand_kv(k, hq)
    v = _expand_kv(v, hq)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    scores = scores / math.sqrt(dd)
    qpos = torch.arange(s, device=q.device)[:, None]
    kpos = torch.arange(s, device=q.device)[None, :]
    mask = kpos <= qpos
    if window:
        mask &= (qpos - kpos) < window
    scores = torch.where(mask, scores, torch.tensor(-1e30, device=q.device))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def attention(p, cfg, x, positions, *, window: int = 0, sel=None,
              flash_threshold: int = FLASH_THRESHOLD):
    """Full training/prefill attention over a whole sequence."""
    b, s, _ = x.shape
    if s > flash_threshold:
        raise NotImplementedError(
            f"sequence length {s} > {flash_threshold} needs the flash "
            f"attention path, which the port does not have yet")
    q, k, v = _qkv(p, cfg, x, positions, sel=sel)
    out = _sdpa_dense(q, k, v, window).reshape(b, s, -1)
    return smm(out, p["wo"], sel, "wo")


def decode_attention(p, cfg, x, positions, cache):
    """Single-token decode against a contiguous KV cache (the serving
    path's oracle; window-free layers only, the sliding-window ring buffer
    comes with ROADMAP queue A item 12).

    cache: {"k","v": [B, S_cache, Hkv, D], "pos": [B] int32 tokens so far},
    `pos` per row, so rows may sit at different depths. Out of place: the
    cache passed in is not written."""
    b, s, _ = x.shape
    assert s == 1
    hd = cfg.resolved_head_dim
    q, k, v = _qkv(p, cfg, x, positions)
    pos = cache["pos"]
    s_cache = cache["k"].shape[1]
    rows = torch.arange(b, device=x.device)
    k_cache, v_cache = cache["k"].clone(), cache["v"].clone()
    k_cache[rows, pos.long()] = k[:, 0].to(k_cache.dtype)
    v_cache[rows, pos.long()] = v[:, 0].to(v_cache.dtype)

    hkv = cfg.num_kv_heads
    g = cfg.num_heads // hkv
    qg = q.reshape(b, hkv, g, hd)
    scores = torch.einsum("bhgd,bkhd->bhgk", qg.float(),
                          k_cache.float()) / math.sqrt(hd)
    idx = torch.arange(s_cache, device=x.device)[None, :]
    valid = idx <= pos[:, None]
    scores = torch.where(valid[:, None, None, :], scores, -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", probs.to(q.dtype).float(),
                       v_cache.float()).to(q.dtype)
    out = out.reshape(b, 1, cfg.num_heads * hd)
    new_cache = {"k": k_cache, "v": v_cache, "pos": pos + 1}
    return smm(out, p["wo"], None, "wo"), new_cache


# ---------------------------------------------------------------------------
# Chunk-capable serving attention (paged)
#
# s >= 1 new tokens per row against an existing cache, so the serving
# engine's one step function covers batched decode (s = 1 over all slots)
# AND chunked prefill (one slot, page-sized chunks). Scores are taken
# against [cached keys ++ in-chunk keys] with the cache read BEFORE the
# chunk's rows are written.
# ---------------------------------------------------------------------------

def _grouped_scores(q, k_cat, v_cat, mask):
    """q: [B,S,Hq,D]; k_cat/v_cat: [B,L,Hkv,D]; mask: [B,S,L] ->
    [B,S,Hq*D]. Scores and softmax in fp32, probabilities cast to q's
    dtype before the PV product, which sums in fp32 (the reference's
    `preferred_element_type`)."""
    b, s, hq, hd = q.shape
    hkv = k_cat.shape[2]
    g = hq // hkv
    qg = q.reshape(b, s, hkv, g, hd)
    scores = torch.einsum("bshgd,blhd->bhgsl", qg.float(),
                          k_cat.float()) / math.sqrt(hd)
    # a Python scalar, not a tensor made on the device: building one from
    # the host would wait for the card once per layer
    scores = torch.where(mask[:, None, None, :, :], scores, -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgsl,blhd->bshgd", probs.to(q.dtype).float(),
                       v_cat.float()).to(q.dtype)
    return out.reshape(b, s, hq * hd)


def _serve_positions(cfg, start, s: int):
    """Token positions of a chunk: [B, S]."""
    if getattr(cfg, "mrope", False):
        raise NotImplementedError("M-RoPE comes with the qwen2-vl slice")
    return start[:, None] + torch.arange(s, dtype=torch.int32,
                                         device=start.device)[None, :]


def chunk_paged_attention(p, cfg, x, start, active, pool, page_table, *,
                          page_size: int, length=None, delta=None):
    """Full (window-free) attention for a chunk of s tokens per batch row,
    reading and writing K/V through per-row page tables.

    pool: {"k","v": [R, H, D]} physical token rows shared by ALL batch rows
    (R = num_pages * page_size); page_table: [B, MP] int32 physical page per
    logical page, -1 where unallocated. `start` [B]: tokens already cached
    per row; `active` [B] bool; `length` [B]: valid tokens per row (None =
    all s). Returns (y, new pool), out of place as the reference.

    The reference drops the writes of inactive rows, of unallocated pages
    and of padded positions through an out-of-bounds index under
    `mode="drop"`. On the card an out-of-bounds index is a device-side
    assert, so here the new pool has one spare row R that takes every such
    write and is cut off again: no host sync, no boolean-mask indexing.
    Valid destinations never repeat (no two rows own a page; positions are
    distinct), so the write is deterministic."""
    b, s, _ = x.shape
    dev = x.device
    if length is None:
        length = torch.full((b,), s, dtype=torch.int32, device=dev)
    ps = page_size
    r_rows = pool["k"].shape[0]
    mp = page_table.shape[1]
    q, k, v = _qkv(p, cfg, x, _serve_positions(cfg, start, s), delta=delta)

    # the cached prefix in logical order: [B, MP*ps] physical rows
    phys = (page_table.clamp(min=0).long()[:, :, None] * ps
            + torch.arange(ps, device=dev)[None, None, :]).reshape(b, mp * ps)
    k_cache = pool["k"][phys]                                # [B, L, H, D]
    v_cache = pool["v"][phys]

    l_idx = torch.arange(mp * ps, device=dev)[None, :]      # logical index
    alloc = torch.gather(page_table, 1, (l_idx // ps).expand(b, -1)) >= 0
    cache_mask = (l_idx < start[:, None]) & alloc           # [B, L]
    cache_mask = cache_mask[:, None, :].expand(b, s, mp * ps)
    j = torch.arange(s, device=dev)
    chunk_mask = (j[None, :] <= j[:, None])[None].expand(b, s, s)

    k_cat = torch.cat([k_cache.to(k.dtype), k], dim=1)
    v_cat = torch.cat([v_cache.to(v.dtype), v], dim=1)
    mask = torch.cat([cache_mask, chunk_mask], dim=2)
    out = _grouped_scores(q, k_cat, v_cat, mask)

    # the chunk's rows: logical position -> page_table page; unallocated
    # pages, inactive rows and padded positions go to the spare row
    wpos = start[:, None].long() + j[None, :]                # [B, S]
    pid = torch.gather(page_table, 1, (wpos // ps).clamp(max=mp - 1)).long()
    keep = (pid >= 0) & active[:, None] & (j[None, :] < length[:, None]) \
        & (wpos // ps < mp)
    dest = torch.where(keep, pid * ps + wpos % ps,
                       torch.full_like(pid, r_rows)).reshape(-1)
    new_pool = {}
    for key, rows in (("k", k), ("v", v)):
        old = pool[key]
        buf = torch.cat([old, old.new_zeros((1,) + tuple(old.shape[1:]))])
        buf.index_copy_(0, dest, rows.reshape((b * s,) + tuple(rows.shape[2:]))
                        .to(old.dtype))
        new_pool[key] = buf[:r_rows]
    y = row_matmul(out, p["wo"], None, "wo", delta)
    return y, new_pool


def init_kv_cache(cfg, batch: int, seq_len: int, dtype, device="cuda"):
    """A contiguous KV cache (the oracle's): k/v [B, S, Hkv, D] and the
    per-row token count `pos`."""
    shape = (batch, seq_len, cfg.num_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": torch.zeros((batch,), dtype=torch.int32, device=device)}


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def init_mlp(gen, cfg, dtype, d_ff: Optional[int] = None, device="cuda"):
    d = cfg.d_model
    ff = d_ff or cfg.d_ff
    init = lambda shape: dense_init(gen, shape, dtype=dtype, device=device)
    if cfg.mlp_kind == "swiglu":
        return {"w_gate": init((d, ff)), "w_up": init((d, ff)),
                "w_down": init((ff, d))}
    if cfg.mlp_kind in ("gelu", "sq_relu"):
        return {"w_up": init((d, ff)), "w_down": init((ff, d))}
    raise ValueError(cfg.mlp_kind)


def apply_mlp(p, cfg, x, sel=None, delta=None):
    """gate/up column-parallel, down row-parallel (single-device forms);
    `delta` carries per-user compact deltas for serving."""
    kind = cfg.mlp_kind
    if kind == "swiglu":
        h = F.silu(col_matmul(x, p["w_gate"], sel, "w_gate", delta)) * \
            col_matmul(x, p["w_up"], sel, "w_up", delta)
    elif kind == "gelu":
        h = F.gelu(col_matmul(x, p["w_up"], sel, "w_up", delta),
                   approximate="tanh")
    elif kind == "sq_relu":
        h = torch.relu(col_matmul(x, p["w_up"], sel, "w_up", delta))
        h = h * h
    else:
        raise ValueError(kind)
    return row_matmul(h, p["w_down"], sel, "w_down", delta)

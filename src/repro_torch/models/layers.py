"""Core layers: norms (incl. the CNN's GroupNorm), RoPE, GQA attention
(dense causal / sliding window, diagonal-block flash past 2048 tokens,
cached decode with ring buffers for windowed layers, chunked paged and ring
serving, the flash-decoding split softmax), MLP variants.

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

# sequences longer than this take the flash path (`_sdpa_flash`)
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


def mrope_sections(head_dim: int) -> tuple[int, int, int]:
    """Pair counts for (temporal, height, width); qwen2-vl uses 16 / 24 /
    24 of 64 pairs for head_dim 128, i.e. fractions (1/4, 3/8, 3/8)."""
    pairs = head_dim // 2
    t = pairs // 4
    h = (pairs - t) // 2
    w = pairs - t - h
    return t, h, w


def apply_mrope(x, positions_thw, theta: float):
    """M-RoPE (qwen2-vl): x [..., S, H, D], positions_thw [3, ..., S]. The
    frequency pairs are split between the three position components, in
    fp32 as `apply_rope`.

    Positions without the leading component axis raise `ValueError`. The
    reference falls back to [B, S] positions there and then indexes their
    batch axis with the component ids 0 / 1 / 2 (ROADMAP queue C)."""
    if positions_thw.dim() != x.dim() - 1 or positions_thw.shape[0] != 3:
        raise ValueError(
            f"M-RoPE takes positions [3, ..., S] (temporal, height, width) "
            f"for x of shape {tuple(x.shape)}; got "
            f"{tuple(positions_thw.shape)}")
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, x.device)                # [pairs]
    # the position component of each frequency pair: [..., S, pairs]
    lead = tuple(positions_thw.shape[1:])
    pos = torch.cat([positions_thw[i][..., None].expand(lead + (n,))
                     for i, n in enumerate(mrope_sections(d))], dim=-1)
    angles = pos.float() * freqs
    cos = torch.cos(angles)[..., :, None, :]
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
    rope = apply_mrope if cfg.mrope else apply_rope
    return (rope(q, positions, cfg.rope_theta),
            rope(k, positions, cfg.rope_theta), v)


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


# ---------------------------------------------------------------------------
# Diagonal-block flash attention (the reference's `_sdpa_flash`)
#
# The sequence is cut into n chunks of c; diagonal `diag` pairs query chunk
# i with key chunk i - diag, so only blocks on or below the causal diagonal
# are computed, and a sliding window cuts the diagonal range statically.
# The forward keeps the online-softmax state (m, l, o) per query row in
# fp32; the backward recomputes each diagonal's probabilities from q, k and
# the log-sum-exp, so it saves O(S·d), never the [S, S] scores. Internal
# layout [B, H, n, c, D], heads ahead of the blocks, so each diagonal's
# products are batched matmuls over (B, H, blocks).
# ---------------------------------------------------------------------------

def _diag_mask(c: int, diag: int, window: int, device):
    """[c, c] bool: query row r of chunk i may see key row t of chunk
    i - diag."""
    delta = (torch.arange(c, device=device)[:, None]
             - torch.arange(c, device=device)[None, :] + diag * c)
    mask = delta >= 0
    if window:
        mask &= delta < window
    return mask


def _max_diag(n: int, c: int, window: int) -> int:
    """The diagonals that hold a visible key: all n, or under a window the
    first ceil(window / c) + 1."""
    return n if not window else min(n, (window + c - 1) // c + 1)


def _blocks(t, c: int):
    """[B, S, H, D] -> fp32 [B, H, S / c, c, D] (bf16 values are exact in
    fp32, so products of these sum as the reference's
    preferred_element_type=float32 does)."""
    b, s, h, d = t.shape
    return t.transpose(1, 2).to(torch.float32,
                                memory_format=torch.contiguous_format
                                ).view(b, h, s // c, c, d)


def _unblock(t, dtype):
    """fp32 [B, H, n, c, D] -> [B, S, H, D] in `dtype`."""
    b, h, n, c, d = t.shape
    return t.to(dtype).reshape(b, h, n * c, d).transpose(1, 2)


def _put(acc, diag: int, new):
    """acc[:, :, diag:] = new: in place where autograd does not watch (the
    custom forward, prefill), out of place under the naive VJP."""
    if torch.is_grad_enabled():
        return torch.cat([acc[:, :, :diag], new], dim=2)
    acc[:, :, diag:] = new
    return acc


def _flash_fwd_impl(q, k, v, window: int, c: int):
    """Diagonal-block causal flash attention forward with an online
    softmax. q, k, v: [B, S, H, D] (k, v already expanded to q's heads).
    Returns (out [B, S, H, D] in q's dtype, lse [B, H, n, c] fp32; the
    reference's lse is the same numbers as [B, n, c, H])."""
    b, s, hq, dd = q.shape
    n = s // c
    qb, kb, vb = _blocks(q, c), _blocks(k, c), _blocks(v, c)
    scale = 1.0 / math.sqrt(dd)
    m = torch.full((b, hq, n, c), -1e30, dtype=torch.float32,
                   device=q.device)                     # running max
    l = torch.zeros((b, hq, n, c), dtype=torch.float32,
                    device=q.device)                    # running denom
    o = torch.zeros((b, hq, n, c, dd), dtype=torch.float32,
                    device=q.device)                    # running numer
    for diag in range(_max_diag(n, c, window)):
        nb = n - diag                        # blocks on this diagonal
        sc = torch.matmul(qb[:, :, diag:],
                          kb[:, :, :nb].transpose(-1, -2)) * scale
        sc = torch.where(_diag_mask(c, diag, window, q.device), sc, -1e30)
        m_old = m[:, :, diag:]
        m_new = torch.maximum(m_old, sc.amax(dim=-1))
        p = torch.exp(sc - m_new[..., None])
        corr = torch.exp(m_old - m_new)
        l_new = l[:, :, diag:] * corr + p.sum(dim=-1)
        pv = torch.matmul(p.to(q.dtype).float(), vb[:, :, :nb])
        o_new = o[:, :, diag:] * corr[..., None] + pv
        m, l, o = _put(m, diag, m_new), _put(l, diag, l_new), \
            _put(o, diag, o_new)
    out = o / torch.clamp(l, min=1e-30)[..., None]
    lse = m + torch.log(torch.clamp(l, min=1e-30))
    return _unblock(out, q.dtype), lse


class _FlashAttn(torch.autograd.Function):
    """Flash attention with the reference's recomputing VJP: the residuals
    are q, k, v, out and the log-sum-exp; the backward rebuilds each
    diagonal's normalized probabilities from (q, k, lse) and the softmax
    term delta = sum(dout * out). Accumulators in fp32; the probabilities
    and ds cast to q's dtype before their products, as the reference."""

    @staticmethod
    def forward(ctx, q, k, v, window: int, c: int):
        out, lse = _flash_fwd_impl(q, k, v, window, c)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.window, ctx.c = window, c
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        window, c = ctx.window, ctx.c
        dt = q.dtype
        scale = 1.0 / math.sqrt(q.shape[-1])
        qb, kb, vb = _blocks(q, c), _blocks(k, c), _blocks(v, c)
        dob = _blocks(dout, c)
        n = qb.shape[2]
        delta = (dob * _blocks(out, c)).sum(dim=-1)     # [B, H, n, c]
        dq, dk, dv = (torch.zeros_like(qb) for _ in range(3))
        for diag in range(_max_diag(n, c, window)):
            nb = n - diag
            qs, ks, vs = qb[:, :, diag:], kb[:, :, :nb], vb[:, :, :nb]
            dos = dob[:, :, diag:]
            sc = torch.matmul(qs, ks.transpose(-1, -2)) * scale
            sc = torch.where(_diag_mask(c, diag, window, q.device), sc,
                             -1e30)
            p = torch.exp(sc - lse[:, :, diag:, :, None])  # normalized
            dv[:, :, :nb] += torch.matmul(p.to(dt).float().transpose(-1, -2),
                                          dos)
            dp = torch.matmul(dos, vs.transpose(-1, -2))
            ds = (p * (dp - delta[:, :, diag:, :, None]) * scale).to(dt)
            ds = ds.float()
            dq[:, :, diag:] += torch.matmul(ds, ks)
            dk[:, :, :nb] += torch.matmul(ds.transpose(-1, -2), qs)
        return _unblock(dq, dt), _unblock(dk, dt), _unblock(dv, dt), \
            None, None


def _sdpa_flash(q, k, v, window: int = 0, q_chunk: int = 512,
                kv_chunk: int = 512, naive_vjp: bool = False):
    """Memory-efficient causal attention. q: [B,S,Hq,D], k, v: [B,S,Hkv,D].
    naive_vjp=True differentiates the forward loop with plain autograd
    (O(S^2) residuals): the plain version the custom backward is held
    against."""
    _, s, hq, _ = q.shape
    if s <= q_chunk:
        return _sdpa_dense(q, k, v, window)
    if s % q_chunk or s % kv_chunk or q_chunk != kv_chunk:
        raise ValueError(
            f"flash path requires equal, dividing chunks: sequence {s}, "
            f"q_chunk {q_chunk}, kv_chunk {kv_chunk}")
    k = _expand_kv(k, hq)
    v = _expand_kv(v, hq)
    if naive_vjp:
        return _flash_fwd_impl(q, k, v, window, q_chunk)[0]
    return _FlashAttn.apply(q, k, v, window, q_chunk)


def attention(p, cfg, x, positions, *, window: int = 0, sel=None,
              flash_threshold: int = FLASH_THRESHOLD):
    """Full training/prefill attention over a whole sequence: dense up to
    `flash_threshold` tokens, the flash path past it."""
    b, s, _ = x.shape
    q, k, v = _qkv(p, cfg, x, positions, sel=sel)
    if s > flash_threshold:
        out = _sdpa_flash(q, k, v, window)
    else:
        out = _sdpa_dense(q, k, v, window)
    return smm(out.reshape(b, s, -1), p["wo"], sel, "wo")


def decode_attention(p, cfg, x, positions, cache, *, window: int = 0):
    """Single-token decode against a contiguous KV cache (the serving
    path's oracle).

    cache: {"k","v": [B, S_cache, Hkv, D], "pos": [B] int32 tokens so far},
    `pos` per row, so rows may sit at different depths. For sliding-window
    layers (window > 0) the cache is a ring buffer: position p lives at
    slot p % S_cache. Out of place: the cache passed in is not written."""
    b, s, _ = x.shape
    assert s == 1
    hd = cfg.resolved_head_dim
    q, k, v = _qkv(p, cfg, x, positions)
    pos = cache["pos"]
    s_cache = cache["k"].shape[1]
    slot = torch.remainder(pos, s_cache) if window > 0 else pos
    rows = torch.arange(b, device=x.device)
    k_cache, v_cache = cache["k"].clone(), cache["v"].clone()
    k_cache[rows, slot.long()] = k[:, 0].to(k_cache.dtype)
    v_cache[rows, slot.long()] = v[:, 0].to(v_cache.dtype)

    hkv = cfg.num_kv_heads
    g = cfg.num_heads // hkv
    qg = q.reshape(b, hkv, g, hd)
    scores = torch.einsum("bhgd,bkhd->bhgk", qg.float(),
                          k_cache.float()) / math.sqrt(hd)
    idx = torch.arange(s_cache, device=x.device)[None, :]
    if window > 0:
        # slot i holds position p_at = pos - ((pos - i) mod W), and
        # pos - W < p_at <= pos by construction: only p_at >= 0 matters
        p_at = pos[:, None] - torch.remainder(pos[:, None] - idx, s_cache)
        valid = p_at >= 0
    else:
        valid = idx <= pos[:, None]
    scores = torch.where(valid[:, None, None, :], scores, -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", probs.to(q.dtype).float(),
                       v_cache.float()).to(q.dtype)
    out = out.reshape(b, 1, cfg.num_heads * hd)
    new_cache = {"k": k_cache, "v": v_cache, "pos": pos + 1}
    return smm(out, p["wo"], None, "wo"), new_cache


# ---------------------------------------------------------------------------
# Chunk-capable serving attention (paged + ring)
#
# s >= 1 new tokens per row against an existing cache, so the serving
# engine's one step function covers batched decode (s = 1 over all slots)
# AND chunked prefill (one slot, page-sized chunks). Scores are taken
# against [cached keys ++ in-chunk keys] with the cache read BEFORE the
# chunk's rows are written, so in-chunk causality never depends on the
# order of writes (a ring buffer may overwrite its own chunk).
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


def _grouped_scores_split(q, k_cat, v_cat, mask, tile: int):
    """The flash-decoding form of `_grouped_scores`: the key axis is cut
    into `tile`-sized blocks (one page each in the serve engine), and the
    blocks merge one after another with the online-softmax update of
    `_flash_fwd_impl` (running max, denominator and numerator in fp32), so
    no [B, Hq, S, L] score tensor is materialized. Matches the monolithic
    softmax to fp32 roundoff. The last block may be short: its missing
    keys would be masked, and a masked key adds exactly 0 once a visible
    one has set the running max."""
    b, s, hq, hd = q.shape
    hkv = k_cat.shape[2]
    g = hq // hkv
    n_keys = k_cat.shape[1]
    qg = q.reshape(b, s, hkv, g, hd).float()
    scale = 1.0 / math.sqrt(hd)
    dev = q.device
    m = torch.full((b, hkv, g, s), -1e30, dtype=torch.float32, device=dev)
    l = torch.zeros((b, hkv, g, s), dtype=torch.float32, device=dev)
    o = torch.zeros((b, hkv, g, s, hd), dtype=torch.float32, device=dev)
    for t0 in range(0, n_keys, tile):
        k_b = k_cat[:, t0:t0 + tile].float()
        v_b = v_cat[:, t0:t0 + tile].float()
        sc = torch.einsum("bshgd,bthd->bhgst", qg, k_b) * scale
        sc = torch.where(mask[:, None, None, :, t0:t0 + tile], sc, -1e30)
        m_new = torch.maximum(m, sc.amax(dim=-1))
        pr = torch.exp(sc - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + pr.sum(dim=-1)
        pv = torch.einsum("bhgst,bthd->bhgsd", pr.to(q.dtype).float(), v_b)
        o = o * corr[..., None] + pv
        m = m_new
    out = o / torch.clamp(l, min=1e-30)[..., None]          # [B,Hkv,G,S,D]
    return out.permute(0, 3, 1, 2, 4).to(q.dtype).reshape(b, s, hq * hd)


def _serve_positions(cfg, start, s: int):
    """Token positions of a chunk: [B, S] ([3, B, S], the three components
    equal, for M-RoPE)."""
    pos = start[:, None] + torch.arange(s, dtype=torch.int32,
                                        device=start.device)[None, :]
    if cfg.mrope:
        pos = pos.expand((3,) + tuple(pos.shape))
    return pos


def chunk_ring_attention(p, cfg, x, start, active, cache, *, window: int,
                         length=None, delta=None):
    """Sliding-window attention for a chunk of s tokens per batch row
    against per-row ring buffers.

    cache: {"k","v": [B, W, Hkv, D]}, position p at slot p % W (W =
    min(window, max_len)). `start` [B]: tokens already cached per row;
    `active` [B] bool; `length` [B]: valid tokens per row (None = all s).
    Returns (y, new ring), out of place.

    The chunk attends to the ring as it was before the chunk, plus itself.
    Then every ring slot takes the newest VALID chunk row that maps onto
    it, if any: padded rows (j >= length) and inactive rows never write,
    and of a row's valid positions only the last W do. The reference drops
    the other writes through an out-of-bounds slot and relies on the valid
    ones never colliding; here each slot gathers its one writer instead
    (slot i's: the largest valid position congruent to i mod W), so no
    scatter, duplicate or dropped index is involved."""
    b, s, _ = x.shape
    dev = x.device
    if length is None:
        length = torch.full((b,), s, dtype=torch.int32, device=dev)
    ring_k, ring_v = cache["k"], cache["v"]
    w_cap = ring_k.shape[1]
    q, k, v = _qkv(p, cfg, x, _serve_positions(cfg, start, s), delta=delta)

    st = start.long()
    j = torch.arange(s, device=dev)
    qpos = st[:, None] + j[None, :]                          # [B, S]
    # ring part: slot i holds the latest position == i (mod W) below start
    # (the pre-chunk content); a negative one was never written
    idx = torch.arange(w_cap, device=dev)[None, :]
    last = st[:, None] - 1
    p_at = last - torch.remainder(last - idx, w_cap)         # [B, W]
    ring_mask = (p_at[:, None, :] >= 0) & \
        (qpos[:, :, None] - p_at[:, None, :] < window)       # [B, S, W]
    # in-chunk part: causal, window-limited
    gap = j[:, None] - j[None, :]
    chunk_mask = (gap >= 0) & (gap < window)
    chunk_mask = chunk_mask[None].expand(b, s, s)

    k_cat = torch.cat([ring_k.to(k.dtype), k], dim=1)
    v_cat = torch.cat([ring_v.to(v.dtype), v], dim=1)
    mask = torch.cat([ring_mask, chunk_mask], dim=2)
    out = _grouped_scores(q, k_cat, v_cat, mask)

    # slot i's writer: the largest position < start + length congruent to
    # i, if it is one of the row's last min(W, length) valid positions
    hi = st + length.long()                                  # [B]
    lo = st + (length.long() - w_cap).clamp(min=0)
    p_w = (hi - 1)[:, None] - torch.remainder((hi - 1)[:, None] - idx,
                                              w_cap)         # [B, W]
    writes = ((p_w >= lo[:, None]) & active[:, None])[:, :, None, None]
    src = (p_w - st[:, None]).clamp(0, s - 1)
    src = src[:, :, None, None].expand((b, w_cap) + tuple(k.shape[2:]))
    new = {"k": torch.where(writes, torch.gather(k, 1, src).to(ring_k.dtype),
                            ring_k),
           "v": torch.where(writes, torch.gather(v, 1, src).to(ring_v.dtype),
                            ring_v)}
    return row_matmul(out, p["wo"], None, "wo", delta), new


def chunk_paged_attention(p, cfg, x, start, active, pool, page_table, *,
                          page_size: int, length=None, delta=None,
                          flash_decode: bool = False):
    """Full (window-free) attention for a chunk of s tokens per batch row,
    reading and writing K/V through per-row page tables.

    pool: {"k","v": [R, H, D]} physical token rows shared by ALL batch rows
    (R = num_pages * page_size); page_table: [B, MP] int32 physical page per
    logical page, -1 where unallocated. `start` [B]: tokens already cached
    per row; `active` [B] bool; `length` [B]: valid tokens per row (None =
    all s). flash_decode: the softmax over the keys page by page
    (`_grouped_scores_split`). Returns (y, new pool), out of place as the
    reference.

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
    if flash_decode:
        out = _grouped_scores_split(q, k_cat, v_cat, mask, tile=ps)
    else:
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


def init_kv_cache(cfg, batch: int, seq_len: int, dtype, device="cuda", *,
                  window: int = 0):
    """A contiguous KV cache (the oracle's): k/v [B, S, Hkv, D] and the
    per-row token count `pos`; S = seq_len, or a ring of min(window,
    seq_len) slots for a windowed layer."""
    size = min(window, seq_len) if window > 0 else seq_len
    shape = (batch, size, cfg.num_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": torch.zeros((batch,), dtype=torch.int32, device=device)}


def ring_snapshot_leaves(cfg, window: int, max_len: int, dtype):
    """Per-row (shape, dtype) of a ring layer's serve-cache state, the unit
    a prefix cache snapshots at a page boundary: the k/v buffers (the serve
    ring keeps no per-row `pos`; the engine's slot position is it)."""
    size = min(window, max_len)
    leaf = ((size, cfg.num_kv_heads, cfg.resolved_head_dim), dtype)
    return {"k": leaf, "v": leaf}


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

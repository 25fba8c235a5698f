"""Core layers: norms (incl. the CNN's GroupNorm), RoPE, GQA attention
(dense causal / sliding window), MLP variants.

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
from repro_torch.models.common import dense_init

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


def _qkv(p, cfg, x, positions, sel=None):
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q = smm(x, p["wq"], sel, "wq").reshape(b, s, -1, hd)
    k = smm(x, p["wk"], sel, "wk").reshape(b, s, -1, hd)
    v = smm(x, p["wv"], sel, "wv").reshape(b, s, -1, hd)
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


def apply_mlp(p, cfg, x, sel=None):
    kind = cfg.mlp_kind
    if kind == "swiglu":
        h = F.silu(smm(x, p["w_gate"], sel, "w_gate")) * \
            smm(x, p["w_up"], sel, "w_up")
    elif kind == "gelu":
        h = F.gelu(smm(x, p["w_up"], sel, "w_up"), approximate="tanh")
    elif kind == "sq_relu":
        h = torch.relu(smm(x, p["w_up"], sel, "w_up"))
        h = h * h
    else:
        raise ValueError(kind)
    return smm(h, p["w_down"], sel, "w_down")

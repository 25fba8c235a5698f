"""RWKV-6 "Finch" block: token-shift time mix with data-dependent decay, and
the channel mix. The counterpart of the reference package's
`models/rwkv6.py`, with the same parameter keys and numerics.

WKV recurrence (per head, head_dim D):
    y_t = r_t . (diag(u) k_t v_t^T + S_{t-1})
    S_t = diag(w_t) S_{t-1} + k_t v_t^T
with per-channel decay w_t = exp(-exp(wlog_t)) from a low-rank
data-dependent path (the Finch contribution), kept in fp32 as the
reference keeps it.

The recurrence is `kernels.ops.WKV6` on every layer: the hand-written
kernel on the card (forward and backward), its plain step-by-step version
on the CPU. Frozen layers run under `torch.no_grad()`, so they launch the
forward only. As in the reference, the five token-shift interpolations use
per-channel learned mu (RWKV-5 style lerp); the decay keeps its full
data-dependent low-rank path.

Training runs from a zero state. The serving forms (a recurrent cache, per
row valid lengths) come with the recurrent serving caches, and the
head-sharded form with the multi-GPU slice; both raise until then.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.sparse_update import smm
from repro_torch.kernels import ops
from repro_torch.models.common import dense_init, row_matmul
from repro_torch.models.layers import apply_norm, init_norm

DECAY_LORA = 64

_CACHE = ("rwkv state caches and per-row lengths: ROADMAP queue A item 12 "
          "(not ported yet)")
_MESH = "head-sharded rwkv time mix: ROADMAP queue A item 14 (not ported yet)"


def num_heads(cfg) -> int:
    return cfg.d_model // cfg.rwkv.head_dim


def _uniform(gen, shape, device):
    t = torch.empty(shape, dtype=torch.float32, device=device)
    if t.device.type != "meta":
        t.uniform_(0.0, 1.0, generator=gen)
    return t


def _normal(gen, shape, device):
    t = torch.empty(shape, dtype=torch.float32, device=device)
    if t.device.type != "meta":
        t.normal_(0.0, 1.0, generator=gen)
    return t


def init_time_mix(gen, cfg, dtype, device="cuda"):
    d = cfg.d_model
    init = lambda shape, **kw: dense_init(gen, shape, device=device, **kw)
    return {
        "mu": _uniform(gen, (5, d), device),           # r,k,v,g,w shifts
        "wr": init((d, d), dtype=dtype),
        "wk": init((d, d), dtype=dtype),
        "wv": init((d, d), dtype=dtype),
        "wg": init((d, d), dtype=dtype),
        "wo": init((d, d), dtype=dtype),
        # data-dependent decay lora: w_t = w0 + tanh(x_w @ A) @ B
        "w0": torch.full((d,), -6.0, dtype=torch.float32, device=device),
        "wA": init((d, DECAY_LORA), dtype=torch.float32),
        "wB": init((DECAY_LORA, d), dtype=torch.float32, scale=0.1),
        "u": _normal(gen, (num_heads(cfg), cfg.rwkv.head_dim), device) * 0.1,
        "ln_x": init_norm(d, "layernorm", torch.float32, device),
    }


def init_channel_mix(gen, cfg, dtype, device="cuda"):
    d, ff = cfg.d_model, cfg.d_ff
    init = lambda shape: dense_init(gen, shape, dtype=dtype, device=device)
    return {
        "mu": _uniform(gen, (2, d), device),           # k,r shifts
        "wk": init((d, ff)),
        "wv": init((ff, d)),
        "wr": init((d, d)),
    }


def _shift(x):
    """Token shift: x_{t-1}, zeros at t=0."""
    return torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)


def wkv(r, k, v, w, u):
    """r, k, v, w: [B, S, H, D] fp32, u: [H, D] -> y [B, S, H, D], from the
    zero state (the reference's `wkv` with s0 = 0, its final state
    dropped)."""
    return ops.WKV6.apply(r.contiguous(), k.contiguous(), v.contiguous(),
                          w.contiguous(), u.contiguous())


def apply_time_mix(p, cfg, x, sel=None, cache=None, length=None):
    """x: [B, S, d] -> (out [B, S, d], None)."""
    if cache is not None or length is not None:
        raise NotImplementedError(_CACHE)
    b, s, d = x.shape
    hd = cfg.rwkv.head_dim
    if p["wr"].shape[-1] != d:
        raise NotImplementedError(_MESH)

    xp = _shift(x)
    mu = p["mu"].to(x.dtype)
    xr, xk, xv, xg, xw = [x + (xp - x) * mu[i] for i in range(5)]

    r = smm(xr, p["wr"], sel, "wr").reshape(b, s, -1, hd)
    k = smm(xk, p["wk"], sel, "wk").reshape(b, s, -1, hd)
    v = smm(xv, p["wv"], sel, "wv").reshape(b, s, -1, hd)
    g = smm(xg, p["wg"], sel, "wg")

    # the decay lora in fp32, as the reference
    wlog = p["w0"] + torch.matmul(torch.tanh(torch.matmul(xw.float(),
                                                          p["wA"])), p["wB"])
    w = torch.exp(-torch.exp(wlog)).reshape(b, s, -1, hd)    # in (0, 1)

    y = wkv(r.float(), k.float(), v.float(), w, p["u"])
    # ln_x normalizes over the full d
    y = apply_norm(p["ln_x"], y.reshape(b, s, d).to(x.dtype))
    y = y * F.silu(g)
    return smm(y, p["wo"], sel, "wo"), None


def apply_channel_mix(p, cfg, x, sel=None, cache=None, length=None):
    """x: [B, S, d] -> (out [B, S, d], None)."""
    if cache is not None or length is not None:
        raise NotImplementedError(_CACHE)
    xp = _shift(x)
    mu = p["mu"].to(x.dtype)
    xk = x + (xp - x) * mu[0]
    xr = x + (xp - x) * mu[1]
    k = torch.relu(smm(xk, p["wk"], sel, "wk"))
    k = k * k
    kv = row_matmul(k, p["wv"], sel, "wv")
    return torch.sigmoid(smm(xr, p["wr"], sel, "wr")) * kv, None

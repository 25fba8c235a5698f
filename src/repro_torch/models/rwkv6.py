"""RWKV-6 "Finch" block: token-shift time mix with data-dependent decay, and
the channel mix. The counterpart of the reference package's
`models/rwkv6.py`, with the same parameter keys and numerics.

WKV recurrence (per head, head_dim D):
    y_t = r_t . (diag(u) k_t v_t^T + S_{t-1})
    S_t = diag(w_t) S_{t-1} + k_t v_t^T
with per-channel decay w_t = exp(-exp(wlog_t)) from a low-rank
data-dependent path (the Finch contribution), kept in fp32 as the
reference keeps it.

The recurrence is the hand-written WKV kernel on every layer on the card,
its plain step-by-step version on the CPU (`kernels.ops`). Training runs
from a zero state through `ops.WKV6` (forward and backward); frozen layers
run under `torch.no_grad()`, so they launch the forward only. Serving
passes a recurrent cache {"s": [B, H, D, D] fp32, "last": [B, d]}: the
kernel's forward starts from the cached state and returns the state after
the chunk (`ops.wkv6_fwd(..., s0=, want_state=True)`), one launch a layer
for a prefill chunk and for a decode step alike. With per-row valid
lengths (`length`, padded prefill chunks) the padded steps get k = 0 and
w = 1, an identity step, and the token-shift `last` is taken at each row's
last valid position, so the cache comes back as after the valid prefix.

As in the reference, the five token-shift interpolations use per-channel
learned mu (RWKV-5 style lerp); the decay keeps its full data-dependent
low-rank path. The head-sharded form comes with the multi-GPU slice and
raises until then.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.sparse_update import smm
from repro_torch.kernels import ops
from repro_torch.models.common import dense_init, last_valid, row_matmul
from repro_torch.models.layers import apply_norm, init_norm

DECAY_LORA = 64

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


def _shift(x, last=None):
    """Token shift: x_{t-1}, with zeros (or the cached `last` [B, d]) at
    t = 0."""
    first = torch.zeros_like(x[:, :1]) if last is None else last[:, None, :]
    return torch.cat([first, x[:, :-1]], dim=1)


def wkv(r, k, v, w, u, s0=None):
    """r, k, v, w: [B, S, H, D] fp32, u: [H, D] -> y [B, S, H, D] from the
    zero state (training: differentiable through the kernel's backward);
    with s0 [B, H, D, D] -> (y, the state after the last step), the
    reference's `wkv(r, k, v, w, u, s0)`, forward only."""
    args = [t.contiguous() for t in (r, k, v, w, u)]
    if s0 is None:
        return ops.WKV6.apply(*args)
    return ops.wkv6_fwd(*args, s0=s0.contiguous(), want_state=True)


def apply_time_mix(p, cfg, x, sel=None, cache=None, length=None):
    """x: [B, S, d] -> (out [B, S, d], new cache or None). cache (serving):
    {"s": [B, H, D, D] fp32, "last": [B, d]}; length [B] (None = all s):
    valid tokens per row."""
    b, s, d = x.shape
    hd = cfg.rwkv.head_dim
    if p["wr"].shape[-1] != d:
        raise NotImplementedError(_MESH)

    xp = _shift(x, None if cache is None else cache["last"])
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

    k32 = k.float()
    if length is not None and s > 1:
        # padded steps: k = 0 (no k v^T) and w = 1 (S kept): identity steps
        valid = (torch.arange(s, device=x.device)[None, :]
                 < length[:, None])[:, :, None, None]
        k32 = torch.where(valid, k32, 0.0)
        w = torch.where(valid, w, 1.0)
    if cache is None:
        y = wkv(r.float(), k32, v.float(), w, p["u"])
    else:
        y, s_new = wkv(r.float(), k32, v.float(), w, p["u"], cache["s"])
    # ln_x normalizes over the full d
    y = apply_norm(p["ln_x"], y.reshape(b, s, d).to(x.dtype))
    y = y * F.silu(g)
    out = smm(y, p["wo"], sel, "wo")
    if cache is None:
        return out, None
    return out, {"s": s_new, "last": last_valid(x, length)}


def apply_channel_mix(p, cfg, x, sel=None, cache=None, length=None):
    """x: [B, S, d] -> (out [B, S, d], new cache or None). cache (serving):
    {"last": [B, d]}, taken back at each row's last valid position."""
    xp = _shift(x, None if cache is None else cache["last"])
    mu = p["mu"].to(x.dtype)
    xk = x + (xp - x) * mu[0]
    xr = x + (xp - x) * mu[1]
    k = torch.relu(smm(xk, p["wk"], sel, "wk"))
    k = k * k
    kv = row_matmul(k, p["wv"], sel, "wv")
    out = torch.sigmoid(smm(xr, p["wr"], sel, "wr")) * kv
    if cache is None:
        return out, None
    return out, {"last": last_valid(x, length)}


def init_rwkv_cache(cfg, batch: int, dtype, device="cuda"):
    """A zero recurrent cache for `batch` rows: the wkv state in fp32, the
    token-shift vectors in the model dtype."""
    hd, h, d = cfg.rwkv.head_dim, num_heads(cfg), cfg.d_model
    zeros = lambda shape, dt: torch.zeros(shape, dtype=dt, device=device)
    return {"time": {"s": zeros((batch, h, hd, hd), torch.float32),
                     "last": zeros((batch, d), dtype)},
            "chan": {"last": zeros((batch, d), dtype)}}


def rwkv_snapshot_leaves(cfg, dtype):
    """Per-row (shape, dtype) of the rwkv6 recurrent state, the unit a
    prefix cache snapshots: the wkv state S and the token-shift `last`
    vectors."""
    hd, h, d = cfg.rwkv.head_dim, num_heads(cfg), cfg.d_model
    return {"time": {"s": ((h, hd, hd), torch.float32),
                     "last": ((d,), dtype)},
            "chan": {"last": ((d,), dtype)}}

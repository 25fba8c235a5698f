"""Mamba-1 selective-scan block (jamba's SSM mixer). The counterpart of the
reference package's `models/mamba.py`, with the same parameter keys and
numerics.

Memory: everything of size [B, S, d_inner] is materialized once; the
[B, Q, d_inner, d_state] discretized tensors exist only inside one chunk of
Q = CHUNK steps, which `torch.utils.checkpoint` recomputes in backward (the
reference's `jax.checkpoint` per chunk), so the forward keeps only the
[B, d_inner, d_state] state between chunks.

Inside a chunk the affine recurrence h_t = dA_t h_{t-1} + dBx_t runs as a
log-depth (Hillis-Steele) scan over the chunk's Q steps: log2(Q) = 6 rounds
of whole-chunk element-wise products, ~40 launches a chunk on whole
[B, Q, d_inner, d_state] tensors. A step-by-step loop does less arithmetic
but launches ~12x more kernels, each on a [B, d_inner, d_state] slice: at
jamba's widths (batch 2 x 1024) one layer's scan in a train step took 451
ms of device time as a log-depth scan, against 163 ms as a loop whose host
needed 3.3 s to issue its launches (NVIDIA H100 80GB HBM3, 700 W;
`chip_smoke.py`'s jamba phase). No TPU kernel covers the scan: it is plain
PyTorch.

The parameters are mixed-dtype as in the reference: `dt_bias`, `A_log` and
`D` are fp32 in any model dtype; `dt_proj` is a plain fp32 product. Only
`in_proj` and `out_proj` take part in channel selection (`smm`); `x_proj`,
`dt_proj`, `conv_w` and `A_log` are excluded from it
(`core.selection.EXCLUDED`), so in trainable layers they and the 1-D
leaves take the dense rule, their gradients flowing through the scan.

Training runs from a zero state. Serving passes a recurrent cache {"h":
[B, d_inner, d_state] fp32, "conv": [B, d_conv - 1, d_inner]}: a one-token
step convolves [conv tail ++ x] in fp32 and advances h = dA h + dBx; a
chunk convolves [conv tail ++ chunk], scans from h, and keeps the last
d_conv - 1 valid inputs as the new tail. With per-row valid lengths
(`length`, padded prefill chunks) dt is forced to 0 on the padded steps, an
identity transition, so the cache comes back as after the valid prefix.
The channel-sharded form comes with the multi-GPU slice and raises until
then.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core.sparse_update import smm
from repro_torch.models.common import dense_init

CHUNK = 64

_MESH = ("channel-sharded mamba (the serve mesh): ROADMAP queue A item 14 "
         "(not ported yet)")


def dt_rank(cfg) -> int:
    return max(1, math.ceil(cfg.d_model / 16))


def d_inner(cfg) -> int:
    return cfg.ssm.expand * cfg.d_model


def init_mamba(gen, cfg, dtype, device="cuda"):
    d = cfg.d_model
    di = d_inner(cfg)
    ns = cfg.ssm.d_state
    dr = dt_rank(cfg)
    init = lambda shape, **kw: dense_init(gen, shape, dtype=dtype,
                                          device=device, **kw)
    u = torch.empty((di,), dtype=torch.float32, device=device)
    if u.device.type != "meta":
        u.uniform_(0.0, 1.0, generator=gen)
    # S4D-real initialization for A
    a = torch.arange(1, ns + 1, dtype=torch.float32,
                     device=device)[None, :].repeat(di, 1)
    return {
        "in_proj": init((d, 2 * di)),
        "conv_w": init((cfg.ssm.d_conv, di), scale=1.0),
        "conv_b": torch.zeros((di,), dtype=dtype, device=device),
        "x_proj": init((di, dr + 2 * ns)),
        "dt_proj": init((dr, di)),
        "dt_bias": torch.log(torch.expm1(torch.clamp(u * 0.1, min=1e-3))),
        "A_log": torch.log(a),
        "D": torch.ones((di,), dtype=torch.float32, device=device),
        "out_proj": init((di, d)),
    }


def softplus(x):
    """log(1 + e^x) as `jax.nn.softplus` (logaddexp(x, 0)) has it, with no
    threshold: `F.softplus` returns x itself above 20."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _causal_depthwise_conv(x, w, b):
    """x: [B, S, C]; w: [K, C] causal depthwise conv, accumulated in fp32
    tap by tap in the reference's order."""
    k, s = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(k):
        out = out + pad[:, i: i + s, :].float() * w[i].float()
    return (out + b.float()).to(x.dtype)


def _discretize(a, dt, xc, b_ssm):
    """dt, xc: [B,Q,D] fp32; b_ssm: [B,Q,N] -> dA, dBx [B,Q,D,N] fp32."""
    dA = torch.exp(dt[..., None] * a)
    dBx = (dt * xc)[..., None] * b_ssm[..., None, :]
    return dA, dBx


def _affine_scan(a, b):
    """Inclusive scan of h_t = a_t h_{t-1} + b_t over dim 1, as the pairs
    (a, b) o (a', b') = (a a', a' b + b'): Hillis-Steele, log2(Q) rounds,
    each combining every step with the one `k` before it. Returns the
    running (products of a, h from a zero start)."""
    q = a.shape[1]
    k = 1
    while k < q:
        b = torch.cat([b[:, :k], a[:, k:] * b[:, :-k] + b[:, k:]], dim=1)
        a = torch.cat([a[:, :k], a[:, k:] * a[:, :-k]], dim=1)
        k *= 2
    return a, b


def _ssm_chunk(a, h0, dt, xc, b_ssm, c):
    """h0 [B, D, N]; dt, xc [B, Q, D]; b_ssm, c [B, Q, N] -> (h_last
    [B, D, N], y [B, Q, D]). The [B, Q, D, N] tensors exist only here."""
    dA, dBx = _discretize(a, dt, xc, b_ssm)
    a_cum, b_cum = _affine_scan(dA, dBx)
    h = a_cum * h0[:, None] + b_cum                      # [B, Q, D, N]
    y = torch.einsum("bqdn,bqn->bqd", h, c)
    return h[:, -1], y


def selective_scan(a, dt, xc, b_ssm, c, h0):
    """dt, xc: [B, S, D] fp32; b_ssm, c: [B, S, N] -> (y [B, S, D],
    h_last). Chunks of CHUNK steps (S itself when shorter; S must be a
    multiple of the chunk, as in the reference), each recomputed in
    backward when a gradient is being taken."""
    s = dt.shape[1]
    q = min(CHUNK, s)
    if s % q:
        raise ValueError(f"mamba: sequence {s} is not a multiple of the "
                         f"scan's chunk of {q} steps")
    h = h0
    ys = []
    for i in range(0, s, q):
        args = (a, h, dt[:, i:i + q], xc[:, i:i + q], b_ssm[:, i:i + q],
                c[:, i:i + q])
        if torch.is_grad_enabled():
            h, y = checkpoint(_ssm_chunk, *args, use_reentrant=False)
        else:
            h, y = _ssm_chunk(*args)
        ys.append(y)
    return torch.cat(ys, dim=1), h


def apply_mamba(p, cfg, x, sel=None, cache=None, length=None):
    """x: [B, S, d] -> (out [B, S, d], new cache or None), from a zero
    state or, serving, from `cache`; length [B] (chunk form, None = all s):
    valid tokens per row."""
    b, s, _ = x.shape
    di = d_inner(cfg)
    ns = cfg.ssm.d_state
    dr = dt_rank(cfg)
    if p["out_proj"].shape[-2] != di:
        raise NotImplementedError(_MESH)

    xz = smm(x, p["in_proj"], sel, "in_proj")
    x_in, z = torch.chunk(xz, 2, dim=-1)
    new_conv = None
    if cache is None:
        x_c = F.silu(_causal_depthwise_conv(x_in, p["conv_w"], p["conv_b"]))
    elif s == 1:
        hist = torch.cat([cache["conv"], x_in], dim=1)      # [B, K, D]
        acc = torch.einsum("bkd,kd->bd", hist.float(), p["conv_w"].float()) \
            + p["conv_b"].float()
        x_c = F.silu(acc)[:, None, :].to(x.dtype)
        new_conv = hist[:, 1:]
    else:
        # a chunk: the conv over [history ++ chunk], each output with its
        # full K-1 causal history; the new tail is the last K-1 VALID
        # inputs, hist rows [length, length + K-1) (hist row i is the
        # chunk's input i - (K-1))
        n_hist = cache["conv"].shape[1]
        hist = torch.cat([cache["conv"], x_in], dim=1)      # [B, K-1+S, D]
        full = _causal_depthwise_conv(hist, p["conv_w"], p["conv_b"])
        x_c = F.silu(full[:, n_hist:])
        if length is None:
            new_conv = hist[:, -n_hist:]
        else:
            tail = length.long()[:, None] + torch.arange(n_hist,
                                                         device=x.device)
            new_conv = torch.gather(
                hist, 1, tail[:, :, None].expand(b, n_hist, hist.shape[2]))

    dbl = smm(x_c, p["x_proj"], sel, "x_proj")
    dt, b_ssm, c_ssm = torch.split(dbl, [dr, ns, ns], dim=-1)
    dt = softplus(torch.matmul(dt.float(), p["dt_proj"].float())
                  + p["dt_bias"])                         # [B,S,D] fp32
    if length is not None and s > 1:
        # padded steps: dt = 0 makes the step an identity (dA = 1, dBx = 0)
        valid = torch.arange(s, device=x.device)[None, :, None] \
            < length[:, None, None]
        dt = torch.where(valid, dt, 0.0)
    a = -torch.exp(p["A_log"])                            # [D,N]
    xc32 = x_c.float()
    h0 = cache["h"] if cache is not None else torch.zeros(
        (b, di, ns), dtype=torch.float32, device=x.device)
    if cache is not None and s == 1:
        dA, dBx = _discretize(a, dt[:, 0], xc32[:, 0], b_ssm[:, 0].float())
        h_last = dA * h0 + dBx
        y = torch.einsum("bdn,bn->bd", h_last, c_ssm[:, 0].float())[:, None]
    else:
        y, h_last = selective_scan(a, dt, xc32, b_ssm.float(),
                                   c_ssm.float(), h0)

    y = y + p["D"] * xc32
    y = y.to(x.dtype) * F.silu(z)
    out = smm(y, p["out_proj"], sel, "out_proj")
    if cache is None:
        return out, None
    return out, {"h": h_last, "conv": new_conv}


def init_mamba_cache(cfg, batch: int, dtype, device="cuda"):
    """A zero recurrent cache for `batch` rows: h in fp32, the conv tail in
    the model dtype."""
    di = d_inner(cfg)
    return {"h": torch.zeros((batch, di, cfg.ssm.d_state),
                             dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.ssm.d_conv - 1, di), dtype=dtype,
                                device=device)}


def mamba_snapshot_leaves(cfg, dtype):
    """Per-row (shape, dtype) of the mamba recurrent state, the unit a
    prefix cache snapshots: the scan's h and the conv tail."""
    di = d_inner(cfg)
    return {"h": ((di, cfg.ssm.d_state), torch.float32),
            "conv": ((cfg.ssm.d_conv - 1, di), dtype)}

"""MobileNetV2 + GroupNorm: the paper's own experiment substrate.

BatchNorm is replaced by GroupNorm (paper §IV-A: batch-independent
statistics for batch-1 edge training). The parameter tree is the reference
package's: HWIO conv weights, NHWC activations at every public function, so
`bridge.to_torch` carries the reference's parameters across unchanged.
Weights are permuted to OIHW only at the conv call, and activations are
kept in NHWC storage (channels_last for the conv library), which is the
contiguous [B*H*W, C] layout the activation pruning kernel reads.

Sparse update: 1x1 (pointwise) convs take part in channel-block selection
via `sconv`, whose backward computes dW only for the selected output-channel
blocks and scatters it into zeros (the reference's dense-scatter VJP; the
reference has no compact conv path). Depthwise 3x3 convs are selected by
layer but not masked by channel.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.models.common import dense_init
from repro_torch.models.layers import apply_group_norm, init_group_norm


# ---------------------------------------------------------------------------
# convolution with JAX's SAME padding, NHWC / HWIO
# ---------------------------------------------------------------------------

def same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    """(lo, hi) padding of XLA's SAME: at stride 2 on an even input it pads
    (0, 1), where a symmetric `padding=1` would shift the window."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _padded(xc, w, stride: int):
    """xc: NCHW view; w: HWIO. Returns (input, padding for the conv call,
    (h_lo, w_lo)): symmetric SAME padding goes to the conv, an asymmetric
    one is applied with F.pad first."""
    (hl, hh), (wl, wh) = (same_pads(xc.shape[2], w.shape[0], stride),
                          same_pads(xc.shape[3], w.shape[1], stride))
    if hl == hh and wl == wh:
        return xc, (hl, wl), (0, 0)
    return F.pad(xc, (wl, wh, hl, hh)), (0, 0), (hl, wl)


def conv(x, w, stride: int = 1, groups: int = 1):
    """x: [B, H, W, C_in] NHWC; w: [kh, kw, C_in / groups, C_out] HWIO ->
    [B, H', W', C_out] NHWC (contiguous), SAME padding as
    `jax.lax.conv_general_dilated`."""
    xc, pad, _ = _padded(x.permute(0, 3, 1, 2), w, stride)
    y = F.conv2d(xc, w.permute(3, 2, 0, 1), stride=stride, padding=pad,
                 groups=groups)
    # channels_last in gives channels_last out: the NHWC view is contiguous
    # and this is a no-op
    return y.permute(0, 2, 3, 1).contiguous()


class _SConv(torch.autograd.Function):
    """A dense conv (groups == 1) whose dW covers the selected output-channel
    blocks only, scattered into zeros; dx is the full input gradient."""

    @staticmethod
    def forward(ctx, x, w, idx, stride: int, spec):
        ctx.save_for_backward(x, w, idx)
        ctx.stride, ctx.spec = stride, spec
        return conv(x, w, stride)

    @staticmethod
    def backward(ctx, dy):
        x, w, idx = ctx.saved_tensors
        stride, (block, n_sel, n_blocks) = ctx.stride, ctx.spec
        xc, pad, (hl, wl) = _padded(x.permute(0, 3, 1, 2), w, stride)
        dyc = dy.permute(0, 3, 1, 2)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dxc = torch.nn.grad.conv2d_input(
                xc.shape, w.permute(3, 2, 0, 1), dyc, stride, pad)
            dx = dxc[:, :, hl:hl + x.shape[1], wl:wl + x.shape[2]] \
                .permute(0, 2, 3, 1)
        if ctx.needs_input_grad[1]:
            idxb = idx.reshape(-1).long()       # [n_sel], one shard
            lead = dy.shape[:-1]
            dy_sel = dy.reshape(lead + (n_blocks, block)) \
                .index_select(-2, idxb).reshape(lead + (n_sel * block,))
            kh, kw, cin, cout = w.shape
            dw_sel = torch.nn.grad.conv2d_weight(
                xc, (n_sel * block, cin, kh, kw), dy_sel.permute(0, 3, 1, 2),
                stride, pad)                    # OIHW
            dw = torch.zeros((kh, kw, cin, n_blocks, block), dtype=w.dtype,
                             device=w.device)
            dw.index_copy_(3, idxb, dw_sel.permute(2, 3, 1, 0)
                           .reshape(kh, kw, cin, n_sel, block).to(w.dtype))
            dw = dw.reshape(w.shape)
        return dx, dw, None, None, None


def sconv(x, w, sel, name: str, stride: int = 1, groups: int = 1):
    """`conv`, with the selected-block dW where `sel` = (idx, spec) (or
    (idx, spec, wsel): there is no compact conv path, so any wsel is
    ignored) names this weight and the conv is dense (groups == 1)."""
    if sel is not None and groups == 1:
        idx_dict, spec_dict = sel[0], sel[1]
        if idx_dict is not None and name in idx_dict:
            sp = spec_dict[name]
            return _SConv.apply(x, w, idx_dict[name], stride,
                                (sp.block, sp.n_sel, sp.n_blocks))
    return conv(x, w, stride, groups)


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------

def _make_divisible(v, divisor=8):
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def conv_layer_names(cfg) -> list[str]:
    """Ordered conv weight names, forward order (for last-K selection)."""
    names = ["stem/w"]
    idx = 0
    for t, c, n, s in cfg.inverted_residual_setting:
        for i in range(n):
            base = f"b{idx}"
            if t != 1:
                names.append(f"{base}/expand/w")
            names.append(f"{base}/dw/w")
            names.append(f"{base}/project/w")
            idx += 1
    names.append("head/w")
    return names


def prune_sites(cfg, img: int) -> list[tuple[str, tuple[int, int, int]]]:
    """The activations `forward` hands to `act_prune`, in forward order:
    (conv weight name, (H, W, C) of one image) for every conv followed by
    ReLU6 (the stem, each expand and depthwise conv, the head)."""
    wm = cfg.width_mult
    res = -(-img // 2)
    c_prev = _make_divisible(cfg.stem_channels * wm)
    sites = [("stem/w", (res, res, c_prev))]
    idx = 0
    for t, c, n, s in cfg.inverted_residual_setting:
        c_out = _make_divisible(c * wm)
        for i in range(n):
            base = f"b{idx}"
            hidden = c_prev * t
            if t != 1:
                sites.append((f"{base}/expand/w", (res, res, hidden)))
            res = -(-res // (s if i == 0 else 1))
            sites.append((f"{base}/dw/w", (res, res, hidden)))
            c_prev = c_out
            idx += 1
    c_head = _make_divisible(cfg.head_channels * max(1.0, wm))
    sites.append(("head/w", (res, res, c_head)))
    return sites


def init_params(cfg, gen: torch.Generator) -> dict:
    """Random params drawn from `gen`, on its device: convs truncated
    normal with gain 0.5 (every conv feeds a GroupNorm, so SGD's step on a
    scale-invariant weight goes as lr / |w|^2; the He gain of 2 would
    quarter the usable learning rate), GroupNorm ones / zeros, the
    classifier `dense_init`."""
    dtype = getattr(torch, cfg.dtype)
    device = gen.device
    wm = cfg.width_mult
    params: dict[str, Any] = {}

    def conv_init(shape):
        fan_in = shape[0] * shape[1] * shape[2]
        t = torch.empty(shape, dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
        return (t * (0.5 / fan_in) ** 0.5).to(dtype)

    def gn(c):
        return init_group_norm(c, dtype, device)

    c_in = cfg.in_channels
    c_stem = _make_divisible(cfg.stem_channels * wm)
    params["stem"] = {"w": conv_init((3, 3, c_in, c_stem)), "gn": gn(c_stem)}
    c_prev = c_stem
    idx = 0
    for t, c, n, s in cfg.inverted_residual_setting:
        c_out = _make_divisible(c * wm)
        for i in range(n):
            hidden = c_prev * t
            blk = {}
            if t != 1:
                blk["expand"] = {"w": conv_init((1, 1, c_prev, hidden)),
                                 "gn": gn(hidden)}
            blk["dw"] = {"w": conv_init((3, 3, 1, hidden)), "gn": gn(hidden)}
            blk["project"] = {"w": conv_init((1, 1, hidden, c_out)),
                              "gn": gn(c_out)}
            params[f"b{idx}"] = blk
            c_prev = c_out
            idx += 1
    c_head = _make_divisible(cfg.head_channels * max(1.0, wm))
    params["head"] = {"w": conv_init((1, 1, c_prev, c_head)), "gn": gn(c_head)}
    params["classifier"] = {
        "w": dense_init(gen, (c_head, cfg.num_classes), dtype=dtype,
                        device=device),
        "b": torch.zeros((cfg.num_classes,), dtype=dtype, device=device)}
    return params


def _pick(frozen, trainable, *path):
    for tree in (trainable, frozen):
        if tree is None:
            continue
        node = tree
        ok = True
        for k in path:
            if not isinstance(node, dict) or k not in node or node[k] is None:
                ok = False
                break
            node = node[k]
        if ok:
            return node
    raise KeyError(path)


def forward(cfg, params_pair, images, sel=None, act_prune=None):
    """images: [B, H, W, 3] -> logits [B, num_classes].

    act_prune: optional callable applied to the post-ReLU6 activations
    (block activation pruning, core.act_prune)."""
    frozen, trainable = params_pair
    ap = act_prune if act_prune is not None else (lambda v: v)

    def cbr(x, p, name, stride=1, groups=1):
        x = sconv(x, p["w"], sel, name, stride=stride, groups=groups)
        x = apply_group_norm(p["gn"], x, cfg.gn_groups)
        return ap(torch.clamp(x, 0.0, 6.0))

    x = images
    x = cbr(x, _pick(frozen, trainable, "stem"), "stem/w", stride=2)
    idx = 0
    for t, c, n, s in cfg.inverted_residual_setting:
        for i in range(n):
            base = f"b{idx}"
            blk = _pick(frozen, trainable, base)
            inp = x
            if "expand" in blk:
                x = cbr(x, blk["expand"], f"{base}/expand/w")
            stride = s if i == 0 else 1
            x = cbr(x, blk["dw"], f"{base}/dw/w", stride=stride,
                    groups=x.shape[-1])
            x = sconv(x, blk["project"]["w"], sel, f"{base}/project/w")
            x = apply_group_norm(blk["project"]["gn"], x, cfg.gn_groups)
            if stride == 1 and inp.shape == x.shape:
                x = x + inp
            idx += 1
    x = cbr(x, _pick(frozen, trainable, "head"), "head/w")
    x = x.mean(dim=(1, 2))
    cl = _pick(frozen, trainable, "classifier")
    return x @ cl["w"] + cl["b"]


def loss_fn(cfg, params_pair, batch, sel=None, act_prune=None):
    """(mean cross-entropy, {"acc"}) of a batch {"images", "labels"}."""
    logits = forward(cfg, params_pair, batch["images"], sel=sel,
                     act_prune=act_prune).float()
    labels = batch["labels"].long()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[:, None])[:, 0]
    loss = torch.mean(lse - gold)
    acc = torch.mean((torch.argmax(logits, -1) == labels).float())
    return loss, {"acc": acc}

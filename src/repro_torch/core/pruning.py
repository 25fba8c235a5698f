"""Offline pruning (paper §III-A) for the CNN path.

1. Dependency-aware channel pruning (DepGraph [9], simplified): the
   *hidden* channels of each inverted residual form one dependency group
   (expand-out, depthwise, project-in); groups are scored by mean |w| and
   pruned with a per-layer sparsity set by the layer's mean-|w| rank
   (higher layers = more sensitive = pruned less, paper §III-A.1). Every
   filter of a layer gets the same sparsity (the paper's PE-utilization
   rule).

2. Pattern-based pruning (PatDNN [10]): every 3x3 depthwise kernel keeps a
   4-entry pattern chosen from a fixed library (best-magnitude match);
   1x1 convs get unstructured magnitude pruning to the target rate.

Both emit masks (semi-structured zeros). Scores and masks are computed on
the host in numpy, as in the reference; the masks come back as tensors on
the weights' device. Applied on the *pre-training* distribution, never the
target dataset (the paper's realism argument).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.mobilenet_v2 import _make_divisible

# PatDNN-style 4-entry patterns for 3x3 kernels (center always kept)
_PATTERNS = np.array([
    [0, 1, 3, 4], [1, 2, 4, 5], [3, 4, 6, 7], [4, 5, 7, 8],
    [0, 2, 4, 6], [2, 4, 6, 8], [0, 4, 6, 8], [0, 2, 4, 8],
    [1, 3, 4, 5], [3, 4, 5, 7],
])


def _np(t) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _blocks(cfg):
    """The inverted-residual block names, in forward order."""
    n = sum(rep for _, _, rep, _ in cfg.inverted_residual_setting)
    return [f"b{i}" for i in range(n)]


def channel_group_scores(params, cfg) -> dict[str, np.ndarray]:
    """Mean |w| per hidden-channel group for each inverted-residual block."""
    scores = {}
    for base in _blocks(cfg):
        blk = params[base]
        group = np.abs(_np(blk["dw"]["w"])).mean((0, 1, 2))
        if "expand" in blk:
            group = group + np.abs(_np(blk["expand"]["w"])).mean((0, 1, 2))
        group = group + np.abs(_np(blk["project"]["w"])).mean((0, 1)).mean(-1)
        scores[base] = group
    return scores


def layer_sparsity_targets(params, cfg, global_target: float) -> dict[str, float]:
    """Per-layer sparsity from mean-|w| rank: larger mean |w| (more
    sensitive, typically later layers) -> pruned less (paper §III-A.1)."""
    means = {base: float(np.abs(_np(params[base]["dw"]["w"])).mean())
             for base in _blocks(cfg)}
    order = sorted(means, key=means.get)          # low mean first = prune more
    n_l = len(order)
    # linear ramp around the global target: [1.3t .. 0.7t]
    return {name: float(np.clip(
        global_target * (1.3 - 0.6 * rank / max(1, n_l - 1)), 0.0, 0.95))
        for rank, name in enumerate(order)}


def channel_prune_masks(params, cfg, global_target: float = 0.4) -> dict:
    """Channel masks per block (True = keep), dependency-consistent across
    the expand / dw / project group."""
    scores = channel_group_scores(params, cfg)
    targets = layer_sparsity_targets(params, cfg, global_target)
    masks = {}
    for base, s in scores.items():
        n = s.shape[0]
        n_prune = int(n * targets[base])
        keep = np.ones(n, bool)
        if n_prune > 0:
            keep[np.argsort(s)[:n_prune]] = False
        masks[base] = torch.from_numpy(keep).to(params[base]["dw"]["w"].device)
    return masks


def apply_channel_masks(params, masks) -> dict:
    """Zero the pruned hidden channels consistently across the group (a new
    tree; untouched leaves are shared)."""
    params = dict(params)
    for base, keep in masks.items():
        blk = dict(params[base])
        k = keep.to(blk["dw"]["w"].dtype)
        for key in ("expand", "dw"):
            if key in blk:
                blk[key] = {**blk[key], "w": blk[key]["w"] * k}
        blk["project"] = {**blk["project"], "w": blk["project"]["w"] * k[:, None]}
        params[base] = blk
    return params


def pattern_prune_kernel(w) -> torch.Tensor:
    """w: [3,3,I,O] -> mask keeping the best 4-entry pattern per (i,o)."""
    flat = np.abs(_np(w)).reshape(9, -1)                       # [9, I*O]
    pat_sums = np.stack([flat[p].sum(0) for p in _PATTERNS])   # [P, I*O]
    best = pat_sums.argmax(0)                                  # [I*O]
    mask = np.zeros((9, flat.shape[1]), np.float32)
    for pi, p in enumerate(_PATTERNS):
        mask[np.ix_(p, np.where(best == pi)[0])] = 1.0
    return torch.from_numpy(mask.reshape(tuple(w.shape))).to(w.device, w.dtype)


def unstructured_prune(w, rate: float) -> torch.Tensor:
    """Mask keeping the entries of |w| at or above the rate-quantile."""
    a = np.abs(_np(w))
    k = int(a.size * rate)
    if k == 0:
        return torch.ones_like(w)
    thr = np.partition(a.ravel(), k)[k]
    return torch.from_numpy((a >= thr).astype(np.float32)).to(w.device, w.dtype)


def full_prune(params, cfg, channel_target: float = 0.4,
               pattern: bool = True, unstructured_rate: float = 0.5):
    """Channel + pattern pruning pipeline. Returns (pruned_params, report):
    conv_sparsity, params_before and params_after_nonzero over the
    inverted-residual convs."""
    pruned = apply_channel_masks(params, channel_prune_masks(
        params, cfg, channel_target))
    for base in _blocks(cfg):
        blk = dict(pruned[base])
        if pattern:
            w = blk["dw"]["w"]
            blk["dw"] = {**blk["dw"], "w": w * pattern_prune_kernel(w)}
        if unstructured_rate > 0:
            for key in ("expand", "project"):
                if key in blk:
                    w = blk[key]["w"]
                    blk[key] = {**blk[key], "w": w * unstructured_prune(
                        w, unstructured_rate)}
        pruned[base] = blk
    total = zeros = 0
    for name in pruned:
        if not name.startswith("b"):
            continue
        for sub in pruned[name].values():
            if isinstance(sub, dict) and "w" in sub:
                total += sub["w"].numel()
                zeros += int((sub["w"] == 0).sum())
    return pruned, {"conv_sparsity": zeros / max(total, 1),
                    "params_before": total,
                    "params_after_nonzero": total - zeros}


def conv_flops(cfg, img: int) -> float:
    """Analytic MAC count (x2) of MobileNetV2 at resolution img (for the
    paper's FLOP-reduction table); the reference's formula, which halves
    the resolution with floor division."""
    wm = cfg.width_mult
    flops = 0.0
    res = img // 2
    c_prev = _make_divisible(cfg.stem_channels * wm)
    flops += (img // 2) ** 2 * 9 * 3 * c_prev
    for t, c, n, s in cfg.inverted_residual_setting:
        c_out = _make_divisible(c * wm)
        for i in range(n):
            stride = s if i == 0 else 1
            hidden = c_prev * t
            out_res = res // stride
            if t != 1:
                flops += res ** 2 * c_prev * hidden
            flops += out_res ** 2 * 9 * hidden
            flops += out_res ** 2 * hidden * c_out
            res, c_prev = out_res, c_out
    c_head = _make_divisible(cfg.head_channels * max(1.0, wm))
    flops += res ** 2 * c_prev * c_head
    return 2.0 * flops

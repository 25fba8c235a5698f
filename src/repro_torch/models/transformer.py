"""Decoder-only LM, dense family (llama3 and its kin); the other families of
the reference package come with their slices.

Layout: layers are grouped into SEGMENTS of stacked params [steps, ...],
keyed as in the reference, so a parameter tree bridged from there means the
same model here. A segment runs as a Python loop over its stacked layers.

Training params arrive as a (frozen, trainable) pair of same-structure trees
(split along the stacked-layer axis by the sparse-update plan). The frozen
prefix runs under `torch.no_grad()` unless something before it trains, so no
activation of it is kept for backward: the paper's activation-memory
saving. Trainable layers are recomputed in backward (`torch.utils.checkpoint`,
non-reentrant) when `remat` is on, as the reference's `jax.checkpoint`.

`sel` carries the channel-block selection (see core.sparse_update).
"""
from __future__ import annotations

import zlib
from typing import Any, NamedTuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.sparse_update import tree_leaves, tree_map
from repro_torch.models import layers as L
from repro_torch.models.common import dense_init, embed_init

CE_CHUNK = 1024

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def dtype_of(cfg) -> torch.dtype:
    return _DTYPES[cfg.dtype]


class SegmentDef(NamedTuple):
    name: str
    steps: int          # stacked layers


# ---------------------------------------------------------------------------
# layout
# ---------------------------------------------------------------------------

def segment_layout(cfg: ModelConfig) -> list[SegmentDef]:
    """One segment of stacked dense blocks. The reference's other layouts
    (MoE, local:global, hybrid and RWKV super-blocks) come with their
    slices."""
    if (cfg.family not in ("dense", "audio", "vlm") or cfg.moe is not None
            or cfg.attn_pattern != "full" or cfg.embed_inputs):
        raise NotImplementedError(
            f"{cfg.name}: the port runs the dense family so far (family "
            f"{cfg.family}, attn_pattern {cfg.attn_pattern})")
    return [SegmentDef("blocks", cfg.num_layers)]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_dense_block(gen, cfg, dtype, device, d_ff=None):
    return {
        "attn_ln": L.init_norm(cfg.d_model, cfg.norm_kind, dtype, device),
        "attn": L.init_attention(gen, cfg, dtype, device),
        "mlp_ln": L.init_norm(cfg.d_model, cfg.norm_kind, dtype, device),
        "mlp": L.init_mlp(gen, cfg, dtype, d_ff=d_ff, device=device),
    }


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> dict:
    """Random params from `seed`, drawn on `device` from one generator per
    segment plus one for the embedding and head. `device="meta"` gives
    shapes and dtypes without allocating. Layers are written into their
    stacked [steps, ...] tensors one at a time, so the peak is the stack
    plus one layer."""
    dtype = dtype_of(cfg)
    segs = segment_layout(cfg)
    device = torch.device(device)
    meta = device.type == "meta"

    def generator(salt: int):
        if meta:
            return None
        return torch.Generator(device=device).manual_seed(
            (seed * 1_000_003 + salt) % 2**63)

    params: dict[str, Any] = {"segments": {}}
    g = generator(0)
    params["embed"] = {"tok": embed_init(g, (cfg.vocab_size, cfg.d_model),
                                         dtype, device)}
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w": dense_init(g, (cfg.d_model, cfg.vocab_size),
                                             dtype=dtype, device=device)}
    for seg in segs:
        g = generator(zlib.crc32(seg.name.encode()))
        stack = None
        for i in range(seg.steps):
            block = _init_dense_block(g, cfg, dtype, device)
            if stack is None:
                stack = tree_map(lambda a: torch.empty(
                    (seg.steps,) + tuple(a.shape), dtype=a.dtype,
                    device=device), block)
            if not meta:
                tree_map(lambda dst, src: dst[i].copy_(src), stack, block)
        params["segments"][seg.name] = stack
    params["final_norm"] = L.init_norm(cfg.d_model, cfg.norm_kind, dtype,
                                       device)
    return params


# ---------------------------------------------------------------------------
# block application
# ---------------------------------------------------------------------------

def _sub_sel(sel, name):
    """Subset a selection tuple — (idx, spec) or (idx, spec, wsel) — to one
    child subtree."""
    if sel is None:
        return None
    idx = sel[0]
    if idx is None or name not in idx:
        return None
    return tuple(comp[name] for comp in sel)


def _apply_dense_block(cfg, p, x, positions, sel):
    h = L.apply_norm(p["attn_ln"], x)
    x = x + L.attention(p["attn"], cfg, h, positions,
                        sel=_sub_sel(sel, "attn"))
    h = L.apply_norm(p["mlp_ln"], x)
    return x + L.apply_mlp(p["mlp"], cfg, h, sel=_sub_sel(sel, "mlp"))


def _unstack(tree, steps: int) -> list:
    """Stacked tree [steps, ...] -> list of per-layer trees (views)."""
    if tree is None:
        return [None] * steps
    unbound = tree_map(lambda a: a.unbind(0), tree)
    return [tree_map(lambda u: u[i], unbound) for i in range(steps)]


def _run_segment(cfg, stack, x, positions, sel_idx, sel_spec,
                 remat: bool = True, sel_wsel=None):
    """Run a segment's layers in order. sel_idx: stacked [steps, ...] idx
    tree or None; sel_wsel: stacked compact selected-block tree (compact
    path) or None."""
    if stack is None:
        return x
    steps = tree_leaves(stack)[0].shape[0]
    layers = _unstack(stack, steps)
    idxs = _unstack(sel_idx, steps)
    wsels = _unstack(sel_wsel, steps)
    for p_l, idx_l, wsel_l in zip(layers, idxs, wsels):
        if idx_l is None:
            sel = None
        elif wsel_l is None:
            sel = (idx_l, sel_spec)
        else:
            sel = (idx_l, sel_spec, wsel_l)
        if remat and torch.is_grad_enabled():
            x = checkpoint(_apply_dense_block, cfg, p_l, x, positions, sel,
                           use_reentrant=False)
        else:
            x = _apply_dense_block(cfg, p_l, x, positions, sel)
    return x


# ---------------------------------------------------------------------------
# forward / loss
# ---------------------------------------------------------------------------

def _pick(a, b, *path):
    """Fetch a subtree preferring the trainable tree."""
    for tree in (b, a):
        if tree is None:
            continue
        node = tree
        ok = True
        for key in path:
            if node is None or key not in node:
                ok = False
                break
            node = node[key]
        if ok and node is not None:
            return node
    return None


def forward(cfg, params_pair, batch, sel=None, remat: bool = True):
    """params_pair = (frozen_tree, trainable_tree); either may be None.
    batch: {"tokens" [B,S], optional "positions"}. Returns hidden [B,S,d]."""
    frozen, trainable = params_pair
    emb = _pick(frozen, trainable, "embed", "tok")
    x = F.embedding(batch["tokens"].long(), emb)
    b, s = x.shape[0], x.shape[1]
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(s, device=x.device).expand(b, s)

    for seg in segment_layout(cfg):
        f_stack = _pick(frozen, None, "segments", seg.name)
        t_stack = _pick(trainable, None, "segments", seg.name)
        sel_idx = sel_spec = sel_wsel = None
        if sel is not None and seg.name in sel[0]:
            sel_idx, sel_spec = sel[0][seg.name], sel[1][seg.name]
            if len(sel) > 2 and sel[2] is not None:
                sel_wsel = sel[2].get(seg.name)
        # the frozen prefix keeps no activations unless a gradient must
        # flow through it (a trainable embedding)
        with torch.set_grad_enabled(torch.is_grad_enabled()
                                    and x.requires_grad):
            x = _run_segment(cfg, f_stack, x, positions, None,
                             None, remat)
        x = _run_segment(cfg, t_stack, x, positions, sel_idx,
                         sel_spec, remat, sel_wsel=sel_wsel)
    return L.apply_norm(_pick(frozen, trainable, "final_norm"), x)


def lm_head_weight(cfg, params_pair):
    frozen, trainable = params_pair
    if cfg.tie_embeddings:
        return _pick(frozen, trainable, "embed", "tok").t()
    return _pick(frozen, trainable, "lm_head", "w")


def _ce_chunk(h, w_head, y):
    # fp32 logits, as the reference's preferred_element_type=float32: bf16
    # products are exact in fp32, so upcasting first gives the same sums
    logits = torch.matmul(h.float(), w_head.float())
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, y[..., None].long())[..., 0]
    return torch.sum(lse - gold)


def chunked_cross_entropy(hidden, w_head, labels, chunk: int = CE_CHUNK):
    """Per-token CE without keeping [B,S,V] logits for backward: sequence
    chunks, each recomputed in backward. Returns (sum_loss, token_count)."""
    b, s, _ = hidden.shape
    c = min(chunk, s)
    assert s % c == 0
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(s // c):
        h, y = hidden[:, i * c:(i + 1) * c], labels[:, i * c:(i + 1) * c]
        if torch.is_grad_enabled():
            total = total + checkpoint(_ce_chunk, h, w_head, y,
                                       use_reentrant=False)
        else:
            total = total + _ce_chunk(h, w_head, y)
    return total, b * s


def loss_fn(cfg, params_pair, batch, sel=None, remat: bool = True):
    """Mean next-token CE. Returns (loss, metrics). The dense family has no
    auxiliary losses; the metric keys match the reference's."""
    hidden = forward(cfg, params_pair, batch, sel=sel, remat=remat)
    w_head = lm_head_weight(cfg, params_pair)
    total, count = chunked_cross_entropy(hidden, w_head, batch["labels"])
    ce = total / count
    zero = torch.zeros((), dtype=torch.float32, device=ce.device)
    return ce, {"ce": ce, "load_balance": zero, "router_z": zero}

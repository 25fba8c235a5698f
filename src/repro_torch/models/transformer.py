"""Decoder-only LM: the dense family (llama3 and its kin) and the MoE family
(deepseek-moe: a dense first layer, then MoE layers); the other families
of the reference package come with their slices.

Layout: layers are grouped into SEGMENTS of stacked params [steps, ...],
keyed as in the reference, so a parameter tree bridged from there means the
same model here. A segment runs as a Python loop over its stacked layers,
carrying the MoE layers' auxiliary losses [load_balance, router_z] beside
the hidden state.

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
from repro_torch.models import moe as MOE
from repro_torch.models.common import dense_init, embed_init

CE_CHUNK = 1024
# weights of the MoE load-balance and router z-losses in the loss (the
# reference's defaults)
AUX_WEIGHT = 0.01
Z_WEIGHT = 1e-3

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def dtype_of(cfg) -> torch.dtype:
    return _DTYPES[cfg.dtype]


class SegmentDef(NamedTuple):
    name: str
    steps: int          # stacked layers
    kind: str           # dense | moe


# ---------------------------------------------------------------------------
# layout
# ---------------------------------------------------------------------------

def segment_layout(cfg: ModelConfig) -> list[SegmentDef]:
    """Stacked dense blocks; for MoE, a dense `first` layer (layout
    all_but_first) and the MoE `blocks`. The reference's other layouts
    (local:global, hybrid and RWKV super-blocks) come with their slices."""
    moe = cfg.family == "moe" and cfg.moe is not None
    if ((cfg.family not in ("dense", "audio", "vlm") and not moe)
            or cfg.attn_pattern != "full" or cfg.embed_inputs
            or (moe and cfg.moe.layout not in ("all", "all_but_first"))):
        raise NotImplementedError(
            f"{cfg.name}: the port runs the dense and MoE families so far "
            f"(family {cfg.family}, attn_pattern {cfg.attn_pattern})")
    if moe and cfg.moe.layout == "all_but_first":
        return [SegmentDef("first", 1, "dense"),
                SegmentDef("blocks", cfg.num_layers - 1, "moe")]
    if moe:
        return [SegmentDef("blocks", cfg.num_layers, "moe")]
    return [SegmentDef("blocks", cfg.num_layers, "dense")]


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


def _init_moe_block(gen, cfg, dtype, device):
    return {
        "attn_ln": L.init_norm(cfg.d_model, cfg.norm_kind, dtype, device),
        "attn": L.init_attention(gen, cfg, dtype, device),
        "mlp_ln": L.init_norm(cfg.d_model, cfg.norm_kind, dtype, device),
        "moe": MOE.init_moe(gen, cfg, dtype, device),
    }


def _dense_ff_first(cfg) -> int:
    # deepseek-style dense first layer: ~ (n_routed_active+shared) * d_ff
    return 8 * cfg.d_ff


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
            if seg.kind == "moe":
                block = _init_moe_block(g, cfg, dtype, device)
            else:
                block = _init_dense_block(
                    g, cfg, dtype, device,
                    d_ff=_dense_ff_first(cfg) if seg.name == "first"
                    else None)
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
    """-> (x, None): a dense layer has no auxiliary losses."""
    h = L.apply_norm(p["attn_ln"], x)
    x = x + L.attention(p["attn"], cfg, h, positions,
                        sel=_sub_sel(sel, "attn"))
    h = L.apply_norm(p["mlp_ln"], x)
    return x + L.apply_mlp(p["mlp"], cfg, h, sel=_sub_sel(sel, "mlp")), None


def _apply_moe_block(cfg, p, x, positions, sel):
    """-> (x, [load_balance, router_z])."""
    h = L.apply_norm(p["attn_ln"], x)
    x = x + L.attention(p["attn"], cfg, h, positions,
                        sel=_sub_sel(sel, "attn"))
    h = L.apply_norm(p["mlp_ln"], x)
    y, aux = MOE.apply_moe(p["moe"], cfg, h, sel=_sub_sel(sel, "moe"))
    return x + y, torch.stack([aux["load_balance"], aux["router_z"]])


_APPLY = {"dense": _apply_dense_block, "moe": _apply_moe_block}


def _unstack(tree, steps: int) -> list:
    """Stacked tree [steps, ...] -> list of per-layer trees (views)."""
    if tree is None:
        return [None] * steps
    unbound = tree_map(lambda a: a.unbind(0), tree)
    return [tree_map(lambda u: u[i], unbound) for i in range(steps)]


def _run_segment(cfg, kind: str, stack, x, positions, sel_idx, sel_spec,
                 remat: bool = True, sel_wsel=None):
    """Run a segment's layers in order. sel_idx: stacked [steps, ...] idx
    tree or None; sel_wsel: stacked compact selected-block tree (compact
    path) or None. Returns (x, aux): aux the sum of the layers' [2]
    auxiliary losses, None where no layer has any."""
    aux = None
    if stack is None:
        return x, aux
    apply = _APPLY[kind]
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
            x, a = checkpoint(apply, cfg, p_l, x, positions, sel,
                              use_reentrant=False)
        else:
            x, a = apply(cfg, p_l, x, positions, sel)
        if a is not None:
            aux = a if aux is None else aux + a
    return x, aux


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
    batch: {"tokens" [B,S], optional "positions"}. Returns (hidden [B,S,d],
    aux [2] fp32: load_balance and router_z summed over the MoE layers,
    zeros for the dense family)."""
    frozen, trainable = params_pair
    emb = _pick(frozen, trainable, "embed", "tok")
    x = F.embedding(batch["tokens"].long(), emb)
    b, s = x.shape[0], x.shape[1]
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(s, device=x.device).expand(b, s)

    aux = torch.zeros((2,), dtype=torch.float32, device=x.device)
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
            x, a1 = _run_segment(cfg, seg.kind, f_stack, x, positions, None,
                                 None, remat)
        x, a2 = _run_segment(cfg, seg.kind, t_stack, x, positions, sel_idx,
                             sel_spec, remat, sel_wsel=sel_wsel)
        for a in (a1, a2):
            if a is not None:
                aux = aux + a
    return L.apply_norm(_pick(frozen, trainable, "final_norm"), x), aux


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
    """Mean next-token CE plus the MoE auxiliary losses (zero for the dense
    family, which then leaves the CE bitwise as it is). Returns (loss,
    metrics) with the reference's metric keys."""
    hidden, aux = forward(cfg, params_pair, batch, sel=sel, remat=remat)
    w_head = lm_head_weight(cfg, params_pair)
    total, count = chunked_cross_entropy(hidden, w_head, batch["labels"])
    ce = total / count
    loss = ce + AUX_WEIGHT * aux[0] + Z_WEIGHT * aux[1]
    return loss, {"ce": ce, "load_balance": aux[0], "router_z": aux[1]}

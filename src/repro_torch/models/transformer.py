"""Decoder-only LM: the dense family (llama3 and its kin), gemma3's
local:global super-blocks, the MoE family (deepseek-moe: a dense first
layer, then MoE layers), jamba's hybrid mamba + attention + MoE
super-blocks, RWKV-6 (rwkv6: time mix + channel mix blocks behind a
layernorm `ln0` on the embedding) and the audio / vlm archs (musicgen,
qwen2-vl: dense layers fed embeddings from a stub frontend; qwen2-vl
rotates with M-RoPE).

Layout: layers are grouped into SEGMENTS of stacked params [steps, ...],
keyed as in the reference, so a parameter tree bridged from there means the
same model here. Heterogeneous periods (gemma 5:1, jamba 1:7) stack
*super-blocks*, whose step runs the period's layers (`sub{i}`) in order. A
segment runs as a Python loop over its stacked steps, carrying the MoE
layers' auxiliary losses [load_balance, router_z] beside the hidden state.

Training params arrive as a (frozen, trainable) pair of same-structure trees
(split along the stacked-step axis by the sparse-update plan). The frozen
prefix runs under `torch.no_grad()` unless something before it trains, so no
activation of it is kept for backward: the paper's activation-memory
saving. Trainable steps are recomputed in backward (`torch.utils.checkpoint`,
non-reentrant) when `remat` is on, as the reference's `jax.checkpoint`.

`sel` carries the channel-block selection (see core.sparse_update).

On a rank of a process mesh (`sharding.use_rules` with a `launch.mesh`
mesh, `mapped_model_axis`), the params are the rank's shards
(`init_params(..., rules=)`, or `launch.specs.shard_local`): attention,
the MLPs and the experts run tensor- / expert-parallel (layers, moe),
rwkv's channel mix on d_ff and mamba on d_inner (rwkv's time mix stays
whole: rwkv6, mamba), the token table and the LM head vocab-parallel
(`vocab_parallel_gather`,
`_ce_chunk_vocab_parallel`), and the batch is the rank's data shard. The
loss then divides by the GLOBAL token count, so the data ranks' losses and
gradients sum to the single-device ones (the train step all-reduces them).
"""
from __future__ import annotations

import functools
import zlib
from typing import Any, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import sharding as SH
from repro_torch.configs.base import ModelConfig
from repro_torch.core.sparse_update import tree_leaves, tree_map
from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models import moe as MOE
from repro_torch.models import rwkv6 as R
from repro_torch.models.common import (dense_init, embed_init,
                                       vocab_parallel_gather)

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
    steps: int          # stacked steps
    kind: str           # dense | moe | gemma_super | jamba_super | rwkv
    layers_per_step: int = 1


# ---------------------------------------------------------------------------
# layout
# ---------------------------------------------------------------------------

def segment_layout(cfg: ModelConfig) -> list[SegmentDef]:
    """The reference's layout: RWKV-6 blocks; jamba super-blocks of
    `attn_every` layers; gemma super-blocks of L local + G global layers
    and a `tail` of local dense layers; for MoE a dense `first` layer
    (layout all_but_first) and the MoE `blocks`; else dense blocks (the
    audio and vlm archs too: they differ in their inputs, not their
    layers)."""
    if cfg.family == "ssm":
        return [SegmentDef("blocks", cfg.num_layers, "rwkv")]
    if cfg.family == "hybrid":
        if cfg.attn_every <= 0 or cfg.num_layers % cfg.attn_every:
            raise ValueError(f"{cfg.name}: {cfg.num_layers} layers are not "
                             f"whole super-blocks of {cfg.attn_every}")
        return [SegmentDef("blocks", cfg.num_layers // cfg.attn_every,
                           "jamba_super", cfg.attn_every)]
    if cfg.attn_pattern.startswith("local_global"):
        _, l, g = cfg.attn_pattern.split(":")
        period = int(l) + int(g)
        n_super = cfg.num_layers // period
        tail = cfg.num_layers - n_super * period
        segs = [SegmentDef("blocks", n_super, "gemma_super", period)]
        if tail:
            segs.append(SegmentDef("tail", tail, "dense"))
        return segs
    if cfg.moe is not None and cfg.moe.layout == "all_but_first":
        return [SegmentDef("first", 1, "dense"),
                SegmentDef("blocks", cfg.num_layers - 1, "moe")]
    if cfg.moe is not None:
        return [SegmentDef("blocks", cfg.num_layers, "moe")]
    return [SegmentDef("blocks", cfg.num_layers, "dense")]


def _moe_at(cfg, layer_in_period: int) -> bool:
    """For jamba: is the FFN at this in-block index MoE?"""
    if cfg.moe is None:
        return False
    if cfg.moe.layout == "every_2":
        return layer_in_period % 2 == 1
    return True


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


def _init_gemma_super(gen, cfg, dtype, device, period: int):
    return {f"sub{i}": _init_dense_block(gen, cfg, dtype, device)
            for i in range(period)}


def _init_jamba_super(gen, cfg, dtype, device):
    """One super-block: `attn_every` sub-layers; index attn_every // 2 is
    attention, the rest mamba; the FFN alternates dense / MoE."""
    out = {}
    period = cfg.attn_every
    attn_pos = period // 2
    for i in range(period):
        sub = {"mixer_ln": L.init_norm(cfg.d_model, cfg.norm_kind, dtype,
                                       device),
               "ffn_ln": L.init_norm(cfg.d_model, cfg.norm_kind, dtype,
                                     device)}
        if i == attn_pos:
            sub["attn"] = L.init_attention(gen, cfg, dtype, device)
        else:
            sub["mamba"] = M.init_mamba(gen, cfg, dtype, device)
        if _moe_at(cfg, i):
            sub["moe"] = MOE.init_moe(gen, cfg, dtype, device)
        else:
            sub["mlp"] = L.init_mlp(gen, cfg, dtype, device=device)
        out[f"sub{i}"] = sub
    return out


def _init_rwkv_block(gen, cfg, dtype, device):
    return {
        "time_ln": L.init_norm(cfg.d_model, "layernorm", dtype, device),
        "time": R.init_time_mix(gen, cfg, dtype, device),
        "chan_ln": L.init_norm(cfg.d_model, "layernorm", dtype, device),
        "chan": R.init_channel_mix(gen, cfg, dtype, device),
    }


def _dense_ff_first(cfg) -> int:
    # deepseek-style dense first layer: ~ (n_routed_active+shared) * d_ff
    return 8 * cfg.d_ff


def _shard_cutter(rules):
    """cut(path, t): the rank's slice of the full leaf `t` at `path`
    under `rules` (a copy where it is a slice, so the full draw is freed),
    or `t` itself with no rules."""
    if rules is None:
        return lambda path, t: t
    from repro_torch.launch.specs import resolve_pspec, shard_leaf
    from repro_torch.models.specs import spec_of
    mesh = rules.mesh

    def cut(path, t):
        sharding = resolve_pspec(tuple(t.shape), spec_of(path, t.dim()),
                                 rules)
        local = shard_leaf(t, sharding, mesh.shape, mesh.coords)
        return local if local.shape == t.shape else local.clone()
    return cut


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda",
                rules=None) -> dict:
    """Random params from `seed`, drawn on `device` from one generator per
    segment plus one for the embedding and head. `device="meta"` gives
    shapes and dtypes without allocating. Layers are written into their
    stacked [steps, ...] tensors one at a time, so the peak is the stack
    plus one layer.

    rules: a process mesh's `AxisRules`: every leaf is drawn whole, in the
    same order, and only this rank's slice kept (`launch.specs`), so the
    ranks together hold the numbers one process draws, while none holds
    the whole model at once (peak: the rank's stacks plus one whole
    layer)."""
    dtype = dtype_of(cfg)
    segs = segment_layout(cfg)
    device = torch.device(device)
    meta = device.type == "meta"
    cut = _shard_cutter(rules)

    def generator(salt: int):
        if meta:
            return None
        return torch.Generator(device=device).manual_seed(
            (seed * 1_000_003 + salt) % 2**63)

    params: dict[str, Any] = {"segments": {}}
    g = generator(0)
    # an embedding-input arch has no token table unless its head is tied
    if not cfg.embed_inputs or cfg.tie_embeddings:
        params["embed"] = {"tok": cut(("embed", "tok"), embed_init(
            g, (cfg.vocab_size, cfg.d_model), dtype, device))}
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w": cut(("lm_head", "w"), dense_init(
            g, (cfg.d_model, cfg.vocab_size), dtype=dtype, device=device))}
    if cfg.family == "ssm":
        params["ln0"] = L.init_norm(cfg.d_model, "layernorm", dtype, device)
    for seg in segs:
        g = generator(zlib.crc32(seg.name.encode()))
        stack = None
        for i in range(seg.steps):
            if seg.kind == "moe":
                block = _init_moe_block(g, cfg, dtype, device)
            elif seg.kind == "gemma_super":
                block = _init_gemma_super(g, cfg, dtype, device,
                                          seg.layers_per_step)
            elif seg.kind == "jamba_super":
                block = _init_jamba_super(g, cfg, dtype, device)
            elif seg.kind == "rwkv":
                block = _init_rwkv_block(g, cfg, dtype, device)
            else:
                block = _init_dense_block(
                    g, cfg, dtype, device,
                    d_ff=_dense_ff_first(cfg) if seg.name == "first"
                    else None)
            # each leaf stacked, then cut to the rank's slice
            block = _cut_block(cut, ("segments", seg.name), block)
            if stack is None:
                stack = tree_map(lambda a: torch.empty(
                    (seg.steps,) + tuple(a.shape[1:]), dtype=a.dtype,
                    device=device), block)
            if not meta:
                tree_map(lambda dst, src: dst[i].copy_(src[0]), stack, block)
        params["segments"][seg.name] = stack
    params["final_norm"] = L.init_norm(
        cfg.d_model, "layernorm" if cfg.family == "ssm" else cfg.norm_kind,
        dtype, device)
    return params


def _cut_block(cut, path: tuple, block):
    """One layer's tree -> its leaves as [1, ...] stacks cut to the rank's
    slices (the stacked leaf's logical axes, layers leading)."""
    if isinstance(block, dict):
        return {k: _cut_block(cut, path + (k,), v) for k, v in block.items()}
    return cut(path, block[None])


# ---------------------------------------------------------------------------
# block application
# ---------------------------------------------------------------------------

def _window_for(cfg, kind: str, sub: int) -> int:
    """The attention window of a layer: gemma's local layers (the first L
    of a super-block, and the tail) see `sliding_window` tokens, every
    other layer the whole sequence (0)."""
    if kind == "gemma_super":
        _, l, _g = cfg.attn_pattern.split(":")
        return cfg.sliding_window if sub < int(l) else 0
    if kind == "dense" and cfg.attn_pattern.startswith("local_global"):
        return cfg.sliding_window   # gemma tail layers are local
    return 0


def _sub_sel(sel, name):
    """Subset a selection tuple — (idx, spec) or (idx, spec, wsel) — to one
    child subtree."""
    if sel is None:
        return None
    idx = sel[0]
    if idx is None or name not in idx:
        return None
    return tuple(comp[name] for comp in sel)


def _apply_dense_block(cfg, p, x, positions, sel, window: int = 0,
                       d_ff=None):
    """-> (x, None): a dense layer has no auxiliary losses."""
    h = L.apply_norm(p["attn_ln"], x)
    x = x + L.attention(p["attn"], cfg, h, positions, window=window,
                        sel=_sub_sel(sel, "attn"))
    h = L.apply_norm(p["mlp_ln"], x)
    return x + L.apply_mlp(p["mlp"], cfg, h, sel=_sub_sel(sel, "mlp"),
                           d_ff=d_ff), None


def _apply_dense_step(cfg, p, x, positions, sel, d_ff=None):
    return _apply_dense_block(cfg, p, x, positions, sel,
                              _window_for(cfg, "dense", 0), d_ff)


def _apply_moe_block(cfg, p, x, positions, sel):
    """-> (x, [load_balance, router_z])."""
    h = L.apply_norm(p["attn_ln"], x)
    x = x + L.attention(p["attn"], cfg, h, positions,
                        sel=_sub_sel(sel, "attn"))
    h = L.apply_norm(p["mlp_ln"], x)
    y, aux = MOE.apply_moe(p["moe"], cfg, h, sel=_sub_sel(sel, "moe"))
    return x + y, torch.stack([aux["load_balance"], aux["router_z"]])


def _apply_gemma_super(cfg, p, x, positions, sel):
    """The period's dense layers in order, local then global -> (x,
    None)."""
    for i in range(len(p)):
        x, _ = _apply_dense_block(cfg, p[f"sub{i}"], x, positions,
                                  _sub_sel(sel, f"sub{i}"),
                                  _window_for(cfg, "gemma_super", i))
    return x, None


def _apply_jamba_super(cfg, p, x, positions, sel):
    """The period's sub-layers in order: a mixer (attention at index
    attn_every // 2, mamba elsewhere) and an FFN (MoE at the odd indices,
    dense elsewhere) -> (x, the MoE layers' [load_balance, router_z]
    summed)."""
    period = cfg.attn_every
    attn_pos = period // 2
    aux = None
    for i in range(period):
        sub = p[f"sub{i}"]
        ssel = _sub_sel(sel, f"sub{i}")
        h = L.apply_norm(sub["mixer_ln"], x)
        if i == attn_pos:
            x = x + L.attention(sub["attn"], cfg, h, positions,
                                sel=_sub_sel(ssel, "attn"))
        else:
            y, _ = M.apply_mamba(sub["mamba"], cfg, h,
                                 sel=_sub_sel(ssel, "mamba"))
            x = x + y
        h = L.apply_norm(sub["ffn_ln"], x)
        if _moe_at(cfg, i):
            y, a = MOE.apply_moe(sub["moe"], cfg, h,
                                 sel=_sub_sel(ssel, "moe"))
            a = torch.stack([a["load_balance"], a["router_z"]])
            aux = a if aux is None else aux + a
        else:
            y = L.apply_mlp(sub["mlp"], cfg, h, sel=_sub_sel(ssel, "mlp"))
        x = x + y
    return x, aux


def _apply_rwkv_block(cfg, p, x, positions, sel):
    """-> (x, None): no auxiliary losses, no positions (the recurrence
    orders the tokens)."""
    h = L.apply_norm(p["time_ln"], x)
    y, _ = R.apply_time_mix(p["time"], cfg, h, sel=_sub_sel(sel, "time"))
    x = x + y
    h = L.apply_norm(p["chan_ln"], x)
    y, _ = R.apply_channel_mix(p["chan"], cfg, h, sel=_sub_sel(sel, "chan"))
    return x + y, None


_APPLY = {"dense": _apply_dense_step, "moe": _apply_moe_block,
          "gemma_super": _apply_gemma_super,
          "jamba_super": _apply_jamba_super, "rwkv": _apply_rwkv_block}


def _unstack(tree, steps: int) -> list:
    """Stacked tree [steps, ...] -> list of per-layer trees (views)."""
    if tree is None:
        return [None] * steps
    unbound = tree_map(lambda a: a.unbind(0), tree)
    return [tree_map(lambda u: u[i], unbound) for i in range(steps)]


def _run_segment(cfg, kind: str, stack, x, positions, sel_idx, sel_spec,
                 remat: bool = True, sel_wsel=None, d_ff=None):
    """Run a segment's layers in order. sel_idx: stacked [steps, ...] idx
    tree or None; sel_wsel: stacked compact selected-block tree (compact
    path) or None; d_ff: the full MLP width of a dense segment whose MLPs
    are wider than cfg.d_ff (deepseek's first layer). Returns (x, aux): aux
    the sum of the layers' [2] auxiliary losses, None where no layer has
    any."""
    aux = None
    if stack is None:
        return x, aux
    apply = _APPLY[kind]
    if d_ff is not None:
        apply = functools.partial(apply, d_ff=d_ff)
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


def embed_tokens(cfg, params_pair, batch):
    """The layer stack's input [B, S, d]: `batch["embeds"]` for an
    embedding-input arch (the stub frontends of musicgen and qwen2-vl),
    cast to the model's dtype; else the token table's rows of
    `batch["tokens"]`. RWKV-6 adds its `ln0`. The reference feeds fp32
    embeds to a bf16 model unchanged, and its activations then stay fp32;
    the port computes in the model's dtype, as it does for tokens."""
    frozen, trainable = params_pair
    if cfg.embed_inputs:
        x = batch["embeds"].to(dtype_of(cfg))
    else:
        emb = _pick(frozen, trainable, "embed", "tok")
        x = vocab_parallel_gather(emb, batch["tokens"], cfg.vocab_size)
    if cfg.family == "ssm":
        x = L.apply_norm(_pick(frozen, trainable, "ln0"), x)
    return x


def forward(cfg, params_pair, batch, sel=None, remat: bool = True):
    """params_pair = (frozen_tree, trainable_tree); either may be None.
    batch: {"tokens" [B,S] | "embeds" [B,S,d], optional "positions" [B,S]
    ([3,B,S] for M-RoPE, which has no default)}. Returns (hidden [B,S,d],
    aux [2] fp32: load_balance and router_z summed over the MoE layers,
    zeros for the dense family)."""
    frozen, trainable = params_pair
    x = embed_tokens(cfg, params_pair, batch)
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
        d_ff = _dense_ff_first(cfg) if seg.name == "first" else None
        with torch.set_grad_enabled(torch.is_grad_enabled()
                                    and x.requires_grad):
            x, a1 = _run_segment(cfg, seg.kind, f_stack, x, positions, None,
                                 None, remat, d_ff=d_ff)
        x, a2 = _run_segment(cfg, seg.kind, t_stack, x, positions, sel_idx,
                             sel_spec, remat, sel_wsel=sel_wsel, d_ff=d_ff)
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


def _ce_chunk_vocab_parallel(h, w_head, y, offset: int):
    """`_ce_chunk` on the rank's vocab shard [d, V / n] (global ids
    offset .. offset + V / n - 1): the row max, the sum of exponentials and
    the gold logit (from the rank that owns it; zero elsewhere) are
    combined over the model group. Inside `torch.utils.checkpoint` the
    backward's recomputation issues the same collectives again, in the
    same order on every rank."""
    logits = torch.matmul(h.float(), w_head.float())
    with torch.no_grad():
        m = SH.pmax_mapped_(logits.amax(dim=-1))
    sumexp = SH.psum_mapped(torch.exp(logits - m[..., None]).sum(dim=-1),
                            "ce")
    lse = m + torch.log(sumexp)
    local = y.long() - offset
    own = (local >= 0) & (local < logits.shape[-1])
    gold = torch.gather(logits, -1, torch.where(own, local, 0)[..., None])
    gold = SH.psum_mapped(torch.where(own, gold[..., 0], 0.0), "ce")
    return torch.sum(lse - gold)


def chunked_cross_entropy(hidden, w_head, labels, chunk: int = CE_CHUNK,
                          vocab_size=None):
    """Per-token CE without keeping [B,S,V] logits for backward: sequence
    chunks, each recomputed in backward. Returns (sum_loss, token_count).
    A head narrower than `vocab_size` is the rank's vocab shard: the
    hidden state enters through `copy_to_model` (its gradient summed over
    the model group) and every chunk is vocab-parallel."""
    b, s, _ = hidden.shape
    c = min(chunk, s)
    assert s % c == 0
    fn = _ce_chunk
    if vocab_size is not None and w_head.shape[-1] != vocab_size:
        SH.require_model_group("the LM head")
        hidden = SH.copy_to_model(hidden)
        fn = functools.partial(_ce_chunk_vocab_parallel,
                               offset=SH.model_index() * w_head.shape[-1])
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(s // c):
        h, y = hidden[:, i * c:(i + 1) * c], labels[:, i * c:(i + 1) * c]
        if torch.is_grad_enabled():
            total = total + checkpoint(fn, h, w_head, y,
                                       use_reentrant=False)
        else:
            total = total + fn(h, w_head, y)
    return total, b * s


def loss_fn(cfg, params_pair, batch, sel=None, remat: bool = True):
    """Mean next-token CE plus the MoE auxiliary losses (zero for the dense
    family, which then leaves the CE bitwise as it is). Returns (loss,
    metrics) with the reference's metric keys.

    On a mesh with n data shards the batch is this rank's shard and the
    mean is over the GLOBAL token count (the MoE losses are shares of
    the global ones too, `moe.apply_moe`): loss and metrics are this
    shard's shares, and their sums over the data group are the
    single-device values."""
    hidden, aux = forward(cfg, params_pair, batch, sel=sel, remat=remat)
    w_head = lm_head_weight(cfg, params_pair)
    total, count = chunked_cross_entropy(hidden, w_head, batch["labels"],
                                         vocab_size=cfg.vocab_size)
    ce = total / (count * SH.data_size())
    loss = ce + AUX_WEIGHT * aux[0] + Z_WEIGHT * aux[1]
    return loss, {"ce": ce, "load_balance": aux[0], "router_z": aux[1]}

"""Token-choice top-k MoE (deepseek style: routed plus shared experts).

The router picks each token's top-k experts in fp32; a capacity bound per
expert drops the overflow; the routed experts run as one batched product
over capacity-bounded buffers [E, C, d] (sort-based dispatch, no one-hot
dispatch tensors); the shared experts are a plain MLP every token takes.

Expert parallelism (a rank of a process mesh whose expert stacks arrived
split over the model axis, the reference's "local dispatch EP"): tokens
stay on their data shard, replicated over the model group; every rank
routes all of them, runs its E / n local experts on the choices they own
(capacity from the data shard's tokens), and one all-reduce over the
model group sums the partial outputs. The tokens and the routing weights
enter the experts through `copy_to_model`, so their gradients are summed
over the model group; the router and the auxiliary losses see the
replicated routing and are whole on every rank. Under data parallelism
the load-balance loss reads the expert counts of the global batch (an
all-reduce over the data group), and both auxiliary losses are this
shard's shares of the global ones.

The d_ff-parallel serve form (a rank of a serve mesh whose expert stacks
arrived with their hidden dim split, `decoding.paged_param_specs`): every
expert is resident, the router and the dispatch run whole on every rank,
each rank's combine holds the partial w_down products of its d_ff slice,
and one all-reduce over the model group sums them (the reference's form
inside its serve `shard_map`). Serving only: no gradient is defined.

Determinism. No two values are ever added into one place in an order the
card chooses (`index_add_`, `index_put_(accumulate=True)` and an index's
backward add with atomics, in an order that changes from run to run):

- dispatch: each (token, choice) writes its row into its own buffer slot
  with a plain `index_put` (no accumulate). The slots are distinct except
  the spare last row, which takes every dropped choice and is discarded, so
  the forward is well defined and the backward is a gather of the buffer's
  gradient. The token's row is repeated k times by expand + reshape, whose
  backward sums the k choices with a reduction, not atomics.
- combine: each (token, choice) gathers its expert's output row from its
  slot (the spare row reads zeros). Its backward (`_TakeRows`) writes each
  choice's gradient row into its slot: the slots are distinct but for the
  spare row, whose gradient is dropped, so nothing is added. (An index's
  own backward adds into a zero buffer, sorting the indices first: 5.5% of
  the device time of a full-width deepseek-moe-16b step on an H100.)
  The k weighted rows of a token are then summed in a fixed order:
  ascending expert index, which is the order the reference's scatter-add
  takes (its stable sort runs by expert), so bf16 rounds alike.
"""
from __future__ import annotations

import contextlib
import threading

import torch
import torch.nn.functional as F

from repro_torch import sharding as SH
from repro_torch.core.sparse_update import smm
from repro_torch.models import layers as L
from repro_torch.models.common import dense_init

_ROUTING = threading.local()


def init_moe(gen, cfg, dtype, device="cuda"):
    """Router [d, E] (fp32 in any model dtype), routed experts w_gate /
    w_up [E, d, ff] and w_down [E, ff, d], and the shared experts' MLP."""
    moe = cfg.moe
    d, ff, e = cfg.d_model, cfg.d_ff, moe.num_experts
    p = {
        "router": dense_init(gen, (d, e), dtype=torch.float32, device=device),
        "w_gate": dense_init(gen, (e, d, ff), in_axis=1, dtype=dtype,
                             device=device),
        "w_up": dense_init(gen, (e, d, ff), in_axis=1, dtype=dtype,
                           device=device),
        "w_down": dense_init(gen, (e, ff, d), in_axis=1, dtype=dtype,
                             device=device),
    }
    if moe.num_shared_experts:
        p["shared"] = L.init_mlp(gen, cfg, dtype,
                                 d_ff=moe.num_shared_experts * ff,
                                 device=device)
    return p


def _expert_ffn(p, buf, sel):
    """buf: [E, C, d] -> [E, C, d] (swiglu, as every MoE arch here)."""
    h = F.silu(smm(buf, p["w_gate"], sel, "w_gate"))
    h = h * smm(buf, p["w_up"], sel, "w_up")
    return smm(h, p["w_down"], sel, "w_down")


def _capacity(t: int, k: int, cf: float, e: int) -> int:
    c = int(t * k * cf / e) + 1
    return max(8, min(c, t * k))


def expert_counts(flat_ids, num_experts: int):
    """Choices per expert, int64 [E]. Not `bincount`: on the card that
    reads the largest id back to the host to size its output."""
    return torch.zeros(num_experts, dtype=torch.int64,
                       device=flat_ids.device).scatter_add_(
        0, flat_ids, torch.ones_like(flat_ids))


def dispatch_slots(ids, num_experts: int, capacity: int):
    """ids [T, k] (distinct experts per token) -> (slot [T, k], kept
    [T, k]): the buffer row of every choice, expert * capacity + its
    position among the expert's choices in token order, and whether it is
    under the capacity. Dropped choices get the spare row E * capacity. The
    reference's order: a stable sort by expert keeps token order within an
    expert, and the first `capacity` choices of each expert stay."""
    flat_e = ids.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    counts = expert_counts(flat_e, num_experts)
    starts = torch.cumsum(counts, 0) - counts
    se = flat_e[order]
    pos_sorted = torch.arange(flat_e.numel(), device=ids.device) - starts[se]
    pos = torch.empty_like(pos_sorted)
    pos[order] = pos_sorted          # a permutation: no index repeats
    kept = pos < capacity
    slot = torch.where(kept, flat_e * capacity + pos,
                       num_experts * capacity)
    return slot.reshape(ids.shape), kept.reshape(ids.shape)


class _TakeRows(torch.autograd.Function):
    """rows = table[slot], where `slot` names every row of `table` at most
    once, except the last (spare) row, which takes no gradient."""

    @staticmethod
    def forward(ctx, table, slot):
        ctx.save_for_backward(slot)
        ctx.rows = table.shape[0]
        return table[slot]

    @staticmethod
    def backward(ctx, g):
        (slot,) = ctx.saved_tensors
        out = g.new_zeros((ctx.rows,) + tuple(g.shape[1:]))
        out.index_put_((slot,), g)      # distinct slots: no accumulate
        out[-1] = 0
        return out, None


def _dispatch_combine(cfg, x_flat, ids, weights, wp, sel, capacity: int,
                      first: int = 0):
    """x_flat [T, d]; ids / weights [T, k]; wp: the routed expert weights,
    experts first .. first + E_loc - 1 of the config's E (all of them off
    a mesh). Returns (y [T, d]: the local experts' share of the output,
    kept [T, k]: whether the capacity kept each choice, on any expert)."""
    t, d = x_flat.shape
    k = ids.shape[1]
    e = cfg.moe.num_experts
    e_loc = wp["w_gate"].shape[0]
    # each token's choices in ascending expert order: the order of the sum
    # below (see the module doc)
    ids, perm = torch.sort(ids, dim=1)
    weights = torch.gather(weights, 1, perm)
    slot, kept = dispatch_slots(ids, e, capacity)
    own = kept
    if e_loc != e:
        # the choices this rank's experts take; the others go to the spare
        own = kept & (ids >= first) & (ids < first + e_loc)
        slot = torch.where(own, slot - first * capacity, e_loc * capacity)
    slot = slot.reshape(-1)

    rows = x_flat[:, None, :].expand(t, k, d).reshape(t * k, d)
    buf = x_flat.new_zeros((e_loc * capacity + 1, d)).index_put((slot,),
                                                                rows)
    h = _expert_ffn(wp, buf[:-1].reshape(e_loc, capacity, d), sel)

    h_pad = torch.cat([h.reshape(e_loc * capacity, d),
                       h.new_zeros((1, d))])
    gathered = _TakeRows.apply(h_pad, slot).reshape(t, k, d)
    w = torch.where(own, weights, 0.0).to(gathered.dtype)
    contrib = gathered * w[..., None]
    y = contrib[:, 0]
    for j in range(1, k):
        y = y + contrib[:, j]
    return y.to(x_flat.dtype), kept


def route(router, x_flat, k: int):
    """The router in fp32: x_flat [T, d] -> (logits, probs [T, E], weights
    [T, k] renormalised over the chosen experts, ids [T, k] int64, by
    descending probability)."""
    logits = x_flat.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    weights, ids = torch.topk(probs, k, dim=-1)
    weights = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-9)
    return logits, probs, weights, ids


@contextlib.contextmanager
def record_routing():
    """Within the block, every `apply_moe` call appends (dropped choices,
    routed choices) to the yielded list, the first as a 0-dim device
    tensor (no host sync). For reports: the share of choices the capacity
    dropped."""
    prev = getattr(_ROUTING, "sink", None)
    _ROUTING.sink = sink = []
    try:
        yield sink
    finally:
        _ROUTING.sink = prev


def apply_moe(p, cfg, x, sel=None):
    """x: [B, S, d] -> (y [B, S, d], aux_losses dict)."""
    moe = cfg.moe
    b, s, d = x.shape
    x_flat = x.reshape(-1, d)
    t = x_flat.shape[0]
    e, k = moe.num_experts, moe.top_k
    e_loc = p["w_gate"].shape[0]
    ff_split = p["w_gate"].shape[-1] != cfg.d_ff
    if ff_split:
        SH.require_model_group("the experts' hidden dim")
        if e_loc != e or p["w_gate"].shape[-1] * SH.model_axis_size() \
                != cfg.d_ff:
            raise ValueError(
                f"expert weights {tuple(p['w_gate'].shape)}: the d_ff-"
                f"parallel form keeps all {e} experts and splits d_ff "
                f"{cfg.d_ff} over {SH.model_axis_size()} ranks")
    if e_loc != e:
        SH.require_model_group("the expert stacks")
        if e_loc * SH.model_axis_size() != e:
            raise ValueError(f"{e_loc} local experts of {e} on a model axis "
                             f"of {SH.model_axis_size()}")

    logits, probs, weights, ids = route(p["router"], x_flat, k)

    # aux losses (switch-style load balance + z-loss)
    counts = expert_counts(ids.reshape(-1), e)
    # the global batch's fractions: the counts summed over the data group
    # (no gradient); this shard's share of the probabilities' and the
    # z-loss's global means (one device: the means themselves)
    n_data = SH.data_size()
    SH.all_reduce_(counts, SH.data_group(), "aux")
    frac_tokens = counts.float() / (ids.numel() * n_data)
    frac_probs = probs.sum(0) / (t * n_data)
    router_z = torch.sum(torch.logsumexp(logits, dim=-1) ** 2) / (t * n_data)
    aux = {"load_balance": e * torch.sum(frac_tokens * frac_probs),
           "router_z": router_z}

    # capacity from the tokens of this rank's data shard
    capacity = _capacity(t, k, moe.capacity_factor, e)
    wp = {n: p[n] for n in ("w_gate", "w_up", "w_down")}
    if e_loc != e:
        y_flat, kept = _dispatch_combine(
            cfg, SH.copy_to_model(x_flat), ids, SH.copy_to_model(weights),
            wp, sel, capacity, first=SH.model_index() * e_loc)
        y_flat = SH.psum_mapped(y_flat)
    else:
        y_flat, kept = _dispatch_combine(cfg, x_flat, ids, weights, wp, sel,
                                         capacity)
        if ff_split:
            y_flat = SH.psum_mapped(y_flat)
    sink = getattr(_ROUTING, "sink", None)
    if sink is not None:
        sink.append(((~kept).sum(), kept.numel()))

    y = y_flat.reshape(b, s, d)
    if "shared" in p:
        y = y + L.apply_mlp(p["shared"], cfg, x, sel=_shared_sel(sel),
                            d_ff=moe.num_shared_experts * cfg.d_ff)
    return y, aux


def _shared_sel(sel):
    if sel is None:
        return None
    idx, spec = sel[0], sel[1]
    if idx is None or "shared" not in idx or "shared" not in spec:
        return None
    return tuple(comp["shared"] for comp in sel)

"""Logical-axis sharding rules and the collectives of the port's process mesh.

Models name the axes of their params and activations logically (`batch`,
`heads`, `ff`, `vocab`, ...); a rule set maps those names onto the axes of a
mesh. The reference package hands the mapping to GSPMD, which inserts the
collectives. PyTorch has no GSPMD, so on a process mesh (`launch.mesh`) each
rank holds its own shards and the model code calls the collectives itself,
as the reference's serve mesh does inside its `shard_map`:

    axis       what                            mesh axis (default_rules)
    batch      global batch                    ("pod", "data")
    seq        sequence (activations)          None
    cache_seq  kv-cache sequence               None ("data" for long_500k)
    model_d    d_model                         None
    heads      attention query heads           "model"
    kv_heads   attention kv heads              "model" (None under rules_for)
    ff         FFN hidden                      "model"
    vocab      vocabulary                      "model"
    expert     MoE expert                      "model"
    layers     stacked-layer leading axis      None
    d_inner    mamba / rwkv inner channels     "model"

With no rules installed (one device) every function here is the identity
and the model code runs as it always did.

The collectives are `torch.autograd.Function`s over the mesh's process
groups, each with its stated backward (Megatron's f and g):

- `copy_to_model`: identity forward, all-reduce backward. In front of a
  tensor-parallel block: a replicated input feeds rank-local products, so
  its gradient is the sum of the ranks' shares.
- `psum_mapped`: all-reduce forward, identity backward. After a
  row-parallel product (or any rank-local partial sum): every rank then
  holds the same sum, and each rank's partial takes the sum's gradient.
- `all_gather_mapped`: tiled all-gather forward, the rank's slice of the
  gradient backward. Right where every rank uses the gathered tensor
  alike (the vocab-parallel logits).
- `all_gather_local_use` / `psum_local_use`: the same forwards, for a
  tensor each rank then reads its own part of (mamba's column-split
  `in_proj` output, its row-parallel `x_proj` sum feeding the rank's
  channels): every rank's gradient is partial, so the backward sums it
  over the model group first (then the gather takes the rank's slice).
  Each is `copy_to_model` composed over the plain collective.

Every all-reduce adds its payload bytes to `COLLECTIVE_BYTES` under a kind
(`collective_bytes()`), so a run can print what each step moved.

The rules live in process-wide state, not in a thread-local as in the
reference: on the card autograd runs the backward, and with it the
recomputation of checkpointed layers, on a thread of its own, and that
recomputation must take the same mesh path as the forward.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.distributed as dist


class _State:
    rules = None
    mapped_axis = None


_STATE = _State()

# payload bytes all-reduced (or gathered), by kind:
#   act       activations over the model group (f / g, embedding gather)
#   ce        the vocab-parallel cross entropy's max, sum and gold logit
#   dw_model  gradients of replicated weights summed over the model group
#   dw        compact dW over the data group (the compact step, and the
#             dense-scatter step with compact_allreduce)
#   grad_full full-shape dW of selectable leaves over the data group
#   grad_dense gradients of the dense-rule leaves over the data group
#   metrics   loss and metrics over the data group
#   aux       MoE expert counts over the data group, norms for selection
#             and clipping
#   logits    a serve step's vocab-parallel logits (each rank's [B, V/n])
#   state     a serve step's ring layers' kv heads, gathered back whole
#   spill     a spilled page's kv heads, gathered for the host tier
#   digest    the serve engine's per-step check of the ranks' inputs
COLLECTIVE_BYTES: dict[str, int] = {}


def reset_collective_bytes() -> None:
    COLLECTIVE_BYTES.clear()


def collective_bytes() -> dict[str, int]:
    return dict(COLLECTIVE_BYTES)


class AxisRules:
    def __init__(self, rules: dict, mesh=None, batch_axes: tuple = (),
                 model_axis: Optional[str] = None):
        self.rules = rules
        self.mesh = mesh               # launch.mesh.ProcessMesh, or any
        self.batch_axes = batch_axes   # object with a `shape` dict
        self.model_axis = model_axis

    def resolve(self, *logical: Optional[str]) -> tuple:
        return tuple(None if name is None else self.rules.get(name)
                     for name in logical)


def _axis_names(mesh) -> tuple:
    names = getattr(mesh, "axis_names", None)
    return tuple(names) if names is not None else tuple(mesh.shape)


def default_rules(mesh) -> AxisRules:
    names = _axis_names(mesh)
    batch_axes = tuple(a for a in ("pod", "data") if a in names)
    model_axis = "model" if "model" in names else None
    rules = {
        "batch": batch_axes or None,
        "seq": None,
        "cache_seq": None,
        "model_d": None,
        "heads": model_axis,
        "kv_heads": model_axis,
        "ff": model_axis,
        "vocab": model_axis,
        "expert": model_axis,
        "layers": None,
        "d_inner": model_axis,
        "sel": None,
        "paged_pool": model_axis,
        "page_table": None,
    }
    return AxisRules(rules, mesh=mesh, batch_axes=batch_axes,
                     model_axis=model_axis)


def seq_sharded_rules(mesh) -> AxisRules:
    """Rules for long-context decode: the KV cache's sequence sharded over
    the batch axes (the batch is too small to shard). Used by long_500k."""
    r = default_rules(mesh)
    rules = dict(r.rules)
    rules["cache_seq"] = r.batch_axes or None
    rules["batch"] = None
    return AxisRules(rules, mesh=mesh, batch_axes=r.batch_axes,
                     model_axis=r.model_axis)


@contextlib.contextmanager
def use_rules(rules: Optional[AxisRules]):
    prev = _STATE.rules
    _STATE.rules = rules
    try:
        yield rules
    finally:
        _STATE.rules = prev


def current_rules() -> Optional[AxisRules]:
    return _STATE.rules


def logical_spec(*logical: Optional[str]) -> tuple:
    r = current_rules()
    if r is None:
        return ()
    return r.resolve(*logical)


def model_axis_size() -> int:
    r = current_rules()
    if r is None or r.model_axis is None:
        return 1
    if r.mesh is None:
        raise ValueError(
            "AxisRules name a model axis "
            f"({r.model_axis!r}) but carry no mesh; model_axis_size() "
            "cannot be resolved. Install rules built from a mesh "
            "(e.g. default_rules(mesh)).")
    return r.mesh.shape[r.model_axis]


@contextlib.contextmanager
def mapped_model_axis(name: Optional[str]):
    """Mark that model code runs on one rank's shards of mesh axis `name`
    (the reference: inside a shard_map): a weight that arrived sharded
    takes its collective."""
    prev = _STATE.mapped_axis
    _STATE.mapped_axis = name
    try:
        yield
    finally:
        _STATE.mapped_axis = prev


def current_mapped_axis() -> Optional[str]:
    return _STATE.mapped_axis


# ---------------------------------------------------------------------------
# the mesh behind the current rules
# ---------------------------------------------------------------------------

def process_mesh():
    """The process mesh of the current rules, or None (no rules, or rules
    over a mesh that only describes a shape, as the planners' fake
    meshes)."""
    r = current_rules()
    if r is None or r.mesh is None or not hasattr(r.mesh, "group"):
        return None
    return r.mesh


def model_group():
    """The process group of the mapped model axis; None off a mesh, outside
    `mapped_model_axis`, or where that axis has one rank."""
    ax = current_mapped_axis()
    mesh = process_mesh()
    if ax is None or mesh is None:
        return None
    return mesh.group(ax)


def require_model_group(what: str):
    """The mapped model group, for a tensor that arrived sharded; raises
    off a mesh, where its collective would silently be skipped."""
    group = model_group()
    if group is None:
        raise ValueError(f"{what} arrived sharded, but no process mesh's "
                         f"model axis is mapped (use_rules with a "
                         f"launch.mesh mesh, mapped_model_axis)")
    return group


def model_index() -> int:
    """This rank's coordinate on the mapped model axis (0 off a mesh)."""
    ax = current_mapped_axis()
    mesh = process_mesh()
    return 0 if ax is None or mesh is None else mesh.index(ax)


def data_group():
    """The process group over the rules' batch axes (None off a mesh or
    where they hold one rank)."""
    mesh = process_mesh()
    if mesh is None or not current_rules().batch_axes:
        return None
    return mesh.group(current_rules().batch_axes)


def data_size() -> int:
    mesh = process_mesh()
    if mesh is None:
        return 1
    n = 1
    for a in current_rules().batch_axes:
        n *= mesh.shape[a]
    return n


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def count_collective(kind: str, t: torch.Tensor) -> None:
    """Add `t`'s bytes to `COLLECTIVE_BYTES[kind]`."""
    COLLECTIVE_BYTES[kind] = COLLECTIVE_BYTES.get(kind, 0) + \
        t.numel() * t.element_size()


def all_reduce_(t: torch.Tensor, group, kind: str,
                op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place all-reduce of `t` over `group` (a no-op for None), counted
    under `kind`. No autograd: for gradients, metrics and statistics."""
    if group is not None:
        count_collective(kind, t)
        if t.is_contiguous():
            dist.all_reduce(t, op=op, group=group)
        else:
            flat = t.contiguous()
            dist.all_reduce(flat, op=op, group=group)
            t.copy_(flat)
    return t


class _CopyToGroup(torch.autograd.Function):
    """f: identity forward, all-reduce backward."""

    @staticmethod
    def forward(ctx, x, group, kind):
        ctx.group, ctx.kind = group, kind
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group, ctx.kind), \
            None, None


class _ReduceFromGroup(torch.autograd.Function):
    """g: all-reduce forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group, kind):
        return all_reduce_(x.contiguous().clone(), group, kind)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherFromGroup(torch.autograd.Function):
    """Tiled all-gather along `axis` forward, this rank's slice backward."""

    @staticmethod
    def forward(ctx, x, group, axis, kind):
        n = dist.get_world_size(group)
        ctx.group, ctx.axis, ctx.n = group, axis, n
        ctx.index = dist.get_rank(group)
        parts = [torch.empty_like(x, memory_format=torch.contiguous_format)
                 for _ in range(n)]
        count_collective(kind, x)
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=axis)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.n, dim=ctx.axis)[ctx.index].contiguous(), None, \
            None, None


def copy_to_model(x, kind: str = "act"):
    """Identity forward; the gradient all-reduced over the mapped model
    group. The identity off a mesh."""
    group = model_group()
    return x if group is None else _CopyToGroup.apply(x, group, kind)


def psum_mapped(x, kind: str = "act"):
    """Sum rank-local partials over the mapped model group (the reference's
    psum inside a shard_map); the gradient passes through unchanged. The
    identity off a mesh."""
    group = model_group()
    return x if group is None else _ReduceFromGroup.apply(x, group, kind)


def all_gather_mapped(x, axis: int, kind: str = "act"):
    """Concatenate the ranks' slices along `axis` over the mapped model
    group, in rank order; each rank's gradient is its slice. The identity
    off a mesh."""
    group = model_group()
    return x if group is None else _GatherFromGroup.apply(x, group, axis,
                                                          kind)


def all_gather_local_use(x, axis: int, kind: str = "act"):
    """`all_gather_mapped` for a gathered tensor that each rank reads a
    different part of: the backward all-reduces the gradient over the
    mapped model group, then takes the rank's slice (a reduce-scatter).
    The identity off a mesh."""
    return copy_to_model(all_gather_mapped(x, axis, kind), kind)


def psum_local_use(x, kind: str = "act"):
    """`psum_mapped` for a sum that each rank reads a different part of:
    the backward all-reduces the gradient over the mapped model group, so
    every rank's partial takes the whole sum's gradient. The identity off
    a mesh."""
    return copy_to_model(psum_mapped(x, kind), kind)


def pmax_mapped_(x, kind: str = "ce"):
    """In-place max over the mapped model group (no gradient: a
    stabilising shift)."""
    return all_reduce_(x, model_group(), kind, op=dist.ReduceOp.MAX)

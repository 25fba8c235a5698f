"""Logical-axis specs for every param leaf, from the leaf's name (the
reference package's rules, megatron-style tensor parallelism plus expert
parallelism), walked over the port's `meta` param tree.

Used by the selection planner (a weight's out-dim shard count is its
selection's `n_shards`) and by `launch.specs`, which resolves them on a
mesh into each rank's slices.
"""
from __future__ import annotations

from typing import Optional

# leaf name -> logical axes of the *trailing* dims (leading "layers" /
# "expert" axes are added from ndim)
_RULES_2D = {
    # attention (column-parallel qkv, row-parallel o)
    "wq": ("model_d", "heads"),
    "wk": ("model_d", "kv_heads"),
    "wv": ("model_d", "kv_heads"),
    "wo": ("heads", "model_d"),
    # mlp (column-parallel up/gate, row-parallel down)
    "w_gate": ("model_d", "ff"),
    "w_up": ("model_d", "ff"),
    "w_down": ("ff", "model_d"),
    # mamba
    "in_proj": ("model_d", "d_inner"),
    "out_proj": ("d_inner", "model_d"),
    "x_proj": ("d_inner", None),
    "dt_proj": (None, "d_inner"),
    "A_log": ("d_inner", None),
    # moe router (replicated)
    "router": ("model_d", None),
    # rwkv decay lora (replicated)
    "wA": (None, None),
    "wB": (None, None),
    "u": (None, None),
    "mu": (None, None),
}
_RULES_1D = {
    "conv_b": ("d_inner",),
    "dt_bias": ("d_inner",),
    "D": ("d_inner",),
    "w0": (None,),
}
# rwkv time-mix square mats are replicated (40 heads do not divide a
# 16-way model axis); its channel mix takes the mlp-style rules below
_RWKV_TIME_REPLICATED = {"wr", "wk", "wv", "wg", "wo"}
_RWKV_CHAN = {"wk": ("model_d", "ff"), "wv": ("ff", "model_d"),
              "wr": (None, None)}


def _leaf_spec(path: tuple, leaf) -> tuple[Optional[str], ...]:
    """Logical axes of one leaf; `leaf` needs only `.ndim`."""
    name = path[-1]
    ndim = leaf.ndim
    inside = list(path[:-1])

    if name == "tok":                                   # embed [V, d]
        return ("vocab", "model_d")
    if path[-2:] == ("lm_head", "w") or (len(path) >= 2
                                         and path[-2] == "lm_head"):
        return ("model_d", "vocab")
    if name in ("scale", "bias"):                       # norms
        return ("layers",) * (ndim - 1) + (None,)
    if name == "conv_w":                                # [*, K, d_inner]
        return ("layers",) * (ndim - 2) + (None, "d_inner")

    in_time_mix = "time" in inside
    in_chan_mix = "chan" in inside
    if in_time_mix and name in _RWKV_TIME_REPLICATED:
        return ("layers",) * (ndim - 2) + (None, None)
    if in_chan_mix and name in _RWKV_CHAN:
        return ("layers",) * (ndim - 2) + _RWKV_CHAN[name]

    if name in _RULES_1D:
        return ("layers",) * (ndim - 1) + _RULES_1D[name]
    if name in _RULES_2D:
        base = _RULES_2D[name]
        lead = ndim - 2
        # moe expert stacks [layers, E, in, out]: the expert axis sharded,
        # and not the ff one
        if lead >= 1 and name in ("w_gate", "w_up", "w_down") \
                and "moe" in inside and "shared" not in inside:
            lead_axes = ("layers",) * (lead - 1) + ("expert",)
            inner = tuple(None if a == "ff" else a for a in base)
            return lead_axes + inner
        return ("layers",) * lead + base
    if name in ("w", "b"):                              # CNN leaves
        return (None,) * ndim
    return ("layers",) * max(0, ndim - 1) + (None,) * min(1, ndim)


class _Shape:
    def __init__(self, ndim: int):
        self.ndim = ndim


def spec_of(path: tuple, ndim: int) -> tuple[Optional[str], ...]:
    """`_leaf_spec` of a leaf of `ndim` dims at `path`."""
    return _leaf_spec(path, _Shape(ndim))


def _walk(tree, path: tuple):
    if isinstance(tree, dict):
        return {k: _walk(v, path + (k,)) for k, v in tree.items()}
    return _leaf_spec(path, tree)


def param_logical_specs(cfg) -> dict:
    """Tree of logical-axis tuples mirroring `init_params(cfg)`."""
    from repro_torch.models.registry import abstract_params
    return _walk(abstract_params(cfg), ())

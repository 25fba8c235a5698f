"""Wrappers between the framework and the port's CUDA kernels.

Each wrapper checks device, dtype, shape and contiguity and raises on what
its kernel does not take. Then it dispatches on the device of its tensors:

- CUDA tensors: it launches the kernel on PyTorch's current stream, raises
  if the launch fails, and adds one to its launch count. There is no
  fallback.
- CPU tensors: it runs the kernel's plain version from `ref.py` and counts
  nothing.

Every logical op is one launch: the dW kernel covers all shards and
selected blocks of one matmul (and, batched, all experts of an expert
leaf), the optimizer and the block scatter-update kernels the whole stacked
leaf (all trainable layers, all shards, lead dims flattened into rows), and
the activation pruning kernel a whole activation, forward or backward,
and the WKV kernel a whole recurrence (all batch rows and heads of one
layer), forward or backward.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.kernels import ref

# launch counts, by kernel; only a launch on the card counts
LAUNCHES = {"block_sparse_dw": 0, "batched_dw": 0, "fused_block_opt": 0,
            "block_act_prune": 0, "block_act_prune_bwd": 0,
            "block_scatter_update": 0, "wkv6": 0, "wkv6_bwd": 0}
# block_sparse_dw and batched_dw launches by instance, for reports: grid
# (SIMT) and pipelined (TMA + wgmma); see dw_instance
DW_INSTANCES = {"grid": 0, "pipelined": 0}
BATCHED_DW_INSTANCES = {"grid": 0, "pipelined": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_OPT_KIND = {"sgd": 0, "momentum": 1, "adamw": 2}


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, DW_INSTANCES, BATCHED_DW_INSTANCES):
        for name in counts:
            counts[name] = 0


def launch_counts() -> dict:
    return dict(LAUNCHES)


def _require(ok: bool, msg: str) -> None:
    if not ok:
        raise ValueError(msg)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{rc}")


# ---------------------------------------------------------------------------
# compact dW
# ---------------------------------------------------------------------------

def _check_dw(name: str, x, dy, idx, block: int, ndim: int):
    """x [*lead, M, K] and dy [*lead, M, N] with `ndim` dims each."""
    _require(x.dim() == ndim and dy.dim() == ndim,
             f"{name}: x and dy must be {ndim}-D, got {tuple(x.shape)} and "
             f"{tuple(dy.shape)}")
    _require(x.dtype in _DTYPE_CODE and dy.dtype == x.dtype,
             f"{name}: x and dy must both be float32 or bfloat16, got "
             f"{x.dtype} and {dy.dtype}")
    _require(idx.dtype == torch.int32 and idx.dim() == 2,
             f"{name}: idx must be int32 [n_shards, n_sel], got "
             f"{idx.dtype} {tuple(idx.shape)}")
    n_shards = idx.shape[0]
    _require(dy.shape[:-1] == x.shape[:-1] and x.shape[-2] > 0,
             f"{name}: x and dy disagree on their rows: {tuple(x.shape)} vs "
             f"{tuple(dy.shape)}")
    _require(block > 0 and dy.shape[-1] % (n_shards * block) == 0,
             f"{name}: N={dy.shape[-1]} is not n_shards*n_blocks*block with "
             f"n_shards={n_shards}, block={block}")
    _require(x.is_contiguous() and dy.is_contiguous() and idx.is_contiguous(),
             f"{name}: x, dy and idx must be contiguous")
    _require(x.device == dy.device == idx.device,
             f"{name}: x, dy and idx must be on one device")


def dw_instance(dtype, k: int, n: int, block: int, x_ptr: int,
                dy_ptr: int) -> str:
    """The dW instance that takes a call on the card, from its arguments
    alone: "pipelined" (TMA + wgmma on the tensor cores) for bf16 with K
    and N multiples of 8 (TMA's 16-byte row strides), `block` a multiple
    of 64 (a TMA box never spans two selected blocks) and 16-byte-aligned
    bases (then every expert's base is aligned too, its stride being whole
    rows); "grid" (SIMT, exact fp32 products) for everything else: fp32,
    the serving waves' block 8, misaligned or ragged rows."""
    fits = (dtype == torch.bfloat16 and k % 8 == 0 and n % 8 == 0
            and block % 64 == 0 and x_ptr % 16 == 0 and dy_ptr % 16 == 0)
    return "pipelined" if fits else "grid"


def use_pipelined(x, dy, block: int,
                  pipelined: Optional[bool] = None) -> bool:
    """Whether a call on x, dy takes the TMA + wgmma instance: `pipelined`
    where given (True is refused where `dw_instance` says "grid"), else
    wherever `dw_instance` allows it."""
    fits = dw_instance(x.dtype, x.shape[-1], dy.shape[-1], block,
                       x.data_ptr(), dy.data_ptr()) == "pipelined"
    if pipelined is None:
        return fits
    _require(not pipelined or fits,
             "the pipelined (TMA + wgmma) dW instance takes bf16 only, with "
             "K and N multiples of 8, block a multiple of 64 and 16-byte-"
             "aligned base pointers")
    return pipelined


def block_sparse_dw(x2, dy2, idx, spec, pipelined: Optional[bool] = None):
    """Compact dW (see core.sparse_update.compact_dw), one launch for all
    shards.

    x2: [M, K], dy2: [M, N], idx: [n_shards, n_sel] int32 ->
    [K, n_shards, n_sel, block] fp32. pipelined: force the TMA + wgmma
    instance (True; a ValueError where it cannot take the call) or the
    grid one (False); None picks by `dw_instance`. On the CPU it is ignored.
    """
    block = spec.block
    _check_dw("block_sparse_dw", x2, dy2, idx, block, 2)
    if not x2.is_cuda:
        return ref.block_sparse_dw_ref(x2, dy2, idx, block)
    from repro_torch.kernels.build import load
    pipe = use_pipelined(x2, dy2, block, pipelined)
    m, k = x2.shape
    n = dy2.shape[1]
    n_shards, n_sel = idx.shape
    out = torch.empty((k, n_shards, n_sel, block), dtype=torch.float32,
                      device=x2.device)
    rc = load("block_sparse_dw").block_sparse_dw_launch(
        x2.data_ptr(), dy2.data_ptr(), idx.data_ptr(), out.data_ptr(),
        m, k, n, n_shards, n_sel, block, _DTYPE_CODE[x2.dtype], int(pipe),
        _stream(x2))
    _raise_on(rc, "block_sparse_dw")
    LAUNCHES["block_sparse_dw"] += 1
    DW_INSTANCES["pipelined" if pipe else "grid"] += 1
    return out


def block_sparse_dw_batched(x3, dy3, idx, spec,
                            pipelined: Optional[bool] = None):
    """Expert-batched compact dW (see core.sparse_update.compact_dw_batched),
    one launch for all experts and shards; the selection is shared by the
    experts.

    x3: [E, C, K], dy3: [E, C, N], idx: [n_shards, n_sel] int32 ->
    [E, K, n_shards, n_sel, block] fp32. pipelined as in block_sparse_dw.
    """
    block = spec.block
    _check_dw("batched_dw", x3, dy3, idx, block, 3)
    if not x3.is_cuda:
        return ref.batched_dw_ref(x3, dy3, idx, block)
    from repro_torch.kernels.build import load
    e, c, k = x3.shape
    _require(e <= 65535, f"batched_dw: {e} experts exceed the grid's 65535")
    pipe = use_pipelined(x3, dy3, block, pipelined)
    n = dy3.shape[2]
    n_shards, n_sel = idx.shape
    out = torch.empty((e, k, n_shards, n_sel, block), dtype=torch.float32,
                      device=x3.device)
    rc = load("block_sparse_dw").batched_dw_launch(
        x3.data_ptr(), dy3.data_ptr(), idx.data_ptr(), out.data_ptr(),
        e, c, k, n, n_shards, n_sel, block, _DTYPE_CODE[x3.dtype],
        int(pipe), _stream(x3))
    _raise_on(rc, "batched_dw")
    LAUNCHES["batched_dw"] += 1
    BATCHED_DW_INSTANCES["pipelined" if pipe else "grid"] += 1
    return out


# ---------------------------------------------------------------------------
# fused block optimizer
# ---------------------------------------------------------------------------

def _check_opt(w, g, idx, hyper, mu, nu, kind: str):
    _require(kind in _OPT_KIND, f"fused_block_opt: unknown kind {kind!r}")
    _require(w.dim() == 3 and g.dim() == 5 and idx.dim() == 3,
             f"fused_block_opt: need w [K,R,N], g [K,R,S,n_sel,block], idx "
             f"[K,S,n_sel]; got {tuple(w.shape)}, {tuple(g.shape)}, "
             f"{tuple(idx.shape)}")
    k, r, n = w.shape
    n_shards, n_sel, block = g.shape[2], g.shape[3], g.shape[4]
    _require(tuple(g.shape[:2]) == (k, r)
             and tuple(idx.shape) == (k, n_shards, n_sel)
             and n % (n_shards * block) == 0,
             f"fused_block_opt: shapes disagree: w {tuple(w.shape)}, g "
             f"{tuple(g.shape)}, idx {tuple(idx.shape)}")
    _require(w.dtype in _DTYPE_CODE and g.dtype in _DTYPE_CODE,
             f"fused_block_opt: w and g must be float32 or bfloat16, got "
             f"{w.dtype} and {g.dtype}")
    _require(idx.dtype == torch.int32, "fused_block_opt: idx must be int32")
    _require(hyper.dtype == torch.float32 and tuple(hyper.shape) == (2,),
             "fused_block_opt: hyper must be float32 [lr, t]")
    n_state = {"sgd": 0, "momentum": 1, "adamw": 2}[kind]
    _require((mu is not None) == (n_state >= 1)
             and (nu is not None) == (n_state >= 2),
             f"fused_block_opt: {kind} takes {n_state} state tensors")
    tensors = [w, g, idx, hyper] + [s for s in (mu, nu) if s is not None]
    for s in (mu, nu):
        if s is not None:
            _require(s.dtype == torch.float32 and s.shape == w.shape,
                     "fused_block_opt: mu/nu must be float32 shaped like w")
    _require(all(t.is_contiguous() for t in tensors),
             "fused_block_opt: every tensor must be contiguous")
    _require(all(t.device == w.device for t in tensors),
             "fused_block_opt: every tensor must be on one device")


def fused_block_opt(w, g, idx, hyper, mu=None, nu=None, *, kind: str,
                    momentum: float = 0.0, beta1: float = 0.9,
                    beta2: float = 0.999, eps: float = 1e-8,
                    weight_decay: float = 0.0):
    """One in-place pass over the selected blocks: gather, optimizer rule,
    write back to w, mu and nu. Shapes as in the kernel source; hyper is the
    fp32 device tensor [lr, t]. Returns (w, mu, nu), updated in place."""
    _check_opt(w, g, idx, hyper, mu, nu, kind)
    if not w.is_cuda:
        new = ref.fused_block_opt_ref(
            w, g, idx, hyper[0], hyper[1], mu, nu, kind=kind,
            momentum=momentum, beta1=beta1, beta2=beta2, eps=eps,
            weight_decay=weight_decay)
        for dst, src in zip((w, mu, nu), new):
            if dst is not None:
                dst.copy_(src)
        return w, mu, nu
    from repro_torch.kernels.build import load
    k, r, n = w.shape
    n_shards, n_sel, block = g.shape[2], g.shape[3], g.shape[4]
    rc = load("fused_block_opt").fused_block_opt_launch(
        w.data_ptr(), g.data_ptr(), idx.data_ptr(),
        mu.data_ptr() if mu is not None else None,
        nu.data_ptr() if nu is not None else None,
        hyper.data_ptr(), k, r, n, n_shards, n_sel, block,
        _DTYPE_CODE[w.dtype], _DTYPE_CODE[g.dtype], _OPT_KIND[kind],
        momentum, beta1, beta2, 1.0 - beta1, 1.0 - beta2, eps,
        weight_decay, _stream(w))
    _raise_on(rc, "fused_block_opt")
    LAUNCHES["fused_block_opt"] += 1
    return w, mu, nu


def fused_block_optimizer(oc, p, g_sel, idx, spec, mu, nu, hyper):
    """`optim.apply_updates_mixed`'s selectable-leaf rule as one in-place
    kernel. p: [K, *lead, N]; g_sel: [K, *lead, n_shards, n_sel, block];
    idx: [K, n_shards, n_sel]; mu/nu: fp32 like p or None; hyper: fp32
    [lr, t] on p's device. Lead dims (an expert axis, later) flatten into
    rows, so a leaf stays one launch. Returns (p, mu, nu), updated in place.
    """
    kind = "adamw" if nu is not None else \
        ("momentum" if mu is not None else "sgd")
    k, n = p.shape[0], p.shape[-1]
    r = p[0].numel() // n
    as3 = lambda a: a.view(k, r, n) if a is not None else None
    fused_block_opt(as3(p), g_sel.reshape(k, r, spec.n_shards, spec.n_sel,
                                          spec.block),
                    idx, hyper, as3(mu), as3(nu), kind=kind,
                    momentum=oc.momentum, beta1=oc.beta1, beta2=oc.beta2,
                    eps=oc.eps, weight_decay=oc.weight_decay)
    return p, mu, nu


# ---------------------------------------------------------------------------
# block scatter-update
# ---------------------------------------------------------------------------

def _check_scatter(w, vals, idx, spec):
    name = "block_scatter_update"
    s, j, blk = spec.n_shards, spec.n_sel, spec.block
    _require(w.dim() >= 2 and blk > 0 and w.shape[-1] % (s * blk) == 0
             and tuple(vals.shape) == tuple(w.shape[:-1]) + (s, j, blk)
             and tuple(idx.shape) == (w.shape[0], s, j),
             f"{name}: need w [K,*lead,N], vals [K,*lead,S,n_sel,block], idx "
             f"[K,S,n_sel] for {tuple(spec)}; got {tuple(w.shape)}, "
             f"{tuple(vals.shape)}, {tuple(idx.shape)}")
    _require(w.dtype in _DTYPE_CODE and vals.dtype in (torch.float32,
                                                       w.dtype),
             f"{name}: w must be float32 or bfloat16 and vals float32 or "
             f"w's type, got {w.dtype} and {vals.dtype}")
    _require(idx.dtype == torch.int32, f"{name}: idx must be int32")
    _require(w.is_contiguous() and vals.is_contiguous()
             and idx.is_contiguous(),
             f"{name}: w, vals and idx must be contiguous")
    _require(w.device == vals.device == idx.device,
             f"{name}: w, vals and idx must be on one device")


def _check_scatter_out(w, out):
    name = "block_scatter_update"
    _require(out.shape == w.shape and out.dtype == w.dtype
             and out.device == w.device,
             f"{name}: out must have w's shape, type and device: "
             f"{tuple(w.shape)} {w.dtype} {w.device}; got {tuple(out.shape)} "
             f"{out.dtype} {out.device}")
    _require(out.is_contiguous(), f"{name}: out must be contiguous")
    nbytes = w.numel() * w.element_size()
    a, b = w.data_ptr(), out.data_ptr()
    _require(a == b or a + nbytes <= b or b + nbytes <= a,
             f"{name}: out overlaps w without being w")


def block_scatter_update(w, vals, idx, spec, out=None):
    """The selected column blocks of a stacked leaf overwritten with
    `vals`, in one launch over (K, rows, shards, selected blocks):

    w:    [K, *lead, N]                     (N = n_shards * n_blocks * block)
    vals: [K, *lead, n_shards, n_sel, block]  float32 or w's type, cast to
          w's type on the store
    idx:  [K, n_shards, n_sel] int32; a block named twice in one shard takes
          the values of its highest j

    out=None (or w itself): in place, unselected blocks never touched;
    returns w. Else `out` (w's shape, type and device, contiguous, not
    overlapping w) receives the whole result and w is only read; returns
    out. Lead dims (an expert axis) flatten into the kernel's rows."""
    _check_scatter(w, vals, idx, spec)
    if out is None:
        out = w
    _check_scatter_out(w, out)
    k, n = w.shape[0], w.shape[-1]
    r = w[0].numel() // n if k else 0
    w3, o3 = w.view(k, r, n), out.view(k, r, n)
    v5 = vals.view(k, r, spec.n_shards, spec.n_sel, spec.block)
    if not w.is_cuda:
        o3.copy_(ref.block_scatter_update_ref(w3, v5, idx, spec.block))
        return out
    from repro_torch.kernels.build import load
    rc = load("block_scatter_update").block_scatter_update_launch(
        o3.data_ptr(), w3.data_ptr(), v5.data_ptr(), idx.data_ptr(), k, r,
        n, spec.n_shards, spec.n_sel, spec.block, _DTYPE_CODE[w.dtype],
        _DTYPE_CODE[vals.dtype], _stream(w))
    _raise_on(rc, "block_scatter_update")
    LAUNCHES["block_scatter_update"] += 1
    return out


# ---------------------------------------------------------------------------
# block activation pruning
# ---------------------------------------------------------------------------

def _check_prune(name: str, tensors, block: int):
    x = tensors[0]
    _require(x.dim() >= 1 and block > 0 and x.shape[-1] % block == 0,
             f"{name}: the last dim of {tuple(x.shape)} is not a multiple of "
             f"block={block}")
    _require(x.dtype in _DTYPE_CODE,
             f"{name}: need float32 or bfloat16, got {x.dtype}")
    _require(all(t.shape == x.shape and t.dtype == x.dtype
                 and t.device == x.device for t in tensors),
             f"{name}: the tensors disagree on shape, dtype or device")
    _require(all(t.is_contiguous() for t in tensors),
             f"{name}: the tensors must be contiguous (channels last, "
             f"blocks along the innermost dim)")


@functools.lru_cache(maxsize=None)
def _type_threshold(threshold: float, dtype) -> float:
    """The threshold rounded to the tensor's type, as comparing a tensor
    with a Python float does in PyTorch and in JAX."""
    return float(torch.tensor(threshold, dtype=dtype))


def block_act_prune_fwd(x, threshold: float, block: int):
    """y = x * keep(x): x [..., C] contiguous, C % block == 0."""
    _check_prune("block_act_prune", (x,), block)
    if not x.is_cuda:
        return ref.block_act_prune_ref(x, threshold, block)
    from repro_torch.kernels.build import load
    y = torch.empty_like(x)
    rc = load("block_act_prune").block_act_prune_fwd_launch(
        x.data_ptr(), y.data_ptr(), x.numel(), block,
        _type_threshold(threshold, x.dtype), _DTYPE_CODE[x.dtype],
        _stream(x))
    _raise_on(rc, "block_act_prune")
    LAUNCHES["block_act_prune"] += 1
    return y


def block_act_prune_bwd(dy, y, threshold: float, block: int):
    """dx = dy * keep(y), y the forward's output."""
    _check_prune("block_act_prune_bwd", (dy, y), block)
    if not dy.is_cuda:
        return ref.block_act_prune_bwd_ref(dy, y, threshold, block)
    from repro_torch.kernels.build import load
    dx = torch.empty_like(dy)
    rc = load("block_act_prune").block_act_prune_bwd_launch(
        dy.data_ptr(), y.data_ptr(), dx.data_ptr(), dy.numel(), block,
        _type_threshold(threshold, dy.dtype), _DTYPE_CODE[dy.dtype],
        _stream(dy))
    _raise_on(rc, "block_act_prune_bwd")
    LAUNCHES["block_act_prune_bwd"] += 1
    return dx


class _BlockActPrune(torch.autograd.Function):
    """Both directions through the kernel. Only the output is saved: the
    backward's mask comes from it, and the next convolution keeps it
    anyway."""

    @staticmethod
    def forward(ctx, x, threshold: float, block: int):
        y = block_act_prune_fwd(x, threshold, block)
        ctx.save_for_backward(y)
        ctx.threshold, ctx.block = threshold, block
        return y

    @staticmethod
    def backward(ctx, dy):
        (y,) = ctx.saved_tensors
        # the incoming gradient's layout is autograd's (a mean's backward
        # hands over an expanded view): the kernel takes it dense
        return (block_act_prune_bwd(dy.contiguous(), y, ctx.threshold,
                                    ctx.block), None, None)


def block_act_prune(x, threshold: float = 0.15, block: int = 2):
    """ZeBRA block activation pruning, differentiable: x [..., C] ->
    x with every `block`-wide channel run whose max |x| is below the
    threshold zeroed. One kernel launch forward, one backward."""
    return _BlockActPrune.apply(x, threshold, block)


# ---------------------------------------------------------------------------
# RWKV-6 WKV recurrence
# ---------------------------------------------------------------------------

# the head size the kernel is built for (rwkv6-3b's); the plain version
# takes any
WKV_HEAD_DIM = 64


def _check_wkv(name: str, tensors, u):
    r = tensors[0]
    _require(r.dim() == 4, f"{name}: need [B, T, H, D], got "
                           f"{tuple(r.shape)}")
    _require(tuple(u.shape) == tuple(r.shape[2:]),
             f"{name}: u must be [H, D] = {tuple(r.shape[2:])}, got "
             f"{tuple(u.shape)}")
    every = tuple(tensors) + (u,)
    _require(all(t.dtype == torch.float32 for t in every),
             f"{name}: every tensor must be float32")
    _require(all(t.shape == r.shape for t in tensors),
             f"{name}: the [B, T, H, D] tensors disagree on shape")
    _require(all(t.is_contiguous() for t in every),
             f"{name}: every tensor must be contiguous")
    _require(all(t.device == r.device for t in every),
             f"{name}: every tensor must be on one device")
    _require(not r.is_cuda or r.shape[-1] == WKV_HEAD_DIM,
             f"{name}: the kernel takes D = {WKV_HEAD_DIM}, got "
             f"{r.shape[-1]}")


def wkv6_fwd(r, k, v, w, u, s0=None, want_state: bool = False):
    """The WKV recurrence (see `ref.wkv6_ref`): r, k, v, w [B, T, H, D] and
    u [H, D], fp32, contiguous -> y [B, T, H, D], from the state s0
    [B, H, D, D] fp32 (None: zero). With want_state, -> (y, s_last), the
    state after the last step, [B, H, D, D]. One launch either way: the
    serving path's prefill chunks (T = page size) and decode steps (T = 1)
    continue each slot's state through the same kernel as training."""
    _check_wkv("wkv6", (r, k, v, w), u)
    if s0 is not None:
        b, _, h, d = r.shape
        _require(tuple(s0.shape) == (b, h, d, d)
                 and s0.dtype == torch.float32 and s0.is_contiguous()
                 and s0.device == r.device,
                 f"wkv6: s0 must be float32 [B, H, D, D] = {(b, h, d, d)}, "
                 f"contiguous, on {r.device}; got {s0.dtype} "
                 f"{tuple(s0.shape)} on {s0.device}")
    if r.is_meta:
        return ref.wkv6_meta(r, k, v, w, u, s0=s0, want_state=want_state)
    if not r.is_cuda:
        return ref.wkv6_ref(r, k, v, w, u, s0=s0, want_state=want_state)
    from repro_torch.kernels.build import load
    b, t, h, d = r.shape
    y = torch.empty_like(r)
    s_last = torch.empty((b, h, d, d), dtype=torch.float32,
                         device=r.device) if want_state else None
    rc = load("wkv6").wkv6_fwd_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        y.data_ptr(), None if s0 is None else s0.data_ptr(),
        None if s_last is None else s_last.data_ptr(), b, t, h, d,
        _stream(r))
    _raise_on(rc, "wkv6")
    LAUNCHES["wkv6"] += 1
    return (y, s_last) if want_state else y


def wkv6_bwd(r, k, v, w, u, dy):
    """The gradients of `wkv6_fwd` (see `ref.wkv6_bwd_ref`) -> (dr, dk, dv,
    dw, du), du [H, D]. The kernels write du per batch row and chunk of
    time; its sum over both is taken here, in a fixed order."""
    _check_wkv("wkv6_bwd", (r, k, v, w, dy), u)
    if r.is_meta:
        return ref.wkv6_bwd_meta(r, k, v, w, u, dy)
    if not r.is_cuda:
        return ref.wkv6_bwd_ref(r, k, v, w, u, dy)
    from repro_torch.kernels.build import load
    lib = load("wkv6")
    b, t, h, d = r.shape
    dr, dk, dv, dw = (torch.empty_like(r) for _ in range(4))
    du_part = torch.empty((b, h, lib.wkv6_bwd_chunks(t), d),
                          dtype=torch.float32, device=r.device)
    ckpt = torch.empty(lib.wkv6_ckpt_floats(b, t, h), dtype=torch.float32,
                       device=r.device)
    rc = lib.wkv6_bwd_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        dy.data_ptr(), dr.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        dw.data_ptr(), du_part.data_ptr(), ckpt.data_ptr(), b, t, h, d,
        _stream(r))
    _raise_on(rc, "wkv6_bwd")
    LAUNCHES["wkv6_bwd"] += 1
    return dr, dk, dv, dw, du_part.sum((0, 2))


class WKV6(torch.autograd.Function):
    """The WKV recurrence, both directions through the kernel. Saves the
    inputs only: the backward recomputes the states it needs."""

    @staticmethod
    def forward(ctx, r, k, v, w, u):
        ctx.save_for_backward(r, k, v, w, u)
        return wkv6_fwd(r, k, v, w, u)

    @staticmethod
    def backward(ctx, dy):
        # autograd's incoming gradient may be a strided view
        return wkv6_bwd(*ctx.saved_tensors, dy.contiguous())

"""Wrappers between the framework and the port's CUDA kernels.

Each wrapper checks device, dtype, shape and contiguity and raises on what
its kernel does not take. Then it dispatches on the device of its tensors:

- CUDA tensors: it launches the kernel on PyTorch's current stream, raises
  if the launch fails, and adds one to its launch count. There is no
  fallback.
- CPU tensors: it runs the kernel's plain version from `ref.py` and counts
  nothing.

Every logical op is one launch: the dW kernel covers all shards and
selected blocks of one matmul, the optimizer kernel the whole stacked leaf
(all trainable layers, all shards, lead dims flattened into rows), and the
activation pruning kernel a whole activation, forward or backward.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.kernels import ref

# launch counts, by kernel; only a launch on the card counts
LAUNCHES = {"block_sparse_dw": 0, "fused_block_opt": 0,
            "block_act_prune": 0, "block_act_prune_bwd": 0}
# block_sparse_dw launches by instance (grid / pipelined), for reports
DW_INSTANCES = {"grid": 0, "pipelined": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_OPT_KIND = {"sgd": 0, "momentum": 1, "adamw": 2}


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, DW_INSTANCES):
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

def _check_dw(x2, dy2, idx, block: int):
    _require(x2.dim() == 2 and dy2.dim() == 2,
             f"block_sparse_dw: x and dy must be 2-D, got {tuple(x2.shape)} "
             f"and {tuple(dy2.shape)}")
    _require(x2.dtype in _DTYPE_CODE and dy2.dtype == x2.dtype,
             f"block_sparse_dw: x and dy must both be float32 or bfloat16, "
             f"got {x2.dtype} and {dy2.dtype}")
    _require(idx.dtype == torch.int32 and idx.dim() == 2,
             f"block_sparse_dw: idx must be int32 [n_shards, n_sel], got "
             f"{idx.dtype} {tuple(idx.shape)}")
    m, _ = x2.shape
    n_shards = idx.shape[0]
    _require(dy2.shape[0] == m and m > 0,
             f"block_sparse_dw: x and dy disagree on M: {m} vs {dy2.shape[0]}")
    _require(block > 0 and dy2.shape[1] % (n_shards * block) == 0,
             f"block_sparse_dw: N={dy2.shape[1]} is not n_shards*n_blocks*"
             f"block with n_shards={n_shards}, block={block}")
    _require(x2.is_contiguous() and dy2.is_contiguous()
             and idx.is_contiguous(),
             "block_sparse_dw: x, dy and idx must be contiguous")
    _require(x2.device == dy2.device == idx.device,
             "block_sparse_dw: x, dy and idx must be on one device")


def pipelined_fits(x2, dy2, block: int) -> bool:
    """The pipelined instance copies 16-byte chunks: rows, block and base
    pointers must be 16-byte aligned."""
    vec = 16 // x2.element_size()
    return (x2.shape[1] % vec == 0 and dy2.shape[1] % vec == 0
            and block % vec == 0 and x2.data_ptr() % 16 == 0
            and dy2.data_ptr() % 16 == 0)


def use_pipelined(x2, dy2, block: int,
                  pipelined: Optional[bool] = None) -> bool:
    """The pipelined instance wherever its alignment holds: on an H100 it
    was the faster of the two at every shape of the llama3-8b main path
    (chip_smoke.py's kernel phase); the grid instance takes the rest."""
    if pipelined is not None:
        return pipelined
    return pipelined_fits(x2, dy2, block)


def block_sparse_dw(x2, dy2, idx, spec, pipelined: Optional[bool] = None):
    """Compact dW (see core.sparse_update.compact_dw), one launch for all
    shards.

    x2: [M, K], dy2: [M, N], idx: [n_shards, n_sel] int32 ->
    [K, n_shards, n_sel, block] fp32. pipelined: force the double-buffered
    instance (True) or the grid one (False); None picks by alignment.
    """
    block = spec.block
    _check_dw(x2, dy2, idx, block)
    if not x2.is_cuda:
        return ref.block_sparse_dw_ref(x2, dy2, idx, block)
    from repro_torch.kernels.build import load
    pipe = use_pipelined(x2, dy2, block, pipelined)
    _require(not pipe or pipelined_fits(x2, dy2, block),
             "block_sparse_dw: the pipelined instance needs K, N, block and "
             "the base pointers 16-byte aligned")
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

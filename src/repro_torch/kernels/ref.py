"""Plain PyTorch versions of the port's kernels.

They are what the kernel wrappers in `ops.py` run on CPU tensors, and what
the kernels are held against on the card. Each mirrors the reference
package's `kernels/ref.py` oracle op for op: the optimizer rule is written
as the reference's separate multiplies and subtractions (no fused
`torch.sub(p, g, alpha=lr)`), so SGD rounds exactly as the reference does.
"""
from __future__ import annotations

import torch


def gather_dy_blocks(dy, idx, block: int):
    """dy: [M, N], idx: [n_shards, n_sel] -> the selected column blocks
    [M, n_shards, n_sel, block]."""
    m, n = dy.shape
    n_shards, n_sel = idx.shape
    dyb = dy.reshape(m, n_shards, n // (n_shards * block), block)
    index = idx.long()[None, :, :, None].expand(m, n_shards, n_sel, block)
    return torch.gather(dyb, 2, index)


def block_sparse_dw_ref(x, dy, idx, block: int):
    """x: [M,K], dy: [M,N], idx: [n_shards,n_sel] ->
    [K, n_shards, n_sel, block] fp32 (the compact-path dW layout)."""
    dy_sel = gather_dy_blocks(dy, idx, block)
    return torch.einsum("mk,msjb->ksjb", x.float(), dy_sel.float())


def batched_dw_ref(x, dy, idx, block: int):
    """Per-expert compact dW: x [E,C,K], dy [E,C,N], idx [n_shards,n_sel]
    (one selection shared by every expert) -> [E, K, n_shards, n_sel,
    block] fp32: the selected dy blocks gathered, then a per-expert product
    with fp32 sums over C."""
    e, c, n = dy.shape
    dy_sel = gather_dy_blocks(dy.reshape(e * c, n), idx, block)
    return torch.einsum("eck,ecsjb->eksjb", x.float(),
                        dy_sel.reshape((e, c) + dy_sel.shape[1:]).float())


def gather_blocks3(a, idx, block: int):
    """a: [K, R, N], idx: [K, n_shards, n_sel] -> [K, R, n_shards, n_sel,
    block], the selected column blocks of every row."""
    k, r, n = a.shape
    n_shards, n_sel = idx.shape[1], idx.shape[2]
    ab = a.reshape(k, r, n_shards, n // (n_shards * block), block)
    index = idx.long()[:, None, :, :, None].expand(k, r, n_shards, n_sel,
                                                   block)
    return torch.gather(ab, 3, index)


def scatter_blocks3(a, vals, idx, block: int):
    """Inverse of gather_blocks3, out of place: `a` with its selected blocks
    overwritten by `vals` (cast to a's dtype), everything else untouched."""
    k, r, n = a.shape
    n_shards, n_sel = idx.shape[1], idx.shape[2]
    ab = a.reshape(k, r, n_shards, n // (n_shards * block), block)
    index = idx.long()[:, None, :, :, None].expand(k, r, n_shards, n_sel,
                                                   block)
    return ab.scatter(3, index, vals.to(a.dtype)).reshape(k, r, n)


def block_scatter_update_ref(w, upd, idx, block: int):
    """The block scatter-update kernel's plain version: w [K,R,N], upd
    [K,R,n_shards,n_sel,block], idx [K,n_shards,n_sel] -> w with the
    selected blocks overwritten by upd cast to w's type (out of place; the
    kernel writes in place)."""
    return scatter_blocks3(w, upd, idx, block)


def block_rule(kind: str, lr, t, p32, g32, mu, nu, *, momentum: float,
               beta1: float, beta2: float, eps: float, weight_decay: float):
    """The optimizer rule on fp32 blocks, in the reference's order of
    operations (`optim.optimizers._leaf_update`). lr and t are 0-dim fp32
    tensors; Python floats enter as fp32, as JAX's weak types do."""
    if kind == "sgd":
        new = p32 - lr * g32
        if weight_decay:
            new = new - lr * weight_decay * p32
        return new, None, None
    if kind == "momentum":
        mu_new = momentum * mu + g32
        new = p32 - lr * mu_new
        if weight_decay:
            new = new - lr * weight_decay * p32
        return new, mu_new, None
    if kind == "adamw":
        b1, b2 = beta1, beta2
        mu_new = b1 * mu + (1 - b1) * g32
        nu_new = b2 * nu + (1 - b2) * g32 * g32
        mu_hat = mu_new / (1 - b1 ** t)
        nu_hat = nu_new / (1 - b2 ** t)
        new = p32 - lr * (mu_hat / (torch.sqrt(nu_hat) + eps)
                          + weight_decay * p32)
        return new, mu_new, nu_new
    raise ValueError(kind)


def fused_block_opt_ref(w, g, idx, lr, t, mu=None, nu=None, *, kind: str,
                        momentum: float = 0.0, beta1: float = 0.9,
                        beta2: float = 0.999, eps: float = 1e-8,
                        weight_decay: float = 0.0):
    """Gather -> optimizer block rule -> scatter, out of place.

    w: [K,R,N]; g: [K,R,n_shards,n_sel,block]; idx: [K,n_shards,n_sel];
    mu/nu: fp32 [K,R,N] or None; lr, t: 0-dim fp32 tensors.
    Returns (w', mu', nu') with None for absent state."""
    block = g.shape[-1]
    p32 = gather_blocks3(w, idx, block).float()
    g32 = g.float()
    mu_sel = gather_blocks3(mu, idx, block) if mu is not None else None
    nu_sel = gather_blocks3(nu, idx, block) if nu is not None else None
    new, mu_new, nu_new = block_rule(
        kind, lr, t, p32, g32, mu_sel, nu_sel, momentum=momentum,
        beta1=beta1, beta2=beta2, eps=eps, weight_decay=weight_decay)
    return (scatter_blocks3(w, new, idx, block),
            scatter_blocks3(mu, mu_new, idx, block) if mu_new is not None
            else None,
            scatter_blocks3(nu, nu_new, idx, block) if nu_new is not None
            else None)


def _keep(a, threshold: float, block: int):
    """[..., C] -> [..., C // block, 1] of 0 / 1 in a's dtype: 1 where the
    block's max |a| (NaN propagating) is at least the threshold."""
    ab = a.reshape(a.shape[:-1] + (a.shape[-1] // block, block))
    return (ab.abs().amax(dim=-1, keepdim=True) >= threshold).to(a.dtype)


def block_act_prune_ref(x, threshold: float = 0.15, block: int = 2):
    """x: [..., C] -> x with every `block`-wide channel run whose max |x| is
    below the threshold zeroed, as `x * keep` (the reference's oracle)."""
    xb = x.reshape(x.shape[:-1] + (x.shape[-1] // block, block))
    return (xb * _keep(x, threshold, block)).reshape(x.shape)


def block_act_prune_bwd_ref(dy, y, threshold: float = 0.15,
                            block: int = 2):
    """The gradient of `block_act_prune_ref` at its input, from its output
    y: dy * keep(y), which is dy * keep(x) (see the kernel source)."""
    dyb = dy.reshape(dy.shape[:-1] + (dy.shape[-1] // block, block))
    return (dyb * _keep(y, threshold, block)).reshape(dy.shape)

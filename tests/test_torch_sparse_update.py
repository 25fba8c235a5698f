"""The port's sparse matmul (both backward forms), block gather/scatter and
layer-stack split against the reference's `core.sparse_update`, on the same
numpy inputs."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from repro_torch.testing import limit_threads  # noqa: E402

limit_threads()
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import sparse_update as J  # noqa: E402
from repro_torch.core import sparse_update as P  # noqa: E402


def _sel_idx(rng, lead_shape, n_blocks, n_sel):
    flat = [rng.choice(n_blocks, n_sel, replace=False)
            for _ in range(int(np.prod(lead_shape)))]
    return np.stack(flat).reshape(lead_shape + (n_sel,)).astype(np.int32)


def _inputs(seed, n_shards, n_blocks, block, n_sel, lead=(3, 5), k=12):
    rng = np.random.default_rng(seed)
    n = n_shards * n_blocks * block
    x = rng.normal(size=lead + (k,)).astype(np.float32)
    w = rng.normal(size=(k, n)).astype(np.float32)
    cot = rng.normal(size=lead + (n,)).astype(np.float32)
    idx = _sel_idx(rng, (n_shards,), n_blocks, n_sel)
    return x, w, cot, idx


SHAPES = [(1, 4, 8, 1), (2, 3, 4, 2), (2, 5, 8, 3)]   # n_shards, nb, blk, n_sel


@pytest.mark.parametrize("n_shards,nb,blk,n_sel", SHAPES)
def test_smm_dense_scatter_grads_match_reference(n_shards, nb, blk, n_sel):
    """dx and the full-shape dW (zero outside the selection) against the
    reference's custom_vjp, fp32 within 1e-5 (matmul summation order)."""
    x, w, cot, idx = _inputs(n_shards * 10 + nb, n_shards, nb, blk, n_sel)
    jspec = J.SelSpec(block=blk, n_shards=n_shards, n_sel=n_sel, n_blocks=nb)
    jsel = ({"w": jnp.asarray(idx)}, {"w": jspec})

    def jloss(xx, ww):
        return jnp.sum(J.smm(xx, ww, jsel, "w") * cot)
    jdx, jdw = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))

    spec = P.SelSpec(*jspec)
    tx = torch.from_numpy(x).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    y = P.smm(tx, tw, ({"w": torch.from_numpy(idx)}, {"w": spec}), "w")
    torch.sum(y * torch.from_numpy(cot)).backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw), rtol=1e-5,
                               atol=1e-5)
    # outside the selection the weight gradient is exactly zero
    assert int((tw.grad != 0).sum()) <= x.shape[-1] * n_shards * n_sel * blk


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_shards,nb,blk,n_sel", SHAPES)
def test_smm_compact_grads_match_reference(dtype, n_shards, nb, blk, n_sel):
    """Compact backward: dx and dW_sel (the gradient of the gathered
    selected blocks, cast to the weight's dtype) against the reference.
    fp32 within 1e-5; bf16 within 2e-2 relative, since dx and dW_sel are
    rounded to bf16 and the two frameworks' bf16 matmuls sum in different
    orders before that rounding."""
    x, w, cot, idx = _inputs(n_shards * 20 + nb, n_shards, nb, blk, n_sel)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jspec = J.SelSpec(block=blk, n_shards=n_shards, n_sel=n_sel, n_blocks=nb)
    jw = jnp.asarray(w, jdt)
    jidx = jnp.asarray(idx)
    jwsel = J.gather_param_blocks(jw[None], jidx[None], jspec)[0]

    def jloss(xx, ws):
        y = J.smm(xx, jax.lax.stop_gradient(jw),
                  ({"w": jidx}, {"w": jspec}, {"w": ws}), "w")
        return jnp.sum(y.astype(jnp.float32) * cot)
    # XLA:CPU has no bf16 x bf16 -> f32 dot, so the reference's bf16 dW
    # runs through its Pallas kernel (interpret mode), which upcasts tiles
    with J.use_kernels(dtype == "bfloat16"):
        jdx, jdws = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x, jdt),
                                                    jwsel)

    spec = P.SelSpec(*jspec)
    tw = torch.from_numpy(w).to(tdt)
    tidx = torch.from_numpy(idx)
    wsel = P.gather_param_blocks(tw[None], tidx[None], spec)[0]
    wsel.requires_grad_(True)
    tx = torch.from_numpy(x).to(tdt).requires_grad_(True)
    y = P.smm(tx, tw, ({"w": tidx}, {"w": spec}, {"w": wsel}), "w")
    torch.sum(y.float() * torch.from_numpy(cot)).backward()
    assert wsel.grad.dtype == tdt and tuple(wsel.grad.shape) == \
        (x.shape[-1], n_shards, n_sel, blk)
    tol = 1e-5 if dtype == "float32" else 2e-2
    for got, want in ((tx.grad, jdx), (wsel.grad, jdws)):
        want = np.asarray(want, np.float32)
        np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                                   atol=tol * float(np.abs(want).max()))


def test_smm_without_selection_is_plain_matmul():
    x, w, _, _ = _inputs(0, 1, 4, 8, 1)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    for sel in (None, ({}, {}), (None, {})):
        assert torch.equal(P.smm(tx, tw, sel, "w"), tx @ tw)


@pytest.mark.parametrize("lead", [(), (2,)])
def test_gather_scatter_param_blocks_match_reference(lead):
    rng = np.random.default_rng(4)
    k, d, s, nb, blk, n_sel = 2, 6, 2, 4, 8, 3
    w = rng.normal(size=(k,) + lead + (d, s * nb * blk)).astype(np.float32)
    idx = _sel_idx(rng, (k, s), nb, n_sel)
    vals = rng.normal(size=(k,) + lead + (d, s, n_sel, blk)).astype(
        np.float32)
    jspec = J.SelSpec(block=blk, n_shards=s, n_sel=n_sel, n_blocks=nb)
    spec = P.SelSpec(*jspec)
    jg = J.gather_param_blocks(jnp.asarray(w), jnp.asarray(idx), jspec)
    tg = P.gather_param_blocks(torch.from_numpy(w), torch.from_numpy(idx),
                               spec)
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    js = J.scatter_param_blocks(jnp.asarray(w), jnp.asarray(vals),
                                jnp.asarray(idx), jspec)
    ts = P.scatter_param_blocks(torch.from_numpy(w), torch.from_numpy(vals),
                                torch.from_numpy(idx), spec)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    # round trip: scatter(gather(w)) == w
    back = P.scatter_param_blocks(torch.from_numpy(w), tg,
                                  torch.from_numpy(idx), spec)
    assert torch.equal(back, torch.from_numpy(w))


def test_map_selectable_and_gather_selected_tree():
    rng = np.random.default_rng(6)
    spec = P.SelSpec(block=4, n_shards=1, n_sel=1, n_blocks=2)
    stack = {"attn": {"wq": torch.from_numpy(
        rng.normal(size=(2, 3, 8)).astype(np.float32))},
        "attn_ln": {"scale": torch.ones(2, 3)}}
    spec_tree = {"blocks": {"attn": {"wq": spec}}}
    idx = {"blocks": {"attn": {"wq": torch.tensor([[[1]], [[0]]],
                                                  dtype=torch.int32)}}}
    mapped = P.map_selectable({"segments": {"blocks": stack}},
                              {"segments": spec_tree}, lambda a: a * 0)
    assert float(mapped["segments"]["blocks"]["attn"]["wq"].abs().sum()) == 0
    assert mapped["segments"]["blocks"]["attn_ln"]["scale"] is \
        stack["attn_ln"]["scale"]
    wsel = P.gather_selected_tree({"blocks": stack}, idx, spec_tree)
    got = wsel["blocks"]["attn"]["wq"]
    assert tuple(got.shape) == (2, 3, 1, 1, 4)
    assert torch.equal(got[0, :, 0, 0], stack["attn"]["wq"][0, :, 4:])
    assert torch.equal(got[1, :, 0, 0], stack["attn"]["wq"][1, :, :4])
    assert P.gather_selected_tree({"blocks": stack}, {"blocks": None},
                                  spec_tree) == {"blocks": None}


def test_selected_grad_targets_have_the_gathered_shape_and_no_storage():
    """The compact step's gradient targets: the shape and dtype of
    `gather_selected_tree`'s blocks, leaves requiring grad, every stride 0
    (one element of storage, whatever the shape)."""
    spec = P.SelSpec(block=4, n_shards=2, n_sel=1, n_blocks=3)
    stack = {"mlp": {"w_up": torch.zeros((2, 5, 24), dtype=torch.bfloat16)},
             "moe": {"w_gate": torch.zeros((2, 3, 5, 24))}}
    spec_tree = {"blocks": {"mlp": {"w_up": spec}, "moe": {"w_gate": spec}}}
    idx = {"blocks": {"mlp": {"w_up": torch.zeros((2, 2, 1),
                                                  dtype=torch.int32)},
                      "moe": {"w_gate": torch.zeros((2, 2, 1),
                                                    dtype=torch.int32)}}}
    want = P.gather_selected_tree({"blocks": stack}, idx, spec_tree)
    got = P.selected_grad_targets({"blocks": stack}, idx, spec_tree)
    for name in (("mlp", "w_up"), ("moe", "w_gate")):
        g = got["blocks"][name[0]][name[1]]
        w = want["blocks"][name[0]][name[1]]
        assert (g.shape, g.dtype) == (w.shape, w.dtype)
        assert g.is_leaf and g.requires_grad
        assert set(g.stride()) == {0} and g.untyped_storage().nbytes() == \
            g.element_size()
    assert P.selected_grad_targets({"blocks": stack}, {"blocks": None},
                                   spec_tree) == {"blocks": None}


@pytest.mark.parametrize("n_trainable", [0, 1, 2, 3, 5])
def test_split_merge_stack_match_reference(n_trainable):
    rng = np.random.default_rng(n_trainable)
    stack = {"a": rng.normal(size=(3, 4)).astype(np.float32),
             "b": {"c": rng.normal(size=(3, 2, 2)).astype(np.float32)}}
    jf, jt = J.split_stack(jax.tree.map(jnp.asarray, stack), n_trainable)
    tstack = jax.tree.map(torch.from_numpy, stack)
    tf, tt = P.split_stack(tstack, n_trainable)
    for jpart, tpart in ((jf, tf), (jt, tt)):
        assert (jpart is None) == (tpart is None)
        if jpart is not None:
            for a, b in zip(jax.tree.leaves(jpart), P.tree_leaves(tpart)):
                np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    merged = P.merge_stack(tf, tt)
    for a, b in zip(P.tree_leaves(merged), P.tree_leaves(tstack)):
        assert torch.equal(a, b)

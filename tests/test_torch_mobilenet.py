"""The port's MobileNetV2 + GroupNorm against the reference: the SAME-padding
conv, the selected-block `sconv` backward, GroupNorm, and the whole model's
loss and gradients, from the reference's own parameters (bridged) on the
same numpy images."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import mobilenetv2_cifar as JC  # noqa: E402
from repro.core.act_prune import make_act_pruner as jpruner  # noqa: E402
from repro.core.sparse_update import SelSpec as JSelSpec  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import mobilenet_v2 as JM  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import mobilenetv2_cifar as PC  # noqa: E402
from repro_torch.core.act_prune import make_act_pruner  # noqa: E402
from repro_torch.core.sparse_update import SelSpec, tree_leaves, tree_map  # noqa: E402
from repro_torch.models import layers as PL  # noqa: E402
from repro_torch.models import mobilenet_v2 as PM  # noqa: E402


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ---------------------------------------------------------------------------
# conv, sconv, GroupNorm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k,stride", [(1, 1), (3, 1), (3, 2), (1, 2)])
@pytest.mark.parametrize("h", [8, 7])
@pytest.mark.parametrize("depthwise", [False, True])
def test_same_padding_conv_matches_xla(k, stride, h, depthwise):
    """`conv` (F.pad with XLA's lo / hi split, then padding 0) against
    `jax.lax.conv_general_dilated(..., "SAME")`. At stride 2 on an even
    input XLA pads (0, 1): a symmetric padding=1 would shift every window.
    Tolerance 1e-5 of the largest output: fp32 sums of at most 9 * 16
    products in another order."""
    rng = np.random.default_rng(k * 100 + stride * 10 + h)
    c = 16
    x = rng.normal(size=(2, h, h + 1, c)).astype(np.float32)
    groups = c if depthwise else 1
    w = rng.normal(size=(k, k, c // groups, 24 if not depthwise else c)) \
        .astype(np.float32)
    want = JM._conv(jnp.asarray(x), jnp.asarray(w), stride, groups)
    got = PM.conv(_t(x), _t(w), stride, groups)
    assert tuple(got.shape) == want.shape and got.is_contiguous()
    assert _rel(got.numpy(), want) <= 1e-5
    if k == 3 and stride == 2 and h % 2 == 0:
        sym = torch.nn.functional.conv2d(
            _t(x).permute(0, 3, 1, 2), _t(w).permute(3, 2, 0, 1),
            stride=2, padding=1, groups=groups).permute(0, 2, 3, 1)
        assert sym.shape == got.shape and _rel(sym.numpy(), want) > 1e-2


@pytest.mark.parametrize("k,stride,h", [(1, 1, 6), (3, 2, 8), (3, 1, 5)])
def test_sconv_backward_matches_reference_vjp(k, stride, h):
    """dx (full) and dW (selected output-channel blocks, zeros elsewhere)
    of `sconv` against the reference's `_sconv` custom VJP: 1e-5 of the
    largest gradient (fp32 sums over B*H*W in another order); the
    unselected blocks of dW exactly zero on both sides."""
    rng = np.random.default_rng(k + stride + h)
    cin, block, nb, n_sel = 12, 4, 6, 2
    x = rng.normal(size=(2, h, h, cin)).astype(np.float32)
    w = rng.normal(size=(k, k, cin, nb * block)).astype(np.float32)
    idx = np.array([[4, 1]], np.int32)
    ho = -(-h // stride)
    dy = rng.normal(size=(2, ho, ho, nb * block)).astype(np.float32)
    jsel = ({"c/w": jnp.asarray(idx)},
            {"c/w": JSelSpec(block=block, n_shards=1, n_sel=n_sel,
                             n_blocks=nb)})
    _, vjp = jax.vjp(lambda a, b: JM.sconv(a, b, jsel, "c/w", stride),
                     jnp.asarray(x), jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(dy))
    psel = ({"c/w": _t(idx)},
            {"c/w": SelSpec(block=block, n_shards=1, n_sel=n_sel,
                            n_blocks=nb)})
    tx, tw = _t(x).requires_grad_(), _t(w).requires_grad_()
    y = PM.sconv(tx, tw, psel, "c/w", stride)
    dx, dw = torch.autograd.grad(y, (tx, tw), _t(dy))
    assert _rel(dx.numpy(), jdx) <= 1e-5
    assert _rel(dw.numpy(), jdw) <= 1e-5
    mask = np.zeros((nb, block), bool)
    mask[idx[0]] = True
    dwb = dw.numpy().reshape(k, k, cin, nb, block)
    assert (dwb[..., ~mask] == 0).all()
    assert (np.asarray(jdw).reshape(k, k, cin, nb, block)[..., ~mask] == 0) \
        .all()


def test_sconv_ignores_wsel_and_depthwise():
    """A (idx, spec, wsel) selection and a depthwise conv both take the
    dense path, as in the reference."""
    rng = np.random.default_rng(0)
    x = _t(rng.normal(size=(1, 4, 4, 8)).astype(np.float32))
    w = _t(rng.normal(size=(3, 3, 1, 8)).astype(np.float32))
    sel = ({"d/w": torch.tensor([[0]], dtype=torch.int32)},
           {"d/w": SelSpec(block=4, n_shards=1, n_sel=1, n_blocks=2)}, None)
    torch.testing.assert_close(PM.sconv(x, w, sel, "d/w", groups=8),
                               PM.conv(x, w, groups=8), rtol=0, atol=0)


def test_group_norm_matches_reference():
    """fp32 statistics over (H, W, C/g), eps 1e-5: 1e-5 relative."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 5, 5, 16)).astype(np.float32) * 3 + 1
    p = {"scale": rng.normal(size=16).astype(np.float32),
         "bias": rng.normal(size=16).astype(np.float32)}
    want = JL.apply_group_norm({k: jnp.asarray(v) for k, v in p.items()},
                               jnp.asarray(x), 4)
    got = PL.apply_group_norm({k: _t(v) for k, v in p.items()}, _t(x), 4)
    assert _rel(got.numpy(), want) <= 1e-5
    init = PL.init_group_norm(16, torch.float32, "cpu")
    assert init["scale"].eq(1).all() and init["bias"].eq(0).all()


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _cfgs(full: bool):
    if full:   # CONFIG's full widths at a CPU-sized image
        return (dataclasses.replace(JC.CONFIG, img_size=32),
                dataclasses.replace(PC.CONFIG, img_size=32))
    return JC.smoke_config(), PC.smoke_config()


@functools.lru_cache(maxsize=None)
def _jparams(full: bool):
    """The reference's init (seed 1), jitted: eager it takes ~14 s at
    full width on the CPU."""
    jcfg, _ = _cfgs(full)
    return jax.device_get(jax.jit(JM.init_params, static_argnums=0)(
        jcfg, jax.random.PRNGKey(1)))


def test_configs_and_names_match_reference():
    for full in (False, True):
        jcfg, pcfg = _cfgs(full)
        assert dataclasses.asdict(jcfg) == dataclasses.asdict(pcfg)
        assert PM.conv_layer_names(pcfg) == JM.conv_layer_names(jcfg)


@pytest.mark.parametrize("full", [False, True], ids=["smoke", "full_width"])
def test_init_params_layout_matches_reference(full):
    """The port's init (its own generator) gives the reference's tree,
    shapes and dtypes; conv weights truncated at 2 std of gain 0.5."""
    jcfg, pcfg = _cfgs(full)
    jp = jax.eval_shape(lambda: JM.init_params(jcfg, jax.random.PRNGKey(0)))
    pp = bridge.to_numpy(
        PM.init_params(pcfg, torch.Generator().manual_seed(0)))
    assert jax.tree.structure(jp) == jax.tree.structure(pp)
    for j, p in zip(jax.tree.leaves(jp), jax.tree.leaves(pp)):
        assert p.shape == j.shape and p.dtype == np.float32
    pp = bridge.to_torch(pp)
    w = pp["head"]["w"]
    bound = 2 * (0.5 / (w.shape[0] * w.shape[1] * w.shape[2])) ** 0.5
    assert float(w.abs().max()) <= bound and float(w.std()) > 0.5 * bound / 2


def test_prune_sites_are_the_activations_forward_prunes():
    """`prune_sites` lists exactly the tensors `forward` hands to
    act_prune, in order, with their shapes; at CONFIG and 224 x 224 they
    are the 35 sites and 6,105,792 elements an image."""
    _, pcfg = _cfgs(False)
    seen = []
    params = PM.init_params(pcfg, torch.Generator().manual_seed(0))
    x = torch.zeros(1, pcfg.img_size, pcfg.img_size, 3)
    PM.forward(pcfg, (None, params), x,
               act_prune=lambda v: seen.append(tuple(v.shape[1:])) or v)
    sites = PM.prune_sites(pcfg, pcfg.img_size)
    assert [s for _, s in sites] == seen
    full = PM.prune_sites(PC.CONFIG, 224)
    assert len(full) == 35
    assert sum(h * w * c for _, (h, w, c) in full) == 6_105_792
    assert [n for n, _ in full[-5:]] == ["b15/expand/w", "b15/dw/w",
                                         "b16/expand/w", "b16/dw/w",
                                         "head/w"]


def _selection(jcfg, jparams, last_k=6, ratio=0.2, block=4):
    """Random selections of the last-K convs, for both packages."""
    rng = np.random.default_rng(11)
    jidx, jspec, pidx, pspec = {}, {}, {}, {}
    for name in JM.conv_layer_names(jcfg)[-last_k:]:
        node = jparams
        for part in name.split("/"):
            node = node[part]
        out = node.shape[-1]
        blk = block if out % block == 0 else 1
        nb = out // blk
        ns = max(1, int(round(ratio * nb)))
        sel = rng.choice(nb, ns, replace=False).astype(np.int32)[None]
        jidx[name], pidx[name] = jnp.asarray(sel), _t(sel)
        jspec[name] = JSelSpec(block=blk, n_shards=1, n_sel=ns, n_blocks=nb)
        pspec[name] = SelSpec(block=blk, n_shards=1, n_sel=ns, n_blocks=nb)
    return (jidx, jspec), (pidx, pspec)


def _trainable_keys(jcfg, last_k=6):
    keys = {n.split("/")[0] for n in JM.conv_layer_names(jcfg)[-last_k:]}
    return keys | {"classifier"}


def _prune_flips(pcfg, params, images, thr=0.15, blk=2, margin=1e-5):
    """Blocks of the port's forward whose max |x| lies within `margin`
    (relative) of the threshold: the ones a one-ulp difference between
    the frameworks could flip."""
    n = [0]

    def probe(v):
        m = v.reshape(v.shape[:-1] + (v.shape[-1] // blk, blk)).abs() \
            .amax(-1)
        n[0] += int(((m - thr).abs() <= margin * thr).sum())
        return make_act_pruner(thr, blk)(v)
    with torch.no_grad():
        PM.forward(pcfg, (None, params), images, act_prune=probe)
    return n[0]


@pytest.mark.parametrize("full,prune_on,sel_on", [
    (False, False, False), (False, True, False), (False, False, True),
    (False, True, True), (True, False, False), (True, True, True)],
    ids=["smoke-dense", "smoke-prune", "smoke-selected",
         "smoke-prune-selected", "full_width-dense",
         "full_width-prune-selected"])
def test_loss_and_grads_match_reference(full, prune_on, sel_on):
    """loss_fn's value, accuracy and gradients with respect to the last-K
    blocks and the classifier (the fixed / dynamic split), from the
    reference's init, against jax.value_and_grad. Tolerances: loss 1e-5
    absolute, gradients 1e-4 of each leaf's largest entry (fp32 convs and
    GroupNorm statistics summed in another order, through 17 blocks).
    With pruning on, a block whose max sits within 1e-5 of the threshold
    could flip between the frameworks: their count is asserted to be 0,
    so a failure here shows a flip, not a loosened tolerance."""
    jcfg, pcfg = _cfgs(full)
    b = 2 if full else 4
    jparams = _jparams(full)
    rng = np.random.default_rng(5)
    images = rng.normal(size=(b, jcfg.img_size, jcfg.img_size, 3)) \
        .astype(np.float32)
    labels = rng.integers(0, 10, b).astype(np.int32)
    keys = _trainable_keys(jcfg)
    jtr = {k: v for k, v in jparams.items() if k in keys}
    jfr = {k: v for k, v in jparams.items() if k not in keys}
    jsel, psel = _selection(jcfg, jparams) if sel_on else (None, None)
    jap_ = jpruner(0.15, 2) if prune_on else None
    pap_ = make_act_pruner(0.15, 2) if prune_on else None
    jb = {"images": jnp.asarray(images), "labels": jnp.asarray(labels)}
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda tr: JM.loss_fn(jcfg, (jfr, tr), jb, sel=jsel,
                              act_prune=jap_), has_aux=True))(jtr)

    pfr, ptr = bridge.to_torch(jax.device_get(jfr)), \
        bridge.to_torch(jax.device_get(jtr))
    if prune_on:
        assert _prune_flips(pcfg, {**pfr, **ptr}, _t(images)) == 0
    leaves = [t.requires_grad_() for t in tree_leaves(ptr)]
    pl, pm = PM.loss_fn(pcfg, (pfr, ptr),
                        {"images": _t(images), "labels": _t(labels)},
                        sel=psel, act_prune=pap_)
    pg = torch.autograd.grad(pl, leaves)
    assert float(pl.detach()) == pytest.approx(float(jl), abs=1e-5)
    assert float(pm["acc"]) == float(jm["acc"])
    jleaves = jax.tree.leaves(jax.device_get(jg))
    assert len(jleaves) == len(pg)
    for want, got in zip(jleaves, pg):
        assert _rel(got.numpy(), want) <= 1e-4
        if sel_on:   # exact zeros (unselected blocks) agree exactly
            assert np.array_equal(got.numpy() == 0, np.asarray(want) == 0)

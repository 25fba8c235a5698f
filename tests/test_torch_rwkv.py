"""The port's RWKV-6 model against the reference's on the rwkv6-3b smoke
config: time mix and channel mix with bridged parameters, the full model's
loss (f32 tight, bf16 loose), and the parameter tree's layout; plus the
serving forms (a cache, per-row lengths) against the reference's. The
train step is `test_torch_rwkv_train.py`."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from repro_torch.testing import limit_threads  # noqa: E402

limit_threads()
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_full  # noqa: E402
from repro.configs import get_smoke_config as jget  # noqa: E402
from repro.models import rwkv6 as JR  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.models import rwkv6 as PR  # noqa: E402
from repro_torch.models import transformer as PT  # noqa: E402

ARCH = "rwkv6-3b"


def _x(cfg, seed, b=2, s=32):
    return (np.random.default_rng(seed).normal(size=(b, s, cfg.d_model))
            * 0.5).astype(np.float32)


def _batch(seed=3, b=2, s=32):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, 256, (b, s)).astype(np.int32),
            "labels": rng.integers(0, 256, (b, s)).astype(np.int32)}


@pytest.mark.parametrize("mix", ["time", "chan"])
def test_mix_matches_reference(mix):
    """f32: the port's block against the reference's on its own params;
    the decay LoRA, ln_x and the WKV recurrence in fp32 on both sides."""
    cfg, pcfg = jget(ARCH), get_smoke_config(ARCH)
    init, japply, papply = {
        "time": (JR.init_time_mix, JR.apply_time_mix, PR.apply_time_mix),
        "chan": (JR.init_channel_mix, JR.apply_channel_mix,
                 PR.apply_channel_mix)}[mix]
    p = init(jax.random.PRNGKey(1), cfg, jnp.float32)
    x = _x(cfg, seed=2)
    want, _ = japply(p, cfg, jnp.asarray(x))
    got, cache = papply(bridge.to_torch(jax.device_get(p)), pcfg,
                        torch.from_numpy(x))
    assert cache is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_param_tree_matches_reference_layout():
    """Same keys, shapes and dtypes as the reference's tree (smoke and, on
    the meta device, full width: 32 x (time, channel mix) and ln0), so a
    bridged tree means the same model."""
    for cfg_j, cfg_p in ((jget(ARCH), get_smoke_config(ARCH)),
                         (None, get_config(ARCH))):
        port = PT.init_params(cfg_p, 0, "meta" if cfg_j is None else "cpu")
        if cfg_j is None:
            want = jax.eval_shape(lambda: JT.init_params(
                jget_full(ARCH), jax.random.PRNGKey(0)))
        else:
            want = JT.init_params(cfg_j, jax.random.PRNGKey(0))
        flat_p = jax.tree_util.tree_flatten_with_path(
            jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype).split(".")[-1]),
                         port, is_leaf=lambda t: isinstance(t, torch.Tensor)))
        flat_j = jax.tree_util.tree_flatten_with_path(
            jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), want))
        assert flat_p[1] == flat_j[1]
        assert [v for _, v in flat_p[0]] == [v for _, v in flat_j[0]]
    n = sum(t.numel() for t in jax.tree.leaves(
        port, is_leaf=lambda t: isinstance(t, torch.Tensor)))
    assert 3.0e9 < n < 3.2e9     # ~3.07 B parameters


@pytest.mark.parametrize("dtype,tol", [
    ("float32", 1e-5),
    # bf16 activations round at other places in the two frameworks (the
    # mixes, silu, the residual adds): the llama bound of
    # test_torch_model.py (seen: up to 1.6e-3 over three seeds)
    ("bfloat16", 2e-2),
])
def test_loss_matches_reference(dtype, tol):
    cfg = dataclasses.replace(jget(ARCH), dtype=dtype)
    pcfg = dataclasses.replace(get_smoke_config(ARCH), dtype=dtype)
    params = JT.init_params(cfg, jax.random.PRNGKey(0))
    batch = _batch()
    want, jm = JT.loss_fn(cfg, (params, None),
                          {k: jnp.asarray(v) for k, v in batch.items()})
    got, pm = PT.loss_fn(pcfg, (bridge.to_torch(jax.device_get(params)),
                                None),
                         {k: torch.from_numpy(v) for k, v in batch.items()})
    assert float(got) == pytest.approx(float(want), abs=tol)
    assert float(pm["load_balance"]) == float(jm["load_balance"]) == 0.0


def test_forward_hidden_matches_reference_f32():
    cfg, pcfg = jget(ARCH), get_smoke_config(ARCH)
    params = JT.init_params(cfg, jax.random.PRNGKey(4))
    tokens = _batch(seed=5)["tokens"]
    want, _ = JT.forward(cfg, (params, None), {"tokens": jnp.asarray(tokens)})
    got, aux = PT.forward(pcfg, (bridge.to_torch(jax.device_get(params)),
                                 None), {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert not aux.any()


def test_serving_forms_refuse_with_their_roadmap_item():
    """The serving forms against the reference's: each mix from a nonzero
    cache over a chunk of 16 with per-row valid lengths (one row padded:
    k = 0 and w = 1 on its padded steps, `last` at its valid end), then a
    one-token step from that cache; outputs and every cache leaf. A head
    block (narrower matrices) off a process mesh refuses: its collectives
    would be skipped."""
    cfg, pcfg = jget(ARCH), get_smoke_config(ARCH)
    rng = np.random.default_rng(6)
    h, hd, d = JR.num_heads(cfg), cfg.rwkv.head_dim, cfg.d_model
    length = np.array([16, 5], np.int32)
    valid = np.arange(16)[None, :] < length[:, None]
    for mix, init, japply, papply in (
            ("time", JR.init_time_mix, JR.apply_time_mix, PR.apply_time_mix),
            ("chan", JR.init_channel_mix, JR.apply_channel_mix,
             PR.apply_channel_mix)):
        p = jax.device_get(init(jax.random.PRNGKey(1), cfg, jnp.float32))
        tp = bridge.to_torch(p)
        cache = {"last": rng.normal(size=(2, d)).astype(np.float32)}
        if mix == "time":
            cache["s"] = (0.3 * rng.normal(size=(2, h, hd, hd))).astype(
                np.float32)
        jc, pc = jax.tree.map(jnp.asarray, cache), bridge.to_torch(cache)
        for x, ln in ((_x(cfg, 7, s=16), length), (_x(cfg, 8, s=1), None)):
            want, jc = japply(p, cfg, jnp.asarray(x), cache=jc,
                              length=None if ln is None else jnp.asarray(ln))
            got, pc = papply(tp, pcfg, torch.from_numpy(x), cache=pc,
                             length=None if ln is None
                             else torch.from_numpy(ln))
            keep = valid if ln is not None else np.ones((2, 1), bool)
            np.testing.assert_allclose(got.numpy()[keep],
                                       np.asarray(want)[keep], rtol=1e-5,
                                       atol=1e-5, err_msg=mix)
            assert sorted(pc) == sorted(jc)
            for key in jc:
                np.testing.assert_allclose(pc[key].numpy(),
                                           np.asarray(jc[key]), rtol=1e-5,
                                           atol=1e-5, err_msg=f"{mix} {key}")
    layer = jax.tree.map(lambda t: t[0], PT.init_params(pcfg, 0, "cpu")[
        "segments"]["blocks"], is_leaf=lambda t: isinstance(t, torch.Tensor))
    narrow = dict(layer["time"], wr=layer["time"]["wr"][:, :16])
    with pytest.raises(ValueError, match="arrived sharded"):
        PR.apply_time_mix(narrow, pcfg, torch.zeros(1, 4, pcfg.d_model))


def test_other_recurrent_and_hybrid_families_still_refuse():
    """gemma3, jamba and rwkv6 lay out their serving caches now (parity in
    tests/test_torch_serve_families.py): rings for gemma's local layers
    and pools for its global ones, mamba state and one paged attention
    layer for jamba, recurrent state and no pages for rwkv, on the full
    configs (meta device). Embedding inputs and M-RoPE lay out as the
    dense family, on the smoke and the full configs, and an
    embedding-input model has no token table unless its head is tied."""
    from repro_torch.models import decoding as PD
    for arch, kinds, paged in (("gemma3-4b", ("gemma_super", "dense"), True),
                               ("jamba-1.5-large-398b", ("jamba_super",),
                                True),
                               ("rwkv6-3b", ("rwkv",), False)):
        cfg = get_config(arch)
        assert tuple(s.kind for s in PT.segment_layout(cfg)) == kinds
        assert PD.has_paged_layers(cfg) is paged
        assert PD.has_state_layers(cfg) is True
        cache = PD.init_cache(cfg, 1, 16, device="meta")
        state, pools = PD.init_serve_cache(cfg, 1, 16, 1, 16, device="meta")
        assert sorted(cache) == sorted(state) == sorted(pools) == \
            [s.name for s in PT.segment_layout(cfg)]
        assert bool(jax.tree.leaves(pools)) is paged
    base = get_smoke_config("llama3-8b")
    for kw in ({"embed_inputs": True}, {"mrope": True},
               {"embed_inputs": True, "tie_embeddings": True}):
        cfg = dataclasses.replace(base, **kw)
        assert [tuple(s) for s in PT.segment_layout(cfg)] == \
            [("blocks", base.num_layers, "dense", 1)]
        params = PT.init_params(cfg, 0, "meta")
        assert ("embed" in params) == (not cfg.embed_inputs
                                       or cfg.tie_embeddings)
    for arch in ("musicgen-medium", "qwen2-vl-7b"):
        for cfg in (get_smoke_config(arch), get_config(arch)):
            assert [s.kind for s in PT.segment_layout(cfg)] == ["dense"]

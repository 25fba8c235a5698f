"""The port's dense decoder LM against the reference on the llama3 smoke
config: the same params (the reference's init, bridged) and the same numpy
batch through `forward` and `loss_fn` on both sides, plus the layers the
model is built from."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.core.sparse_update import split_stack as jsplit  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.registry import abstract_params as jabstract  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.core.sparse_update import split_stack  # noqa: E402
from repro_torch.models import layers as PL  # noqa: E402
from repro_torch.models import transformer as PT  # noqa: E402
from repro_torch.models.registry import abstract_params  # noqa: E402


def _setup(dtype: str, seed: int = 0, b: int = 2, s: int = 16):
    jcfg = dataclasses.replace(jget_smoke("llama3-8b"), dtype=dtype)
    pcfg = dataclasses.replace(get_smoke_config("llama3-8b"), dtype=dtype)
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, 256, (b, s)).astype(np.int32),
             "labels": rng.integers(0, 256, (b, s)).astype(np.int32)}
    return jcfg, pcfg, jparams, bridge.to_torch(jax.device_get(jparams)), \
        batch


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("dtype,tol", [
    ("float32", 1e-5),
    # bf16: both sides round activations to bf16 after every matmul, norm
    # and residual add, in different summation orders; over 3 layers the
    # hidden state agrees to a few bf16 ulps (2^-8 relative each) of its
    # largest value
    ("bfloat16", 2e-2),
])
@pytest.mark.parametrize("trainable_layers", [0, 2])
def test_forward_and_loss_match_reference(dtype, tol, trainable_layers):
    """forward (hidden states) and loss_fn (CE) against the reference, with
    the layer stack whole or split into a frozen prefix and a trainable
    suffix (the prefix runs under no_grad here)."""
    jcfg, pcfg, jparams, tparams, batch = _setup(dtype)
    if trainable_layers:
        jf, jt = jsplit(jparams["segments"]["blocks"], trainable_layers)
        tf, tt = split_stack(tparams["segments"]["blocks"], trainable_layers)
        jpair = ({**jparams, "segments": {"blocks": jf}},
                 {"segments": {"blocks": jt}})
        tpair = ({**tparams, "segments": {"blocks": tf}},
                 {"segments": {"blocks": tt}})
    else:
        jpair, tpair = (jparams, None), (tparams, None)
    (jh, _), (jl, jm) = jax.jit(lambda p, bt: (
        JT.forward(jcfg, p, bt), JT.loss_fn(jcfg, p, bt)))(jpair,
                                                           _jbatch(batch))
    th, taux = PT.forward(pcfg, tpair, _tbatch(batch))
    assert th.dtype == getattr(torch, dtype)
    assert torch.equal(taux, torch.zeros(2))    # the dense family: no aux
    jh32 = np.asarray(jh, np.float32)
    np.testing.assert_allclose(th.float().numpy(), jh32, rtol=tol,
                               atol=tol * float(np.abs(jh32).max()))
    tl, tm = PT.loss_fn(pcfg, tpair, _tbatch(batch))
    assert tl.dtype == torch.float32
    assert float(tl) == pytest.approx(float(jl), rel=tol)
    assert float(tm["ce"]) == pytest.approx(float(jm["ce"]), rel=tol)
    assert torch.equal(tl, tm["ce"])            # + zero aux, bitwise
    assert float(tm["load_balance"]) == float(tm["router_z"]) == 0.0


@pytest.mark.parametrize("window", [0, 3])
def test_sdpa_dense_masks_match_reference(window):
    """Causal and sliding-window attention (GQA 4 query heads on 2 kv
    heads) against the reference, fp32 within 1e-5."""
    rng = np.random.default_rng(window)
    q = rng.normal(size=(2, 9, 4, 8)).astype(np.float32)
    k = rng.normal(size=(2, 9, 2, 8)).astype(np.float32)
    v = rng.normal(size=(2, 9, 2, 8)).astype(np.float32)
    want = np.asarray(JL._sdpa_dense(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), window))
    got = PL._sdpa_dense(torch.from_numpy(q), torch.from_numpy(k),
                         torch.from_numpy(v), window).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_attention_reach_is_causal_and_windowed():
    """Perturbing token t changes no output before t, and with a window w
    none at or after t + w."""
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.normal(size=(1, 10, 2, 4)).astype(np.float32))
    kv = torch.from_numpy(rng.normal(size=(1, 10, 2, 4)).astype(np.float32))
    for window in (0, 3):
        base = PL._sdpa_dense(q, kv, kv, window)
        kv2 = kv.clone()
        kv2[0, 4] += 1.0
        moved = (PL._sdpa_dense(q, kv2, kv2, window) - base).abs() \
            .amax(dim=(0, 2, 3)) > 0
        assert not moved[:4].any()
        assert moved[4]
        if window:
            assert not moved[4 + window:].any()


def test_gqa_expansion_matches_reference():
    rng = np.random.default_rng(2)
    k = rng.normal(size=(1, 3, 2, 4)).astype(np.float32)
    want = np.asarray(JL._expand_kv(jnp.asarray(k), 6))
    got = PL._expand_kv(torch.from_numpy(k), 6).numpy()
    np.testing.assert_array_equal(got, want)


def test_rope_and_norms_match_reference():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 5, 3, 8)).astype(np.float32)
    pos = np.tile(np.arange(5, dtype=np.int32), (2, 1))
    want = np.asarray(JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 5e5))
    got = PL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 5e5)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    h = rng.normal(size=(2, 5, 8)).astype(np.float32)
    scale = rng.normal(size=(8,)).astype(np.float32)
    bias = rng.normal(size=(8,)).astype(np.float32)
    for p in ({"scale": scale}, {"scale": scale, "bias": bias}):
        want = np.asarray(JL.apply_norm(jax.tree.map(jnp.asarray, p),
                                        jnp.asarray(h)))
        got = PL.apply_norm(bridge.to_torch(p), torch.from_numpy(h))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("full", [False, True], ids=["smoke", "full"])
def test_param_tree_matches_reference_shapes(full):
    """init_params on the meta device has the reference's keys, shapes and
    dtypes (eval_shape there), at the smoke and the full config."""
    jcfg = jget_config("llama3-8b") if full else jget_smoke("llama3-8b")
    pcfg = get_config("llama3-8b") if full else get_smoke_config("llama3-8b")
    want = jabstract(jcfg)
    got = abstract_params(pcfg)

    def walk(a, b):
        assert set(a) == set(b)
        for key in a:
            if isinstance(a[key], dict):
                walk(a[key], b[key])
            else:
                assert tuple(b[key].shape) == tuple(a[key].shape), key
                assert str(b[key].dtype).split(".")[-1] == str(a[key].dtype)
                assert b[key].device.type == "meta"
    walk(want, got)


def test_init_params_is_seeded_and_scaled():
    cfg = get_smoke_config("llama3-8b")
    a = PT.init_params(cfg, seed=3, device="cpu")
    b = PT.init_params(cfg, seed=3, device="cpu")
    c = PT.init_params(cfg, seed=4, device="cpu")
    wq = a["segments"]["blocks"]["attn"]["wq"]
    assert torch.equal(wq, b["segments"]["blocks"]["attn"]["wq"])
    assert not torch.equal(wq, c["segments"]["blocks"]["attn"]["wq"])
    assert not torch.equal(wq[0], wq[1])        # layers drawn independently
    # truncated normal at +-2 std, std = 1/sqrt(fan_in)
    assert float(wq.abs().max()) <= 2.0 / cfg.d_model ** 0.5 + 1e-6
    assert float(a["embed"]["tok"].std()) == pytest.approx(0.02, rel=0.1)


def test_attention_refuses_sequences_past_the_dense_path():
    """Past 2048 tokens attention takes the flash path, whose chunks of 512
    must divide the sequence: 2049 raises the chunk rule's ValueError, 2560
    runs and agrees with the dense path (f32, 1e-5)."""
    cfg = get_smoke_config("llama3-8b")
    params = PT.init_params(cfg, seed=0, device="cpu")
    p = {k: v[0] for k, v in params["segments"]["blocks"]["attn"].items()}
    x = torch.zeros(1, 2049, cfg.d_model)
    with pytest.raises(ValueError, match="equal, dividing chunks"):
        PL.attention(p, cfg, x, torch.arange(2049)[None])
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(1, 2560, cfg.d_model)).astype(np.float32))
    pos = torch.arange(2560)[None]
    got = PL.attention(p, cfg, x, pos)
    want = PL.attention(p, cfg, x, pos, flash_threshold=4096)
    assert got.shape == (1, 2560, cfg.d_model)
    assert float((got - want).abs().max()) <= 1e-5

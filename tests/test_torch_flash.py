"""The port's diagonal-block flash attention (`layers._sdpa_flash`) against
the reference's `_sdpa_flash` and `_sdpa_dense`, at the reference test's
size (batch 2, seq 512, 4 query / 2 KV heads of 16, chunks of 128), with
and without a window; its custom backward against plain autograd through
its forward loop (`naive_vjp=True`); and the port's shape grid against the
reference's.

Tolerances: the reference test's own, 1e-4 / 1e-5 on the output and
1e-3 / 1e-4 on the gradients (f32, sums in another order); bf16 at 2^-6
of the largest value (the probabilities and the output round to bf16,
2^-8 relative each, in another order of sums)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch import configs as PC  # noqa: E402
from repro_torch.models import layers as PL  # noqa: E402

B, S, HQ, HKV, D, C = 2, 512, 4, 2, 16, 128


def _qkv(seed=0, s=S, hq=HQ, hkv=HKV, d=D):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, s, h, d)).astype(np.float32)
            for h in (hq, hkv, hkv)]


def _torch(arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype).requires_grad_() for a in arrays]


def _sq_grads(fn, tensors):
    out = fn(*tensors)
    (out.float() ** 2).sum().backward()
    return out.detach(), [t.grad for t in tensors]


def _ref_grads(fn, arrays):
    return jax.grad(lambda q, k, v: (fn(q, k, v) ** 2).sum(),
                    argnums=(0, 1, 2))(*(jnp.asarray(a) for a in arrays))


@pytest.mark.parametrize("window", [0, 100])
def test_flash_matches_reference_flash_and_dense(window):
    """Forward and the gradients of (out²).sum() for q, k and v: the port's
    flash against the reference's flash and the reference's dense."""
    arrays = _qkv()
    out, grads = _sq_grads(
        lambda q, k, v: PL._sdpa_flash(q, k, v, window, C, C), _torch(arrays))
    jq = [jnp.asarray(a) for a in arrays]
    refs = {
        "flash": (JL._sdpa_flash(*jq, window, C, C),
                  _ref_grads(lambda q, k, v: JL._sdpa_flash(q, k, v, window,
                                                            C, C), arrays)),
        "dense": (JL._sdpa_dense(*jq, window),
                  _ref_grads(lambda q, k, v: JL._sdpa_dense(q, k, v, window),
                             arrays)),
    }
    for name, (want, want_g) in refs.items():
        np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-5, err_msg=name)
        for g, wg in zip(grads, want_g):
            np.testing.assert_allclose(g.numpy(), np.asarray(wg), rtol=1e-3,
                                       atol=1e-4, err_msg=name)


@pytest.mark.parametrize("window", [0, 100])
def test_flash_forward_state_matches_reference(window):
    """`_flash_fwd_impl` on expanded heads: the output and the per-row
    log-sum-exp (the port keeps it [B, H, n, c], the reference
    [B, n, c, H])."""
    q, k, v = _qkv(seed=1)
    jk, jv = (JL._expand_kv(jnp.asarray(a), HQ) for a in (k, v))
    jo, jl = JL._flash_fwd_impl(jnp.asarray(q), jk, jv, window, C)
    pk, pv = (PL._expand_kv(torch.from_numpy(a), HQ) for a in (k, v))
    po, pl = PL._flash_fwd_impl(torch.from_numpy(q), pk, pv, window, C)
    np.testing.assert_allclose(po.numpy(), np.asarray(jo), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(pl.permute(0, 2, 3, 1).numpy(),
                               np.asarray(jl), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 100])
def test_custom_backward_matches_naive_vjp(window, dtype):
    """The recomputing backward against autograd through the forward loop:
    the same forward bitwise; gradients within 1e-5 in f32 (the same
    products summed in another order) and within 2^-6 of the largest
    gradient in bf16 (q, k, v's gradients round to bf16 on both sides, p and
    ds round to bf16 only in the custom one)."""
    dt = getattr(torch, dtype)
    arrays = _qkv(seed=2)
    out, grads = _sq_grads(
        lambda q, k, v: PL._sdpa_flash(q, k, v, window, C, C),
        _torch(arrays, dt))
    out_n, grads_n = _sq_grads(
        lambda q, k, v: PL._sdpa_flash(q, k, v, window, C, C,
                                       naive_vjp=True), _torch(arrays, dt))
    assert torch.equal(out, out_n)
    for g, gn in zip(grads, grads_n):
        assert g.dtype == dt
        tol = 1e-5 if dtype == "float32" else \
            2.0 ** -6 * float(gn.float().abs().max())
        assert float((g.float() - gn.float()).abs().max()) <= tol


def test_bf16_flash_against_dense_and_reference():
    """bf16 in, bf16 out: within 2^-6 of the largest value of the port's
    dense path and of the reference's flash on the same bf16 inputs."""
    arrays = _qkv(seed=3)
    t = [torch.from_numpy(a).bfloat16() for a in arrays]
    fl = PL._sdpa_flash(*t, 0, C, C)
    assert fl.dtype == torch.bfloat16
    dn = PL._sdpa_dense(*t, 0)
    ref = JL._sdpa_flash(*(jnp.asarray(a, jnp.bfloat16) for a in arrays),
                         0, C, C)
    scale = float(dn.float().abs().max())
    assert float((fl.float() - dn.float()).abs().max()) <= 2.0 ** -6 * scale
    assert float(np.abs(fl.float().numpy()
                        - np.asarray(ref, np.float32)).max()) \
        <= 2.0 ** -6 * scale


def test_window_truncates_the_diagonals_and_the_reach():
    """Under a window only the first ceil(window / c) + 1 diagonals are
    computed (gemma3-4b's local layers at seq 4096: 3 of 8); a key beyond
    the window reaches no query, as in the reference's reach test."""
    assert PL._max_diag(8, 512, 1024) == 3
    assert PL._max_diag(8, 512, 0) == 8
    assert PL._max_diag(4, 128, 100) == 2
    arrays = _qkv(seed=4)
    t = [torch.from_numpy(a) for a in arrays]
    out1 = PL._sdpa_flash(*t, 100, C, C)
    k2, v2 = t[1].clone(), t[2].clone()
    k2[:, 0], v2[:, 0] = 100.0, -100.0
    out2 = PL._sdpa_flash(t[0], k2, v2, 100, C, C)
    assert torch.allclose(out1[:, 100:], out2[:, 100:], rtol=1e-5,
                          atol=1e-5)
    assert float((out1[:, 0] - out2[:, 0]).abs().max()) > 1.0


def test_short_sequences_take_the_dense_path():
    """s <= q_chunk: the dense path itself, bitwise."""
    arrays = _qkv(seed=5, s=128)
    t = [torch.from_numpy(a) for a in arrays]
    assert torch.equal(PL._sdpa_flash(*t, 0, C, C), PL._sdpa_dense(*t, 0))


@pytest.mark.parametrize("s,chunks", [(576, (128, 128)), (512, (128, 256)),
                                      (768, (256, 128))])
def test_non_dividing_chunks_raise(s, chunks):
    t = [torch.from_numpy(a) for a in _qkv(seed=6, s=s)]
    with pytest.raises(ValueError, match="equal, dividing chunks"):
        PL._sdpa_flash(*t, 0, *chunks)
    with pytest.raises(AssertionError, match="equal, dividing chunks"):
        JL._sdpa_flash(*(jnp.asarray(a) for a in _qkv(seed=6, s=s)), 0,
                       *chunks)


# ---------------------------------------------------------------------------
# the shape grid
# ---------------------------------------------------------------------------

def test_shape_grid_matches_reference():
    """SHAPES, LONG_CONTEXT_ARCHS, ARCH_IDS, all_cells and cell_is_skipped
    on every cell, field for field."""
    assert {n: (s.name, s.seq_len, s.global_batch, s.kind)
            for n, s in PC.SHAPES.items()} == \
        {n: (s.name, s.seq_len, s.global_batch, s.kind)
         for n, s in JC.SHAPES.items()}
    assert PC.ARCH_IDS == JC.ARCH_IDS
    assert PC.LONG_CONTEXT_ARCHS == JC.LONG_CONTEXT_ARCHS
    assert PC.all_cells() == JC.all_cells()
    assert len(PC.all_cells()) == 40
    for arch, shape in JC.all_cells():
        assert PC.cell_is_skipped(arch, shape) == \
            JC.cell_is_skipped(arch, shape), (arch, shape)
    assert PC.SHAPES["train_4k"].seq_len == 4096
    assert PC.SHAPES["prefill_32k"].seq_len == 32768


def test_every_text_arch_is_registered_and_the_rest_name_item_10a():
    """(The name is the test's from before the audio and vlm archs were
    ported.) All ten of the reference's archs are registered, each with the
    reference's full and smoke configs, field for field; an unknown arch
    raises KeyError."""
    assert PC.ARCH_IDS == JC.ARCH_IDS and len(PC.ARCH_IDS) == 10
    with pytest.raises(KeyError, match="unknown architecture"):
        PC.get_config("gpt-2")
    for arch in JC.ARCH_IDS:
        for pget, jget in ((PC.get_config, JC.get_config),
                           (PC.get_smoke_config, JC.get_smoke_config)):
            p, j = pget(arch), jget(arch)
            pd = {f: getattr(p, f) for f in p.__dataclass_fields__}
            jd = {f: getattr(j, f) for f in j.__dataclass_fields__}
            for key in ("moe", "ssm", "rwkv"):
                pd[key] = None if pd[key] is None else vars(pd[key])
                jd[key] = None if jd[key] is None else vars(jd[key])
            assert pd == jd, arch

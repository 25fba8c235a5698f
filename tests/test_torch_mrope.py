"""M-RoPE (qwen2-vl) in the port against the reference: `mrope_sections`
and `apply_mrope` with distinct temporal / height / width positions, the
equal-components case (plain RoPE), the serving positions, and the port's
refusal of positions without the component axis.

The reference's own tests feed three equal components (its
tests/test_models.py), where M-RoPE is plain RoPE, so they cannot tell the
two apart; these tests use distinct ones. The reference's `forward` falls
back to [B, S] positions when none are given and `apply_mrope` then indexes
their batch axis with the component ids (ROADMAP queue C): the port raises
`ValueError` there, and the fault is recorded below without asserting the
reference right."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as PC  # noqa: E402
from repro_torch.models import layers as PL  # noqa: E402
from repro_torch.models import transformer as PT  # noqa: E402

THETA = 1_000_000.0


def _distinct(b, s, seed=0):
    """[3, b, s] positions whose three components differ everywhere but by
    chance."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 4096, (3, b, s)).astype(np.int32)


@pytest.mark.parametrize("head_dim", [8, 16, 64, 128, 320])
def test_sections_match_reference(head_dim):
    got = PL.mrope_sections(head_dim)
    assert got == JL.mrope_sections(head_dim)
    assert sum(got) == head_dim // 2
    if head_dim == 128:
        assert got == (16, 24, 24)     # qwen2-vl-7b's


@pytest.mark.parametrize("head_dim", [16, 128])
def test_apply_mrope_matches_reference_with_distinct_components(head_dim):
    """f32, [B, S, H, D] with positions up to 4096: within 2^-20 of the
    largest input (fp32 angles and rotation, the same formulas)."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 3, head_dim)).astype(np.float32)
    pos = _distinct(2, 7)
    want = np.asarray(JL.apply_mrope(jnp.asarray(x), jnp.asarray(pos), THETA))
    got = PL.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), THETA)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=2**-20 * float(np.abs(x).max()))
    # and it is not plain RoPE of any one component
    for c in range(3):
        rope = PL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos[c]),
                             THETA)
        assert float((rope - got).abs().max()) > 1e-2


def test_apply_mrope_bf16_close_to_reference():
    """bf16 input: computed in fp32 and rounded once, as the reference: the
    two agree within one bf16 ulp of the largest output."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 2, 128)).astype(np.float32)
    pos = _distinct(2, 5, seed=2)
    want = np.asarray(JL.apply_mrope(jnp.asarray(x, jnp.bfloat16),
                                     jnp.asarray(pos), THETA), np.float32)
    got = PL.apply_mrope(torch.from_numpy(x).to(torch.bfloat16),
                         torch.from_numpy(pos), THETA)
    assert got.dtype == torch.bfloat16
    assert float(np.abs(got.float().numpy() - want).max()) <= \
        2**-7 * float(np.abs(want).max())


def test_equal_components_are_plain_rope():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 6, 2, 16)).astype(
        np.float32))
    pos = torch.arange(6).expand(2, 6)
    assert torch.equal(PL.apply_mrope(x, pos.expand(3, 2, 6), THETA),
                       PL.apply_rope(x, pos, THETA))


@pytest.mark.parametrize("shape", [(2, 6), (1, 2, 6), (2, 2, 6), (3, 1, 2, 6)])
def test_positions_without_the_component_axis_raise(shape):
    x = torch.zeros((2, 6, 2, 16))
    with pytest.raises(ValueError, match=r"\[3, \.\.\., S\]"):
        PL.apply_mrope(x, torch.zeros(shape, dtype=torch.int32), THETA)


def test_serve_positions_match_reference():
    """A chunk's positions on the serving path: [3, B, S], equal
    components (token positions), as the reference's."""
    cfg = PC.get_smoke_config("qwen2-vl-7b")
    start = np.array([0, 5, 17], np.int32)
    got = PL._serve_positions(cfg, torch.from_numpy(start), 4)
    want = JL._serve_positions(JC.get_smoke_config("qwen2-vl-7b"),
                               jnp.asarray(start), 4)
    assert got.shape == (3, 3, 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    llama = PL._serve_positions(PC.get_smoke_config("llama3-8b"),
                                torch.from_numpy(start), 4)
    assert llama.shape == (3, 4)


def test_forward_without_positions_raises_where_the_reference_falls_back():
    """qwen2-vl's smoke config at B = 2 with no positions: the port raises.
    The reference falls back to [B, S] positions and indexes their batch
    axis with the component ids, so its hidden states differ from the same
    call given [3, B, S] arange positions (by 4.36e-4 on these inputs);
    recorded, not asserted right."""
    jcfg, pcfg = JC.get_smoke_config("qwen2-vl-7b"), \
        PC.get_smoke_config("qwen2-vl-7b")
    params = JT.init_params(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(4)
    emb = rng.standard_normal((2, 16, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(16, dtype=np.int32), (3, 2, 16))
    fallback, _ = JT.forward(jcfg, (params, None),
                             {"embeds": jnp.asarray(emb)})
    given, _ = JT.forward(jcfg, (params, None),
                          {"embeds": jnp.asarray(emb),
                           "positions": jnp.asarray(pos)})
    fault = float(jnp.abs(fallback - given).max())
    assert fault > 1e-4, "the reference's fallback fault is gone"
    pp = bridge.to_torch(jax.device_get(params))
    with pytest.raises(ValueError):
        PT.forward(pcfg, (pp, None), {"embeds": torch.from_numpy(emb)})
    got, _ = PT.forward(pcfg, (pp, None),
                        {"embeds": torch.from_numpy(emb),
                         "positions": torch.from_numpy(
                             np.ascontiguousarray(pos))})
    np.testing.assert_allclose(got.numpy(), np.asarray(given), rtol=1e-5,
                               atol=1e-5)

"""The port's mamba block (`repro_torch.models.mamba`) against the
reference's on the jamba smoke config, in f32: the causal depthwise conv,
the chunked selective scan at one, a whole and two chunks, the whole block,
and their gradients with respect to the input and every mamba leaf against
`jax.grad`; the port's chunked scan against its own step-by-step recurrence
(the counterpart of the reference's
`test_mamba_chunked_scan_matches_stepwise`); the serving forms (a cached
chunk with per-row lengths, a one-token step) against the reference's;
and the refusal of the channel-sharded form."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jget  # noqa: E402
from repro.models import mamba as JM  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import mamba as PM  # noqa: E402

ARCH = "jamba-1.5-large-398b"
# forward bounds; gradients rtol 1e-4 (sums over the sequence in another
# order), atol 1e-5
FWD = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-5)


def _params(seed=0):
    cfg = jget(ARCH)
    p = jax.device_get(JM.init_mamba(jax.random.PRNGKey(seed), cfg,
                                     jnp.float32))
    return cfg, get_smoke_config(ARCH), p


def _normal(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape)
            * scale).astype(np.float32)


def _torch_leaves(p):
    return {k: torch.from_numpy(np.array(v)).requires_grad_(True)
            for k, v in p.items()}


def test_causal_depthwise_conv_matches_reference():
    cfg, _, p = _params()
    x = _normal(1, (2, 32, JM.d_inner(cfg)))
    want = JM._causal_depthwise_conv(jnp.asarray(x), p["conv_w"],
                                     jnp.asarray(_normal(2, p["conv_b"].shape)))
    got = PM._causal_depthwise_conv(
        torch.from_numpy(x), torch.from_numpy(np.array(p["conv_w"])),
        torch.from_numpy(_normal(2, p["conv_b"].shape)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)


def _scan_inputs(cfg, s, seed):
    di, ns = JM.d_inner(cfg), cfg.ssm.d_state
    a = -np.exp(_normal(seed, (di, ns), 0.5))
    dt = np.log1p(np.exp(_normal(seed + 1, (2, s, di)) - 2.0))  # softplus
    return [a.astype(np.float32), dt.astype(np.float32),
            _normal(seed + 2, (2, s, di)), _normal(seed + 3, (2, s, ns)),
            _normal(seed + 4, (2, s, ns)),
            _normal(seed + 5, (2, di, ns), 0.1)]


@pytest.mark.parametrize("s", [16, 64, 128])
def test_selective_scan_and_its_gradients_match_reference(s):
    """S = 16 (one short chunk), 64 (one chunk), 128 (two chunks, the state
    carried across): y and h_last, and the gradients of <y, gy> + <h, gh>
    with respect to all six inputs."""
    cfg, _, _ = _params()
    args = _scan_inputs(cfg, s, seed=10 + s)
    gy = _normal(3, (2, s, JM.d_inner(cfg)))
    gh = _normal(4, args[-1].shape)

    def jloss(*a):
        y, h = JM.selective_scan(*a)
        return jnp.sum(y * gy) + jnp.sum(h * gh)

    y_want, h_want = JM.selective_scan(*[jnp.asarray(a) for a in args])
    g_want = jax.grad(jloss, argnums=tuple(range(6)))(
        *[jnp.asarray(a) for a in args])
    targs = [torch.from_numpy(a).requires_grad_(True) for a in args]
    y, h = PM.selective_scan(*targs)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_want), **FWD)
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(h_want), **FWD)
    ((y * torch.from_numpy(gy)).sum() + (h * torch.from_numpy(gh)).sum()
     ).backward()
    for t, want in zip(targs, g_want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), **GRAD)


def test_apply_mamba_and_its_gradients_match_reference():
    """The whole block at S = 128 (two chunks): the output, and the
    gradients with respect to x and every mamba leaf (in_proj, conv_w,
    conv_b, x_proj, dt_proj, dt_bias, A_log, D, out_proj)."""
    cfg, pcfg, p = _params(seed=3)
    x = _normal(5, (2, 128, cfg.d_model), 0.5)
    g = _normal(6, x.shape)

    def jloss(p, x):
        return jnp.sum(JM.apply_mamba(p, cfg, x)[0] * g)

    want, _ = JM.apply_mamba(p, cfg, jnp.asarray(x))
    gp_want, gx_want = jax.grad(jloss, argnums=(0, 1))(p, jnp.asarray(x))
    tp = _torch_leaves(p)
    tx = torch.from_numpy(x).requires_grad_(True)
    got, cache = PM.apply_mamba(tp, pcfg, tx)
    assert cache is None
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **FWD)
    (got * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx_want), **GRAD)
    assert set(tp) == set(gp_want) and len(tp) == 9
    for name, t in tp.items():
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(gp_want[name]),
                                   err_msg=name, **GRAD)


def test_mixed_dtype_leaves_and_init_match_reference_layout():
    """In a bf16 model dt_bias, A_log and D stay fp32, as the reference's;
    same keys and shapes; A_log is the S4D-real log(1..d_state)."""
    cfg, pcfg, _ = _params()
    want = jax.device_get(JM.init_mamba(jax.random.PRNGKey(0), cfg,
                                        jnp.bfloat16))
    got = PM.init_mamba(torch.Generator().manual_seed(0), pcfg,
                        torch.bfloat16, "cpu")
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in got.items()} == \
        {k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()}
    np.testing.assert_array_equal(got["A_log"].numpy(),
                                  np.asarray(want["A_log"]))
    assert bool((got["dt_bias"] >= np.log(np.expm1(1e-3)) - 1e-6).all())


def test_softplus_matches_reference_past_torchs_threshold():
    x = np.array([-30.0, -1.0, 0.0, 15.0, 20.5, 25.0, 80.0], np.float32)
    np.testing.assert_allclose(PM.softplus(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.nn.softplus(jnp.asarray(x))),
                               rtol=1e-6, atol=0)


def _stepwise_scan(a, dt, xc, b_ssm, c, h0):
    """The recurrence one step at a time: h_t = dA_t h_{t-1} + dBx_t,
    y_t = <h_t, c_t>."""
    h, ys = h0, []
    for t in range(dt.shape[1]):
        dA, dBx = PM._discretize(a, dt[:, t], xc[:, t], b_ssm[:, t])
        h = dA * h + dBx
        ys.append(torch.einsum("bdn,bn->bd", h, c[:, t]))
    return torch.stack(ys, dim=1), h


def test_chunked_scan_matches_stepwise(monkeypatch):
    """The port's chunked block against the same block with the scan run
    step by step, at S = 128 (the reference test's bounds)."""
    _, pcfg, p = _params()
    tp = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    x = torch.from_numpy(_normal(1, (2, 128, pcfg.d_model), 0.5))
    with torch.no_grad():
        chunked, _ = PM.apply_mamba(tp, pcfg, x)
        monkeypatch.setattr(PM, "selective_scan", _stepwise_scan)
        step, _ = PM.apply_mamba(tp, pcfg, x)
    np.testing.assert_allclose(chunked.numpy(), step.numpy(), rtol=2e-3,
                               atol=2e-4)


def test_scan_keeps_only_the_state_between_chunks():
    """Under a gradient, each chunk is recomputed in backward: the forward
    saves no [B, Q, D, N] tensor (the largest saved one is [B, S, D])."""
    cfg, _, _ = _params()
    args = [torch.from_numpy(a).requires_grad_(True)
            for a in _scan_inputs(cfg, 128, seed=1)]
    sizes = []

    def pack(t):
        sizes.append(t.dim())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        y, _ = PM.selective_scan(*args)
    assert sizes and max(sizes) <= 3


def test_sequence_must_fill_whole_chunks():
    """Past one chunk the sequence must be a multiple of 64 steps, as in
    the reference (a shorter one is a chunk of its own)."""
    cfg, _, _ = _params()
    args = [torch.from_numpy(a) for a in _scan_inputs(cfg, 96, seed=1)]
    with pytest.raises(ValueError, match="multiple"):
        PM.selective_scan(*args)
    y, _ = PM.selective_scan(*[torch.from_numpy(a)
                               for a in _scan_inputs(cfg, 40, seed=1)])
    assert y.shape[1] == 40


def test_serving_forms_refuse():
    """The serving forms against the reference's apply_mamba with a cache:
    a chunk of 16 from a nonzero state with per-row valid lengths (one row
    padded: its dt forced to 0, its conv tail gathered at its valid end),
    then a one-token step from that cache; outputs and both cache leaves
    (h fp32, conv). The channel-sharded form still refuses (item 14)."""
    cfg, pcfg, p = _params(seed=2)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    di, k1 = JM.d_inner(cfg), cfg.ssm.d_conv - 1
    cache = {"h": _normal(7, (2, di, cfg.ssm.d_state), 0.3),
             "conv": _normal(8, (2, k1, di), 0.5)}
    length = np.array([16, 9], np.int32)
    x = _normal(9, (2, 16, cfg.d_model), 0.5)
    want, jc = JM.apply_mamba(p, cfg, jnp.asarray(x),
                              cache=jax.tree.map(jnp.asarray, cache),
                              length=jnp.asarray(length))
    got, pc = PM.apply_mamba(tp, pcfg, torch.from_numpy(x),
                             cache=bridge.to_torch(cache),
                             length=torch.from_numpy(length))
    valid = np.arange(16)[None, :] < length[:, None]
    np.testing.assert_allclose(got.numpy()[valid], np.asarray(want)[valid],
                               **FWD)
    for key in ("h", "conv"):
        np.testing.assert_allclose(pc[key].numpy(), np.asarray(jc[key]),
                                   err_msg=key, **FWD)
    x1 = _normal(10, (2, 1, cfg.d_model), 0.5)
    want, jc = JM.apply_mamba(p, cfg, jnp.asarray(x1), cache=jc)
    got, pc = PM.apply_mamba(tp, pcfg, torch.from_numpy(x1), cache=pc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)
    for key in ("h", "conv"):
        np.testing.assert_allclose(pc[key].numpy(), np.asarray(jc[key]),
                                   err_msg=key, **FWD)
    narrow = dict(tp, out_proj=tp["out_proj"][:16])
    with pytest.raises(NotImplementedError, match="item 14"):
        PM.apply_mamba(narrow, pcfg, torch.zeros((1, 4, pcfg.d_model)))

"""The port past the dense path's 2048 tokens, against the reference, on
smoke configs: the llama3-8b forward loss and 3 compact train steps (SGD
and AdamW) and a gemma3-4b compact step (its 16-token window on 5 of 6
layers) at seq 3072, and `decoding.prefill`'s logits and cache at seq
2560. Params and selections come from the reference, bridged; the batch is
numpy from a seed; f32.

Seq 3072, not 2560, for the loss: both packages' chunked cross-entropy
takes chunks of 1024 tokens that must divide the sequence, so 3072 is the
shortest length past 2048 that both the flash chunks (512) and the loss
take. Prefill computes no loss, so it runs at 2560.

Tolerance of hidden states, logits and caches: (1e-5 + S * 2^-23) of the
largest value at sequence S. Compiled (the reference's layer scan), XLA
folds the RoPE frequencies `1 / theta ** (i / d)` to values an ulp away
from the ones its eager code and the port compute, and at position p an
ulp of a frequency <= 1 moves the angle by up to p * 2^-24 radians: 6.1e-5
at p = 2560, against 4e-7 at the dense tests' 16 positions. The losses, a
mean over every position, stay within 1e-5."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from repro_torch.testing import limit_threads  # noqa: E402

limit_threads()
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.models import decoding as JD  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.train import make_train_state as jstate  # noqa: E402
from repro.train import make_train_step as jstep  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as PC  # noqa: E402
from repro_torch.core import selection as psel  # noqa: E402
from repro_torch.models import decoding as PD  # noqa: E402
from repro_torch.models import layers as PL  # noqa: E402
from repro_torch.models import transformer as PT  # noqa: E402
from repro_torch.train import make_train_step  # noqa: E402

SEQ = 3072
OPTS = {"sgd": {}, "adamw": {}}


def _batch(seed=3, b=1, s=SEQ):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, 256, (b, s)).astype(np.int32),
            "labels": rng.integers(0, 256, (b, s)).astype(np.int32)}


def _rope_tol(s: int) -> float:
    return 1e-5 + s * 2.0 ** -23


def _max_diff(a, b):
    return max(float(np.abs(np.asarray(x, np.float32)
                            - np.asarray(y, np.float32)).max())
               for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)))


@pytest.fixture
def flash_calls(monkeypatch):
    """Counts the port's `_sdpa_flash` calls (the attention and prefill
    paths look it up in `layers` at call time)."""
    calls = []
    inner = PL._sdpa_flash

    def counted(*a, **kw):
        calls.append(a[0].shape[1])
        return inner(*a, **kw)
    monkeypatch.setattr(PL, "_sdpa_flash", counted)
    return calls


def test_llama_forward_loss_at_3072_matches_reference(flash_calls):
    """The smoke model's hidden states and loss at seq 3072, every layer
    through the flash path."""
    jcfg, pcfg = JC.get_smoke_config("llama3-8b"), \
        PC.get_smoke_config("llama3-8b")
    params = JT.init_params(jcfg, jax.random.PRNGKey(5))
    batch = _batch(seed=5)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want, _ = JT.forward(jcfg, (params, None), jb)
    jl, _ = JT.loss_fn(jcfg, (params, None), jb)
    pp = bridge.to_torch(jax.device_get(params))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    got, _ = PT.forward(pcfg, (pp, None), tb)
    pl, _ = PT.loss_fn(pcfg, (pp, None), tb)
    want = np.asarray(want)
    assert float(np.abs(got.numpy() - want).max()) <= \
        _rope_tol(SEQ) * float(np.abs(want).max())
    assert float(pl) == pytest.approx(float(jl), abs=1e-5)
    assert flash_calls == [SEQ] * (2 * pcfg.num_layers)


@pytest.mark.parametrize("arch,kind,tol", [
    ("llama3-8b", "sgd", 1e-5),
    # the reference's own bound for AdamW (test_compact_path)
    ("llama3-8b", "adamw", 1e-2),
    ("gemma3-4b", "sgd", 1e-5),
])
def test_compact_steps_at_3072_match_reference(arch, kind, tol, flash_calls):
    """3 compact fixed-phase steps at seq 3072, batch 1: losses (1e-5),
    trainable params, selection, frozen params and optimizer state against
    the reference's jitted compact step. K = 1 scan step (gemma: its
    super-block of 5 local layers and 1 global)."""
    tcs = [C.TrainConfig(
        model=C.get_smoke_config(arch), shape=C.ShapeConfig("t", SEQ, 1,
                                                            "train"),
        sparse=C.SparseUpdateConfig(update_ratio=0.5, num_update_layers=1,
                                    channel_block=8),
        optimizer=C.OptimizerConfig(kind=kind, learning_rate=0.05,
                                    **OPTS[kind])) for C in (JC, PC)]
    js, jplan = jstate(tcs[0], jax.random.PRNGKey(0))
    pplan = psel.build_plan(tcs[1].model, tcs[1].sparse, SEQ)
    ps = bridge.state_to_torch(jax.device_get(js))
    jfn = jax.jit(jstep(tcs[0], jplan, compact_grads=True))
    pfn = make_train_step(tcs[1], pplan, compact_grads=True)
    batch = _batch()
    jb = {key: jnp.asarray(v) for key, v in batch.items()}
    tb = {key: torch.from_numpy(v) for key, v in batch.items()}
    for _ in range(3):
        js, jm = jfn(js, jb)
        ps, pm = pfn(ps, tb)
        assert float(pm["loss"]) == pytest.approx(float(jm["loss"]), abs=1e-5)
    assert flash_calls and set(flash_calls) == {SEQ}
    got = bridge.state_to_numpy(ps)
    js = jax.device_get(js)
    for key in ("sel_idx", "params_frozen"):
        assert _max_diff(got[key], js[key]) == 0
    assert _max_diff(got["params_trainable"], js["params_trainable"]) <= tol
    if js["opt"]:
        assert _max_diff(got["opt"], js["opt"]) <= tol


def test_prefill_at_2560_matches_reference(flash_calls):
    """`decoding.prefill` of 2560 tokens, padded to 2600: the last-token
    logits and every layer's k, v and pos against the reference's
    prefill."""
    jcfg, pcfg = JC.get_smoke_config("llama3-8b"), \
        PC.get_smoke_config("llama3-8b")
    params = JT.init_params(jcfg, jax.random.PRNGKey(7))
    toks = _batch(seed=7, s=2560)["tokens"]
    jl, jcache = JD.prefill(jcfg, params, {"tokens": jnp.asarray(toks)},
                            pad_to=2600)
    pl, pcache = PD.prefill(pcfg, bridge.to_torch(jax.device_get(params)),
                            {"tokens": torch.from_numpy(toks)}, pad_to=2600)
    assert flash_calls == [2560] * pcfg.num_layers
    for got, want in [(pl, jl)] + [(pcache["blocks"][k], jcache["blocks"][k])
                                   for k in ("k", "v", "pos")]:
        got, want = bridge.to_numpy(got), np.asarray(want)
        assert got.shape == want.shape
        scale = max(1.0, float(np.abs(want).max()))
        assert float(np.abs(got.astype(np.float32)
                            - want.astype(np.float32)).max()) \
            <= _rope_tol(2560) * scale
    assert int(pcache["blocks"]["pos"].max()) == 2560

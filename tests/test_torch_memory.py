"""The port's training-memory model against the reference's, for all ten LM
archs at their published configs (abstract params: `meta` tensors here,
`jax.eval_shape` there, so a 398B model costs nothing).

The super-block families charge one checkpoint per sub-layer: the hybrid
family `attn_every`, a `local_global:L:G` pattern L + G. Without that the
budget solver trains other layers than the reference under a budget
(gemma3-4b K = 5 against 3 at 512 MiB and 4096 tokens)."""
import warnings

import pytest

torch = pytest.importorskip("torch")
from repro_torch.testing import limit_threads  # noqa: E402

limit_threads()
jax = pytest.importorskip("jax")

import repro.models.registry as jregistry  # noqa: E402
from repro.configs import SparseUpdateConfig as JSparse  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import memory as jmem  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro_torch.configs import ARCH_IDS, SparseUpdateConfig  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import memory as pmem  # noqa: E402
from repro_torch.launch import specs as pspecs  # noqa: E402

TOKENS = 4096
BUDGETS = {"64MiB": 64 * 2**20, "512MiB": 512 * 2**20, "4GiB": 4 * 2**30}


@pytest.fixture(scope="module", autouse=True)
def _cached_reference_shapes():
    """The reference's memory model traces its params' shapes anew for every
    K the solver tries (~30 s an arch); within this module they come from
    one trace per config. The values are the same: the trace is a pure
    function of the config."""
    real = jregistry.abstract_params
    cache = {}

    def cached(cfg):
        if cfg not in cache:
            cache[cfg] = real(cfg)
        return cache[cfg]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jregistry, "abstract_params", cached)
        yield


def _pair(arch):
    return jget_config(arch), get_config(arch)


def _sparse(**kw):
    return JSparse(**kw), SparseUpdateConfig(**kw)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_memory_model_matches_reference(arch):
    """Activation bytes a step, the selected-param bytes, the sparse extra
    at K = 1, 2 and the reference's default K, and the dense baseline at 0
    and 1 optimizer slots: all equal the reference's to the byte."""
    jcfg, pcfg = _pair(arch)
    assert pmem.activation_bytes_per_layer(pcfg, TOKENS) == \
        jmem.activation_bytes_per_layer(jcfg, TOKENS)
    k_default = jspecs._default_k(jcfg)
    assert pspecs._default_k(pcfg) == k_default
    jsp, psp = _sparse(update_ratio=0.2, channel_block=128)
    for k in sorted({1, 2, k_default}):
        assert pmem.trainable_param_bytes(pcfg, psp, k) == \
            jmem.trainable_param_bytes(jcfg, jsp, k)
        for slots in (0, 1):
            assert pmem.training_extra_bytes(pcfg, psp, k, TOKENS, slots) == \
                jmem.training_extra_bytes(jcfg, jsp, k, TOKENS, slots)
    for slots in (0, 1):
        assert pmem.dense_training_extra_bytes(pcfg, TOKENS, slots) == \
            jmem.dense_training_extra_bytes(jcfg, TOKENS, slots)


@pytest.mark.parametrize("budget", list(BUDGETS), ids=list(BUDGETS))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_solve_max_layers_matches_reference(arch, budget):
    """The budget solver picks the reference's K (gemma3-4b and jamba differ
    when a super-block is charged as one layer)."""
    jcfg, pcfg = _pair(arch)
    jsp, psp = _sparse(update_ratio=0.2, memory_budget_bytes=BUDGETS[budget])
    with warnings.catch_warnings():
        # a budget under one step warns on both sides and falls back to K=1
        warnings.simplefilter("ignore")
        want = jmem.solve_max_layers(jcfg, jsp, TOKENS)
        got = pmem.solve_max_layers(pcfg, psp, TOKENS)
    assert got == want


def test_super_blocks_charge_every_sub_layer():
    """The figures the budget solver turns on, by hand: gemma3-4b steps are
    5 local + 1 global layers of d_model 2560, jamba's 8 layers of 8192,
    bf16, at 4096 tokens."""
    assert pmem.activation_bytes_per_layer(get_config("gemma3-4b"),
                                           TOKENS) == 6 * TOKENS * 2560 * 2
    assert pmem.activation_bytes_per_layer(
        get_config("jamba-1.5-large-398b"), TOKENS) == 8 * TOKENS * 8192 * 2
    assert pmem.activation_bytes_per_layer(get_config("llama3-8b"),
                                           TOKENS) == TOKENS * 4096 * 2

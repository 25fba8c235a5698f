"""The port's compact train step against the reference's step under
`use_kernels(True)`: its Pallas dW and fused-optimizer kernels in interpret
mode. Slow on the CPU (the kernels are interpreted), so it sits apart from
test_torch_train.py and runs beside it."""
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core.sparse_update import use_kernels  # noqa: E402
from repro.train import make_train_step as jstep  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.train import make_train_step  # noqa: E402
from test_torch_train import _batch, _max_diff, _start  # noqa: E402


@pytest.mark.parametrize("kind,tol", [
    ("sgd", 1e-5),
    ("momentum", 1e-5),
    # the reference's own AdamW bound for its kernel path (test_compact_path)
    ("adamw", 1e-2),
])
def test_compact_step_matches_reference_kernels(kind, tol):
    """One compact step (un-jitted, as the reference's own kernel test runs
    it): loss within 1e-5, trainable params and optimizer state within
    `tol`."""
    jtc, ptc, js, jplan, pplan = _start(kind)
    ps = bridge.state_to_torch(jax.device_get(js))
    batch = _batch()
    with use_kernels(True):
        js, jm = jstep(jtc, jplan, compact_grads=True)(
            js, {k: jnp.asarray(v) for k, v in batch.items()})
    ps, pm = make_train_step(ptc, pplan, compact_grads=True)(
        ps, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert float(pm["loss"]) == pytest.approx(float(jm["loss"]), abs=1e-5)
    got, js = bridge.state_to_numpy(ps), jax.device_get(js)
    assert _max_diff(got["params_trainable"], js["params_trainable"]) <= tol
    if js["opt"]:
        assert _max_diff(got["opt"], js["opt"]) <= tol

"""The WKV recurrence's plain versions in the port (`kernels.ref.wkv6_ref`,
`wkv6_bwd_ref`) against the reference: its oracle, its chunked Pallas
kernel (interpret mode) and its model's `wkv`, forward; autograd and
`jax.grad`, backward; a strong-decay case; and the wrappers' CPU dispatch
and argument checks. The CUDA kernel itself runs on the card only
(`chip_smoke.py` phase 3 holds it against these plain versions)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from repro_torch.testing import limit_threads  # noqa: E402

limit_threads()
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.wkv6_chunk import wkv6_chunk_kernel  # noqa: E402
from repro.models import rwkv6 as JR  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

# fp32 throughout: both sides sum D products per step and carry the state
# over T steps in fp32, in different orders (einsum vs a scan, log-space
# chunks for the Pallas kernel); at these sizes the differences stay below
# 1e-5 of values of order 1
TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(b, t, h, d, seed, log_decay=-1.0):
    """r, k, v, w [B, T, H, D] and u [H, D] as numpy fp32, drawn as
    `tests/test_kernels.py::test_wkv6_chunk_kernel` draws them."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(b, t, h, d)).astype(np.float32) * 0.5
               for _ in range(3))
    w = np.exp(-np.exp(rng.normal(size=(b, t, h, d)) + log_decay)).astype(
        np.float32)
    u = (rng.normal(size=(h, d)) * 0.3).astype(np.float32)
    return r, k, v, w, u


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("bh,t,d", [(3, 128, 16), (2, 64, 32), (1, 256, 8)])
def test_plain_forward_matches_reference_oracle_and_chunk_kernel(bh, t, d):
    """One u for every head, the reference's [BH, T, D] as [BH, T, 1, D]."""
    r, k, v, w, u = _inputs(bh, t, 1, d, seed=bh * t + d)
    got = ref.wkv6_ref(*_t(r, k, v, w, u[:1])).numpy()[:, :, 0]
    flat = [jnp.asarray(a[:, :, 0]) for a in (r, k, v, w)]
    want = np.asarray(jref.wkv6_ref(*flat, jnp.asarray(u[0])))
    np.testing.assert_allclose(got, want, **TOL)
    chunked = np.asarray(wkv6_chunk_kernel(*flat, jnp.asarray(u[0]),
                                           chunk=min(32, t), interpret=True))
    np.testing.assert_allclose(got, chunked, **TOL)


@pytest.mark.parametrize("b,t,h,d", [(2, 64, 4, 16), (1, 96, 2, 32)])
def test_plain_forward_matches_model_wkv_per_head_u(b, t, h, d):
    """The model's layout [B, S, H, D] with one u per head, from s0 = 0."""
    r, k, v, w, u = _inputs(b, t, h, d, seed=7 + t)
    s0 = jnp.zeros((b, h, d, d), jnp.float32)
    want, _ = JR.wkv(*(jnp.asarray(a) for a in (r, k, v, w, u)), s0)
    got = ops.wkv6_fwd(*_t(r, k, v, w, u))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _plain_grads(r, k, v, w, u, dy):
    xs = [a.clone().requires_grad_(True) for a in _t(r, k, v, w, u)]
    ref.wkv6_ref(*xs).backward(torch.from_numpy(dy))
    return [x.grad.numpy() for x in xs]


@pytest.mark.parametrize("b,t,h,d", [(2, 24, 3, 16), (1, 17, 2, 32)])
def test_plain_backward_matches_autograd(b, t, h, d):
    r, k, v, w, u = _inputs(b, t, h, d, seed=11 + d)
    dy = np.random.default_rng(3).normal(size=(b, t, h, d)).astype(
        np.float32)
    got = ref.wkv6_bwd_ref(*_t(r, k, v, w, u, dy))
    for name, a, want in zip("rkvwu", got, _plain_grads(r, k, v, w, u, dy)):
        np.testing.assert_allclose(a.numpy(), want, err_msg=f"d{name}",
                                   **TOL)


def test_plain_backward_matches_jax_grad_of_model_wkv():
    b, t, h, d = 2, 64, 2, 16
    r, k, v, w, u = _inputs(b, t, h, d, seed=5)
    dy = np.random.default_rng(6).normal(size=(b, t, h, d)).astype(
        np.float32)
    s0 = jnp.zeros((b, h, d, d), jnp.float32)

    def loss(r, k, v, w, u):
        return jnp.sum(JR.wkv(r, k, v, w, u, s0)[0] * dy)

    want = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(a) for a in (r, k, v, w, u)))
    got = ops.wkv6_bwd(*_t(r, k, v, w, u, dy))
    for name, a, j in zip("rkvwu", got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(j),
                                   err_msg=f"d{name}", **TOL)


def test_strong_decay_stays_finite():
    """w = 1e-12 on every channel (the reference kernel's log clamp): the
    state keeps only the last step's outer product, so y_t = r_t . (u k_t
    v_t^T + k_{t-1} v_{t-1}^T) up to 1e-12. The step-by-step forms stay
    finite; the reference's log-space chunks overflow there."""
    b, t, h, d = 1, 64, 2, 16
    r, k, v, _, u = _inputs(b, t, h, d, seed=9)
    w = np.full((b, t, h, d), 1e-12, np.float32)
    y = ops.wkv6_fwd(*_t(r, k, v, w, u)).numpy()
    assert np.isfinite(y).all()
    prev_kv = np.zeros((b, h, d, d), np.float32)
    for i in range(t):
        kv = k[:, i, :, :, None] * v[:, i, :, None, :]
        want = np.einsum("bhd,bhde->bhe", r[:, i],
                         u[None, :, :, None] * kv + prev_kv)
        np.testing.assert_allclose(y[:, i], want, **TOL)
        prev_kv = kv
    dy = np.ones_like(y)
    grads = ops.wkv6_bwd(*_t(r, k, v, w, u, dy))
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    for name, a, want in zip("rkvwu", grads, _plain_grads(r, k, v, w, u,
                                                          dy)):
        np.testing.assert_allclose(a.numpy(), want, err_msg=f"d{name}",
                                   **TOL)
    chunked = np.asarray(wkv6_chunk_kernel(
        *(jnp.asarray(a[:, :, 0]) for a in (r, k, v, w)),
        jnp.asarray(u[0]), chunk=32, interpret=True))
    assert not np.isfinite(chunked).all()


def test_autograd_function_takes_the_plain_path_on_cpu():
    """`ops.WKV6` on CPU tensors: the plain forward, the written-out
    backward, no launch counted."""
    ops.reset_launch_counts()
    r, k, v, w, u = _inputs(2, 20, 2, 16, seed=4)
    dy = np.random.default_rng(8).normal(size=r.shape).astype(np.float32)
    xs = [a.requires_grad_(True) for a in _t(r, k, v, w, u)]
    y = ops.WKV6.apply(*xs)
    torch.testing.assert_close(y.detach(), ref.wkv6_ref(*_t(r, k, v, w, u)),
                               rtol=0, atol=0)
    y.backward(torch.from_numpy(dy))
    for x, want in zip(xs, ref.wkv6_bwd_ref(*_t(r, k, v, w, u, dy))):
        torch.testing.assert_close(x.grad, want, rtol=0, atol=0)
    assert ops.launch_counts()["wkv6"] == ops.launch_counts()["wkv6_bwd"] == 0


def test_wrappers_refuse_what_the_kernel_does_not_take():
    r, k, v, w, u = _t(*_inputs(1, 8, 2, 16, seed=1))
    with pytest.raises(ValueError, match="float32"):
        ops.wkv6_fwd(r.bfloat16(), k, v, w, u)
    with pytest.raises(ValueError, match="u must be"):
        ops.wkv6_fwd(r, k, v, w, u[0])
    with pytest.raises(ValueError, match="contiguous"):
        ops.wkv6_fwd(r.transpose(1, 2).contiguous().transpose(1, 2), k, v,
                     w, u)
    with pytest.raises(ValueError, match="disagree"):
        ops.wkv6_bwd(r, k, v, w, u, r[:, :4].contiguous())

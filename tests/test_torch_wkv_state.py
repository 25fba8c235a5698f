"""The WKV recurrence with a carried state, the form serving runs: the
port's plain version `kernels.ref.wkv6_ref(..., s0=, want_state=True)`
against the reference's model `wkv(r, k, v, w, u, s0) -> (y, s_last)` over
whole chunks and against its one-step `_wkv_chunk` at T = 1 (a decode
step); a prefill continued chunk by chunk through the state equal to the
recurrence over the whole prompt; the wrapper's CPU dispatch (the plain
path, no launch counted) and its argument checks; and the rwkv time mix's
padded steps (k = 0, w = 1) leaving the state as after the valid prefix.
The CUDA kernel's state form runs on the card only (`chip_smoke.py` phase
3 holds it against this plain version at T = 1, 16 and 128).

fp32 throughout: both sides sum D products a step and carry the state in
fp32, in different orders (einsum vs a scan): within 1e-5 of values of
order 1."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from repro_torch.testing import limit_threads  # noqa: E402

limit_threads()
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import rwkv6 as JR  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(b, t, h, d, seed, log_decay=-1.0):
    """r, k, v, w [B, T, H, D], u [H, D] and a nonzero s0 [B, H, D, D],
    numpy fp32."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(b, t, h, d)).astype(np.float32) * 0.5
               for _ in range(3))
    w = np.exp(-np.exp(rng.normal(size=(b, t, h, d)) + log_decay)).astype(
        np.float32)
    u = (rng.normal(size=(h, d)) * 0.3).astype(np.float32)
    s0 = rng.normal(size=(b, h, d, d)).astype(np.float32)
    return r, k, v, w, u, s0


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("b,t,h,d", [(2, 16, 4, 16), (1, 64, 2, 32),
                                     (3, 32, 2, 8)])
def test_state_form_matches_reference_wkv(b, t, h, d):
    """A prefill chunk (T = 16) and longer runs from a nonzero state: y
    and the last state against the reference model's `wkv`."""
    r, k, v, w, u, s0 = _inputs(b, t, h, d, seed=b * t + d)
    want_y, want_s = JR.wkv(*(jnp.asarray(a) for a in (r, k, v, w, u, s0)))
    got_y, got_s = ref.wkv6_ref(*_t(r, k, v, w, u), s0=_t(s0)[0],
                                want_state=True)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), **TOL)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), **TOL)


def test_decode_step_matches_reference_wkv_chunk():
    """T = 1, the decode fast path of the reference's time mix: its
    `_wkv_chunk` on one step."""
    r, k, v, w, u, s0 = _inputs(4, 1, 3, 16, seed=11)
    want_s, want_y = JR._wkv_chunk(jnp.asarray(u), jnp.asarray(s0),
                                   tuple(jnp.asarray(a) for a in (r, k, v, w)))
    got_y, got_s = ref.wkv6_ref(*_t(r, k, v, w, u), s0=_t(s0)[0],
                                want_state=True)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), **TOL)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), **TOL)


def test_chunks_through_the_state_equal_one_pass():
    """A 40-step prompt as chunks of 16, 16 and 8 steps, then 3 decode
    steps, each continuing the last state: y and the state equal one pass
    over all 43 steps from s0 (and the zero-state form with s0 omitted)."""
    r, k, v, w, u, s0 = _t(*_inputs(2, 43, 2, 16, seed=5))
    y_all, s_all = ref.wkv6_ref(r, k, v, w, u, s0=s0, want_state=True)
    ys, s = [], s0
    for lo, hi in ((0, 16), (16, 32), (32, 40), (40, 41), (41, 42),
                   (42, 43)):
        y, s = ops.wkv6_fwd(*(a[:, lo:hi].contiguous() for a in (r, k, v, w)),
                            u, s0=s, want_state=True)
        ys.append(y)
    torch.testing.assert_close(torch.cat(ys, 1), y_all, **TOL)
    torch.testing.assert_close(s, s_all, **TOL)
    zero_y = ref.wkv6_ref(r, k, v, w, u)
    torch.testing.assert_close(
        ref.wkv6_ref(r, k, v, w, u, s0=torch.zeros_like(s0)), zero_y,
        rtol=0, atol=0)


def test_state_form_on_cpu_is_plain_and_counts_nothing():
    """On CPU tensors the wrapper returns the plain version's (y, s_last)
    bitwise and counts no launch; a wrong s0 is refused before any
    dispatch."""
    r, k, v, w, u, s0 = _t(*_inputs(2, 16, 2, 64, seed=3))
    ops.reset_launch_counts()
    y, s_last = ops.wkv6_fwd(r, k, v, w, u, s0=s0, want_state=True)
    want_y, want_s = ref.wkv6_ref(r, k, v, w, u, s0=s0, want_state=True)
    assert torch.equal(y, want_y) and torch.equal(s_last, want_s)
    assert torch.equal(ops.wkv6_fwd(r, k, v, w, u, s0=s0), want_y)
    assert ops.launch_counts()["wkv6"] == 0
    for bad in (s0[:1], s0.double(), s0.transpose(-1, -2), s0[:, :1]):
        with pytest.raises(ValueError, match="s0"):
            ops.wkv6_fwd(r, k, v, w, u, s0=bad)


def test_padded_steps_leave_the_state():
    """Padded steps as the time mix feeds them (k = 0, w = 1) are identity
    steps: the state after a chunk of 5 valid + 11 padded steps is the
    state after the 5."""
    r, k, v, w, u, s0 = _t(*_inputs(1, 16, 2, 16, seed=9))
    valid = (torch.arange(16) < 5)[None, :, None, None]
    _, s_pad = ref.wkv6_ref(r, torch.where(valid, k, 0.0), v,
                            torch.where(valid, w, 1.0), u, s0=s0,
                            want_state=True)
    _, s_5 = ref.wkv6_ref(r[:, :5], k[:, :5], v[:, :5], w[:, :5], u, s0=s0,
                          want_state=True)
    torch.testing.assert_close(s_pad, s_5, rtol=0, atol=0)

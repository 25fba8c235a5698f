"""The chunked linear-space form of the RWKV-6 WKV recurrence, forward and
backward, as `kernels/csrc/wkv6.cu` computes it, written out here in numpy
and held against the port's step-by-step plain versions (`ref.wkv6_ref`,
`ref.wkv6_bwd_ref`) and against the reference model's `wkv` and `jax.grad`
of it, on the same numpy inputs.

A chunk covers steps t0 .. t0+C-1; S_c is the state before it and G_c the
gradient of the state after its last step. Every decay factor is a product
of w's built by running multiplication (never a quotient, exp or log):
A_t = prod_{t0<=s<t} w_s, B_t = prod_{t<s<=t0+C-1} w_s and, for u < t,
P(u, t) = prod_{u<s<t} w_s. So a decay of 1e-12 underflows to 0 instead of
overflowing, as the reference's log-space chunks do.

Forward: y_t = (r_t A_t) S_c + sum_{u<=t} att[t, u] v_u, with att[t, u] =
sum_d r_t k_u P(u, t) and the bonus r_t . (u k_t) on the diagonal; S_{c+1}
= diag(prod of the chunk's w) S_c + (k B)^T V. The backward's dv is that
same forward run backwards in time with r and k swapped and dy for v; its
states are the G_c. dr, dk, dw and du come per chunk from S_c, G_c and the
chunk's inputs alone, with dw = rowsum(G_t * S_{t-1}) expanded into those
terms directly (no cumulative sum divided by w); the intra-chunk sums are
the kernel's two walks a channel, one forward in t and one back."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from repro_torch.testing import limit_threads  # noqa: E402

limit_threads()
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import rwkv6 as JR  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

B_, H_, D_ = 2, 3, 16


def _inputs(t, seed, strong=False):
    """r, k, v, dy ~ 0.5 N, w = exp(-exp(N - 1)) (the reference tests'
    draw), u ~ 0.3 N, as numpy fp32 [B, T, H, D] / [H, D]; `strong` sets
    w = 1e-12 on every other channel."""
    rng = np.random.default_rng(seed)
    shape = (B_, t, H_, D_)
    r, k, v, dy = (rng.normal(size=shape).astype(np.float32) * 0.5
                   for _ in range(4))
    w = np.exp(-np.exp(rng.normal(size=shape) - 1.0)).astype(np.float32)
    if strong:
        w[..., ::2] = 1e-12
    u = (rng.normal(size=(H_, D_)) * 0.3).astype(np.float32)
    return r, k, v, w, u, dy


def _rows(a):
    """[B, T, H, D] -> [B*H, T, D]."""
    b, t, h, d = a.shape
    return np.ascontiguousarray(a.transpose(0, 2, 1, 3).reshape(b * h, t, d))


def _unrows(a, b):
    n, t, d = a.shape
    return a.reshape(b, n // b, t, d).transpose(0, 2, 1, 3)


def _pad(a, tp):
    """Zeros past T: a padded step has k = v = r = dy = 0, so it adds
    nothing, and its w = 0 only scales states that nothing reads."""
    return np.pad(a, ((0, 0), (0, tp - a.shape[1]), (0, 0)))


def _decays(wc):
    """A, B [N, C, D] and the chunk's product [N, D], by running products."""
    n, c, d = wc.shape
    a_, b_ = np.empty_like(wc), np.empty_like(wc)
    a = np.ones((n, d), np.float32)
    for t in range(c):
        a_[:, t] = a
        a = a * wc[:, t]
    b = np.ones((n, d), np.float32)
    for t in range(c - 1, -1, -1):
        b_[:, t] = b
        b = b * wc[:, t]
    return a_, b_, a


def _scores(rc, kc, wc, u):
    """att [N, C, C]: att[t, j] = sum_d r_t k_j P(j, t) below the diagonal,
    r_t . (u k_t) on it, 0 above. P(j, t) runs up from k_j as t grows."""
    n, c, _ = rc.shape
    att = np.zeros((n, c, c), np.float32)
    for j in range(c):
        att[:, j, j] = (rc[:, j] * u * kc[:, j]).sum(-1)
        kp = kc[:, j].copy()
        for t in range(j + 1, c):
            att[:, t, j] = (rc[:, t] * kp).sum(-1)
            kp = kp * wc[:, t]
    return att


def chunked_scan(r, k, v, w, u, c):
    """The chunked forward on rows [N, T, D] (u [N, D]): (y [N, T, D], the
    state before every chunk [N, nc, D, D])."""
    n, t, d = r.shape
    nc = -(-t // c)
    r, k, v, w = (_pad(a, nc * c) for a in (r, k, v, w))
    s = np.zeros((n, d, d), np.float32)
    y = np.empty_like(r)
    states = np.empty((n, nc, d, d), np.float32)
    for ci in range(nc):
        sl = slice(ci * c, ci * c + c)
        rc, kc, vc, wc = r[:, sl], k[:, sl], v[:, sl], w[:, sl]
        a_, b_, pi = _decays(wc)
        states[:, ci] = s
        y[:, sl] = (np.einsum("ntd,nde->nte", rc * a_, s)
                    + np.einsum("ntj,nje->nte", _scores(rc, kc, wc, u), vc))
        s = pi[:, :, None] * s + np.einsum("njd,nje->nde", kc * b_, vc)
    return y[:, :t], states


def chunked_bwd(r, k, v, w, u, dy, c):
    """The chunked backward on rows: (dr, dk, dv, dw [N, T, D], du [N, D]
    summed over the rows' steps, S_c and G_c [N, nc, D, D])."""
    n, t, d = r.shape
    nc = -(-t // c)
    tp = nc * c
    _, s_states = chunked_scan(r, k, v, w, u, c)
    # dv and the G_c: the forward, backwards in time, r <-> k, dy for v
    flip = [_pad(a, tp)[:, ::-1] for a in (k, r, dy, w)]
    dv_f, g_f = chunked_scan(*flip, u, c)
    dv = dv_f[:, ::-1][:, :t]
    g_states = g_f[:, ::-1]
    r, k, v, w, dy = (_pad(a, tp) for a in (r, k, v, w, dy))
    dr, dk, dw = (np.empty_like(r) for _ in range(3))
    du = np.zeros((n, d), np.float32)
    for ci in range(nc):
        sl = slice(ci * c, ci * c + c)
        rc, kc, vc, wc, dyc = (a[:, sl] for a in (r, k, v, w, dy))
        s0, g1 = s_states[:, ci], g_states[:, ci]
        sd = np.einsum("nde,nte->ntd", s0, dyc)     # (S_c dy_t)[d]
        gv = np.einsum("nde,nte->ntd", g1, vc)      # (G_c v_t)[d]
        vd = np.einsum("nse,nje->nsj", dyc, vc)     # dy_s . v_j
        sg = (s0 * g1).sum(-1)
        # forward walk: A_t, x_t = sum_{j<t} P(j,t) k_j GV_j and the vector
        # z_t[s] = sum_{j<t} P(j,t) k_j VD[s,j], all by multiplying with w
        a = np.ones((n, d), np.float32)
        x = np.zeros((n, d), np.float32)
        z = np.zeros((n, c, d), np.float32)
        zz, a_t, x_t = [], [], []
        for i in range(c):
            zz.append(z.copy())
            a_t.append(a)
            x_t.append(x)
            diag = vd[:, i, i][:, None]
            dr[:, ci * c + i] = a * sd[:, i] + z[:, i] + u * kc[:, i] * diag
            du += rc[:, i] * kc[:, i] * diag
            a = a * wc[:, i]
            x = wc[:, i] * x + kc[:, i] * gv[:, i]
            z = wc[:, None, i] * z + kc[:, None, i] * vd[:, :, i, None]
        # backward walk: B_t, m_t = sum_{s>t} P(t,s) r_s SD_s, the vector
        # y_t[j] = sum_{s>t} P(t,s) r_s VD[s,j] and beta_t[s] = P(t,s) r_s,
        # which meets z_t for the last term of dw
        bb = np.ones((n, d), np.float32)
        m = np.zeros((n, d), np.float32)
        yv = np.zeros((n, c, d), np.float32)
        beta = np.zeros((n, c, d), np.float32)
        for i in range(c - 1, -1, -1):
            if i + 1 < c:
                beta[:, i + 1] = rc[:, i + 1]
            t3 = (beta * zz[i]).sum(1)
            diag = vd[:, i, i][:, None]
            dk[:, ci * c + i] = bb * gv[:, i] + yv[:, i] + u * rc[:, i] * diag
            dw[:, ci * c + i] = (a_t[i] * bb * sg + a_t[i] * m
                                 + bb * x_t[i] + t3)
            m = wc[:, i] * m + rc[:, i] * sd[:, i]
            yv = wc[:, None, i] * yv + rc[:, None, i] * vd[:, i, :, None]
            beta = beta * wc[:, None, i]
            bb = bb * wc[:, i]
    return (dr[:, :t], dk[:, :t], dv, dw[:, :t], du, s_states, g_states)


def _chunked(r, k, v, w, u, dy, c):
    """The chunked forms in the model's layout: y and (dr, dk, dv, dw, du
    [H, D])."""
    b = r.shape[0]
    uu = np.tile(u, (b, 1))
    rows = [_rows(a) for a in (r, k, v, w, dy)]
    y, _ = chunked_scan(*rows[:4], uu, c)
    dr, dk, dv, dw, du, _, _ = chunked_bwd(*rows[:4], uu, rows[4], c)
    grads = [_unrows(a, b) for a in (dr, dk, dv, dw)]
    return _unrows(y, b), grads + [du.reshape(b, -1, du.shape[-1]).sum(0)]


def _close(name, got, want):
    """fp32 on both sides, summed in other orders (chunk products against
    single steps) over at most 1001 steps of decays below 1: held within
    2e-5 of the largest |value| of the step-by-step result."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.isfinite(got).all(), f"{name}: not finite"
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= 2e-5 * scale, f"{name}: max abs err {err} against {scale}"


CASES = [(c, t) for c in (16, 64) for t in (1, c - 1, c, c + 1, 1001)]


@pytest.mark.parametrize("c,t", CASES)
def test_chunked_matches_plain_step_by_step(c, t):
    r, k, v, w, u, dy = _inputs(t, seed=c * 7 + t)
    y, grads = _chunked(r, k, v, w, u, dy, c)
    xs = [torch.from_numpy(a) for a in (r, k, v, w, u, dy)]
    _close("y", y, ref.wkv6_ref(*xs[:5]).numpy())
    for name, got, want in zip("rkvwu", grads, ref.wkv6_bwd_ref(*xs)):
        _close(f"d{name}", got, want.numpy())


def _jax_wkv(r, k, v, w, u):
    """The reference model's `wkv` from s0 = 0; where its 32-step chunks do
    not divide T, its chunk body over the whole sequence."""
    s0 = jnp.zeros((r.shape[0], r.shape[2], r.shape[3], r.shape[3]),
                   jnp.float32)
    t = r.shape[1]
    if t % min(JR.CHUNK, t) == 0:
        return JR.wkv(r, k, v, w, u, s0)[0]
    return JR._wkv_chunk(u, s0, (r, k, v, w))[1]


@pytest.mark.parametrize("c,t", CASES)
def test_chunked_matches_jax_model_wkv_and_grad(c, t):
    r, k, v, w, u, dy = _inputs(t, seed=c * 11 + t)
    y, grads = _chunked(r, k, v, w, u, dy, c)
    js = [jnp.asarray(a) for a in (r, k, v, w, u)]
    _close("y", y, np.asarray(_jax_wkv(*js)))
    want = jax.grad(lambda *a: jnp.sum(_jax_wkv(*a) * dy),
                    argnums=(0, 1, 2, 3, 4))(*js)
    for name, got, j in zip("rkvwu", grads, want):
        _close(f"d{name}", got, np.asarray(j))


@pytest.mark.parametrize("c", [16, 64])
@pytest.mark.parametrize("t", [100, 1001])
def test_chunked_strong_decay_stays_finite_and_right(c, t):
    """w = 1e-12 on half the channels: every factor underflows towards 0
    and nothing overflows; dw is held directly against the oracle's."""
    r, k, v, w, u, dy = _inputs(t, seed=c + t, strong=True)
    y, grads = _chunked(r, k, v, w, u, dy, c)
    xs = [torch.from_numpy(a) for a in (r, k, v, w, u, dy)]
    _close("y", y, ref.wkv6_ref(*xs[:5]).numpy())
    for name, got, want in zip("rkvwu", grads, ref.wkv6_bwd_ref(*xs)):
        _close(f"d{name}", got, want.numpy())


def _oracle_states(r, k, v, w, dy):
    """Rows [N, T, D]: S_{t} and dS_t (gradient of S_t) for every t, step by
    step."""
    n, t, d = r.shape
    s = np.zeros((n, d, d), np.float32)
    ss = []
    for i in range(t):
        ss.append(s)                                   # S_{i-1}
        s = w[:, i, :, None] * s + k[:, i, :, None] * v[:, i, None, :]
    g = np.zeros((n, d, d), np.float32)
    gs = [None] * t
    for i in range(t - 1, -1, -1):
        gs[i] = g                                      # dS_i
        g = r[:, i, :, None] * dy[:, i, None, :] + w[:, i, :, None] * g
    return ss, gs


@pytest.mark.parametrize("c", [16, 64])
def test_chunk_boundary_states_match_the_oracle(c):
    """S before every chunk and dS after its last step (zero past T)."""
    t = 3 * c + 5
    r, k, v, w, u, dy = (_rows(a) if a.ndim == 4 else a
                         for a in _inputs(t, seed=c))
    uu = np.tile(u, (B_, 1))
    *_, s_states, g_states = chunked_bwd(r, k, v, w, uu, dy, c)
    ss, gs = _oracle_states(r, k, v, w, dy)
    for ci in range(s_states.shape[1]):
        _close(f"S before chunk {ci}", s_states[:, ci], ss[ci * c])
        end = ci * c + c - 1
        want = gs[end] if end < t else np.zeros_like(gs[0])
        _close(f"dS after chunk {ci}", g_states[:, ci], want)


def test_dv_is_the_forward_run_backwards_in_time():
    """dv_t = G_t^T k_t + dy_t (r_t . u k_t): the forward recurrence on
    reversed time with r and k swapped and dy for v, step by step."""
    r, k, v, w, u, dy = _inputs(37, seed=3)
    flip = [torch.from_numpy(np.ascontiguousarray(a[:, ::-1]))
            for a in (k, r, dy, w)]
    dv = ref.wkv6_ref(*flip[:3], flip[3], torch.from_numpy(u)).numpy()
    want = ref.wkv6_bwd_ref(*(torch.from_numpy(a)
                              for a in (r, k, v, w, u, dy)))[2].numpy()
    _close("dv", dv[:, ::-1], want)


def test_probe_variants_apply_to_the_shipped_source():
    """`launch/wkv_probe.py` undoes design choices by editing the CUDA
    source's text: every edit, and every clock64() stamp of --trace, must
    find its text exactly once, or the probe cannot build on the card."""
    from repro_torch.kernels import build
    from repro_torch.launch import wkv_probe
    src = (build.CSRC / "wkv6.cu").read_text()
    for name, edits in list(wkv_probe.VARIANTS.items()) + [
            ("trace", wkv_probe.TRACE)]:
        for old, _ in edits:
            assert src.count(old) == 1, (name, old)
        assert wkv_probe._edit(src, edits, name) != src or not edits

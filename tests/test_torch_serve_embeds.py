"""Serving the embedding-input archs (musicgen-medium, qwen2-vl-7b) in the
port, against the reference's engine on their smoke configs (f32): the
synthetic prompts bitwise the reference's, the engine's counts equal the
JAX engine's with the same flags, every request's first token (its
prefill's) equal to the JAX engine's, and every later token equal to the
port's contiguous oracle fed the same placeholder embeddings. (The
placeholder frontend draws fresh decode embeddings each step from each
engine's own generator, which the two frameworks cannot share.)"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from repro_torch.testing import limit_threads  # noqa: E402

limit_threads()
jax = pytest.importorskip("jax")

from repro import configs as JC  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serve import engine as JE  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as PC  # noqa: E402
from repro_torch.models import decoding as PD  # noqa: E402
from repro_torch.serve import PersonalizationConfig  # noqa: E402
from repro_torch.serve import engine as PE  # noqa: E402
from repro_torch.serve import scheduler as PS  # noqa: E402

ARCHS = ("musicgen-medium", "qwen2-vl-7b")
COUNTS = ("requests_completed", "requests_cancelled", "tokens_out",
          "tokens_cancelled", "refills", "prefill_chunks", "pages_total",
          "pages_peak", "cow_splits", "prefill_tokens", "decode_tokens",
          "prefix_mode")
PLEN, GEN, MAX_LEN = 20, 6, 26


@pytest.mark.parametrize("arch", ARCHS)
def test_random_requests_are_bitwise_the_references(arch):
    want = JE.make_random_requests(JC.get_smoke_config(arch), 5, PLEN, GEN,
                                   seed=3)
    got = PE.make_random_requests(PC.get_smoke_config(arch), 5, PLEN, GEN,
                                  seed=3)
    for w, g in zip(want, got):
        assert (g.rid, g.max_new_tokens, g.tokens) == \
            (w.rid, w.max_new_tokens, None)
        assert g.embeds.dtype == w.embeds.dtype == np.float32
        assert g.embeds.tobytes() == w.embeds.tobytes()


def capture_decode_embeds(engine, monkeypatch):
    """{rid: [the placeholder embedding [d] each decode step fed it]}."""
    fed, last = {}, {}
    make_decode, make_chunk = engine._decode_batch, engine._chunk_batch
    record = PS.Scheduler.record_token

    def decode_batch(*args):
        batch = make_decode(*args)
        last["embeds"] = batch["embeds"][:, 0].clone()
        return batch

    def chunk_batch(*args):
        last.clear()        # a prompt's first token is its prefill's
        return make_chunk(*args)

    def record_token(sched, slot, token):
        if last:
            fed.setdefault(slot.request.rid, []).append(
                last["embeds"][slot.index])
        return record(sched, slot, token)

    monkeypatch.setattr(engine, "_decode_batch", decode_batch)
    monkeypatch.setattr(engine, "_chunk_batch", chunk_batch)
    monkeypatch.setattr(PS.Scheduler, "record_token", record_token)
    return fed


def oracle_tokens(cfg, params, prompt, fed):
    """Greedy tokens of contiguous prefill + decode_step fed `prompt` and
    then `fed`, at the engine's positions ([3, 1, S] equal components for
    M-RoPE)."""
    def pos(start, n):
        p = torch.arange(start, start + n)[None]
        return p.expand(3, 1, n) if cfg.mrope else p
    logits, cache = PD.prefill(cfg, params, {
        "embeds": torch.from_numpy(prompt)[None],
        "positions": pos(0, len(prompt))}, pad_to=MAX_LEN)
    out = [int(logits.argmax(-1)[0])]
    for j, e in enumerate(fed):
        logits, cache = PD.decode_step(cfg, params, {
            "embeds": e[None, None], "positions": pos(len(prompt) + j, 1)},
            cache)
        out.append(int(logits.argmax(-1)[0]))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_reference_counts_first_tokens_and_oracle(
        arch, monkeypatch):
    """2 slots, pages of 8, 5 requests of 20 + 6, `prefix_mode="radix"`
    asked of both engines (both serve embed archs with it off): equal
    counts, equal first tokens; the rest equal to the contiguous oracle;
    every sampled step's top-2 logit gap above 1e-4."""
    jcfg, pcfg = JC.get_smoke_config(arch), PC.get_smoke_config(arch)
    params = JT.init_params(jcfg, jax.random.PRNGKey(1))
    pp = bridge.to_torch(jax.device_get(params))
    kw = dict(num_slots=2, max_len=MAX_LEN, page_size=8, prefix_mode="radix")
    want = JE.ServeEngine(jcfg, params, **kw).run(
        JE.make_random_requests(jcfg, 5, PLEN, GEN, seed=3))
    eng = PE.ServeEngine(pcfg, pp, **kw)
    seen, sample = [], eng._sample

    def rec(logits):
        seen.append(logits.clone())
        return sample(logits)
    monkeypatch.setattr(eng, "_sample", rec)
    fed = capture_decode_embeds(eng, monkeypatch)
    reqs = PE.make_random_requests(pcfg, 5, PLEN, GEN, seed=3)
    got = eng.run(reqs)
    top = torch.topk(torch.cat(seen), 2, dim=-1).values
    assert float((top[:, 0] - top[:, 1]).min()) > 1e-4
    for key in COUNTS:
        assert getattr(got, key) == getattr(want, key), key
    assert got.prefix_mode == "off"
    for r in reqs:
        toks = got.results[r.rid].tokens
        assert len(toks) == GEN and len(fed[r.rid]) == GEN - 1
        assert toks[0] == want.results[r.rid].tokens[0]
        assert toks == oracle_tokens(pcfg, pp, r.embeds, fed[r.rid])


def test_decode_embeds_come_from_the_engines_seed():
    """Two engines of one seed serve the same tokens; the placeholder
    embeddings of another seed differ."""
    cfg = PC.get_smoke_config("musicgen-medium")
    from repro_torch.models import transformer as PT
    params = PT.init_params(cfg, 0, "cpu")
    runs = []
    for seed in (0, 0):
        eng = PE.ServeEngine(cfg, params, num_slots=2, max_len=MAX_LEN,
                             page_size=8, seed=seed)
        res = eng.run(PE.make_random_requests(cfg, 3, PLEN, GEN, seed=3))
        runs.append([res.results[i].tokens for i in range(3)])
    assert runs[0] == runs[1]
    a = PE.ServeEngine(cfg, params, num_slots=2, max_len=MAX_LEN, seed=0)
    b = PE.ServeEngine(cfg, params, num_slots=2, max_len=MAX_LEN, seed=1)
    rows = ([0, 0], [PLEN, PLEN], [True, True])
    ea, eb = a._decode_batch(*rows)["embeds"], b._decode_batch(*rows)["embeds"]
    assert ea.shape == (2, 1, cfg.d_model) and not torch.equal(ea, eb)


@pytest.mark.parametrize("arch", ARCHS)
def test_embed_archs_refuse_personalization(arch):
    """As the reference asserts: online waves train on token streams."""
    cfg = PC.get_smoke_config(arch)
    from repro_torch.models import transformer as PT
    with pytest.raises(ValueError, match="token streams"):
        PE.ServeEngine(cfg, PT.init_params(cfg, 0, "cpu"), num_slots=2,
                       max_len=MAX_LEN,
                       personalization=PersonalizationConfig())


def test_serve_cli_serves_qwen2_vl_on_the_cpu(capsys):
    from repro_torch.launch import serve
    stats = serve.main(["--arch", "qwen2-vl-7b", "--smoke", "--device", "cpu",
                        "--requests", "4", "--batch", "2", "--prompt-len",
                        "20", "--gen-len", "4", "--page-size", "8"])
    assert stats.requests_completed == 4 and stats.tokens_out == 16
    assert "4/4 requests" in capsys.readouterr().out

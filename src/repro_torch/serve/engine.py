"""Continuous-batching engine over a paged KV cache, with per-user compact
deltas and online train waves.

One engine iteration:

1. *Timeouts*: requests past their deadline are cancelled (queued ones are
   dropped without admission); their tokens never reach the throughput
   counters.
2. *Admission*: while a FREE slot and a queued request exist AND the page
   pool can cover the request's worst-case page need, bind the request to
   the slot.
3. *Chunked prefill*: every PREFILL slot advances by ONE page-sized chunk
   through the same `paged_step` the decode uses (B = 1), so a long prompt
   never stalls in-flight decodes. The final chunk's logits give the
   request's first token.
4. *Decode*: one fixed-shape `paged_step` over all slots (S = 1) with
   per-slot start positions and an active mask; inactive rows keep their
   state and their page writes are dropped.

Per-user personalization (a `PersonalizationConfig`): `Request.user` routes
a request to that user's compact delta (`core/delta.py`), copied into the
slot's rows of the device-resident delta batch at admission and applied as
a gather-add inside every covered matmul. When a user's request completes,
an online compact train wave (`train.steps.make_online_wave`) advances the
delta on the request's token stream, and live slots of the same user pick
the new delta up mid-stream. The shared base params are never written.

The port serves the reference engine's `prefix_mode="off"`: no prefix
sharing, so no page is ever shared and copy-on-write never triggers (its
contract stays in `_ensure_writable`). The reference's other features are
refused with the ROADMAP item that brings them: prefix caches, spill and
persist, chaos injection, the request journal, the watchdog and load
shedding (queue A item 13), sharded serving (item 14) and the
flash-decoding softmax (item 12).

Sampling: greedy, or temperature sampling from the engine's own
`torch.Generator`, seeded by `seed` and advanced by every draw.
"""
from __future__ import annotations

import dataclasses
import time
import zlib
from typing import Optional

import numpy as np
import torch

from repro_torch.core.sparse_update import SelSpec, tree_leaves, tree_map
from repro_torch.models import decoding as D
from repro_torch.serve.deltas import DeltaStore, PersonalizationConfig
from repro_torch.serve.paging import PagePool
from repro_torch.serve.sampling import sample_token
from repro_torch.serve.scheduler import Request, Scheduler, Slot

__all__ = ["RequestResult", "ServeEngine", "ServeStats",
           "make_random_requests"]

_A12 = "ROADMAP queue A item 12"
_A13 = "ROADMAP queue A item 13"


@dataclasses.dataclass
class RequestResult:
    rid: int
    tokens: list            # sampled token ids, in order
    latency_s: float        # submit -> completion (includes queueing)
    status: str = "completed"   # completed | cancelled


@dataclasses.dataclass
class ServeStats:
    requests_completed: int
    requests_cancelled: int
    tokens_out: int         # tokens of COMPLETED requests only
    tokens_cancelled: int
    wall_s: float
    tok_per_s: float
    latency_p50_s: float
    latency_p95_s: float
    refills: int            # admissions that recycled a dirty slot
    prefill_chunks: int     # chunked-prefill steps run
    pages_total: int        # page-pool capacity
    pages_peak: int         # peak pages in use
    cow_splits: int
    results: dict           # rid -> RequestResult
    prefix_mode: str = "off"
    # per-user personalization (all zero when the engine has none)
    delta_hits: int = 0             # delta-store admissions that hit
    delta_lookups: int = 0          # delta-store admissions total
    delta_evictions: int = 0
    delta_resident_bytes: int = 0   # host bytes of resident deltas at end
    train_waves: int = 0            # online train waves run
    train_wave_s: float = 0.0       # wall time spent in train waves
    wave_losses: list = dataclasses.field(default_factory=list)
    # (user, pre-update loss) per wave, in wave order
    # phase-split throughput: wall time inside the step (synchronized) and
    # tokens processed, prefill vs decode
    prefill_s: float = 0.0
    decode_s: float = 0.0
    prefill_tokens: int = 0         # VALID prompt tokens prefilled (pad excl.)
    decode_tokens: int = 0          # tokens sampled for runnable slots
    decode_step_s: list = dataclasses.field(default_factory=list)
    # wall time of every decode step, synchronized, in order

    @property
    def page_util(self) -> float:
        return self.pages_peak / max(1, self.pages_total)

    @property
    def delta_hit_rate(self) -> float:
        return self.delta_hits / max(1, self.delta_lookups)

    @property
    def prefill_tok_per_s(self) -> float:
        return self.prefill_tokens / max(self.prefill_s, 1e-9)

    @property
    def decode_tok_per_s(self) -> float:
        return self.decode_tokens / max(self.decode_s, 1e-9)

    @property
    def train_wave_ms_per_token(self) -> float:
        """Train-wave overhead in milliseconds amortized over every decoded
        token."""
        return self.train_wave_s * 1e3 / max(1, self.tokens_out)


def _refuse(what: str, item: str):
    raise NotImplementedError(f"{what}: comes with {item} (not ported yet)")


class ServeEngine:
    """Paged continuous-batching serve loop for one model + parameter set,
    on the device its params lie on."""

    def __init__(self, cfg, params, *, num_slots: int, max_len: int,
                 temperature: float = 0.0, eos_id: Optional[int] = None,
                 seed: int = 0, page_size: int = 16,
                 num_pages: Optional[int] = None, prefix_mode: str = "off",
                 personalization: Optional[PersonalizationConfig] = None,
                 prefix_persist: Optional[str] = None, chaos=None,
                 shed_watermark: float = 0.0,
                 watchdog_s: Optional[float] = None, journal=None,
                 rules=None, flash_decode: Optional[bool] = None):
        assert num_slots >= 1 and max_len >= 2 and page_size >= 1
        if prefix_mode != "off":
            _refuse(f"prefix_mode={prefix_mode!r} (radix / chain prefix "
                    f"caches)", _A13)
        for what, given in (("prefix_persist", prefix_persist is not None),
                            ("chaos (fault injection)", chaos is not None),
                            ("shed_watermark > 0", shed_watermark > 0.0),
                            ("watchdog_s", watchdog_s is not None),
                            ("journal", journal is not None)):
            if given:
                _refuse(what, _A13)
        if rules is not None:
            _refuse("sharded serving (rules)", "ROADMAP queue A item 14")
        if flash_decode:
            _refuse("flash_decode", _A12)
        self.cfg = cfg
        self.params = params
        self.device = tree_leaves(params)[0].device
        self.num_slots = num_slots
        self.max_len = max_len
        self.page_size = page_size
        self.max_pages = -(-max_len // page_size)
        self.has_pages = D.has_paged_layers(cfg)
        self.num_pages = 0 if not self.has_pages else (
            num_pages if num_pages is not None
            else num_slots * self.max_pages)
        self.prefix_mode = prefix_mode
        self.temperature = float(temperature)
        self.eos_id = eos_id
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._decode_length = torch.ones((num_slots,), dtype=torch.int32,
                                         device=self.device)
        ps = page_size
        self._step = lambda p, batch, state, pools, pt, deltas: D.paged_step(
            cfg, p, batch, state, pools, pt, page_size=ps, deltas=deltas)
        self._p13n = personalization
        self._dbatch = None
        if personalization is not None:
            self._init_personalization()

    # -- per-user personalization ------------------------------------------

    def _init_personalization(self):
        """The selection plan pruned to decode-coverable leaves, the
        frozen / trainable base split (views of the served params), the
        online train wave and the per-user delta store. Requests with
        user=None keep zero delta rows, an exact no-op."""
        from repro_torch.core.delta import decode_delta_spec
        from repro_torch.core.selection import build_plan
        from repro_torch.train.steps import make_online_wave, split_params

        p = self._p13n
        plan = build_plan(self.cfg, p.sparse, 0)
        frozen, trainable = split_params(self.params, plan)
        spec = decode_delta_spec(plan, trainable["segments"])
        if not spec:
            raise ValueError(
                "no decode-coverable selectable leaves for this arch "
                "(personalized decode covers attn/mlp projections only)")
        # train exactly what decode can apply: waves update only the
        # covered leaves, so the served model IS the trained one
        self._plan = dataclasses.replace(plan, spec=spec)
        self._frozen, self._trainable = frozen, trainable
        self._seg_steps = {
            seg: tree_leaves(self.params["segments"][seg])[0].shape[0]
            for seg in spec}
        self._wave = make_online_wave(self.cfg, p.sparse, p.optimizer,
                                      self._plan,
                                      wave_tokens=p.train_tokens)
        self._deltas = DeltaStore(p.store_capacity, self._make_delta_entry)

    def _make_delta_entry(self, user):
        """Fresh zero delta (host tensors) with this user's fixed channel
        selection: drawn from generators seeded by the personalization seed
        XOR the crc32 of the user id, so it is stable across evictions."""
        from repro_torch.core.delta import DeltaState, zeros_delta_tree
        from repro_torch.core.selection import random_selection

        salt = zlib.crc32(str(user).encode()) & 0x7FFFFFFF
        drawn = random_selection(self._plan, self._p13n.seed ^ salt, 0, "cpu")
        idx = {seg: drawn[seg] for seg in self._plan.spec}
        vals = zeros_delta_tree(self._trainable["segments"], idx,
                                self._plan.spec, device="cpu")
        return DeltaState(idx=idx, vals=vals)

    def _delta_batch_zeros(self):
        """Device-resident per-slot delta rows, all zero: {seg: {"idx",
        "val"}} with leaves [steps, num_slots, ...] beside the params
        (zero rows over the frozen prefix and for plain slots)."""
        b, dev = self.num_slots, self.device

        def walk(stack, sp, steps):
            if isinstance(sp, SelSpec):
                return (torch.zeros((steps, b, sp.n_shards, sp.n_sel),
                                    dtype=torch.int32, device=dev),
                        torch.zeros((steps, b, stack.shape[1], sp.n_shards,
                                     sp.n_sel, sp.block),
                                    dtype=torch.float32, device=dev))
            pairs = {k: walk(stack[k], sp[k], steps) for k in sp}
            return ({k: v[0] for k, v in pairs.items()},
                    {k: v[1] for k, v in pairs.items()})

        out = {}
        for seg, spec in self._plan.spec.items():
            idx, val = walk(self._trainable["segments"][seg], spec,
                            self._seg_steps[seg])
            out[seg] = {"idx": idx, "val": val}
        return out

    def _insert_delta_row(self, entry, row: int):
        """Copy a host DeltaState into slot `row` of the delta batch, zero
        over the frozen layer prefix (the trainable layers are the LAST K
        of each segment), in place."""
        for seg in self._plan.spec:
            steps = self._seg_steps[seg]
            for key, src in (("idx", entry.idx[seg]),
                             ("val", entry.vals[seg])):
                def ins(dst, a):
                    k = a.shape[0]
                    dst[:steps - k, row].zero_()
                    dst[steps - k:, row].copy_(a)
                    return dst
                tree_map(ins, self._dbatch[seg][key], src)

    def _online_wave(self, slot: Slot, sched: Scheduler):
        """One compact train wave on the completed request's token stream:
        advance the user's delta in the store, and re-materialize the delta
        rows of any live slot of the same user (their in-flight decode picks
        the update up mid-stream)."""
        req = slot.request
        p = self._p13n
        stream = np.concatenate([np.asarray(req.tokens, np.int64),
                                 np.asarray(slot.out_tokens, np.int64)])
        n = p.train_tokens
        arr = stream[-(n + 1):] if len(stream) >= n + 1 \
            else np.resize(stream, n + 1)
        batch = {"tokens": self._tensor(arr[:-1])[None],
                 "labels": self._tensor(arr[1:])[None]}
        entry = self._deltas.get(req.user)
        to_dev = lambda a: a.to(self.device)
        t0 = time.perf_counter()
        new_vals, metrics = self._wave(
            self._trainable, self._frozen, tree_map(to_dev, entry.vals),
            tree_map(to_dev, entry.idx), batch)
        loss = float(metrics["loss"])
        self._sync()
        self._wave_s += time.perf_counter() - t0
        self._wave_count += 1
        self._wave_losses.append((req.user, loss))
        entry.vals = tree_map(lambda a: a.cpu(), new_vals)
        self._deltas.put(req.user, entry)
        for other in sched.live_slots():
            if other is slot or other.request is None or \
                    other.request.user != req.user:
                continue
            self._insert_delta_row(entry, other.index)

    # -- input plumbing ----------------------------------------------------

    def _tensor(self, values, dtype=torch.int32):
        return torch.as_tensor(np.asarray(values), dtype=dtype,
                               device=self.device)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _sample(self, logits) -> list:
        return sample_token(logits, self._gen, self.temperature).tolist()

    def _chunk_batch(self, req: Request, start: int, size: int):
        """Prefill chunk, always padded to one page-sized shape; `length`
        masks the padding inside the step (writes dropped, logits at
        length-1)."""
        ps = self.page_size
        toks = np.asarray(req.tokens[start:start + size], np.int32)
        if size < ps:
            toks = np.pad(toks, (0, ps - size))
        return {"start": self._tensor([start]),
                "active": self._tensor([True], torch.bool),
                "length": self._tensor([size]),
                "tokens": self._tensor(toks)[None]}

    def _decode_batch(self, tokens_row, pos_row, active_row):
        return {"start": self._tensor(pos_row),
                "active": self._tensor(active_row, torch.bool),
                "length": self._decode_length,
                "tokens": self._tensor(tokens_row)[:, None]}

    # -- page bookkeeping --------------------------------------------------

    def _pages_needed(self, req: Request) -> int:
        if not self.has_pages:
            return 0
        # the final sampled token is returned but never written back
        written = req.prompt_len + req.max_new_tokens - 1
        return -(-written // self.page_size)

    def _worst_case_need(self, slot: Slot) -> int:
        """Pages this live request may still allocate: unallocated logical
        pages plus (at most) one COW of a shared page at its write
        boundary."""
        need = sum(1 for pg in range(self._pages_needed(slot.request))
                   if self._pt[slot.index, pg] < 0)
        wp = slot.pos // self.page_size
        if wp < self.max_pages:
            pid = self._pt[slot.index, wp]
            if pid >= 0 and self._pool.ref[pid] > 1:
                need += 1
        return need

    def _headroom(self, sched: Scheduler) -> int:
        return self._pool.free_pages - sum(self._worst_case_need(s)
                                           for s in sched.live_slots())

    def _ensure_writable(self, slot: Slot, lo: int, hi: int, pools):
        """Make every page covering token positions [lo, hi) allocated and
        exclusive to `slot`, copy-on-write splitting shared pages (copying
        their device rows) before any write lands in them."""
        if not self.has_pages:
            return pools
        ps = self.page_size
        for pg in range(lo // ps, -(-hi // ps)):
            pid = int(self._pt[slot.index, pg])
            if pid < 0:
                pid = self._pool.alloc()
                assert pg == len(slot.page_ids), "non-contiguous page alloc"
                slot.page_ids.append(pid)
                self._pt[slot.index, pg] = pid
            elif self._pool.ref[pid] > 1:
                new = self._pool.cow_split(pid)
                pools = D.copy_pool_rows(pools, pid * ps, new * ps, ps)
                slot.page_ids[pg] = new
                self._pt[slot.index, pg] = new
        return pools

    def _release_slot(self, slot: Slot):
        for pid in slot.page_ids:
            self._pool.decref(pid)
        slot.page_ids = []
        slot.registered_pages = 0
        self._pt[slot.index, :] = -1

    # -- serve loop --------------------------------------------------------

    def run(self, requests: list[Request],
            verbose: bool = False) -> ServeStats:
        for r in requests:
            assert r.tokens is not None, (
                f"request {r.rid}: the port serves token inputs only")
            assert r.max_new_tokens >= 1, (
                f"request {r.rid}: max_new_tokens must be >= 1")
            assert r.prompt_len + r.max_new_tokens <= self.max_len, (
                f"request {r.rid}: prompt {r.prompt_len} + gen "
                f"{r.max_new_tokens} exceeds max_len {self.max_len}")
            assert self._pages_needed(r) <= self.num_pages, (
                f"request {r.rid} needs {self._pages_needed(r)} pages; "
                f"pool has {self.num_pages}")
        sched = Scheduler(self.num_slots, eos_id=self.eos_id)
        for r in requests:
            sched.submit(r)
        self._prefill_s = self._decode_s = 0.0
        self._prefill_tokens = self._decode_tokens = 0
        decode_step_s = []

        state, self._pools = D.init_serve_cache(
            self.cfg, self.num_slots, self.max_len, max(1, self.num_pages),
            self.page_size, device=self.device)
        self._pt = np.full((self.num_slots, self.max_pages), -1, np.int32)
        self._pool = PagePool(max(1, self.num_pages), self.page_size)
        if self._p13n is not None:
            self._dbatch = None     # the previous run's rows go first
            self._dbatch = self._delta_batch_zeros()
            self._duser = [None] * self.num_slots
            self._wave_s, self._wave_count = 0.0, 0
            self._wave_losses = []
        prefill_chunks = 0
        results: dict[int, RequestResult] = {}
        t0 = time.perf_counter()
        deadline = {r.rid: (t0 + r.timeout_s if r.timeout_s is not None
                            else None) for r in requests}

        def close(slot, status):
            req = slot.request
            if self._p13n is not None and req.user is not None:
                if status == "completed":
                    self._online_wave(slot, sched)
                self._deltas.release(req.user)
            results[req.rid] = RequestResult(
                req.rid, list(slot.out_tokens),
                time.perf_counter() - t0, status)
            self._release_slot(slot)
            if verbose and status == "completed":
                print(f"[serve] completed {sched.requests_completed}"
                      f"/{len(requests)} requests", flush=True)

        while not sched.done:
            now = time.perf_counter()
            # 1) deadlines: cancel overdue slots, drop overdue queued ones
            for slot in sched.live_slots():
                dl = deadline[slot.request.rid]
                if dl is not None and now > dl:
                    sched.cancel(slot)
                    close(slot, "cancelled")
            for req in [q for q in sched.queue
                        if deadline[q.rid] is not None
                        and now > deadline[q.rid]]:
                sched.drop_queued(req)
                results[req.rid] = RequestResult(req.rid, [], 0.0,
                                                 "cancelled")

            # 2) admission (two-phase: page-pool pressure defers the queue
            # head without disturbing FIFO order)
            while (adm := sched.peek_admission()) is not None:
                slot, req = adm
                need = self._pages_needed(req)
                if self.has_pages and self._headroom(sched) < need:
                    if sched.live_slots():
                        break   # retry when an in-flight request frees pages
                    # nothing in flight: the whole pool is free, and
                    # pages_needed <= num_pages always fits
                    assert self._headroom(sched) >= need
                sched.commit_admission(slot)
                slot.page_ids = []
                slot.registered_pages = 0
                self._pt[slot.index, :] = -1
                state = D.cache_reset_row(state, slot.index)
                if self._p13n is not None:
                    if req.user is not None:
                        entry = self._deltas.admit(req.user)
                        self._insert_delta_row(entry, slot.index)
                        self._duser[slot.index] = req.user
                    elif self._duser[slot.index] is not None:
                        # recycle a slot a personalized request left dirty
                        D.cache_reset_row(self._dbatch, slot.index)
                        self._duser[slot.index] = None

            # 3) chunked prefill: one page-sized chunk per PREFILL slot
            for slot in sched.prefill_slots():
                req = slot.request
                size = min(self.page_size, req.prompt_len - slot.pos)
                self._pools = self._ensure_writable(
                    slot, slot.pos, slot.pos + size, self._pools)
                st_row = D.cache_extract_row(state, slot.index)
                pt_row = self._tensor(self._pt[slot.index:slot.index + 1])
                d_row = None if self._dbatch is None else \
                    D.cache_extract_row(self._dbatch, slot.index)
                ts = time.perf_counter()
                logits, st_row, self._pools = self._step(
                    self.params, self._chunk_batch(req, slot.pos, size),
                    st_row, self._pools, pt_row, d_row)
                self._sync()
                self._prefill_s += time.perf_counter() - ts
                self._prefill_tokens += size
                state = D.cache_insert_row(state, st_row, slot.index)
                slot.pos += size
                prefill_chunks += 1
                if slot.pos == req.prompt_len:
                    sched.finish_prefill(slot)
                    outcome = sched.record_token(slot,
                                                 self._sample(logits)[0])
                    if outcome is not None:
                        close(slot, "completed" if outcome == "done"
                              else "cancelled")

            active = sched.active_slots()
            if not active:
                if not sched.prefill_slots() and sched.queue:
                    raise RuntimeError(
                        "serve deadlock: queued requests but no admissible "
                        "slot (page-pool accounting bug)")
                continue

            # 4) one decode step over the full fixed-shape batch; each slot
            # consumes its last sampled token at position slot.pos
            for slot in active:
                self._pools = self._ensure_writable(
                    slot, slot.pos, slot.pos + 1, self._pools)
            run_idx = {s.index for s in active}
            tokens_row = [s.last_token for s in sched.slots]
            pos_row = [min(s.pos, self.max_len - 1) for s in sched.slots]
            active_row = [s.index in run_idx for s in sched.slots]
            ts = time.perf_counter()
            logits, state, self._pools = self._step(
                self.params,
                self._decode_batch(tokens_row, pos_row, active_row),
                state, self._pools, self._tensor(self._pt), self._dbatch)
            self._sync()
            decode_step_s.append(time.perf_counter() - ts)
            self._decode_s += decode_step_s[-1]
            self._decode_tokens += len(active)
            toks = self._sample(logits)
            for slot in active:       # inactive rows: sampled, discarded
                slot.pos += 1         # the fed token is now cached
                outcome = sched.record_token(slot, toks[slot.index])
                if outcome is not None:
                    close(slot, "completed" if outcome == "done"
                          else "cancelled")

        wall = time.perf_counter() - t0
        lat = [r.latency_s for r in results.values()
               if r.status == "completed"] or [0.0]
        p13n = self._p13n is not None
        return ServeStats(
            requests_completed=sched.requests_completed,
            requests_cancelled=sched.requests_cancelled,
            tokens_out=sched.tokens_out,
            tokens_cancelled=sched.tokens_cancelled,
            wall_s=wall,
            tok_per_s=sched.tokens_out / max(wall, 1e-9),
            latency_p50_s=float(np.percentile(lat, 50)),
            latency_p95_s=float(np.percentile(lat, 95)),
            refills=sched.refills,
            prefill_chunks=prefill_chunks,
            pages_total=self.num_pages,
            pages_peak=self._pool.peak_in_use,
            cow_splits=self._pool.cow_splits,
            results=results,
            prefix_mode=self.prefix_mode,
            delta_hits=self._deltas.hits if p13n else 0,
            delta_lookups=(self._deltas.hits + self._deltas.misses
                           if p13n else 0),
            delta_evictions=self._deltas.evictions if p13n else 0,
            delta_resident_bytes=self._deltas.resident_bytes if p13n else 0,
            train_waves=self._wave_count if p13n else 0,
            train_wave_s=self._wave_s if p13n else 0.0,
            wave_losses=list(self._wave_losses) if p13n else [],
            prefill_s=self._prefill_s,
            decode_s=self._decode_s,
            prefill_tokens=self._prefill_tokens,
            decode_tokens=self._decode_tokens,
            decode_step_s=decode_step_s,
        )


def make_random_requests(cfg, n: int, prompt_len: int, gen_len: int,
                         seed: int = 0, **req_kw) -> list[Request]:
    """Uniform-random prompts: the synthetic serving workload (the same
    prompts as the reference's for the same seed)."""
    if cfg.embed_inputs:
        raise NotImplementedError("embed-input frontends are not ported yet")
    rng = np.random.default_rng(seed)
    return [Request(rid, gen_len,
                    tokens=rng.integers(0, cfg.vocab_size,
                                        prompt_len).astype(np.int32),
                    **req_kw)
            for rid in range(n)]

"""Continuous-batching engine over a paged KV cache, with per-user compact
deltas and online train waves.

One engine iteration:

1. *Timeouts*: requests past their deadline are cancelled (queued ones are
   dropped without admission); their tokens never reach the throughput
   counters.
2. *Admission*: while a FREE slot and a queued request exist AND the page
   pool can cover the request's worst-case page need, bind the request to
   the slot. Prompt-prefix sharing (every cache family) attaches cached
   pages from the radix tree and, for archs with ring or recurrent state,
   restores the state snapshot at the deepest matched page boundary, so
   the matched prefix tokens are never recomputed. The match stays pinned
   in the tree until the slot closes.
3. *Chunked prefill*: every PREFILL slot advances by ONE page-sized chunk
   through the same `paged_step` the decode uses (B = 1), so a long prompt
   never stalls in-flight decodes. The final chunk's logits give the
   request's first token.
4. *Decode*: one fixed-shape `paged_step` over all slots (S = 1) with
   per-slot start positions and an active mask; inactive rows keep their
   state and their page writes are dropped.

Copy-on-write: any write into a page shared with the prefix cache or
another request first splits it (an exclusive copy of the device rows in
every layer's pool). The canonical trigger: a request registers its
partially-filled last prompt page, then splits it on its first decode
write, leaving the cached page frozen at prompt-only content.

Prefix reuse modes (`prefix_mode`, `serve/paging.py`): "radix" (the
default) is the radix tree over token pages with recurrent-state snapshots
and the host spill tier: evicted and ended trees survive across `run()`
calls and, with `prefix_persist`, across engine restarts. "chain" is the
flat chain-hash baseline (fully-paged archs only, it dies with `run()`),
kept for comparison. "off" disables sharing. Personalized requests
(`user` set) never share: their K/V come from their own delta.

Per-user personalization (a `PersonalizationConfig`): `Request.user` routes
a request to that user's compact delta (`core/delta.py`), copied into the
slot's rows of the device-resident delta batch at admission and applied as
a gather-add inside every covered matmul. When a user's request completes,
an online compact train wave (`train.steps.make_online_wave`) advances the
delta on the request's token stream, and live slots of the same user pick
the new delta up mid-stream. The shared base params are never written.

Every cache family serves: window-free attention through the page pools,
sliding-window layers through per-slot ring buffers, mamba and rwkv layers
through per-slot recurrent state (`models.decoding`). An arch whose mixers
keep only state (rwkv) allocates no pages at all. `flash_decode=True` takes
the paged layers' softmax page by page (the flash-decoding split); as in
the reference it is off by default on one device and on with `rules`.

Robustness (``runtime/chaos.py`` is the serve-side fault story):

- *Deterministic fault injection*: a seeded ``FaultSchedule`` makes page
  allocations, prefill / decode steps and stream callbacks fail (or run
  slow) on a replayable schedule. Step faults fire BEFORE the step and
  alloc faults before any pool mutation, so every injected failure is
  retryable without state repair: under greedy decoding, faults change
  latency and counters, never served tokens. A copy-on-write split copies
  its page's rows in place before the next allocation can fault, so a
  retried chunk finds the split page whole.
- *Graceful degradation*: a faulted slot retries with capped exponential
  backoff (its batch row is masked out, its state kept bit for bit); a
  request that exhausts ``max_retries``, or trips the hung-request
  watchdog, is closed as "quarantined", so one poison request never
  wedges a slot; admission sheds (defers) load when free pages would drop
  below ``shed_watermark``; stream-callback exceptions are absorbed; every
  engine iteration that ran a step feeds a ``StragglerMonitor``. Only
  ``InjectedFault`` is retried: a real error (a failed launch, a kernel
  that did not build) propagates.
- *Crash safety*: with ``journal=...`` every admission and completion is
  fsynced to an append-only request journal (``serve/journal.py``);
  ``recover_requests()`` on a restarted engine replays the requests left
  in flight, and the prefix spill tier (flushed on a clean exit and on
  the crash unwind) turns their prefill into prefix and snapshot hits.
  ``InjectedCrash`` (``kill_after``) simulates the hard kill end to end.

Sharded serving (``rules=``, a ``launch.mesh`` process mesh's rules with a
model axis): every rank of the mesh runs this engine on the same requests.
The host logic (scheduler, radix tree, page tables, sampling) is the same
on every rank, and the logits every step samples from are all-gathered,
the same bytes on every rank, so every rank takes the same decisions.
The step runs on the rank's shards (`models.decoding.
make_sharded_paged_step`): the page pools hold the rank's kv-head block,
the page tables, batch rows and per-slot state stay whole. Each step's
inputs (slots, positions, page-table rows) are checked across the ranks
by a crc32 digest: a rank that has fallen out of step raises rather than
hangs. Every pool helper works on the rank's head block; the spill tier
holds full-head rows (the page reader all-gathers the heads, the writer
takes back the rank's slice), so a tier persisted at one mesh width
restores at another. Every rank trains each online wave on the whole
params it was given (`_host_params`), the one-device wave on the same
inputs, so deltas and tokens are the same at every mesh width, and no
delta crosses the mesh (a broadcast from rank 0 would move one user's
delta values every wave: 436 MB at llama3-8b's widths). What reads
wall time (fault injection and its retry backoff, the watchdog, request
timeouts) would let the ranks' decisions part, and the journal would be
written by every rank: those options are refused on a mesh (ROADMAP
queue A item 14d).

Embedding-input archs (musicgen, qwen2-vl): a request carries its prompt
as `embeds` [prompt_len, d_model], and each decode step feeds every slot a
fresh standard-normal embedding, the reference's placeholder frontend
(sampled tokens are returned, never fed back). They serve with
`prefix_mode="off"` whatever is asked (no token identity to key reuse on)
and without personalization (no token stream to train on).

Sampling: greedy, or temperature sampling from the engine's own
`torch.Generator`, seeded by `seed` and advanced by every draw (the decode
embeddings of the placeholder frontend come from it too).
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import time
import warnings
import zlib
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import sharding as SH
from repro_torch.checkpoint.manager import (CheckpointCorruptError,
                                            restore_spill_tier,
                                            save_spill_tier)
from repro_torch.core.sparse_update import SelSpec, tree_leaves, tree_map
from repro_torch.models import decoding as D
from repro_torch.models.transformer import dtype_of
from repro_torch.runtime.chaos import FaultKind, InjectedCrash, InjectedFault
from repro_torch.runtime.fault import StragglerMonitor
from repro_torch.serve.deltas import DeltaStore, PersonalizationConfig
from repro_torch.serve.journal import RequestJournal
from repro_torch.serve.paging import (ChainPrefixCache, PagePool,
                                      RadixPrefixCache, SpillTier)
from repro_torch.serve.sampling import sample_token
from repro_torch.serve.scheduler import Request, Scheduler, Slot, SlotState

__all__ = ["RequestResult", "ServeEngine", "ServeStats",
           "make_random_requests", "make_shared_prefix_requests",
           "make_branching_prefix_requests"]

def _graft_like(tpl, blob):
    """Re-attach the empty subtrees that checkpoint serialization drops:
    walk the template's dict skeleton and take `blob`'s value wherever the
    template has leaves below (structure only, no data moves)."""
    if isinstance(tpl, dict):
        return {k: _graft_like(v, blob.get(k, {}) if isinstance(blob, dict)
                               else {}) for k, v in tpl.items()}
    return blob


def _to_host(tree):
    """A copy of a tree of tensors on the host (the spill tier's and the
    snapshots' storage)."""
    return tree_map(lambda a: a.to("cpu", copy=True), tree)


@dataclasses.dataclass
class RequestResult:
    rid: int
    tokens: list            # sampled token ids, in order
    latency_s: float        # submit -> completion (includes queueing)
    status: str = "completed"   # completed | cancelled | quarantined


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
    prefix_hit_tokens: int  # prompt tokens served from shared pages
    prefix_lookup_tokens: int
    pages_total: int        # page-pool capacity
    pages_peak: int         # peak pages in use (sharing lowers this)
    cow_splits: int
    results: dict           # rid -> RequestResult
    # prefix-reuse internals (zero when prefix_mode is "off")
    prefix_mode: str = "off"
    prefix_lookups: int = 0         # admission-time cache lookups
    state_lookups: int = 0          # lookups that asked for a state snapshot
    radix_nodes: int = 0            # tree nodes at end of run
    snapshot_hits: int = 0          # matches that restored recurrent state
    snapshots_stored: int = 0
    spills: int = 0                 # entries written to the host spill tier
    rehydrates: int = 0             # spilled entries re-attached on match
    spill_entries: int = 0          # tier size at end of run
    # per-user personalization (all zero when the engine has none)
    delta_hits: int = 0             # delta-store admissions that hit
    delta_lookups: int = 0          # delta-store admissions total
    delta_evictions: int = 0
    delta_resident_bytes: int = 0   # host bytes of resident deltas at end
    train_waves: int = 0            # online train waves run
    train_wave_s: float = 0.0       # wall time spent in train waves
    wave_losses: list = dataclasses.field(default_factory=list)
    # (user, pre-update loss) per wave, in wave order
    # robustness / chaos (all zero without a FaultSchedule / journal)
    faults_injected: int = 0        # chaos draws that fired during this run
    faults_by_kind: dict = dataclasses.field(default_factory=dict)
    retries: int = 0                # transient faults absorbed by backoff
    sheds: int = 0                  # requests deferred by the load-shed watermark
    quarantined: int = 0            # requests closed as poison
    tokens_quarantined: int = 0
    watchdog_kills: int = 0         # quarantines from the hung-request watchdog
    stream_errors: int = 0          # stream-callback exceptions absorbed
    journal_replays: int = 0        # re-admissions recovered from the journal
    stragglers: int = 0             # engine iterations flagged as stragglers
    # sharded serving (the one-device engine: 1 and the pool's bytes)
    mesh_shards: int = 1            # model-axis shards the pools split into
    pool_shard_bytes: int = 0       # page-pool bytes this rank holds
    # phase-split throughput: wall time inside the step (synchronized) and
    # tokens processed, prefill vs decode
    prefill_s: float = 0.0
    decode_s: float = 0.0
    prefill_tokens: int = 0         # VALID prompt tokens prefilled (pad excl.)
    decode_tokens: int = 0          # tokens sampled for runnable slots
    decode_step_s: list = dataclasses.field(default_factory=list)
    # wall time of every decode step, synchronized, in order

    @property
    def prefix_hit_rate(self) -> float:
        return self.prefix_hit_tokens / max(1, self.prefix_lookup_tokens)

    @property
    def page_util(self) -> float:
        return self.pages_peak / max(1, self.pages_total)

    @property
    def snapshot_hit_rate(self) -> float:
        """Snapshot hits over state-family lookups only: attention-family
        lookups never ask for a snapshot."""
        return self.snapshot_hits / max(1, self.state_lookups)

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
                 num_pages: Optional[int] = None, prefix_sharing: bool = True,
                 prefix_mode: str = "radix",
                 prefix_persist: Optional[str] = None,
                 spill_entries: int = 4096, snapshot_budget: int = 256,
                 max_tree_nodes: int = 4096,
                 personalization: Optional[PersonalizationConfig] = None,
                 chaos=None, max_retries: int = 3,
                 retry_backoff_s: float = 0.005,
                 retry_backoff_cap_s: float = 0.1,
                 shed_watermark: float = 0.0,
                 watchdog_s: Optional[float] = None,
                 journal=None, straggler_factor: float = 2.5,
                 rules=None, flash_decode: Optional[bool] = None):
        assert num_slots >= 1 and max_len >= 2 and page_size >= 1
        assert prefix_mode in ("radix", "chain", "off")
        assert max_retries >= 0 and 0.0 <= shed_watermark < 1.0
        if personalization is not None and cfg.embed_inputs:
            raise ValueError("personalization trains on token streams; "
                             "embed-input frontends have none")
        # sharded serving: the rules are checked before any device work
        self.rules = rules
        self.mesh_shards = 1
        if rules is not None:
            if getattr(rules, "mesh", None) is None \
                    or getattr(rules, "model_axis", None) is None:
                raise ValueError(
                    "sharded serving needs AxisRules built from a mesh with "
                    f"a model axis (got mesh={getattr(rules, 'mesh', None)!r}"
                    f", model_axis={getattr(rules, 'model_axis', None)!r})")
            self.mesh_shards = D.validate_pool_sharding(cfg, rules)
            if self.mesh_shards > 1:
                for name, given in (("chaos", chaos is not None),
                                    ("watchdog_s", watchdog_s is not None),
                                    ("journal", journal is not None)):
                    if given:
                        _refuse(f"{name} on a serve mesh",
                                "ROADMAP queue A item 14d")
        # robustness knobs (the module docstring's Robustness section);
        # `chaos` is a runtime.chaos.FaultSchedule or None: every injection
        # point is gated on it, so a chaos-free engine runs the fault-free
        # code path
        self.chaos = chaos
        self.max_retries = max_retries
        self.retry_backoff_s = float(retry_backoff_s)
        self.retry_backoff_cap_s = float(retry_backoff_cap_s)
        self.shed_watermark = float(shed_watermark)
        self.watchdog_s = watchdog_s
        self._straggler_factor = straggler_factor
        self._journal = RequestJournal(journal) if isinstance(journal, str) \
            else journal
        self._stream_errors = 0
        self.cfg = cfg
        self.params = params
        self.device = tree_leaves(params)[0].device
        # the model group and this rank's place in it (None / 0 off a mesh)
        self._mgroup = None
        self._mrank = 0
        if self.mesh_shards > 1:
            self._mgroup = rules.mesh.group(rules.model_axis)
            self._mrank = rules.mesh.index(rules.model_axis)
        if watchdog_s is not None and self.device.type == "cuda":
            # nvcc builds a kernel at its first use (~8 s a source): build
            # them now, or a fresh process's first steps would look hung
            from repro_torch.kernels import build
            build.build_all()
        self.num_slots = num_slots
        self.max_len = max_len
        self.page_size = page_size
        # the reference's default: on when sharded, off on one device
        self.flash_decode = bool(flash_decode) if flash_decode is not None \
            else rules is not None
        self.max_pages = -(-max_len // page_size)
        self.has_pages = D.has_paged_layers(cfg)
        self._need_state = D.has_state_layers(cfg)
        # default pool = contiguous capacity (num_slots full-length tables);
        # prefix sharing brings the peak under it. State-only archs (rwkv)
        # have no paged layers and no pool at all.
        self.num_pages = 0 if not self.has_pages else (
            num_pages if num_pages is not None
            else num_slots * self.max_pages)
        # placeholder-embeds frontends have no token identity to key reuse
        # on; the chain baseline also needs every layer paged (it has no
        # snapshots to cover ring or recurrent state)
        if not prefix_sharing or cfg.embed_inputs:
            prefix_mode = "off"
        elif prefix_mode == "chain" and (self._need_state
                                         or not self.has_pages):
            prefix_mode = "off"
        self.prefix_mode = prefix_mode
        self.prefix_sharing = prefix_mode != "off"
        self.snapshot_budget = snapshot_budget
        self.max_tree_nodes = max_tree_nodes
        # ONE spill tier per engine, shared by every run()'s tree: prefix
        # state outlives the pools (and, with prefix_persist, restarts)
        self._spill = SpillTier(spill_entries) \
            if prefix_mode == "radix" else None
        self._cache = None      # built per run(); None until the first run
        self._persist_path = None
        if prefix_persist is not None and self._spill is not None:
            self._restore_prefix_state(prefix_persist)
        self.temperature = float(temperature)
        self.eos_id = eos_id
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._decode_length = torch.ones((num_slots,), dtype=torch.int32,
                                         device=self.device)
        ps, fd = page_size, self.flash_decode
        if self._mgroup is not None:
            # waves train on the whole params (`_host_params`); the step
            # takes this rank's shards
            self.params = D.shard_serve_params(cfg, params, rules)
            self._step = D.make_sharded_paged_step(
                cfg, rules, page_size=ps, flash_decode=fd)
        else:
            self._step = lambda p, batch, state, pools, pt, deltas: \
                D.paged_step(cfg, p, batch, state, pools, pt, page_size=ps,
                             deltas=deltas, flash_decode=fd)
        self._host_params = params
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
        frozen, trainable = split_params(self._host_params, plan)
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
            seg: tree_leaves(self._host_params["segments"][seg])[0].shape[0]
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

    def _check_step(self, *parts) -> None:
        """On a mesh: every rank's step inputs must be rank 0's. A crc32 of
        `parts` (host arrays) is all-gathered over the model group; a rank
        that differs fails the step on every rank, rather than leaving its
        peers waiting in a collective."""
        if self._mgroup is None:
            return
        crc = 0
        for a in parts:
            crc = zlib.crc32(np.ascontiguousarray(a).tobytes(), crc)
        mine = torch.tensor([crc], dtype=torch.int64, device=self.device)
        got = [torch.empty_like(mine) for _ in range(self.mesh_shards)]
        SH.count_collective("digest", mine)
        dist.all_gather(got, mine, group=self._mgroup)
        seen = [int(g) for g in got]
        if len(set(seen)) > 1:
            raise RuntimeError(f"serve mesh out of step: the ranks' step "
                               f"input digests are {seen}")

    @contextlib.contextmanager
    def _on_mesh(self):
        """The context a pool helper's collective runs in."""
        with SH.use_rules(self.rules), \
                SH.mapped_model_axis(self.rules.model_axis), torch.no_grad():
            yield

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
        batch = {"start": self._tensor([start]),
                 "active": self._tensor([True], torch.bool),
                 "length": self._tensor([size])}
        if self.cfg.embed_inputs:
            emb = np.asarray(req.embeds[start:start + size], np.float32)
            if size < ps:
                emb = np.pad(emb, ((0, ps - size), (0, 0)))
            batch["embeds"] = self._tensor(emb, torch.float32)[None]
        else:
            toks = np.asarray(req.tokens[start:start + size], np.int32)
            if size < ps:
                toks = np.pad(toks, (0, ps - size))
            batch["tokens"] = self._tensor(toks)[None]
        return batch

    def _decode_batch(self, tokens_row, pos_row, active_row):
        batch = {"start": self._tensor(pos_row),
                 "active": self._tensor(active_row, torch.bool),
                 "length": self._decode_length}
        if self.cfg.embed_inputs:
            # placeholder frontend: fresh embeds every step
            batch["embeds"] = torch.randn(
                (self.num_slots, 1, self.cfg.d_model), generator=self._gen,
                device=self.device, dtype=dtype_of(self.cfg))
        else:
            batch["tokens"] = self._tensor(tokens_row)[:, None]
        return batch

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
        avail = self._pool.free_pages
        if self._cache is not None:
            avail += self._cache.evictable()
        return avail - sum(self._worst_case_need(s)
                           for s in sched.live_slots())

    def _evict_until_free(self) -> None:
        while not self._pool.free_pages:
            if self._cache is None or not self._cache.evict_one():
                raise RuntimeError("page pool exhausted with nothing "
                                   "evictable (reservation bug)")

    def _alloc_page(self) -> int:
        self._evict_until_free()
        return self._pool.alloc()

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
                pid = self._alloc_page()
                assert pg == len(slot.page_ids), "non-contiguous page alloc"
                slot.page_ids.append(pid)
                self._pt[slot.index, pg] = pid
            elif self._pool.ref[pid] > 1:
                self._evict_until_free()
                new = self._pool.cow_split(pid)
                pools = D.copy_pool_rows(pools, pid * ps, new * ps, ps)
                slot.page_ids[pg] = new
                self._pt[slot.index, pg] = new
        return pools

    def _page_reader(self, pid: int):
        """Device -> host: one page's token rows from EVERY layer's pool
        (the radix cache's spill callback), all heads: on a mesh the ranks'
        head blocks are all-gathered."""
        ps = self.page_size
        rows = D.read_pool_rows(self._pools, pid * ps, ps)
        if self._mgroup is not None:
            with self._on_mesh():
                rows = tree_map(
                    lambda a: SH.all_gather_mapped(a, 2, "spill"), rows)
        return _to_host(rows)

    def _page_writer(self, pid: int, blob) -> None:
        """Host -> device: write a spilled page's rows back into EVERY
        layer's pool (the radix cache's rehydrate callback); on a mesh the
        rank's head block of them. The blob is grafted onto the live pool
        structure first: a disk round trip drops empty subtrees."""
        blob = _graft_like(self._pools, blob)
        if self._mgroup is not None:
            h = self.cfg.num_kv_heads // self.mesh_shards
            lo = self._mrank * h
            blob = tree_map(lambda a: a[:, :, lo:lo + h], blob)
        D.write_pool_rows(self._pools, blob, pid * self.page_size)

    def _release_slot(self, slot: Slot):
        for pid in slot.page_ids:
            self._pool.decref(pid)
        slot.page_ids = []
        slot.registered_pages = 0
        if slot.match is not None:
            if self._cache is not None:
                self._cache.release(slot.match)
            slot.match = None
        self._pt[slot.index, :] = -1

    def _restore_prefix_state(self, directory: str) -> None:
        """Point the engine at `directory`'s persisted tree and load it into
        the spill tier. A torn file (a crash mid-write) warns and starts
        cold; so does a tree saved for another page size, max_len or
        model, silently."""
        os.makedirs(directory, exist_ok=True)
        self._persist_path = os.path.join(directory, "prefix_tree.ckpt")
        if not os.path.exists(self._persist_path):
            return
        want = self._persist_meta()
        try:
            meta = restore_spill_tier(self._persist_path, self._spill)
        except CheckpointCorruptError as e:
            warnings.warn(f"prefix-persist tree is corrupt ({e}); "
                          "starting cold")
            self._spill.clear()
            meta = want
        if any(meta.get(k) != v for k, v in want.items()):
            self._spill.clear()         # incompatible tree: start cold

    def _persist_meta(self) -> dict:
        return {"page_size": self.page_size, "max_len": self.max_len,
                "model": self.cfg.name}

    def _persist_prefix_state(self) -> None:
        """Flush the radix tree (pages and snapshots) into the host spill
        tier while the device pools are still alive, and, with
        `prefix_persist`, the tier to disk. Runs at the end of a run and on
        the unwind of a failed one, so a killed engine still leaves a warm
        tree behind."""
        if self.prefix_mode != "radix" or self._cache is None:
            return
        self._cache.spill_all()
        if self._persist_path is not None and self._mrank == 0:
            # the tier holds full-head rows, the same on every rank: rank 0
            # writes it, and no rank moves on before the file is whole
            save_spill_tier(self._persist_path, self._spill,
                            meta=self._persist_meta())
        if self._persist_path is not None and self._mgroup is not None:
            dist.barrier(group=self._mgroup)

    # -- robustness --------------------------------------------------------

    def _transient_fault(self, slot: Slot) -> bool:
        """Absorb one transient fault on `slot`'s request: count the retry
        and schedule capped exponential backoff. Returns True when the
        retry budget is exhausted: the caller quarantines the request, so
        a poison request can never wedge the slot forever."""
        slot.retries += 1
        self._retry_events += 1
        if slot.retries > self.max_retries:
            return True
        back = min(self.retry_backoff_cap_s,
                   self.retry_backoff_s * (2 ** (slot.retries - 1)))
        slot.retry_at = time.perf_counter() + back
        return False

    def _wrap_stream(self, req: Request):
        """Guard a request's stream callback: injected stream faults AND
        exceptions the callback raises are absorbed (counted in
        `stream_errors`, treated as "keep generating"): a broken client
        degrades its own stream, it never crashes the engine or changes
        the served tokens. Returning False still cancels."""
        inner = req.stream
        if inner is None or getattr(inner, "_chaos_guarded", False):
            return inner

        def guarded(rid, tok):
            try:
                if self.chaos is not None:
                    self.chaos.maybe_raise(FaultKind.STREAM, site=rid)
                return inner(rid, tok)
            except Exception:
                self._stream_errors += 1
                return None
        guarded._chaos_guarded = True
        return guarded

    def recover_requests(self) -> list[Request]:
        """In-flight requests from the journal: admitted by a previous
        (crashed) engine, never completed. Feed them back through `run()`;
        with `prefix_persist` their already-prefilled pages come back as
        prefix and snapshot hits instead of recomputation. [] when the
        engine has no journal."""
        if self._journal is None:
            return []
        return self._journal.pending_requests()

    # -- serve loop --------------------------------------------------------

    def run(self, requests: list[Request],
            verbose: bool = False) -> ServeStats:
        try:
            return self._run(requests, verbose)
        except BaseException:
            # a failed run, InjectedCrash included (no `except Exception`
            # can swallow it), still flushes the radix tree to the spill
            # tier (and disk, with prefix_persist), so a restarted engine
            # replays journaled requests against a warm prefix cache
            self._persist_prefix_state()
            raise

    def _run(self, requests: list[Request], verbose: bool) -> ServeStats:
        for r in requests:
            given = r.embeds if self.cfg.embed_inputs else r.tokens
            assert given is not None, (
                f"request {r.rid}: {self.cfg.name} takes "
                f"{'embeds' if self.cfg.embed_inputs else 'tokens'}")
            assert r.max_new_tokens >= 1, (
                f"request {r.rid}: max_new_tokens must be >= 1")
            assert r.prompt_len + r.max_new_tokens <= self.max_len, (
                f"request {r.rid}: prompt {r.prompt_len} + gen "
                f"{r.max_new_tokens} exceeds max_len {self.max_len}")
            assert self._pages_needed(r) <= self.num_pages, (
                f"request {r.rid} needs {self._pages_needed(r)} pages; "
                f"pool has {self.num_pages}")
            if r.timeout_s is not None and self._mgroup is not None:
                _refuse("request timeouts on a serve mesh",
                        "ROADMAP queue A item 14d")
        sched = Scheduler(self.num_slots, eos_id=self.eos_id)
        # rids journaled by a previous (crashed) engine and admitted again
        # in this run count as journal replays
        replay_rids = (self._journal.pending_rids()
                       if self._journal is not None else set())
        for r in requests:
            r.stream = self._wrap_stream(r)
            sched.submit(r)
        chaos = self.chaos
        faults0 = chaos.faults_injected if chaos is not None else 0
        kinds0 = dict(chaos.faults_by_kind) if chaos is not None else {}
        self._retry_events = 0
        self._stream_errors = 0
        self._watchdog_kills = 0
        journal_replays = 0
        shed_rids: set[int] = set()
        mon = StragglerMonitor(factor=self._straggler_factor)
        self._prefill_s = self._decode_s = 0.0
        self._prefill_tokens = self._decode_tokens = 0
        decode_step_s = []

        state, self._pools = D.init_serve_cache(
            self.cfg, self.num_slots, self.max_len, max(1, self.num_pages),
            self.page_size, device=self.device,
            pool_shards=self.mesh_shards if self.has_pages else 1)
        pool_bytes = sum(a.numel() * a.element_size()
                         for a in tree_leaves(self._pools))
        self._pt = np.full((self.num_slots, self.max_pages), -1, np.int32)
        self._pool = PagePool(max(1, self.num_pages), self.page_size,
                              chaos=chaos)
        if self.prefix_mode == "radix":
            self._cache = RadixPrefixCache(
                self._pool, has_pages=self.has_pages,
                reader=self._page_reader if self.has_pages else None,
                writer=self._page_writer if self.has_pages else None,
                spill=self._spill, snapshot_budget=self.snapshot_budget,
                max_nodes=self.max_tree_nodes)
        elif self.prefix_mode == "chain":
            self._cache = ChainPrefixCache(self._pool)
        else:
            self._cache = None
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
            if self._journal is not None:
                self._journal.done(req.rid, status)
            # the injected crash fires AFTER the journal records this
            # request done and its slot is released: the completed request
            # is never replayed, and the pool's accounting stays whole for
            # the crash unwind's prefix flush
            if chaos is not None and status == "completed" \
                    and chaos.crash_due(sched.requests_completed):
                raise InjectedCrash(
                    f"injected crash after {sched.requests_completed} "
                    f"completed request(s)")
            if verbose and status == "completed":
                print(f"[serve] completed {sched.requests_completed}"
                      f"/{len(requests)} requests", flush=True)

        it_prev, it_work = None, False
        while not sched.done:
            now = time.perf_counter()
            # the straggler record: only iterations that ran a step count
            # (idle and backoff spins are sub-ms and would drag the median
            # down until every real iteration looked like a straggler)
            if it_prev is not None and it_work:
                mon.record(now - it_prev)
            it_prev, it_work = now, False
            # 1) deadlines: cancel overdue slots, drop overdue queued ones;
            # the watchdog quarantines slots that stopped progressing
            for slot in sched.live_slots():
                dl = deadline[slot.request.rid]
                if dl is not None and now > dl:
                    sched.cancel(slot)
                    close(slot, "cancelled")
                    continue
                if (self.watchdog_s is not None
                        and now - slot.last_progress > self.watchdog_s):
                    self._watchdog_kills += 1
                    sched.quarantine(slot)
                    close(slot, "quarantined")
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
                mr, matched, covered = None, [], 0
                # personalized requests compute K/V under their own delta:
                # sharing those pages (or adopting shared ones) would serve
                # another user's prefix from the wrong weights
                if self._cache is not None and req.tokens is not None \
                        and req.user is None:
                    # leave >= 1 prompt token uncached: something must
                    # produce the logits that sample the first token
                    mr = self._cache.match(
                        np.asarray(req.tokens), req.prompt_len - 1,
                        need_state=self._need_state)
                    matched, covered = mr.pages, mr.covered
                has_partial = bool(matched) and \
                    matched[-1][1] < self.page_size
                need = self._pages_needed(req) - len(matched) \
                    + int(has_partial)
                pressure = self.has_pages and self._headroom(sched) < need
                # load shedding: admitting would drop free pages below the
                # watermark, so defer while anything is in flight. The shed
                # request stays queued and keeps ticking toward its own
                # timeout_s (the queued-deadline drop above accounts for
                # it): never silently dropped
                shed = (not pressure and self.has_pages
                        and self.shed_watermark > 0.0
                        and bool(sched.live_slots())
                        and self._headroom(sched) - need
                        < self.shed_watermark * self.num_pages)
                if pressure or shed:
                    if mr is not None:              # roll the match back
                        self._cache.abandon(mr, req.prompt_len)
                        mr, matched, covered = None, [], 0
                    if sched.live_slots():
                        if shed:
                            shed_rids.add(req.rid)  # counted once per rid
                        break   # retry when an in-flight request frees pages
                    # nothing in flight will ever free pages: admit WITHOUT
                    # sharing. With no live slot every cache page is
                    # evictable, so pages_needed <= num_pages always fits
                    # (the watermark never blocks this path: a degraded
                    # trickle of admissions beats a deadlock)
                    assert self._headroom(sched) >= self._pages_needed(req)
                    has_partial = False
                sched.commit_admission(slot, prefilled=covered)
                slot.last_progress = time.perf_counter()
                if self._journal is not None:
                    if req.rid in replay_rids:
                        journal_replays += 1
                        replay_rids.discard(req.rid)
                    self._journal.admit(req)
                slot.match = mr     # pinned until the slot closes
                slot.page_ids = [pid for pid, _ in matched]
                slot.registered_pages = len(matched) - int(has_partial)
                self._pt[slot.index, :] = -1
                self._pt[slot.index, :len(matched)] = slot.page_ids
                if mr is not None and mr.snapshot is not None:
                    # restore the recurrent state at the matched boundary;
                    # prefill resumes from slot.pos = covered
                    state = D.cache_insert_row(
                        state, _graft_like(state, mr.snapshot), slot.index)
                else:
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
                if now < slot.retry_at:
                    continue        # backing off after a transient fault
                # faults are injected BEFORE the step and before any pool
                # mutation, so absorbing one and retrying next iteration
                # replays the identical chunk: injected faults can delay a
                # request but never change its tokens
                try:
                    if chaos is not None:
                        chaos.maybe_raise(FaultKind.STEP, site=req.rid)
                        if chaos.draw(FaultKind.SLOW, site=req.rid):
                            time.sleep(chaos.slow_s)
                    ps = self.page_size
                    shareable = (self._cache is not None
                                 and req.tokens is not None
                                 and req.user is None)
                    toks = np.asarray(req.tokens) if shareable else None
                    # chunk-time adoption: a page a CONCURRENT slot
                    # registered since our admission is attached instead of
                    # recomputed (same-wave admissions of a common prefix
                    # share this way). State archs skip it: adopting K/V
                    # rows without the recurrent state at that boundary
                    # would lose the state those tokens should have made.
                    while (shareable and not self._need_state
                           and slot.pos % ps == 0
                           and slot.pos + ps <= req.prompt_len - 1
                           and slot.pos // ps == len(slot.page_ids)):
                        pid = self._cache.match_page(toks, slot.pos)
                        if pid is None:
                            break
                        slot.page_ids.append(pid)
                        self._pt[slot.index, len(slot.page_ids) - 1] = pid
                        slot.pos += ps
                        slot.registered_pages = len(slot.page_ids)
                    size = min(ps, req.prompt_len - slot.pos)
                    self._pools = self._ensure_writable(
                        slot, slot.pos, slot.pos + size, self._pools)
                    st_row = D.cache_extract_row(state, slot.index)
                    pt_row = self._tensor(self._pt[slot.index:slot.index + 1])
                    d_row = None if self._dbatch is None else \
                        D.cache_extract_row(self._dbatch, slot.index)
                    self._check_step(np.asarray([slot.index, slot.pos, size]),
                                     self._pt[slot.index])
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
                    it_work = True
                    slot.last_progress = time.perf_counter()
                    if shareable and self.has_pages:
                        slot.registered_pages = self._cache.insert_pages(
                            toks, slot.pos // ps, slot.page_ids,
                            slot.registered_pages)
                    if (shareable and self._need_state and slot.pos % ps == 0
                            and self._cache.wants_snapshot(toks, slot.pos)):
                        # the recurrent state at this page boundary, copied
                        # to the host: a later shared-prefix request
                        # resumes from it instead of prefilling again
                        self._cache.insert_snapshot(
                            toks, slot.pos,
                            _to_host(D.cache_extract_row(state, slot.index)))
                    if slot.pos == req.prompt_len:
                        sched.finish_prefill(slot)
                        if shareable and self.has_pages \
                                and not self._need_state \
                                and self._headroom(sched) >= 1:
                            self._cache.insert_partial(toks,
                                                       slot.page_ids[-1])
                        outcome = sched.record_token(
                            slot, self._sample(logits)[0])
                        if outcome is not None:
                            close(slot, "completed" if outcome == "done"
                                  else "cancelled")
                except InjectedFault:
                    # progress made before the fault (adopted pages, pages
                    # allocated, a split page copied in place) is recorded
                    # on the slot, so the retry resumes from it
                    if self._transient_fault(slot):
                        sched.quarantine(slot)
                        close(slot, "quarantined")

            active = sched.active_slots()
            if not active:
                if not sched.prefill_slots() and sched.queue:
                    raise RuntimeError(
                        "serve deadlock: queued requests but no admissible "
                        "slot (page-pool accounting bug)")
                continue

            # 4) one decode step over the full fixed-shape batch; each slot
            # consumes its last sampled token at position slot.pos. Slots
            # backing off after a transient fault, or drawing one now, are
            # masked out of active_row: an inactive row keeps its state and
            # cache bit for bit, so the retried step feeds identical inputs
            # and, greedy, samples the identical token.
            runnable = []
            for slot in active:
                if now < slot.retry_at:
                    continue
                try:
                    if chaos is not None:
                        rid = slot.request.rid
                        chaos.maybe_raise(FaultKind.STEP, site=rid)
                        if chaos.draw(FaultKind.SLOW, site=rid):
                            time.sleep(chaos.slow_s)
                    self._pools = self._ensure_writable(
                        slot, slot.pos, slot.pos + 1, self._pools)
                except InjectedFault:
                    if self._transient_fault(slot):
                        sched.quarantine(slot)
                        close(slot, "quarantined")
                    continue
                runnable.append(slot)
            if not runnable:
                time.sleep(0.0005)  # everyone backing off: don't busy-spin
                continue
            run_idx = {s.index for s in runnable}
            tokens_row = [s.last_token for s in sched.slots]
            pos_row = [min(s.pos, self.max_len - 1) for s in sched.slots]
            active_row = [s.state is SlotState.ACTIVE and s.index in run_idx
                          for s in sched.slots]
            self._check_step(np.asarray(tokens_row, np.int64),
                             np.asarray(pos_row), np.asarray(active_row),
                             self._pt)
            ts = time.perf_counter()
            logits, state, self._pools = self._step(
                self.params,
                self._decode_batch(tokens_row, pos_row, active_row),
                state, self._pools, self._tensor(self._pt), self._dbatch)
            self._sync()
            decode_step_s.append(time.perf_counter() - ts)
            self._decode_s += decode_step_s[-1]
            self._decode_tokens += len(runnable)
            it_work = True
            toks = self._sample(logits)
            for slot in runnable:     # inactive rows: sampled, discarded
                slot.pos += 1         # the fed token is now cached
                slot.last_progress = time.perf_counter()
                outcome = sched.record_token(slot, toks[slot.index])
                if outcome is not None:
                    close(slot, "completed" if outcome == "done"
                          else "cancelled")

        self._persist_prefix_state()
        wall = time.perf_counter() - t0
        lat = [r.latency_s for r in results.values()
               if r.status == "completed"] or [0.0]
        p13n = self._p13n is not None
        c = self._cache
        count = lambda name: getattr(c, name) if c is not None else 0
        # the robustness counts are this run's: the schedule's counters
        # run on across runs, so take their deltas
        d_faults, d_kinds = 0, {}
        if chaos is not None:
            d_faults = chaos.faults_injected - faults0
            d_kinds = {k: v - kinds0.get(k, 0)
                       for k, v in chaos.faults_by_kind.items()
                       if v - kinds0.get(k, 0)}
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
            prefix_hit_tokens=count("hit_tokens"),
            prefix_lookup_tokens=count("lookup_tokens"),
            pages_total=self.num_pages,
            pages_peak=self._pool.peak_in_use,
            cow_splits=self._pool.cow_splits,
            results=results,
            prefix_mode=self.prefix_mode,
            prefix_lookups=count("lookups"),
            state_lookups=count("state_lookups"),
            radix_nodes=count("node_count"),
            snapshot_hits=count("snapshot_hits"),
            snapshots_stored=count("snapshots_stored"),
            spills=count("spills"),
            rehydrates=count("rehydrates"),
            spill_entries=len(self._spill) if self._spill is not None else 0,
            delta_hits=self._deltas.hits if p13n else 0,
            delta_lookups=(self._deltas.hits + self._deltas.misses
                           if p13n else 0),
            delta_evictions=self._deltas.evictions if p13n else 0,
            delta_resident_bytes=self._deltas.resident_bytes if p13n else 0,
            train_waves=self._wave_count if p13n else 0,
            train_wave_s=self._wave_s if p13n else 0.0,
            wave_losses=list(self._wave_losses) if p13n else [],
            faults_injected=d_faults,
            faults_by_kind=d_kinds,
            retries=self._retry_events,
            sheds=len(shed_rids),
            quarantined=sched.requests_quarantined,
            tokens_quarantined=sched.tokens_quarantined,
            watchdog_kills=self._watchdog_kills,
            stream_errors=self._stream_errors,
            journal_replays=journal_replays,
            stragglers=len(mon.flagged),
            mesh_shards=self.mesh_shards,
            pool_shard_bytes=pool_bytes,
            prefill_s=self._prefill_s,
            decode_s=self._decode_s,
            prefill_tokens=self._prefill_tokens,
            decode_tokens=self._decode_tokens,
            decode_step_s=decode_step_s,
        )


def make_random_requests(cfg, n: int, prompt_len: int, gen_len: int,
                         seed: int = 0, **req_kw) -> list[Request]:
    """Uniform-random prompts (token ids, or standard-normal embeds for
    embed-input frontends): the synthetic serving workload, bitwise the
    reference's for the same seed."""
    rng = np.random.default_rng(seed)
    reqs = []
    for rid in range(n):
        if cfg.embed_inputs:
            emb = rng.standard_normal(
                (prompt_len, cfg.d_model)).astype(np.float32)
            reqs.append(Request(rid, gen_len, embeds=emb, **req_kw))
        else:
            toks = rng.integers(
                0, cfg.vocab_size, prompt_len).astype(np.int32)
            reqs.append(Request(rid, gen_len, tokens=toks, **req_kw))
    return reqs


def make_shared_prefix_requests(cfg, n: int, prefix_len: int, prompt_len: int,
                                gen_len: int, seed: int = 0) -> list[Request]:
    """Workload with a common `prefix_len`-token prompt prefix (system-
    prompt style): later admissions hit the prefix cache and share pages.
    Bitwise the reference's for the same seed."""
    assert 0 < prefix_len <= prompt_len
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, cfg.vocab_size, prefix_len).astype(np.int32)
    reqs = []
    for rid in range(n):
        tail = rng.integers(
            0, cfg.vocab_size, prompt_len - prefix_len).astype(np.int32)
        reqs.append(Request(rid, gen_len,
                            tokens=np.concatenate([prefix, tail])))
    return reqs


def make_branching_prefix_requests(cfg, n: int, prompt_len: int, gen_len: int,
                                   *, page_size: int = 16,
                                   max_prefix_pages: int = 4, branch: int = 2,
                                   zipf_a: float = 1.5,
                                   seed: int = 0) -> list[Request]:
    """Partially-overlapping prefix workload: prompts walk a `branch`-ary
    token tree with zipf-skewed branch popularity (few-shot preambles that
    agree for a while, then diverge), so pairs of requests share SOME page-
    aligned prefix but rarely the whole prompt. This is the workload where
    the radix tree's arbitrary-prefix matching beats whole-chain hashing.
    Page content at each tree position is keyed by the path to it, so equal
    paths yield identical tokens across requests (and across runs), and
    the same seed gives the reference's tokens."""
    assert prompt_len > max_prefix_pages * page_size
    rng = np.random.default_rng(seed)
    w = 1.0 / np.arange(1, branch + 1) ** zipf_a
    w /= w.sum()
    reqs = []
    for rid in range(n):
        depth = 1 + int(rng.integers(0, max_prefix_pages))
        path: list[int] = []
        pages = []
        for _ in range(depth):
            path.append(int(rng.choice(branch, p=w)))
            pages.append(np.random.default_rng([seed, *path]).integers(
                0, cfg.vocab_size, page_size).astype(np.int32))
        prefix = np.concatenate(pages)
        tail = rng.integers(0, cfg.vocab_size,
                            prompt_len - len(prefix)).astype(np.int32)
        reqs.append(Request(rid, gen_len,
                            tokens=np.concatenate([prefix, tail])))
    return reqs

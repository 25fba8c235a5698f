"""Sharded paged serving on the ranks of a spawned world: serve jobs, and
the `--mesh-model` rank of the serve launcher.

    from repro_torch.launch import mesh, mesh_serve
    results = mesh.spawn(mesh_serve.run_jobs, 4, args=(jobs,))

`run_jobs` runs every job in order on every rank; a job with a `tc` key is
a train job and goes to `launch.mesh_train.run_job`, so one world serves
both. A serve job is a dict:

    name      a label for its results
    kind      "serve" (the default), "audit" (`replicated_matmul_leaves`
              over one decode step, sharded and on one process), or "moe"
              (`apply_moe` on the rank's d_ff shards of the experts)
    cfg       the ModelConfig
    n         the mesh width: the first n ranks on a (1, n) mesh over
              `model` (`launch.mesh.make_serve_mesh`); 1 runs the one-device
              engine (no rules) on rank 0
    device    "cpu" or "cuda" (every rank on cuda:0 with gloo; with nccl
              the rank's own card)
    params    the whole params (numpy); None draws them from `seed` on the
              device, the same numbers on every rank
    engine    ServeEngine keyword arguments (num_slots, max_len, ...);
              `rules` is the job's
    rank_engine  {rank: kwargs} laid over `engine` on that rank (a
              caller's control: a rank whose decisions part from the
              others' must fail the run, not hang it)
    deltas    {user: {"idx": tree, "vals": tree}} (numpy): the users'
              first deltas, in place of the engine's own draws (another
              package's selection, say)
    runs      request lists, each one `engine.run` on the same engine
    argv      instead of `engine` / `runs`: the serve launcher's flags
              (`launch.serve.build_engine` / `build_requests`), served
              `repeat` times (default 1) on one engine
    hook      a module-level function hook(engine, rules, params) called
              after the engine is built (a caller's control: e.g. swap the
              ranks' shards); it must not skip a collective
    expect_raise  an exception of this type is the job's result (its
              message)
    diverge_from  {rid: tokens}: keep, fp32 on the host, the logits row
              each such request sampled its first token from, and the one
              of the first step whose token differs from the given ones
    decode_bytes  after the runs, the collective bytes by kind of one
              decode step over all slots (a fresh cache)
    gaps      record the smallest top-2 logit gap of every sampled step

A rank's result per serve job: its coordinates, per run the tokens, the
counts of `ACCOUNT`, the pool's resident pages and every kernel's
launches, the wall seconds, and what the job asks for. The ranks import
only torch and this package, and keep to one CPU thread on the CPU.
"""
from __future__ import annotations

import time

import torch

from repro_torch import sharding as SH
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_serve_mesh

# the ServeStats counts a sharded run must share with the one-device run
ACCOUNT = ("pages_peak", "cow_splits", "prefix_hit_tokens", "prefill_chunks",
           "rehydrates", "snapshot_hits", "train_waves", "requests_completed",
           "tokens_out")


def run_jobs(jobs: list) -> list:
    """Every job in order on this rank; a result per job (None where the
    rank is outside the job's mesh)."""
    from repro_torch.launch import mesh_train
    out = []
    for job in jobs:
        out.append(mesh_train.run_job(job) if "tc" in job
                   else run_serve_job(job))
        if job.get("device", "cpu") != "cpu":
            import gc
            gc.collect()
            torch.cuda.empty_cache()
    return out


def _device(job) -> torch.device:
    dev = torch.device(job.get("device", "cpu"))
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _params(job, device):
    from repro_torch import bridge
    from repro_torch.models import transformer as T
    if job.get("params") is not None:
        return bridge.to_torch(job["params"], device)
    return T.init_params(job["cfg"], job.get("seed", 0), device)


def run_serve_job(job: dict):
    """One serve job on this rank; None where the rank is not in it. A job
    starts once every rank of the world has ended the ones before it (a
    job may read what an earlier one wrote, a persisted spill tier), and
    every rank builds its mesh (a collective)."""
    rank = 0
    if torch.distributed.is_initialized():
        torch.distributed.barrier()
        rank = torch.distributed.get_rank()
    n = job.get("n", 1)
    mesh = make_serve_mesh(n) if n > 1 else None
    if rank >= n:
        return None
    device = _device(job)
    if device.type == "cpu":
        torch.set_num_threads(1)
    else:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    rules = SH.default_rules(mesh) if mesh is not None else None
    out = {"name": job.get("name"),
           "coords": dict(mesh.coords) if mesh else {"data": 0, "model": 0}}
    kind = job.get("kind", "serve")
    try:
        if kind == "audit":
            out.update(_audit(job, rules, device))
        elif kind == "moe":
            out.update(_moe(job, rules, device))
        else:
            _serve(job, rules, device, out, rank)
    except Exception as e:       # noqa: BLE001 - the job names its type
        want = job.get("expect_raise")
        if want is None or not isinstance(e, want):
            raise
        out["raised"] = f"{type(e).__name__}: {e}"
    return out


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _serve(job, rules, device, out, rank: int) -> None:
    from repro_torch.serve import ServeEngine
    t0 = time.perf_counter()
    cfg = job["cfg"]
    params = _params(job, device)
    runs = job.get("runs", ())
    if job.get("argv") is not None:
        import argparse
        from repro_torch.launch import serve
        args = serve.add_serve_args(argparse.ArgumentParser()).parse_args(
            job["argv"])
        _, eng = serve.build_engine(args, cfg, params=params, rules=rules,
                                    device=device)
        runs = [serve.build_requests(args, cfg)
                for _ in range(job.get("repeat", 1))]
    else:
        kw = dict(job.get("engine", {}))
        kw.update(job.get("rank_engine", {}).get(rank, {}))
        eng = ServeEngine(cfg, params, rules=rules, **kw)
    if job.get("deltas"):
        from repro_torch import bridge
        from repro_torch.core.delta import DeltaState
        given = job["deltas"]
        eng._deltas._make = lambda user: DeltaState(
            idx=bridge.to_torch(given[user]["idx"]),
            vals=bridge.to_torch(given[user]["vals"]))
    gaps = []
    if job.get("gaps"):
        sample = eng._sample

        def probed(logits):
            top = torch.topk(logits.float(), 2, dim=-1).values
            gaps.append(float((top[:, 0] - top[:, 1]).min()))
            return sample(logits)
        eng._sample = probed
    if job.get("hook") is not None:
        job["hook"](eng, rules, params)
    _sync(device)
    out["setup_s"] = time.perf_counter() - t0
    rows, undo = None, None
    if job.get("diverge_from"):
        rows, undo = _capture_rows(eng, job["diverge_from"])
    out["runs"] = []
    for reqs in runs:
        _sync(device)
        ops.reset_launch_counts()
        SH.reset_collective_bytes()
        t0 = time.perf_counter()
        stats = eng.run(reqs)
        _sync(device)
        out["runs"].append({
            "tokens": {k: list(r.tokens) for k, r in stats.results.items()},
            "account": {k: getattr(stats, k) for k in ACCOUNT},
            "mesh_shards": stats.mesh_shards,
            "pool_shard_bytes": stats.pool_shard_bytes,
            "wave_losses": list(stats.wave_losses),
            "in_use": eng._pool.in_use,
            "launches": ops.launch_counts(),
            "bytes": SH.collective_bytes(),
            "wall_s": time.perf_counter() - t0,
            "decode_steps": len(stats.decode_step_s)})
    if undo is not None:
        undo()
        out["logits"] = rows
    if gaps:
        out["min_gap"] = min(gaps)
    if job.get("decode_bytes"):
        out["decode_bytes"] = decode_step_bytes(eng)
    if device.type == "cuda":
        out["max_memory_allocated"] = torch.cuda.max_memory_allocated(device)


def _capture_rows(engine, want: dict):
    """({rid: {step: fp32 host row}}, undo): the logits row each request in
    `want` ({rid: tokens}) samples its first token from, and the row of
    the first step whose token differs from `want[rid]`'s."""
    from repro_torch.serve import scheduler as S
    rows, last, parted = {}, {}, set()
    sample, record = engine._sample, S.Scheduler.record_token

    def keep(logits):
        last["logits"] = logits
        return sample(logits)

    def record_token(sched, slot, token):
        rid = slot.request.rid
        step = len(slot.out_tokens)
        if rid in want:
            ref = want[rid]
            first = rid not in parted and step < len(ref) \
                and token != ref[step]
            if step == 0 or first:
                lg = last["logits"]
                row = lg[0 if lg.shape[0] == 1 else slot.index]
                rows.setdefault(rid, {})[step] = row.float().cpu().clone()
            if first:
                parted.add(rid)
        return record(sched, slot, token)

    def undo():
        S.Scheduler.record_token = record
        del engine._sample

    engine._sample = keep
    S.Scheduler.record_token = record_token
    return rows, undo


def decode_step_bytes(engine) -> dict:
    """The collective bytes by kind of one decode step of `engine` over all
    its slots (one token each, a fresh cache and page table)."""
    from repro_torch.models import decoding as D
    b, dev = engine.num_slots, engine.device
    state, pools = D.init_serve_cache(
        engine.cfg, b, engine.max_len, max(1, engine.num_pages),
        engine.page_size, device=dev,
        pool_shards=engine.mesh_shards if engine.has_pages else 1)
    pt = torch.zeros((b, engine.max_pages), dtype=torch.int32, device=dev)
    batch = {"tokens": torch.zeros((b, 1), dtype=torch.int32, device=dev),
             "start": torch.zeros((b,), dtype=torch.int32, device=dev),
             "active": torch.ones((b,), dtype=torch.bool, device=dev),
             "length": torch.ones((b,), dtype=torch.int32, device=dev)}
    SH.reset_collective_bytes()
    with torch.no_grad():
        engine._step(engine.params, batch, state, pools, pt, None)
    _sync(dev)
    return SH.collective_bytes()


def _audit(job, rules, device) -> dict:
    """The replication audit over one decode step: the sharded step on the
    rank's shards, and (the audit's own control) the one-device step over
    the whole params."""
    from repro_torch.launch.trace_analysis import replicated_matmul_leaves
    from repro_torch.models import decoding as D
    cfg, ps = job["cfg"], job["engine"]["page_size"]
    b, max_len = job["engine"]["num_slots"], job["engine"]["max_len"]
    params = _params(job, device)
    n = rules.mesh.shape[rules.model_axis]
    forbidden, _ = D.sharded_param_shapes(cfg, params, rules)
    local = D.shard_serve_params(cfg, params, rules)
    step = D.make_sharded_paged_step(cfg, rules, page_size=ps)
    pages = b * -(-max_len // ps)

    def args(shards):
        state, pools = D.init_serve_cache(cfg, b, max_len, pages, ps,
                                          device=device, pool_shards=shards)
        pt = torch.zeros((b, -(-max_len // ps)), dtype=torch.int32,
                         device=device)
        batch = {"tokens": torch.zeros((b, 1), dtype=torch.int32,
                                       device=device),
                 "start": torch.zeros((b,), dtype=torch.int32, device=device),
                 "active": torch.ones((b,), dtype=torch.bool, device=device),
                 "length": torch.ones((b,), dtype=torch.int32,
                                      device=device)}
        return batch, state, pools, pt

    batch, state, pools, pt = args(n)
    hits = replicated_matmul_leaves(
        lambda: step(local, batch, state, pools, pt), forbidden)
    batch, state, pools, pt = args(1)
    with torch.no_grad():
        ref_hits = replicated_matmul_leaves(
            lambda: D.paged_step(cfg, params, batch, state, pools, pt,
                                 page_size=ps), forbidden)
    return {"forbidden": sorted(forbidden), "hits": hits,
            "ref_hits": ref_hits}


def _moe(job, rules, device) -> dict:
    """`apply_moe` on the rank's d_ff shards of whole expert params (the
    d_ff-parallel serve form) for the job's `x` (numpy [B, S, d])."""
    from repro_torch import bridge
    from repro_torch.launch.specs import shard_local
    from repro_torch.models import moe as MOE
    cfg, n = job["cfg"], rules.mesh.shape[rules.model_axis]
    m = (rules.model_axis,)
    spec = {"router": (None, None), "w_gate": (None, None, m),
            "w_up": (None, None, m), "w_down": (None, m, None)}
    if "shared" in job["params"]:
        spec["shared"] = {"w_gate": (None, m), "w_up": (None, m),
                          "w_down": (m, None)}
    p = bridge.to_torch(shard_local(job["params"], spec, rules.mesh.shape,
                                    rules.mesh.coords), device)
    x = bridge.to_torch(job["x"], device)
    with SH.use_rules(rules), SH.mapped_model_axis(rules.model_axis), \
            torch.no_grad():
        y, _ = MOE.apply_moe(p, cfg, x)
    return {"y": y.cpu(), "d_ff_local": p["w_gate"].shape[-1], "n": n}


# ---------------------------------------------------------------------------
# the serve launcher's rank (`launch.serve --mesh-model N`)
# ---------------------------------------------------------------------------

def serve_rank(argv: list):
    """One rank of `python -m repro_torch.launch.serve --mesh-model N`:
    the engine on this rank's shards of the seed's params, the requests of
    the flags; rank 0 prints the launcher's report. Returns the stats."""
    import argparse
    from repro_torch.launch import serve
    args = serve.add_serve_args(argparse.ArgumentParser()).parse_args(argv)
    device = _device({"device": args.device})
    if device.type == "cpu":
        torch.set_num_threads(1)
    rules = SH.default_rules(make_serve_mesh(args.mesh_model))
    cfg, engine = serve.build_engine(args, rules=rules, device=device)
    stats = engine.run(serve.build_requests(args, cfg),
                       verbose=not args.stream
                       and torch.distributed.get_rank() == 0)
    if torch.distributed.get_rank() == 0:
        serve.report(args, stats)
    return stats

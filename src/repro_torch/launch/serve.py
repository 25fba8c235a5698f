"""Serving launcher (the port's counterpart of `repro.launch.serve`): a thin
CLI over the paged continuous-batching engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
        --smoke --device cpu --requests 8 --batch 4 --prompt-len 32 \
        --gen-len 16 --page-size 16 --shared-prefix-len 16

Requests are admitted into fixed decode slots backed by a paged KV cache;
prompts chunk-prefill a page at a time, common prompt prefixes share
refcounted pages copy-on-write through the radix prefix cache (the
default `--prefix-mode radix`; `chain` is the flat baseline, `off` no
sharing), and `--stream` prints tokens as they are sampled.
`--shared-prefix-len N` and `--branching-prefix` choose the prefix
workloads, and `--prefix-persist DIR` keeps the prefix tree on disk across
restarts. With `--users N > 0` requests are routed round-robin to N
users, each with a compact per-user delta applied at decode and advanced by
an online train wave when the user's request completes. Reported counts
cover COMPLETED requests only. Runs on the card (`--device cuda`, the
default) or on the CPU (`--device cpu`, smoke configs).

Robustness: `--fault-rate R` injects seeded page-alloc, step, stream and
slow faults (`--chaos-seed`, `--chaos-slow-s`; a faulted request retries
up to `--max-retries` times, then is quarantined), `--watchdog-s`
quarantines a request that stops progressing, `--shed-watermark` defers
admission under a free-page watermark, `--journal FILE` records every
admission and completion, and `--kill-after N` crashes the engine after N
completions (a restart with the same `--journal` and `--prefix-persist`
replays what was in flight). The `[serve] chaos:` line prints the counts.

Every registered LM arch serves through `--arch` (dense, sliding-window,
MoE, mamba / attention hybrid and rwkv layers; the audio and vlm archs
with placeholder prompt embeddings). The flags are the reference
launcher's.

Sharded serving: `--mesh-model N` spawns N ranks (`launch.mesh.spawn`,
`launch.mesh_serve.serve_rank`) on a (1, N) mesh over `model`: gloo ranks
sharing one device (`--backend gloo`, the default: the CPU, or cuda:0), or
`--backend nccl` with a card each. Every rank draws the seed's params,
keeps its shards and serves the same requests; rank 0 prints the report
and a `[serve] mesh:` line. Every arch serves so (rwkv's time mix by
head block, mamba by d_inner: `models.decoding`); the fault, watchdog,
timeout and journal flags are refused on a mesh (ROADMAP item 14d).
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import (OptimizerConfig, SparseUpdateConfig,
                                 get_config, get_smoke_config)
from repro_torch.models import transformer as T
from repro_torch.runtime.chaos import FaultSchedule
from repro_torch.serve import (PersonalizationConfig, ServeEngine,
                               make_branching_prefix_requests,
                               make_random_requests,
                               make_shared_prefix_requests)

def build_engine(args, cfg=None, params=None, rules=None, device=None):
    """(cfg, engine) for parsed `args`; `params` (on args.device) are
    random from args.seed unless given, so two engines can share one copy
    of the weights. `rules`: a serve mesh's (`--mesh-model`), the engine
    then keeps this rank's shards; `device` overrides args.device (a
    rank's own card)."""
    device = torch.device(device or args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device; pass --device cpu "
                           "to run on the CPU")
    cfg = cfg or (get_smoke_config(args.arch) if args.smoke
                  else get_config(args.arch))
    if params is None:
        params = T.init_params(cfg, args.seed, device)
    p13n = None
    if args.users > 0:
        p13n = PersonalizationConfig(
            sparse=SparseUpdateConfig(
                update_ratio=args.personalize_ratio,
                num_update_layers=args.personalize_layers,
                channel_block=8),
            optimizer=OptimizerConfig(kind="sgd",
                                      learning_rate=args.personalize_lr),
            store_capacity=args.delta_capacity,
            train_tokens=args.train_tokens, seed=args.seed)
    chaos = None
    if args.fault_rate > 0.0 or args.kill_after is not None:
        chaos = FaultSchedule(args.chaos_seed, fault_rate=args.fault_rate,
                              slow_s=args.chaos_slow_s,
                              kill_after=args.kill_after)
    engine = ServeEngine(
        cfg, params, num_slots=args.batch,
        max_len=args.prompt_len + args.gen_len,
        temperature=args.temperature, eos_id=args.eos_id, seed=args.seed,
        page_size=args.page_size, num_pages=args.num_pages,
        prefix_sharing=not args.no_prefix_sharing,
        prefix_mode=args.prefix_mode, prefix_persist=args.prefix_persist,
        personalization=p13n,
        chaos=chaos, max_retries=args.max_retries,
        shed_watermark=args.shed_watermark, watchdog_s=args.watchdog_s,
        journal=args.journal, rules=rules,
        flash_decode=True if args.flash_decode else None)
    return cfg, engine


def build_requests(args, cfg):
    if args.branching_prefix:
        reqs = make_branching_prefix_requests(
            cfg, args.requests, args.prompt_len, args.gen_len,
            page_size=args.page_size,
            max_prefix_pages=max(1, (args.prompt_len - 1) // args.page_size
                                 - 1),
            seed=args.seed)
    elif args.shared_prefix_len > 0:
        reqs = make_shared_prefix_requests(
            cfg, args.requests, args.shared_prefix_len, args.prompt_len,
            args.gen_len, seed=args.seed)
    else:
        reqs = make_random_requests(cfg, args.requests, args.prompt_len,
                                    args.gen_len, seed=args.seed)
    for r in reqs:
        r.timeout_s = args.timeout_s
        if args.users > 0:
            r.user = r.rid % args.users  # round-robin user routing
        if args.stream:
            r.stream = lambda rid, tok: print(
                f"[stream] rid={rid} token={tok}")
    return reqs


def add_serve_args(ap: argparse.ArgumentParser):
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--eos-id", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--page-size", type=int, default=16,
                    help="tokens per KV-cache page")
    ap.add_argument("--num-pages", type=int, default=None,
                    help="page-pool capacity (default: batch * max pages "
                         "per request, i.e. contiguous-equivalent)")
    ap.add_argument("--no-prefix-sharing", action="store_true",
                    help="disable cross-request prompt-prefix page sharing")
    ap.add_argument("--prefix-mode", choices=("radix", "chain", "off"),
                    default="radix",
                    help="prefix-reuse structure: radix tree with state "
                         "snapshots + spill (default), the chain-hash "
                         "baseline, or off")
    ap.add_argument("--prefix-persist", type=str, default=None,
                    help="directory for the persistent prefix tree: the "
                         "spill tier is saved there after each run and "
                         "restored at engine start (radix mode only)")
    ap.add_argument("--shared-prefix-len", type=int, default=0,
                    help="> 0: requests share a common prompt prefix of "
                         "this many tokens (system-prompt workload)")
    ap.add_argument("--branching-prefix", action="store_true",
                    help="partially-overlapping (zipf-branching) prefix "
                         "workload instead of uniform-random prompts")
    ap.add_argument("--timeout-s", type=float, default=None,
                    help="per-request wall-clock deadline")
    ap.add_argument("--stream", action="store_true",
                    help="print tokens as they are sampled")
    ap.add_argument("--users", type=int, default=0,
                    help="> 0: route requests round-robin across this many "
                         "user ids and personalize per user (delta store + "
                         "online train waves)")
    ap.add_argument("--personalize-lr", type=float, default=0.05,
                    help="online train-wave sgd learning rate")
    ap.add_argument("--personalize-layers", type=int, default=2,
                    help="trainable layer suffix K for per-user deltas")
    ap.add_argument("--personalize-ratio", type=float, default=0.25,
                    help="channel update ratio for per-user deltas")
    ap.add_argument("--train-tokens", type=int, default=16,
                    help="tokens per online train wave")
    ap.add_argument("--delta-capacity", type=int, default=32,
                    help="max resident per-user deltas (hard LRU bound)")
    ap.add_argument("--fault-rate", type=float, default=0.0,
                    help="> 0: deterministic chaos injection, the per-draw "
                         "probability of page-alloc / step / stream / slow "
                         "faults (runtime/chaos.py)")
    ap.add_argument("--chaos-seed", type=int, default=0,
                    help="fault-schedule seed: same seed, same faults")
    ap.add_argument("--chaos-slow-s", type=float, default=0.002,
                    help="injected straggler delay per slow fault")
    ap.add_argument("--max-retries", type=int, default=3,
                    help="transient faults absorbed per request before it "
                         "is quarantined")
    ap.add_argument("--shed-watermark", type=float, default=0.0,
                    help="> 0: defer admission when free pages would drop "
                         "below this fraction of the pool")
    ap.add_argument("--watchdog-s", type=float, default=None,
                    help="quarantine a request making no progress for this "
                         "many seconds")
    ap.add_argument("--journal", type=str, default=None,
                    help="request-lifecycle journal file: admitted but "
                         "unfinished requests are replayed after a restart")
    ap.add_argument("--kill-after", type=int, default=None,
                    help="inject a hard crash after N completed requests "
                         "(exercises journal replay and prefix persistence)")
    ap.add_argument("--mesh-model", type=int, default=1,
                    help="> 1: N ranks on a (1, N) mesh over the model axis: "
                         "page pools shard over kv heads, weights tensor-, "
                         "vocab- and d_ff-parallel, page tables and slot "
                         "state whole")
    ap.add_argument("--backend", choices=("gloo", "nccl"), default="gloo",
                    help="--mesh-model's process group: gloo (the ranks "
                         "share one device) or nccl (a card each)")
    ap.add_argument("--flash-decode", action="store_true",
                    help="flash-decoding: the paged layers' softmax page "
                         "by page (default: on with --mesh-model > 1, off "
                         "otherwise)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card) or cpu")
    return ap


def main(argv=None):
    import sys
    argv = list(sys.argv[1:] if argv is None else argv)
    args = add_serve_args(argparse.ArgumentParser()).parse_args(argv)
    if args.mesh_model > 1:
        from repro_torch.launch import mesh, mesh_serve
        if torch.device(args.device).type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("--device cuda: no CUDA device; pass "
                                   "--device cpu to run on the CPU")
            from repro_torch.kernels import build
            build.build_all()        # the ranks load these libraries
        return mesh.spawn(mesh_serve.serve_rank, args.mesh_model,
                          args=(argv,), backend=args.backend)[0]
    cfg, engine = build_engine(args)
    stats = engine.run(build_requests(args, cfg), verbose=not args.stream)
    report(args, stats)
    return stats


def report(args, stats) -> None:
    """The launcher's summary lines for a run's stats."""
    print(f"[serve] {stats.requests_completed}/{args.requests} requests "
          f"({stats.requests_cancelled} cancelled), "
          f"{stats.tokens_out} tokens in {stats.wall_s:.2f}s "
          f"({stats.tok_per_s:.1f} tok/s, "
          f"{stats.refills} slot refills, "
          f"{stats.prefill_chunks} prefill chunks)")
    print(f"[serve] latency p50 {stats.latency_p50_s * 1e3:.1f}ms "
          f"p95 {stats.latency_p95_s * 1e3:.1f}ms")
    print(f"[serve] pages {stats.pages_peak}/{stats.pages_total} peak "
          f"(util {stats.page_util:.2f}), prefix mode {stats.prefix_mode}, "
          f"prefix hit rate {stats.prefix_hit_rate:.2f}, "
          f"{stats.cow_splits} COW splits")
    if stats.mesh_shards > 1:
        print(f"[serve] mesh: {stats.mesh_shards} model-axis shards, "
              f"{stats.pool_shard_bytes} pool bytes/shard")
    if stats.prefix_mode == "radix":
        print(f"[serve] radix: {stats.radix_nodes} nodes, "
              f"snapshot hit rate {stats.snapshot_hit_rate:.2f} "
              f"({stats.snapshots_stored} stored), "
              f"{stats.spills} spills / {stats.rehydrates} rehydrates, "
              f"{stats.spill_entries} tier entries")
    if args.fault_rate > 0.0 or args.kill_after is not None \
            or args.journal is not None:
        print(f"[serve] chaos: {stats.faults_injected} faults injected "
              f"{dict(stats.faults_by_kind)}, {stats.retries} retries, "
              f"{stats.sheds} sheds, {stats.quarantined} quarantined, "
              f"{stats.watchdog_kills} watchdog kills, "
              f"{stats.stream_errors} stream errors, "
              f"{stats.journal_replays} journal replays, "
              f"{stats.stragglers} straggler waves")
    if args.users > 0:
        print(f"[serve] personalization: {args.users} users, "
              f"{stats.train_waves} train waves "
              f"({stats.train_wave_ms_per_token:.2f}ms/token overhead), "
              f"delta hit rate {stats.delta_hit_rate:.2f}, "
              f"{stats.delta_resident_bytes} delta bytes resident, "
              f"{stats.delta_evictions} evictions")


if __name__ == "__main__":
    main()

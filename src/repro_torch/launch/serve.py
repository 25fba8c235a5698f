"""Serving launcher (the port's counterpart of `repro.launch.serve`): a thin
CLI over the paged continuous-batching engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
        --smoke --device cpu --requests 8 --batch 4 --prompt-len 32 \
        --gen-len 16 --page-size 16 --users 2

Requests are admitted into fixed decode slots backed by a paged KV cache;
prompts chunk-prefill a page at a time, and `--stream` prints tokens as
they are sampled. With `--users N > 0` requests are routed round-robin to N
users, each with a compact per-user delta applied at decode and advanced by
an online train wave when the user's request completes. Reported counts
cover COMPLETED requests only. Runs on the card (`--device cuda`, the
default) or on the CPU (`--device cpu`, smoke configs).

The flags are the reference launcher's. Prefix sharing is off in this
slice (`--prefix-mode off`, the default and the only mode accepted); the
flags of the features still to port raise with the ROADMAP item that
brings them rather than being ignored.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import (OptimizerConfig, SparseUpdateConfig,
                                 get_config, get_smoke_config)
from repro_torch.models import transformer as T
from repro_torch.serve import (PersonalizationConfig, ServeEngine,
                               make_random_requests)

_A13 = "ROADMAP queue A item 13"
# flag -> (is it set?, the ROADMAP item that brings it)
_REFUSED = {
    "--branching-prefix": (lambda a: a.branching_prefix, _A13),
    "--shared-prefix-len > 0": (lambda a: a.shared_prefix_len > 0, _A13),
    "--prefix-persist": (lambda a: a.prefix_persist is not None, _A13),
    "--fault-rate > 0": (lambda a: a.fault_rate > 0.0, _A13),
    "--kill-after": (lambda a: a.kill_after is not None, _A13),
    "--journal": (lambda a: a.journal is not None, _A13),
    "--watchdog-s": (lambda a: a.watchdog_s is not None, _A13),
    "--shed-watermark > 0": (lambda a: a.shed_watermark > 0.0, _A13),
    "--mesh-model > 1": (lambda a: a.mesh_model > 1,
                         "ROADMAP queue A item 14"),
    "--flash-decode": (lambda a: a.flash_decode, "ROADMAP queue A item 12"),
}


def check_args(args) -> None:
    """Raise on a flag whose feature the port does not have yet."""
    if args.prefix_mode != "off":
        raise NotImplementedError(
            f"--prefix-mode {args.prefix_mode}: prefix caches come with "
            f"{_A13} (not ported yet); this slice serves --prefix-mode off")
    for flag, (given, item) in _REFUSED.items():
        if given(args):
            raise NotImplementedError(
                f"{flag}: comes with {item} (not ported yet)")


def build_engine(args, cfg=None, params=None):
    """(cfg, engine) for parsed `args`; `params` (on args.device) are
    random from args.seed unless given, so two engines can share one copy
    of the weights."""
    check_args(args)
    device = torch.device(args.device)
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
    engine = ServeEngine(
        cfg, params, num_slots=args.batch,
        max_len=args.prompt_len + args.gen_len,
        temperature=args.temperature, eos_id=args.eos_id, seed=args.seed,
        page_size=args.page_size, num_pages=args.num_pages,
        prefix_mode=args.prefix_mode, personalization=p13n)
    return cfg, engine


def build_requests(args, cfg):
    check_args(args)
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
                    help="disable cross-request prompt-prefix page sharing "
                         "(always off in this slice)")
    ap.add_argument("--prefix-mode", choices=("radix", "chain", "off"),
                    default="off",
                    help="prefix-reuse structure; only off is served so far")
    ap.add_argument("--prefix-persist", type=str, default=None,
                    help="directory for the persistent prefix tree (not "
                         "ported yet)")
    ap.add_argument("--shared-prefix-len", type=int, default=0,
                    help="> 0: requests share a common prompt prefix of "
                         "this many tokens (not ported yet)")
    ap.add_argument("--branching-prefix", action="store_true",
                    help="partially-overlapping prefix workload (not ported "
                         "yet)")
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
                    help="chaos injection (not ported yet)")
    ap.add_argument("--chaos-seed", type=int, default=0)
    ap.add_argument("--chaos-slow-s", type=float, default=0.002)
    ap.add_argument("--max-retries", type=int, default=3)
    ap.add_argument("--shed-watermark", type=float, default=0.0,
                    help="load shedding (not ported yet)")
    ap.add_argument("--watchdog-s", type=float, default=None,
                    help="hung-request watchdog (not ported yet)")
    ap.add_argument("--journal", type=str, default=None,
                    help="request-lifecycle journal (not ported yet)")
    ap.add_argument("--kill-after", type=int, default=None,
                    help="injected crash (not ported yet)")
    ap.add_argument("--mesh-model", type=int, default=1,
                    help="> 1: sharded serving (not ported yet)")
    ap.add_argument("--flash-decode", action="store_true",
                    help="flash-decoding split softmax (not ported yet)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card) or cpu")
    return ap


def main(argv=None):
    args = add_serve_args(argparse.ArgumentParser()).parse_args(argv)
    cfg, engine = build_engine(args)
    stats = engine.run(build_requests(args, cfg), verbose=not args.stream)
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
          f"{stats.cow_splits} COW splits")
    if args.users > 0:
        print(f"[serve] personalization: {args.users} users, "
              f"{stats.train_waves} train waves "
              f"({stats.train_wave_ms_per_token:.2f}ms/token overhead), "
              f"delta hit rate {stats.delta_hit_rate:.2f}, "
              f"{stats.delta_resident_bytes} delta bytes resident, "
              f"{stats.delta_evictions} evictions")
    return stats


if __name__ == "__main__":
    main()

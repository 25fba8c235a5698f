"""Single-device dry-run of every (architecture x input-shape) cell: build
the cell's state, batch and cache on the `meta` device, run its step once
there for its FLOPs, and record its bytes beside the analytic memory model
and whether it fits one H100.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b \\
        --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mode dense
    # on a card: the same, plus one real step of a train cell at --batch
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b \\
        --shape train_4k --device cuda --batch 1

One JSON per cell goes to --out (default build/dryrun). The reference's
dry-run lowers and compiles each cell for a 512-chip TPU mesh and reads
XLA's memory and cost analyses; here there is one device and no compiler,
so:

- the bytes are the abstract state's (params trainable / frozen, optimizer
  state, `sel_idx`), the batch's and the cache's (a decode cell's input
  cache, a prefill cell's output cache), in place of
  `argument_size_in_bytes`;
- the extra memory is the analytic model's (`core.memory`:
  `training_extra_bytes` sparse, `dense_training_extra_bytes` dense; none
  for serving cells), in place of `temp_size_in_bytes`;
- the FLOPs are `torch.utils.flop_counter.FlopCounterMode`'s count of one
  run of the step on `meta`: every layer as it runs (forward, the
  recompute under checkpoint, backward), matmul-family ops only, where the
  reference's `hlo_flops_body_once` counts a scan body once;
- `fits_one_h100` holds state + batch + cache + the analytic extra against
  the card's memory (80 GiB assumed on `meta`).

A sparse train cell runs the compact step (the paper's path: the dW and
the optimizer touch the selected blocks only); the reference lowers its
dense-scatter step there. Every kernel wrapper takes its plain path on
`meta` and counts no launch.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Optional

import torch

from repro_torch.configs import (ARCH_IDS, SHAPES, ModelConfig,
                                 ShapeConfig, SparseUpdateConfig,
                                 cell_is_skipped, get_config)
from repro_torch.core import memory as memmod
from repro_torch.core.sparse_update import tree_leaves
from repro_torch.launch.specs import (_default_k, make_decode_cell,
                                      make_prefill_cell, make_train_cell)

DEVICE_BYTES_ASSUMED = 80 * 2**30      # one H100's memory, on `meta`
FLOPS_COUNTED = ("FlopCounterMode over one run of the step: every layer as "
                 "it runs (forward, recompute, backward), matmul-family ops")


def tree_bytes(tree) -> int:
    if tree is None:
        return 0
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _sparse_for(cfg, mode: str, update_ratio: float) -> SparseUpdateConfig:
    if mode == "sparse":
        return SparseUpdateConfig(update_ratio=update_ratio,
                                  num_update_layers=_default_k(cfg),
                                  channel_block=128)
    return SparseUpdateConfig(enabled=False)


def _analytic_extra(cfg, sparse, plan, tokens: int, slots: int) -> int:
    if sparse.enabled:
        return memmod.training_extra_bytes(cfg, sparse, plan.total_steps(),
                                           tokens, slots)
    return memmod.dense_training_extra_bytes(cfg, tokens, slots)


def card_batch(cfg, batch: int, seq: int, device, seed: int = 0) -> dict:
    """A random train batch on `device`: tokens (or the stub frontends'
    embeddings) and labels from `seed`; M-RoPE positions all text."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    out = {"labels": torch.randint(0, cfg.vocab_size, (batch, seq),
                                   generator=gen, dtype=torch.int32)}
    if cfg.embed_inputs:
        out["embeds"] = torch.randn((batch, seq, cfg.d_model),
                                    generator=gen).to(
                                        getattr(torch, cfg.dtype))
    else:
        out["tokens"] = torch.randint(0, cfg.vocab_size, (batch, seq),
                                      generator=gen, dtype=torch.int32)
    if cfg.mrope:
        out["positions"] = torch.arange(seq, dtype=torch.int32).expand(
            3, batch, seq).contiguous()
    return {k: v.to(device) for k, v in out.items()}


def card_step(cfg, shape, sparse, batch: int, seq: int) -> dict:
    """One train step of the cell on the card at `batch` x `seq`: the
    peak device bytes, the bytes resident before the step, the extra (peak
    less resident) beside the analytic model's, the launches it made and
    the launches its plan derives. Skipped with a reason when the state
    and the analytic extra exceed the card."""
    from repro_torch.launch.trace_analysis import (launch_breakdown,
                                                   plan_launches)
    cell = ShapeConfig(shape.name, seq, batch, "train")
    step_fn, state, _, plan = make_train_cell(cfg, cell, sparse,
                                              device="meta")
    analytic = _analytic_extra(cfg, sparse, plan, batch * seq,
                               len(state["opt"]))
    total = torch.cuda.get_device_properties(0).total_memory
    need = tree_bytes(state) + analytic
    rec = {"batch": batch, "seq": seq, "analytic_extra_bytes": analytic,
           "device_bytes": total}
    if need > total:
        rec.update(status="SKIP", reason=f"state + analytic extra {need} B "
                   f"exceed the card's {total} B")
        return rec
    del state
    torch.cuda.empty_cache()
    step_fn, state, _, plan = make_train_cell(cfg, cell, sparse,
                                              device="cuda")
    data = card_batch(cfg, batch, seq, "cuda")
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    (_, metrics), launches = launch_breakdown(lambda: step_fn(state, data))
    torch.cuda.synchronize()
    rec.update(
        status="OK", wall_s=time.perf_counter() - t0,
        loss=float(metrics["loss"]), resident_bytes=resident,
        peak_bytes=torch.cuda.max_memory_allocated(),
        launches=launches,
        plan_launches=plan_launches(cfg, plan) if sparse.enabled else None)
    rec["extra_bytes"] = rec["peak_bytes"] - resident
    rec["extra_over_analytic"] = rec["extra_bytes"] / analytic
    del state, data, step_fn
    torch.cuda.empty_cache()
    return rec


def run_cell(arch: str, shape_name: str, mode: str = "sparse",
             update_ratio: float = 0.2, device: str = "meta",
             batch: int = 1, seq: int = 0, device_bytes: int = 0,
             model: Optional[ModelConfig] = None,
             shape: Optional[ShapeConfig] = None) -> dict:
    """The record of one cell (see the module docstring). device "cuda":
    also one real step of a train cell at `batch` x `seq` (seq 0: the
    shape's), under "cuda" in the record. device_bytes: the card's memory
    (0: 80 GiB assumed). model / shape: a stated cut of the arch's config
    or of the cell's shape (as `launch.train.main(model=)` takes one)."""
    cfg = model or get_config(arch)
    shape = shape or SHAPES[shape_name]
    rec = {"arch": arch, "shape": shape_name, "mesh": "1", "mode": mode,
           "kind": shape.kind, "num_devices": 1, "device": device}
    skip = cell_is_skipped(arch, shape_name)
    if skip:
        rec["status"] = "SKIP"
        rec["skip_reason"] = skip
        return rec

    t0 = time.perf_counter()
    nbytes: dict = {}
    if shape.kind == "train":
        sparse = _sparse_for(cfg, mode, update_ratio)
        step_fn, state, data, plan = make_train_cell(cfg, shape, sparse)
        for key in ("params_trainable", "params_frozen", "opt", "sel_idx"):
            nbytes[key] = tree_bytes(state[key])
        nbytes["batch"] = tree_bytes(data)
        nbytes["cache"] = 0
        # the optimizer's fp32 state trees: SGD none, momentum mu, AdamW
        # mu and nu
        slots = len(state["opt"])
        rec["optimizer_slots"] = slots
        rec["analytic_extra_bytes"] = _analytic_extra(
            cfg, sparse, plan, shape.global_batch * shape.seq_len, slots)
        if sparse.enabled:
            from repro_torch.core.selection import selected_fraction
            rec["selected_param_fraction"] = selected_fraction(plan, cfg)
            rec["trainable_scan_steps"] = plan.total_steps()
        run = lambda: step_fn(state, data)
    elif shape.kind == "decode":
        step_fn, (params, data, cache) = make_decode_cell(cfg, shape)
        nbytes.update(params=tree_bytes(params), batch=tree_bytes(data),
                      cache=tree_bytes(cache))
        rec["analytic_extra_bytes"] = None
        run = lambda: step_fn(params, data, cache)
    else:
        step_fn, (params, data) = make_prefill_cell(cfg, shape)
        nbytes.update(params=tree_bytes(params), batch=tree_bytes(data))
        rec["analytic_extra_bytes"] = None
        run = lambda: step_fn(params, data)

    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as counter:
        out = run()
    if shape.kind == "prefill":
        nbytes["cache"] = tree_bytes(out[1])       # the cache it fills
    del out
    rec["flops"] = counter.get_total_flops()
    rec["flops_counted"] = FLOPS_COUNTED
    rec["bytes"] = nbytes
    need = sum(nbytes.values()) + (rec["analytic_extra_bytes"] or 0)
    rec["bytes_needed"] = need
    rec["device_bytes"] = device_bytes or DEVICE_BYTES_ASSUMED
    rec["device_bytes_assumed"] = not device_bytes
    rec["fits_one_h100"] = need <= rec["device_bytes"]
    rec["meta_s"] = time.perf_counter() - t0
    if device == "cuda" and shape.kind == "train":
        rec["cuda"] = card_step(cfg, shape, _sparse_for(cfg, mode,
                                                        update_ratio),
                                batch, seq or shape.seq_len)
    rec["status"] = "OK"
    return rec


def safe_run_cell(arch: str, shape_name: str, mode: str = "sparse",
                  **kw) -> dict:
    """run_cell, with an exception recorded as a FAIL (error and the
    traceback's tail) instead of raised."""
    try:
        return run_cell(arch, shape_name, mode, **kw)
    except Exception as e:  # noqa: BLE001 -- record and continue
        return {"arch": arch, "shape": shape_name, "mesh": "1",
                "mode": mode, "num_devices": 1, "status": "FAIL",
                "error": f"{type(e).__name__}: {e}",
                "traceback": traceback.format_exc()[-4000:]}


def summary(rec: dict) -> str:
    """One line of a record: status, bytes, FLOPs, fits."""
    if rec["status"] == "SKIP":
        return f"SKIP {rec['skip_reason']}"
    if rec["status"] == "FAIL":
        return f"FAIL {rec['error'][:160]}"
    b = rec["bytes"]
    state = sum(v for k, v in b.items() if k not in ("batch", "cache"))
    extra = rec["analytic_extra_bytes"]
    line = (f"OK state={state / 2**30:.2f}GiB "
            f"batch={b['batch'] / 2**20:.1f}MiB "
            f"cache={b['cache'] / 2**30:.2f}GiB "
            f"extra={'-' if extra is None else f'{extra / 2**30:.2f}GiB'} "
            f"flops={rec['flops']:.4e} "
            f"fits={'yes' if rec['fits_one_h100'] else 'no'} "
            f"meta={rec['meta_s']:.1f}s")
    card = rec.get("cuda")
    if card and card["status"] == "OK":
        line += (f" | card {card['batch']}x{card['seq']}: "
                 f"extra={card['extra_bytes'] / 2**30:.3f}GiB "
                 f"(analytic {card['analytic_extra_bytes'] / 2**30:.3f}) "
                 f"peak={card['peak_bytes'] / 2**30:.3f}GiB "
                 f"launches={card['launches']}")
    elif card:
        line += f" | card SKIP {card['reason']}"
    return line


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mode", choices=["sparse", "dense"], default="sparse")
    ap.add_argument("--update-ratio", type=float, default=0.2)
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--device", choices=["meta", "cuda"], default="meta")
    ap.add_argument("--batch", type=int, default=1,
                    help="batch of the card step (--device cuda)")
    ap.add_argument("--seq", type=int, default=0,
                    help="sequence of the card step (0: the shape's)")
    args = ap.parse_args(argv)

    if args.all:
        cells = [(a, s) for a in ARCH_IDS for s in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        cells = [(args.arch, args.shape)]
    device_bytes = 0
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("--device cuda: no CUDA device")
        device_bytes = torch.cuda.get_device_properties(0).total_memory
    os.makedirs(args.out, exist_ok=True)
    failures = 0
    for arch, shape in cells:
        tag = f"{arch}__{shape}__1__{args.mode}"
        rec = safe_run_cell(arch, shape, args.mode,
                            update_ratio=args.update_ratio,
                            device=args.device, batch=args.batch,
                            seq=args.seq, device_bytes=device_bytes)
        failures += rec["status"] == "FAIL"
        with open(os.path.join(args.out, tag + ".json"), "w") as f:
            json.dump(rec, f, indent=1)
        print(f"[dryrun] {tag}: {summary(rec)}", flush=True)
    if failures:
        raise SystemExit(f"{failures} cells failed")


if __name__ == "__main__":
    main()

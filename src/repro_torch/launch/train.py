"""Training launcher (the port's counterpart of `repro.launch.train`).

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \
        --steps 6 --batch 4 --seq 1024 --compact-grads --update-layers 2 \
        --channel-block 128 --phase-j 2 --phase-k 2 --log-every 1

Runs the DGSU fine-tuning loop on the card (`--device cuda`, the default) or
on the CPU (`--device cpu`, smoke configs). The flags are the reference
launcher's. Checkpointing comes with its own slice: `--ckpt-dir` is refused
until then rather than ignored.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import (OptimizerConfig, ShapeConfig,
                                 SparseUpdateConfig, TrainConfig, get_config,
                                 get_smoke_config)
from repro_torch.data import lm_batches
from repro_torch.train import make_train_state, make_train_step


def build_argparser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--optimizer", default="adamw",
                    choices=["sgd", "momentum", "adamw"])
    ap.add_argument("--dense", action="store_true", help="disable DGSU")
    ap.add_argument("--compact-grads", action="store_true",
                    help="compact-gradient path: never scatter a full-shape "
                         "dW; optimizer updates gathered blocks only")
    ap.add_argument("--update-ratio", type=float, default=0.2)
    ap.add_argument("--update-layers", type=int, default=0,
                    help="last-K scan blocks (0 = solve from budget)")
    ap.add_argument("--memory-budget-mb", type=float, default=0.0)
    ap.add_argument("--channel-block", type=int, default=16)
    ap.add_argument("--phase-j", type=int, default=10)
    ap.add_argument("--phase-k", type=int, default=30)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card) or cpu")
    return ap


def train_config(args) -> TrainConfig:
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    sparse = SparseUpdateConfig(
        enabled=not args.dense,
        update_ratio=args.update_ratio,
        num_update_layers=args.update_layers,
        memory_budget_bytes=int(args.memory_budget_mb * 2**20),
        channel_block=args.channel_block,
        phase_fixed_early=args.phase_j,
        phase_dynamic=args.phase_k,
        phase_fixed_late=max(0, args.steps - args.phase_j - args.phase_k),
        seed=args.seed,
    )
    return TrainConfig(
        model=cfg, shape=shape, sparse=sparse,
        optimizer=OptimizerConfig(kind=args.optimizer, learning_rate=args.lr,
                                  warmup_steps=min(20, args.steps // 10),
                                  decay_steps=args.steps),
        steps=args.steps, checkpoint_every=args.ckpt_every,
        checkpoint_dir=args.ckpt_dir, seed=args.seed,
        compact_grads=args.compact_grads and not args.dense)


def main(argv=None, on_step=None):
    """Parse `argv`, train, and return {"state", "plan", "losses"}.

    on_step(step, state, metrics), when given, runs after every step with
    the new state and the step's metrics (incl. "step_ms")."""
    ap = build_argparser()
    args = ap.parse_args(argv)
    if args.ckpt_dir:
        ap.error("--ckpt-dir: checkpointing is not ported yet")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        ap.error("--device cuda: no CUDA device; pass --device cpu to run "
                 "on the CPU")
    tc = train_config(args)
    cfg = tc.model
    state, plan = make_train_state(tc, device=device)
    if not args.dense:
        from repro_torch.core.selection import selected_fraction
        print(f"[train] DGSU plan: trainable steps/segment={plan.seg_trainable} "
              f"ratio={args.update_ratio} -> "
              f"{100*selected_fraction(plan, cfg):.2f}% of params per iter",
              flush=True)
    step_fn = make_train_step(tc, plan)
    data = lm_batches(tc.shape.global_batch, tc.shape.seq_len,
                      cfg.vocab_size, seed=args.seed)
    losses = []
    for step, batch in zip(range(args.steps), data):
        batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        metrics["step_ms"] = (time.perf_counter() - t0) * 1e3
        losses.append(float(metrics["loss"]))
        if (step + 1) % args.log_every == 0 or step + 1 == args.steps:
            print(f"[train] step {step + 1:5d} loss={losses[-1]:.4f} "
                  f"ce={float(metrics['ce']):.4f} "
                  f"ms={metrics['step_ms']:.1f}", flush=True)
        if on_step is not None:
            on_step(step + 1, state, metrics)
    print("[train] done", flush=True)
    return {"state": state, "plan": plan, "losses": losses}


if __name__ == "__main__":
    main()

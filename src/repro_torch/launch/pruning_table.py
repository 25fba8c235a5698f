"""Paper §IV-B analogue: channel + pattern pruning sparsity and FLOPs of
MobileNetV2 (the port's counterpart of `benchmarks/pruning_table.py`).

    PYTHONPATH=src python -m repro_torch.launch.pruning_table \
        [--config smoke|full] [--seed 0] [--device cuda|cpu]

Prints CSV rows `pruning/<metric>,<microseconds>,<value>`. Paper: channel
pruning 3.5M -> 2.01M params, FLOPs 0.32G -> 0.15G (2.15x), channel +
pattern sparsity ~92%.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.mobilenetv2_cifar import CONFIG, smoke_config
from repro_torch.core import pruning
from repro_torch.models import mobilenet_v2 as MN


def run(cfg, params) -> list[tuple]:
    t0 = time.perf_counter()
    _, rep_ch = pruning.full_prune(params, cfg, channel_target=0.45,
                                   pattern=False, unstructured_rate=0.0)
    _, rep_all = pruning.full_prune(params, cfg, channel_target=0.45,
                                    pattern=True, unstructured_rate=0.6)
    dt = (time.perf_counter() - t0) * 1e6
    flops_dense = pruning.conv_flops(cfg, cfg.img_size)
    flops_pruned = flops_dense * (1 - rep_ch["conv_sparsity"])
    return [
        ("pruning/channel_sparsity", dt / 2,
         f"{rep_ch['conv_sparsity']:.4f}"),
        ("pruning/channel+pattern_sparsity", dt / 2,
         f"{rep_all['conv_sparsity']:.4f}"),
        ("pruning/flops_reduction", 0.0,
         f"{flops_dense/1e6:.1f}M->{flops_pruned/1e6:.1f}M "
         f"({flops_dense/max(flops_pruned,1):.2f}x)"),
    ]


def main(argv=None) -> list[tuple]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (the card) or cpu")
    args = ap.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        ap.error("--device cuda: no CUDA device; pass --device cpu")
    cfg = CONFIG if args.config == "full" else smoke_config()
    params = MN.init_params(
        cfg, torch.Generator(device=args.device).manual_seed(args.seed))
    rows = run(cfg, params)
    for r in rows:
        print(",".join(map(str, r)))
    return rows


if __name__ == "__main__":
    main()

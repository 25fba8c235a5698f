#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA H100 and check it end to end.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):

1. environment: torch version, the card's name and power limit, TF32 off;
2. build: nvcc builds every kernel of the port from `src/repro_torch/kernels/csrc`;
3. kernels against their plain versions at the main paths' shapes
   (M = 4096 tokens, full llama3-8b widths; every activation shape of the
   full-width MobileNetV2 at batch 32), with their times, bounds and the
   library call's time;
4. the LM path: the compact sparse-update train step on full-width
   llama3-8b (32 layers, bf16), batch 4 x seq 1024, AdamW, 6 steps across
   the fixed / dynamic / fixed phases, through `repro_torch.launch.train`;
   the kernels' launch counts are zeroed just before and read just after;
5. one more LM step under torch.profiler: device time by op and the
   device's idle share;
6. compact against dense-scatter on the card: SGD, 2 fixed-phase steps,
   trainable params bitwise equal;
7. the CNN path: MobileNetV2 + GroupNorm at full width (224 x 224, width
   1.0), batch 32, the `dynamic` method for 12 steps (fixed 4 / dynamic 4 /
   fixed 4) through `repro_torch.launch.cnn_transfer`, counts zeroed just
   before and read just after: block activation pruning launched exactly
   as derived every step, frozen params and (in the first fixed phase) the
   unselected blocks bitwise unchanged; then 2 steps of `full`, and
   peak(dynamic) < peak(full);
8. one more CNN step under torch.profiler;
9. the reference's Table II at the smoke config (150 pretraining steps,
   120 transfer steps, five methods) and the learnability check.

The last lines are one JSON object with every kernel's numbers, and then
`{"ok": true, "device": {...}}`.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

M_TOKENS = 4096            # batch 4 x seq 1024: the main path's dW rows
M_LONG = 32768             # the pipelined instance at long M
K_LAYERS = 2               # trainable layers on the main path
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # H100 SXM, dense
PEAK_BYTES = 3.35e12
MAIN_ARGV = ["--arch", "llama3-8b", "--steps", "6", "--batch", "4",
             "--seq", "1024", "--compact-grads",
             "--update-layers", str(K_LAYERS), "--update-ratio", "0.2",
             "--channel-block", "128", "--optimizer", "adamw",
             "--phase-j", "2", "--phase-k", "2", "--log-every", "1",
             "--seed", "0"]
# name -> (route, source, the TPU kernel it replaces, the path that launches
# it). block_sparse_dw also replaces block_sparse_dw_pipelined_kernel
# (masked_dw.py:131) with its pipelined instance, which the wrapper picks
# wherever the shape is aligned. block_act_prune_bwd is the same kernel's
# backward entry point (the reference differentiates its jnp version).
SOURCES = {
    "block_sparse_dw": ("cuda",
                        "src/repro_torch/kernels/csrc/block_sparse_dw.cu",
                        "src/repro/kernels/masked_dw.py:65", "lm"),
    "fused_block_opt": ("cuda",
                        "src/repro_torch/kernels/csrc/fused_block_opt.cu",
                        "src/repro/kernels/fused_block_opt.py:88", "lm"),
    "block_act_prune": ("cuda",
                        "src/repro_torch/kernels/csrc/block_act_prune.cu",
                        "src/repro/kernels/block_act_prune.py:26", "cnn"),
    "block_act_prune_bwd": ("cuda",
                            "src/repro_torch/kernels/csrc/block_act_prune.cu",
                            "src/repro/kernels/block_act_prune.py:26", "cnn"),
}
# the port's kernels as the profiler names them
PORT_KERNELS = ("dw_grid_kernel", "dw_pipelined_kernel",
                "fused_block_opt_kernel", "prune_kernel")
CNN_BATCH = 32
CNN_STEPS, CNN_J, CNN_K = 12, 4, 4
CNN_ARGV = ["--config", "full", "--batch", str(CNN_BATCH), "--steps",
            str(CNN_STEPS), "--pretrain-steps", "0", "--methods", "dynamic",
            "--phase-j", str(CNN_J), "--phase-k", str(CNN_K), "--seed", "0"]
CNN_FULL_ARGV = ["--config", "full", "--batch", str(CNN_BATCH), "--steps",
                 "2", "--pretrain-steps", "0", "--methods", "full",
                 "--seed", "0"]


class SmokeError(RuntimeError):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeError(msg)


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _dev_us(e) -> float:
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def device_ms(fn, reps: int = 20, warmup: int = 2, flush=None) -> float:
    """The card's time per call: the device time of every kernel `fn`
    launches, from torch.profiler over `reps` calls. Where the host takes
    longer to submit a call than the card takes to run it (a small
    element-wise kernel), CUDA events around back-to-back calls time the
    host; this times the card. flush: a tensor larger than the 50 MB L2,
    zeroed before every call (its fill kernel is not counted), so that the
    call reads its inputs from device memory, as the byte bound assumes."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            if flush is not None:
                flush.zero_()
            fn()
        torch.cuda.synchronize()
    us = sum(_dev_us(e) for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA
             and not (flush is not None and "FillFunctor" in e.key))
    return us / reps / 1e3


def bound_ms(flops: float, nbytes: float, dtype: str) -> tuple[float, str]:
    """The least time the card could take: operations over the peak rate
    for their type, or bytes over the memory rate, whichever is larger."""
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _dname(dtype) -> str:
    return str(dtype).split(".")[-1]


def _rand_idx(lead: tuple, spec, gen):
    """Distinct random block indices, int32 [*lead, n_sel]."""
    rows = [torch.randperm(spec.n_blocks, generator=gen, device="cuda")
            [: spec.n_sel] for _ in range(int(torch.tensor(lead).prod()))]
    return torch.stack(rows).reshape(lead + (spec.n_sel,)).to(torch.int32)


def _selected_mask(leaf, idx, spec):
    """Bool mask of the selected column blocks of a stacked leaf."""
    from repro_torch.core.sparse_update import (gather_param_blocks,
                                                scatter_param_blocks)
    zeros = torch.zeros_like(leaf, dtype=torch.int8)
    ones = torch.ones_like(gather_param_blocks(zeros, idx, spec))
    return scatter_param_blocks(zeros, ones, idx, spec).bool()


def _main_path_leaves() -> dict:
    """{leaf: (fan_in, out, SelSpec)} of one trainable llama3-8b layer, as
    the main path's plan gives them."""
    from repro_torch.configs import SparseUpdateConfig, get_config
    from repro_torch.core.selection import build_plan
    from repro_torch.models.registry import abstract_params
    cfg = get_config("llama3-8b")
    plan = build_plan(cfg, SparseUpdateConfig(update_ratio=0.2,
                                              num_update_layers=K_LAYERS,
                                              channel_block=128))
    shapes = abstract_params(cfg)["segments"]["blocks"]
    return {name: tuple(shapes[group][name].shape[1:]) + (spec,)
            for group in ("attn", "mlp")
            for name, spec in plan.spec["blocks"][group].items()}


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_environment():
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[env] device={torch.cuda.get_device_name(0)} "
          f"count={torch.cuda.device_count()} "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}", flush=True)


def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    for name in build.build_all():
        build.load(name)
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}", flush=True)
    print(f"[build] {len(build.SOURCES)} libraries ready in "
          f"{time.perf_counter() - t0:.1f} s (nvcc seconds per source: "
          f"{ {k: round(v, 1) for k, v in build.BUILD_SECONDS.items()} })",
          flush=True)


def _new_sums() -> dict:
    return {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "flops": 0.0,
            "bytes": 0.0, "max_abs_err": 0.0}


def check_dw(leaves: dict, gen, sums: dict):
    """Both dW instances at every leaf shape, bf16 and fp32, against the
    plain version (fp32 sums over M in another order: 1e-4 of the largest
    output). The main path's instance, in bf16, goes into the sums."""
    from repro_torch.kernels import ops, ref
    for dtype in (torch.bfloat16, torch.float32):
        for leaf, (fan_in, out, spec) in leaves.items():
            x = torch.randn(M_TOKENS, fan_in, generator=gen,
                            device="cuda").to(dtype)
            dy = torch.randn(M_TOKENS, out, generator=gen,
                             device="cuda").to(dtype)
            idx = _rand_idx((spec.n_shards,), spec, gen)
            want = ref.block_sparse_dw_ref(x, dy, idx, spec.block)
            tol = 1e-4 * float(want.abs().max())
            main_pipe = ops.use_pipelined(x, dy, spec.block)
            dy_sel = ref.gather_dy_blocks(dy, idx, spec.block).reshape(
                M_TOKENS, -1).contiguous()
            lib = cuda_ms(lambda: torch.matmul(x.t(), dy_sel))
            plain = cuda_ms(lambda: ref.block_sparse_dw_ref(x, dy, idx,
                                                            spec.block))
            cols = spec.n_shards * spec.n_sel * spec.block
            flops = 2.0 * M_TOKENS * fan_in * cols
            # x once, the selected dy columns once, idx, the fp32 output
            nbytes = (M_TOKENS * fan_in + M_TOKENS * cols) * x.element_size() \
                + idx.numel() * 4 + fan_in * cols * 4
            b_ms, b_by = bound_ms(flops, nbytes, _dname(dtype))
            for pipe in (False, True):
                got = ops.block_sparse_dw(x, dy, idx, spec, pipelined=pipe)
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                inst = "pipelined" if pipe else "grid"
                check(got.shape == want.shape and err <= tol,
                      f"block_sparse_dw {inst} {leaf} {_dname(dtype)}: "
                      f"max_abs_err {err} > {tol}")
                ms = cuda_ms(lambda: ops.block_sparse_dw(x, dy, idx, spec,
                                                         pipelined=pipe))
                main = pipe == main_pipe
                print(f"[kernel] block_sparse_dw {inst} {leaf} "
                      f"{_dname(dtype)} M={M_TOKENS} K={fan_in} N={out} "
                      f"n_sel={spec.n_sel} block={spec.block} "
                      f"main_path={main} kernel_ms={ms:.4f} "
                      f"plain_ms={plain:.4f} library_ms={lib:.4f} "
                      f"bound_ms={b_ms:.4f} ({b_by}) max_abs_err={err:.3e} "
                      f"tol={tol:.3e}", flush=True)
                if dtype == torch.bfloat16 and main:
                    for key, val in (("ms", ms), ("plain_ms", plain),
                                     ("library_ms", lib), ("flops", flops),
                                     ("bytes", nbytes)):
                        sums[key] += val
                    sums["max_abs_err"] = max(sums["max_abs_err"], err)
            del x, dy, want, dy_sel


def check_dw_long(leaves: dict, gen):
    """Both instances at M = 32768 rows, bf16."""
    from repro_torch.kernels import ops, ref
    for leaf in ("wk", "w_down"):
        fan_in, out, spec = leaves[leaf]
        x = torch.randn(M_LONG, fan_in, generator=gen,
                        device="cuda").to(torch.bfloat16)
        dy = torch.randn(M_LONG, out, generator=gen,
                         device="cuda").to(torch.bfloat16)
        idx = _rand_idx((spec.n_shards,), spec, gen)
        want = ref.block_sparse_dw_ref(x, dy, idx, spec.block)
        tol = 1e-4 * float(want.abs().max())
        for pipe in (True, False):
            got = ops.block_sparse_dw(x, dy, idx, spec, pipelined=pipe)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            check(err <= tol, f"block_sparse_dw pipelined={pipe} {leaf} "
                              f"M={M_LONG}: max_abs_err {err} > {tol}")
            ms = cuda_ms(lambda: ops.block_sparse_dw(x, dy, idx, spec,
                                                     pipelined=pipe), reps=3)
            print(f"[kernel] block_sparse_dw "
                  f"{'pipelined' if pipe else 'grid'} {leaf} bfloat16 "
                  f"M={M_LONG} K={fan_in} N={out} n_sel={spec.n_sel} "
                  f"kernel_ms={ms:.4f} max_abs_err={err:.3e} tol={tol:.3e}",
                  flush=True)
        del x, dy, want


def check_opt(leaves: dict, gen, sums: dict):
    """The fused optimizer at every leaf shape of the K trainable layers,
    for SGD (bitwise), momentum and AdamW (1e-6, or one ulp of the stored
    type), bf16 and fp32 weights: selected blocks move, every other element
    of w, mu and nu stays bitwise. The main path's case (AdamW, bf16) is
    timed into the sums."""
    from repro_torch.kernels import ops, ref
    for kind in ("sgd", "momentum", "adamw"):
        for wdtype in (torch.bfloat16, torch.float32):
            for leaf, (fan_in, out, spec) in leaves.items():
                shape = (K_LAYERS, fan_in, out)
                w = (torch.randn(shape, generator=gen, device="cuda")
                     * 0.02).to(wdtype)
                g = torch.randn(K_LAYERS, fan_in, spec.n_shards, spec.n_sel,
                                spec.block, generator=gen,
                                device="cuda").to(wdtype)
                idx = _rand_idx((K_LAYERS, spec.n_shards), spec, gen)
                mu = torch.randn(shape, generator=gen, device="cuda") \
                    if kind != "sgd" else None
                nu = torch.rand(shape, generator=gen, device="cuda") \
                    if kind == "adamw" else None
                hyper = torch.tensor([1e-3, 3.0], device="cuda")
                hp = dict(kind=kind, weight_decay=0.01,
                          momentum=0.9 if kind == "momentum" else 0.0)
                want = ref.fused_block_opt_ref(w, g, idx, hyper[0], hyper[1],
                                               mu, nu, **hp)
                before = [t.clone() if t is not None else None
                          for t in (w, mu, nu)]
                ops.fused_block_opt(w, g, idx, hyper, mu, nu, **hp)
                torch.cuda.synchronize()
                mask = _selected_mask(w, idx, spec)
                err = 0.0
                for got, exp, old in zip((w, mu, nu), want, before):
                    if got is None:
                        continue
                    check(torch.equal(got[~mask], old[~mask]),
                          f"fused_block_opt {kind} {leaf}: an unselected "
                          f"element changed")
                    check(not torch.equal(got[mask], old[mask]),
                          f"fused_block_opt {kind} {leaf}: the selected "
                          f"blocks did not change")
                    d = (got.float() - exp.float()).abs()
                    if kind == "sgd":
                        check(torch.equal(got, exp),
                              f"fused_block_opt sgd {leaf} {wdtype}: not "
                              f"bitwise equal to the plain version")
                    else:
                        ulp = torch.finfo(got.dtype).eps * exp.float().abs()
                        check(bool((d <= ulp.clamp(min=1e-6)).all()),
                              f"fused_block_opt {kind} {leaf} {wdtype}: "
                              f"max abs err {float(d.max())}")
                    err = max(err, float(d.max()))
                line = (f"[kernel] fused_block_opt {kind} {leaf} "
                        f"w={_dname(wdtype)} K={K_LAYERS} R={fan_in} N={out} "
                        f"n_sel={spec.n_sel} max_abs_err={err:.3e}")
                if kind == "adamw" and wdtype == torch.bfloat16:
                    ms = cuda_ms(lambda: ops.fused_block_opt(
                        w, g, idx, hyper, mu, nu, **hp))
                    plain = cuda_ms(lambda: ref.fused_block_opt_ref(
                        w, g, idx, hyper[0], hyper[1], mu, nu, **hp))
                    elems = g.numel()
                    # read and write w, mu, nu; read g and idx
                    nbytes = elems * (2 * w.element_size() + g.element_size()
                                      + 2 * 4 + 2 * 4) + idx.numel() * 4
                    flops = elems * 16.0
                    b_ms, b_by = bound_ms(flops, nbytes, "float32")
                    line += (f" kernel_ms={ms:.4f} plain_ms={plain:.4f} "
                             f"bound_ms={b_ms:.4f} ({b_by})")
                    for key, val in (("ms", ms), ("plain_ms", plain),
                                     ("flops", flops), ("bytes", nbytes)):
                        sums[key] += val
                    sums["max_abs_err"] = max(sums["max_abs_err"], err)
                print(line, flush=True)
                del w, g, mu, nu, want, before, mask


def _same_bits(a, b) -> bool:
    """Bitwise equality (the sign of zero included)."""
    view = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.view(view[a.dtype]), b.view(view[b.dtype]))


def _prune_case(x, dy, thr, blk):
    """Both entry points against their plain versions, bitwise."""
    from repro_torch.kernels import ops, ref
    y = ops.block_act_prune_fwd(x, thr, blk)
    dx = ops.block_act_prune_bwd(dy, y, thr, blk)
    torch.cuda.synchronize()
    want_y = ref.block_act_prune_ref(x, thr, blk)
    want_dx = ref.block_act_prune_bwd_ref(dy, want_y, thr, blk)
    return (_same_bits(y, want_y) and _same_bits(dx, want_dx),
            float((y.float() - want_y.float()).abs().max()),
            float((y == 0).float().mean()))


def check_prune(gen, fwd: dict, bwd: dict):
    """Block activation pruning, forward and backward, at every distinct
    activation shape of the full-width MobileNetV2 forward at batch 32
    ([32*H*W, C]), fp32 (the path's type) and bf16: bitwise equal to the
    plain versions. The fp32 times go into the sums, weighted by how often
    the shape occurs: all 35 sites forward, the 5 sites one dynamic step
    differentiates backward. Bytes: x read, y written (forward); dy and y
    read, dx written (backward). Times are the card's (`device_ms`), with
    the L2 flushed before every call: at the small shapes the wrapper's
    ~20 us of host work exceeds the kernel, so CUDA events (printed beside
    them) time the host, and an L2-warm input (also printed) beats the
    device-memory bound."""
    from collections import Counter
    from repro_torch.configs.mobilenetv2_cifar import CONFIG
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import cnn_transfer as CT
    from repro_torch.models import mobilenet_v2 as MN
    thr, blk = CT.PRUNE_THRESHOLD, CT.PRUNE_BLOCK
    sites = MN.prune_sites(CONFIG, CONFIG.img_size)
    n_bwd = CT.prune_launches(CONFIG, "dynamic")[1]
    n_fwd = Counter(shape for _, shape in sites)
    n_back = Counter(shape for _, shape in sites[len(sites) - n_bwd:])
    flush = torch.empty(64 << 20, device="cuda")     # 256 MB, 5x the L2
    for (h, w, c), mult in n_fwd.items():
        r = CNN_BATCH * h * w
        for dtype in (torch.float32, torch.bfloat16):
            x = (torch.randn(r, c, generator=gen, device="cuda") * 0.3) \
                .to(dtype)
            dy = torch.randn(r, c, generator=gen, device="cuda").to(dtype)
            ok, err, pruned = _prune_case(x, dy, thr, blk)
            check(ok, f"block_act_prune [{r}, {c}] {_dname(dtype)}: not "
                      f"bitwise equal to the plain version")
            line = (f"[kernel] block_act_prune R={r} C={c} "
                    f"{_dname(dtype)} sites={mult} backward_sites="
                    f"{n_back[(h, w, c)]} pruned_share={pruned:.3f} "
                    f"bitwise=True")
            if dtype == torch.float32:
                y = ops.block_act_prune_fwd(x, thr, blk)
                calls = {
                    "fwd": lambda: ops.block_act_prune_fwd(x, thr, blk),
                    "fwd_plain": lambda: ref.block_act_prune_ref(x, thr, blk),
                    "bwd": lambda: ops.block_act_prune_bwd(dy, y, thr, blk),
                    "bwd_plain": lambda: ref.block_act_prune_bwd_ref(
                        dy, y, thr, blk)}
                t = {k: device_ms(fn, flush=flush)
                     for k, fn in calls.items()}
                warm = {k: device_ms(fn) for k, fn in calls.items()}
                events = {k: cuda_ms(fn) for k, fn in calls.items()}
                n = r * c
                for sums, k, m, nbytes in ((fwd, "fwd", mult, 2 * n * 4),
                                           (bwd, "bwd", n_back[(h, w, c)],
                                            3 * n * 4)):
                    sums["ms"] += m * t[k]
                    sums["plain_ms"] += m * t[k + "_plain"]
                    sums["bytes"] += m * nbytes
                    sums["flops"] += m * 2.0 * n
                    sums["max_abs_err"] = max(sums["max_abs_err"], err)
                line += " device " + " ".join(f"{k}_ms={v:.4f}"
                                              for k, v in t.items())
                line += " l2_warm " + " ".join(f"{k}_ms={v:.4f}"
                                               for k, v in warm.items())
                line += " events " + " ".join(f"{k}_ms={v:.4f}"
                                              for k, v in events.items())
                line += (f" fwd_bound_ms={2 * n * 4 / PEAK_BYTES * 1e3:.4f}"
                         f" bwd_bound_ms={3 * n * 4 / PEAK_BYTES * 1e3:.4f}")
                del y
            print(line, flush=True)
            del x, dy


def check_prune_paths(gen):
    """The kernel's other instances, bitwise: the 8-wide bf16 vector path
    (block 8), a block wider than a vector (16), blocks that leave a tail
    after the last whole vector, and a base pointer off 16-byte alignment
    (the scalar loop)."""
    for dtype in (torch.float32, torch.bfloat16):
        for blk, c, offset in ((4, 64, 0), (8, 64, 0), (16, 64, 0),
                               (2, 6, 0), (2, 64, 1), (1, 7, 3)):
            n = 999 * c
            base = torch.randn(n + offset, generator=gen, device="cuda")
            x = (base * 0.3).to(dtype)[offset:].view(999, c)
            dy = base.to(dtype)[offset:].view(999, c)
            ok, _, _ = _prune_case(x, dy, 0.15, blk)
            check(ok, f"block_act_prune block={blk} C={c} offset={offset} "
                      f"{_dname(dtype)}: not bitwise equal")
    print("[kernel] block_act_prune other instances (block 1, 2, 4, 8, 16; "
          "tails; misaligned): bitwise equal", flush=True)


def phase_kernels(results: dict):
    gen = torch.Generator(device="cuda").manual_seed(0)
    leaves = _main_path_leaves()
    results["block_sparse_dw"] = _new_sums()
    results["fused_block_opt"] = _new_sums()
    check_dw(leaves, gen, results["block_sparse_dw"])
    check_dw_long(leaves, gen)
    check_opt(leaves, gen, results["fused_block_opt"])
    results["block_act_prune"] = _new_sums()
    results["block_act_prune_bwd"] = _new_sums()
    check_prune(gen, results["block_act_prune"],
                results["block_act_prune_bwd"])
    check_prune_paths(gen)
    torch.cuda.empty_cache()


def phase_main_path(results: dict):
    from repro_torch.core.selection import build_plan, selected_fraction
    from repro_torch.kernels import ops
    from repro_torch.launch import train

    args = train.build_argparser().parse_args(MAIN_ARGV)
    tc = train.train_config(args)
    plan = build_plan(tc.model, tc.sparse,
                      tc.shape.global_batch * tc.shape.seq_len)
    spec = plan.spec["blocks"]["mlp"]["w_gate"]
    print(f"[main] llama3-8b full width, {tc.model.num_layers} layers "
          f"(no depth cut), {tc.model.dtype}, batch {args.batch} x seq "
          f"{args.seq}, {args.optimizer}, selected share of params per step "
          f"{selected_fraction(plan, tc.model):.6f}", flush=True)

    per_step = []
    last = {"counts": {k: 0 for k in ops.LAUNCHES}, "w_gate": None}

    def on_step(step, state, metrics):
        counts = ops.launch_counts()
        delta = {k: counts[k] - last["counts"][k] for k in counts}
        leaf = state["params_trainable"]["segments"]["blocks"]["mlp"]["w_gate"]
        if last["w_gate"] is not None:
            # this step's selection, against the leaf before this step
            mask = _selected_mask(
                leaf, state["sel_idx"]["blocks"]["mlp"]["w_gate"], spec)
            check(torch.equal(leaf[~mask], last["w_gate"][~mask]),
                  f"step {step}: an unselected block of w_gate changed")
            check(not torch.equal(leaf[mask], last["w_gate"][mask]),
                  f"step {step}: the selected blocks of w_gate did not move")
        last["counts"], last["w_gate"] = counts, leaf.clone()
        row = {"step": step, "loss": float(metrics["loss"]),
               "step_ms": metrics["step_ms"],
               "max_memory_allocated": torch.cuda.max_memory_allocated(),
               "launches": delta}
        per_step.append(row)
        print(f"[main] step {step} loss={row['loss']:.6f} "
              f"step_ms={row['step_ms']:.1f} "
              f"max_memory_allocated={row['max_memory_allocated']} "
              f"launches={delta}", flush=True)

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    out = train.main(MAIN_ARGV, on_step=on_step)
    totals = ops.launch_counts()

    check(len(per_step) == 6, f"ran {len(per_step)} steps, want 6")
    for row in per_step:
        dw, opt = (row["launches"]["block_sparse_dw"],
                   row["launches"]["fused_block_opt"])
        check(dw == K_LAYERS * 7,
              f"step {row['step']}: {dw} dW launches, want {K_LAYERS}x7")
        check(opt == 7, f"step {row['step']}: {opt} optimizer launches, "
                        f"want 7")
        check(bool(torch.isfinite(torch.tensor(row["loss"]))),
              f"step {row['step']}: loss {row['loss']} is not finite")
    for name, (_, _, _, path) in SOURCES.items():
        if path == "lm":
            check(totals[name] > 0, f"{name} was never launched on the LM "
                                    f"path")
            results["launches"][name] = totals[name]
    print(f"[main] launches over 6 steps: {totals}; block_sparse_dw by "
          f"instance: {dict(ops.DW_INSTANCES)}", flush=True)
    return tc, out


def profile_step(tag: str, run):
    """`run()` once under torch.profiler, then synced: device time by
    kernel, the share of the wall time the device sits idle, and the port's
    kernels' share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    # kernel rows only: a CPU op's row repeats its kernels' device time
    rows = sorted(((_dev_us(e), e.key, e.count) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and _dev_us(e) > 0),
                  reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    check(busy_ms > 0, "the profiler saw no device time")
    ours = sum(r[0] for r in rows if any(
        k in r[1] for k in PORT_KERNELS)) / 1e3
    print(f"[profile] {tag}: wall_ms={wall_ms:.1f} "
          f"device_busy_ms={busy_ms:.1f} "
          f"idle_share={max(0.0, 1 - busy_ms / wall_ms):.3f} "
          f"port_kernels_ms={ours:.2f}", flush=True)
    for us, key, count in rows[:15]:
        print(f"[profile] {us / 1e3:9.2f} ms {100 * us / 1e3 / busy_ms:5.1f}% "
              f"x{count:<5d} {key[:90]}", flush=True)


def phase_profile(tc, out):
    """One more LM step (fixed phase) under torch.profiler."""
    from repro_torch.data import lm_batches
    from repro_torch.train import make_train_step

    step_fn = make_train_step(tc, out["plan"])
    batch = next(lm_batches(tc.shape.global_batch, tc.shape.seq_len,
                            tc.model.vocab_size, seed=tc.seed, start_step=6))
    batch = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
    profile_step("one fixed-phase step",
                 lambda: step_fn(out["state"], batch))


def phase_compact_vs_dense():
    from repro_torch.configs import (OptimizerConfig, ShapeConfig,
                                     SparseUpdateConfig, TrainConfig,
                                     get_config)
    from repro_torch.core.sparse_update import tree_leaves, tree_map
    from repro_torch.data import lm_batches
    from repro_torch.train import make_train_state, make_train_step

    cfg = get_config("llama3-8b")
    tc = TrainConfig(model=cfg, shape=ShapeConfig("smoke", 1024, 4, "train"),
                     sparse=SparseUpdateConfig(update_ratio=0.2,
                                               num_update_layers=K_LAYERS,
                                               channel_block=128,
                                               phase_fixed_early=10),
                     optimizer=OptimizerConfig(kind="sgd", learning_rate=0.1),
                     seed=1)
    state_c, plan = make_train_state(tc, device="cuda")
    # the compact step updates its trainable tensors in place: the
    # dense-scatter run starts from its own copy
    state_d = dict(state_c)
    state_d["params_trainable"] = tree_map(torch.clone,
                                           state_c["params_trainable"])
    data = lm_batches(4, 1024, cfg.vocab_size, seed=1)
    step_c = make_train_step(tc, plan, compact_grads=True)
    step_d = make_train_step(tc, plan, compact_grads=False)
    for i in range(2):
        batch = {k: torch.from_numpy(v).cuda() for k, v in next(data).items()}
        state_c, m_c = step_c(state_c, batch)
        state_d, m_d = step_d(state_d, batch)
        print(f"[compact-vs-dense] step {i + 1} loss compact="
              f"{float(m_c['loss']):.6f} dense_scatter="
              f"{float(m_d['loss']):.6f}", flush=True)
        check(float(m_c["loss"]) == float(m_d["loss"]),
              f"step {i + 1}: losses differ")
    a = tree_leaves(state_c["params_trainable"])
    b = tree_leaves(state_d["params_trainable"])
    unequal = sum(not torch.equal(x, y) for x, y in zip(a, b))
    check(unequal == 0, f"{unequal} of {len(a)} trainable leaves differ")
    print(f"[compact-vs-dense] sgd, 2 fixed-phase steps: all {len(a)} "
          f"trainable leaves bitwise equal", flush=True)


def _blocks_of(w, idx, spec):
    """w [..., out] viewed as [-1, n_blocks, block], and the bool mask of
    the blocks in idx ([1, n_sel])."""
    mask = torch.zeros(spec.n_blocks, dtype=torch.bool, device=w.device)
    mask[idx[0].long()] = True
    return w.reshape(-1, spec.n_blocks, spec.block), mask


def _leaf(tree, name):
    node = tree
    for part in name.split("/"):
        node = node[part]
    return node


def _run_cnn(argv, method, per_step_check):
    """cnn_transfer.main(argv) with the launch counts zeroed just before and
    read just after; checks every step's launches against prune_launches
    and its loss for finiteness. Returns (out, per-step rows, totals)."""
    from repro_torch.configs.mobilenetv2_cifar import CONFIG
    from repro_torch.kernels import ops
    from repro_torch.launch import cnn_transfer as CT
    want = dict(zip(("block_act_prune", "block_act_prune_bwd"),
                    CT.prune_launches(CONFIG, method)))
    rows = []
    last = {"counts": {k: 0 for k in ops.LAUNCHES}}

    def on_step(step, state, metrics):
        counts = ops.launch_counts()
        delta = {k: counts[k] - last["counts"][k] for k in counts}
        last["counts"] = counts
        for name, n in want.items():
            check(delta[name] == n, f"{method} step {step}: {delta[name]} "
                                    f"{name} launches, want {n}")
        check(delta["block_sparse_dw"] == delta["fused_block_opt"] == 0,
              f"{method} step {step}: an LM kernel was launched")
        check(bool(torch.isfinite(torch.tensor(metrics["loss"]))),
              f"{method} step {step}: loss {metrics['loss']} is not finite")
        per_step_check(step, state)
        rows.append(dict(metrics, step=step))
        print(f"[cnn] {method} step {step} loss={metrics['loss']:.6f} "
              f"step_ms={metrics['step_ms']:.2f} "
              f"data_ms={metrics['data_ms']:.2f} launches={delta}",
              flush=True)

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    out = CT.main(argv, on_step=on_step)
    totals = ops.launch_counts()
    steps = len(rows)
    for name, n in want.items():   # eval runs without pruning: no more
        check(totals[name] == steps * n, f"{method}: {totals[name]} {name} "
                                         f"launches in the run, want "
                                         f"{steps} x {n}")
    return out, rows, totals


def phase_cnn(results: dict):
    """The CNN path at full width: 12 dynamic-method steps, then 2 full
    fine-tuning steps for the memory comparison."""
    from repro_torch.configs.mobilenetv2_cifar import CONFIG
    from repro_torch.core.sparse_update import tree_leaves
    from repro_torch.launch import cnn_transfer as CT
    from repro_torch.models import mobilenet_v2 as MN

    cfg = CONFIG
    # the run's init, made again from the same seed: the yardstick for
    # "unchanged"
    init = MN.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    trainable = set(CT.split_for(cfg, init, "dynamic")[1])
    print(f"[cnn] MobileNetV2 + GN full width ({cfg.img_size}x{cfg.img_size},"
          f" width {cfg.width_mult}, {len(MN.conv_layer_names(cfg))} convs, "
          f"{sum(t.numel() for t in tree_leaves(init))} params), batch "
          f"{CNN_BATCH}, trainable {sorted(trainable)}, prune launches per "
          f"step {CT.prune_launches(cfg, 'dynamic')}", flush=True)
    prev = {}

    def dynamic_check(step, state):
        idx, spec = state["idx"], state["spec"]
        if step <= CNN_J:
            # first fixed phase, momentum from zero: the unselected blocks of
            # the selected 1x1 convs are bitwise their init, the rest moved
            for name, sp in spec.items():
                w0 = _leaf(init, name)
                if w0.shape[2] == 1:      # depthwise: not masked by channel
                    continue
                wb, mask = _blocks_of(_leaf(state["trainable"], name),
                                      idx[name], sp)
                w0b, _ = _blocks_of(w0, idx[name], sp)
                check(torch.equal(wb[:, ~mask], w0b[:, ~mask]),
                      f"step {step}: an unselected block of {name} changed")
                check(not torch.equal(wb[:, mask], w0b[:, mask]),
                      f"step {step}: the selected blocks of {name} did not "
                      f"move")
        elif step <= CNN_J + CNN_K:
            check(any(not torch.equal(idx[n], prev[n]) for n in idx),
                  f"step {step}: the dynamic phase kept the last selection")
        else:
            check(all(torch.equal(idx[n], prev[n]) for n in idx),
                  f"step {step}: the late fixed phase changed the selection")
        prev.update(idx)

    out, rows, totals = _run_cnn(CNN_ARGV, "dynamic", dynamic_check)
    check(len(rows) == CNN_STEPS, f"ran {len(rows)} steps, want {CNN_STEPS}")
    row = out["rows"][0]
    unchanged = [k for k in init if k not in trainable and all(
        torch.equal(a, b) for a, b in zip(tree_leaves(init[k]),
                                          tree_leaves(row["params"][k])))]
    check(len(unchanged) == len(init) - len(trainable),
          "a frozen param changed")
    for name in ("block_act_prune", "block_act_prune_bwd"):
        results["launches"][name] = totals[name]
    steady = [r["step_ms"] for r in rows[1:]]
    med = statistics.median(steady)
    peak_dyn = row["peak_bytes"]
    print(f"[cnn] dynamic: {CNN_STEPS} steps, frozen params bitwise "
          f"unchanged ({len(unchanged)} blocks), unselected blocks unchanged "
          f"through the first fixed phase; launches {totals}", flush=True)
    print(f"[cnn] dynamic step_ms steps 2-{CNN_STEPS}: "
          f"{[round(t, 3) for t in steady]} median={med:.3f} "
          f"images_per_s={CNN_BATCH / med * 1e3:.1f} step1_ms="
          f"{rows[0]['step_ms']:.3f} data_ms_median="
          f"{statistics.median(r['data_ms'] for r in rows):.3f} "
          f"acc={row['acc']:.4f} peak_bytes={peak_dyn}", flush=True)
    del out, row

    out, rows, totals = _run_cnn(CNN_FULL_ARGV, "full", lambda *_: None)
    peak_full = out["rows"][0]["peak_bytes"]
    print(f"[cnn] full: step_ms={[round(r['step_ms'], 3) for r in rows]} "
          f"peak_bytes={peak_full} launches {totals}", flush=True)
    check(peak_dyn < peak_full, f"peak(dynamic) {peak_dyn} is not below "
                                f"peak(full) {peak_full}")
    print(f"[cnn] peak(dynamic) / peak(full) = {peak_dyn / peak_full:.4f}",
          flush=True)
    return init


def phase_cnn_profile(init):
    """One dynamic-phase step of the CNN path under torch.profiler, its
    batch already on the card."""
    from repro_torch.configs.mobilenetv2_cifar import CONFIG
    from repro_torch.data import TransferTask
    from repro_torch.launch import cnn_transfer as CT
    from repro_torch.optim import init_opt_state

    cfg, step = CONFIG, CNN_J
    frozen, p = CT.split_for(cfg, init, "dynamic")
    idx, spec = CT._selection(cfg, init, CT.UPDATE_RATIO, CT.LAST_K_CONVS,
                              seed=0, step=step, magnitude=False)
    oc = CT.transfer_optimizer("dynamic", CNN_STEPS)
    st = init_opt_state(oc, p)
    t0 = time.perf_counter()
    host = TransferTask(img=cfg.img_size, seed=0).batch(CNN_BATCH, step,
                                                        "target")
    data_ms = (time.perf_counter() - t0) * 1e3
    b = CT._to_device(host, "cuda")
    prune = CT.make_act_pruner(CT.PRUNE_THRESHOLD, CT.PRUNE_BLOCK)

    def run():
        CT.train_step(cfg, oc, frozen, p, st, b, step, sel=(idx, spec),
                      act_prune=prune)
    run()
    profile_step(f"one CNN dynamic step (the host made its batch of "
                 f"{CNN_BATCH} images in {data_ms:.1f} ms beforehand)", run)


def phase_table2():
    """The reference's Table II at the smoke config, on the card: the rows
    are reported, not asserted; the learnability check is asserted."""
    from repro_torch.configs.mobilenetv2_cifar import smoke_config
    from repro_torch.data import TransferTask
    from repro_torch.kernels import ops
    from repro_torch.launch import cnn_transfer as CT
    from repro_torch.models import mobilenet_v2 as MN

    t0 = time.perf_counter()
    ops.reset_launch_counts()
    out = CT.main(["--config", "smoke", "--seed", "0"])
    totals = ops.launch_counts()
    cfg = out["cfg"]
    want = [sum(CT.prune_launches(cfg, m)[i] for m in CT.METHODS) * CT.STEPS
            for i in (0, 1)]
    got = [totals["block_act_prune"], totals["block_act_prune_bwd"]]
    check(got == want, f"table2: prune launches {got}, want {want}")
    for row in out["rows"]:
        print(f"[table2] {row['method']} acc={row['acc']:.4f} "
              f"extra_mem={row['extra_mem']}B seconds={row['seconds']:.2f}",
              flush=True)
    print(f"[table2] paper (CIFAR-10): none=36.83 last=59.34 full=90.33 "
          f"fixed=84.30 dynamic=85.77; run took "
          f"{time.perf_counter() - t0:.1f} s, prune launches {got}",
          flush=True)
    cfg = smoke_config()
    params = MN.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    acc0, acc = CT.learnability(cfg, TransferTask(img=cfg.img_size, seed=0),
                                params, "cuda")
    print(f"[table2] learnability (30 full fine-tuning steps from the seed-0 "
          f"port init): acc0={acc0:.4f} acc={acc:.4f}", flush=True)
    check(acc >= acc0 + 0.05, f"learnability: {acc0} -> {acc}, want +0.05")


def kernels_line(results: dict) -> dict:
    """The kernels' JSON line. Times: block_sparse_dw summed over the 7 leaf
    shapes of one trainable LM layer, fused_block_opt over the 7 leaves of
    the K trainable layers; block_act_prune over the 35 activations of one
    full-width CNN forward at batch 32, block_act_prune_bwd over the 5 that
    one dynamic-method step differentiates. Launches: the LM path's run
    (6 steps) and the CNN path's run (12 steps of `dynamic`)."""
    dtypes = {"block_sparse_dw": "bfloat16"}
    rows = []
    for name, (route, source, replaces, _) in SOURCES.items():
        s = results[name]
        b_ms, b_by = bound_ms(s["flops"], s["bytes"],
                              dtypes.get(name, "float32"))
        rows.append({
            "name": name, "route": route, "source": source,
            "replaces": replaces, "launches": results["launches"][name],
            "max_abs_err": s["max_abs_err"], "ms": s["ms"],
            "plain_ms": s["plain_ms"], "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": s["library_ms"] if name == "block_sparse_dw"
            else None,
        })
    return {"kernels": rows}


def main() -> int:
    if not torch.cuda.is_available():
        print("[chip_smoke] FAIL: torch.cuda.is_available() is false",
              flush=True)
        return 1
    if not (SRC / "repro_torch").is_dir():
        print(f"[chip_smoke] FAIL: the port's package is missing under {SRC}",
              flush=True)
        return 1
    sys.path.insert(0, str(SRC))

    t0 = time.perf_counter()
    results: dict = {"launches": {}}
    phase_environment()
    phase_build()
    phase_kernels(results)
    print(f"[chip_smoke] kernels checked at {time.perf_counter() - t0:.0f} s",
          flush=True)
    tc, out = phase_main_path(results)
    print(f"[chip_smoke] LM path done at {time.perf_counter() - t0:.0f} s",
          flush=True)
    phase_profile(tc, out)
    del out
    torch.cuda.empty_cache()
    phase_compact_vs_dense()
    torch.cuda.empty_cache()
    print(f"[chip_smoke] LM phases done at {time.perf_counter() - t0:.0f} s",
          flush=True)
    init = phase_cnn(results)
    print(f"[chip_smoke] CNN path done at {time.perf_counter() - t0:.0f} s",
          flush=True)
    phase_cnn_profile(init)
    del init
    torch.cuda.empty_cache()
    phase_table2()
    print(f"[chip_smoke] all phases passed in {time.perf_counter() - t0:.0f} s",
          flush=True)
    print(json.dumps(kernels_line(results)), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

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
   120 transfer steps, five methods) and the learnability check;
10. the MoE path: the compact train step on full-width deepseek-moe-16b
   (all 28 layers, bf16, 64 routed experts top-6 plus 2 shared), batch
   4 x seq 1024, AdamW, 6 steps across the fixed / dynamic / fixed phases,
   through `repro_torch.launch.train`, counts zeroed just before and read
   just after: exactly K x 7 block_sparse_dw, K x 3 batched_dw and 10
   fused_block_opt launches a step; the expert leaves' unselected blocks
   bitwise their init through the first fixed phase; the share of routed
   choices the capacity dropped;
11. one more MoE step under torch.profiler, then the frozen params (the
   dense first layer and the 25 frozen MoE layers) bitwise against a fresh
   init from the same seed;
12. MoE compact against dense-scatter on the card: SGD, 2 fixed-phase
   steps at full width cut to 4 layers, trainable params bitwise equal;
13. the serving path: full-width llama3-8b (32 layers, bf16) through
   `repro_torch.launch.serve`'s `build_engine`, 4 slots, pages of 16, 8
   requests of 128 + 32 tokens, greedy, twice on one copy of the weights,
   counts zeroed just before each run and read just after. Run A plain:
   8/8 completed, no wave kernel launched. Run B with 2 users and online
   waves (K = 2, r = 0.25, block 8, sgd 0.05, 16 tokens): 8/8 completed,
   its first 4 requests bitwise run A's, exactly 7 block_scatter_update,
   14 block_sparse_dw and 7 fused_block_opt launches a wave, the served
   base bitwise unchanged, every user's delta nonzero; and, for one
   request, the largest logit difference between the paged and the
   contiguous path;
14. one decode step of run B under torch.profiler, beside its byte bound;
15. oracle parity at full widths cut to 4 layers, f32: the engine's greedy
   tokens against the contiguous prefill + decode_step oracle, plain and,
   after one wave, personalized (the delta dense-scattered into the
   oracle's params), with every step's top-2 logit gap probed.

Phase 3 also holds the expert-batched dW (`batched_dw`) against its plain
version at the three expert leaf shapes of the MoE path (64 experts,
capacity 481), and the block scatter-update bitwise against its plain
version at the online wave's 7 leaf shapes of full-width llama3-8b and at
an fp32, a lead-dim and an unaligned case.

The last lines are one JSON object with every kernel's numbers, and then
`{"ok": true, "device": {...}}`.
"""
from __future__ import annotations

import dataclasses
import gc
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
MOE_ARGV = ["--arch", "deepseek-moe-16b"] + MAIN_ARGV[2:]
MOE_J = 2                  # the first fixed phase of the MoE run
# launches a step of the MoE path: 4 attention and 3 shared-expert dW per
# trainable layer, 3 expert dW per layer, one optimizer launch per
# selectable stacked leaf (the router takes the plain optimizer)
MOE_PER_STEP = {"block_sparse_dw": K_LAYERS * 7, "batched_dw": K_LAYERS * 3,
                "fused_block_opt": 10}
C_LONG = 8192              # the batched dW at a long capacity
SERVE_RATIO = 0.25         # the serving launcher's per-user update ratio
# name -> (route, source, the TPU kernel it replaces, the path that launches
# it). block_sparse_dw also replaces block_sparse_dw_pipelined_kernel
# (masked_dw.py:131) with its pipelined instance, which the wrapper picks
# wherever the shape is aligned; batched_dw, the same source's expert entry
# point, likewise replaces batched_dw_pipelined_kernel (batched_dw.py:130).
# block_act_prune_bwd is the same kernel's backward entry point (the
# reference differentiates its jnp version).
SOURCES = {
    "block_sparse_dw": ("cuda",
                        "src/repro_torch/kernels/csrc/block_sparse_dw.cu",
                        "src/repro/kernels/masked_dw.py:65", "lm"),
    "batched_dw": ("cuda",
                   "src/repro_torch/kernels/csrc/block_sparse_dw.cu",
                   "src/repro/kernels/batched_dw.py:60", "moe"),
    "fused_block_opt": ("cuda",
                        "src/repro_torch/kernels/csrc/fused_block_opt.cu",
                        "src/repro/kernels/fused_block_opt.py:88", "lm"),
    "block_act_prune": ("cuda",
                        "src/repro_torch/kernels/csrc/block_act_prune.cu",
                        "src/repro/kernels/block_act_prune.py:26", "cnn"),
    "block_act_prune_bwd": ("cuda",
                            "src/repro_torch/kernels/csrc/block_act_prune.cu",
                            "src/repro/kernels/block_act_prune.py:26", "cnn"),
    "block_scatter_update": (
        "cuda", "src/repro_torch/kernels/csrc/block_scatter_update.cu",
        "src/repro/kernels/scatter_blocks.py:42", "serve"),
}
# kernels with a one-call PyTorch yardstick (library_ms)
LIBRARY = ("block_sparse_dw", "batched_dw", "block_scatter_update")
# the port's kernels as the profiler names them
PORT_KERNELS = ("batched_dw_grid_kernel", "batched_dw_pipelined_kernel",
                "dw_grid_kernel", "dw_pipelined_kernel",
                "fused_block_opt_kernel", "prune_kernel",
                "scatter_vec_kernel", "scatter_scalar_kernel")
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
    """Bool mask of the selected column blocks of a stacked leaf [K, ...,
    N]. Built with the plain scatter (`kref.scatter_blocks3`), never the
    port's `scatter_param_blocks`, whose kernel takes no int8 and would
    count launches inside the paths' launch windows."""
    from repro_torch.kernels import ref as kref
    k, n = leaf.shape[0], leaf.shape[-1]
    zeros = torch.zeros((k, leaf[0].numel() // n, n), dtype=torch.int8,
                        device=leaf.device)
    ones = torch.ones(zeros.shape[:2] + (spec.n_shards, spec.n_sel,
                                         spec.block),
                      dtype=torch.int8, device=leaf.device)
    return kref.scatter_blocks3(zeros, ones, idx, spec.block).reshape(
        leaf.shape).bool()


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

def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()


def phase_environment():
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    print(card_line(), flush=True)
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


def _moe_leaves():
    """(experts, capacity, {leaf: (fan_in, out, SelSpec)}) of the routed
    experts of one trainable deepseek-moe-16b layer, as the MoE path's plan
    and its batch of M_TOKENS tokens give them."""
    from repro_torch.configs import SparseUpdateConfig, get_config
    from repro_torch.core.selection import build_plan
    from repro_torch.models import moe
    from repro_torch.models.registry import abstract_params
    cfg = get_config("deepseek-moe-16b")
    plan = build_plan(cfg, SparseUpdateConfig(update_ratio=0.2,
                                              num_update_layers=K_LAYERS,
                                              channel_block=128))
    shapes = abstract_params(cfg)["segments"]["blocks"]["moe"]
    leaves = {name: tuple(shapes[name].shape[2:])
              + (plan.spec["blocks"]["moe"][name],)
              for name in ("w_gate", "w_up", "w_down")}
    mc = cfg.moe
    return (mc.num_experts,
            moe._capacity(M_TOKENS, mc.top_k, mc.capacity_factor,
                          mc.num_experts), leaves)


def _batched_case(e, c, fan_in, out, spec, dtype, gen, offset: int = 0):
    """x [e, c, fan_in], dy [e, c, out] and a selection; `offset` elements
    into their buffers (1 puts the base pointers off 16-byte alignment)."""
    def rand(*shape):
        n = int(torch.tensor(shape).prod())
        buf = torch.randn(n + offset, generator=gen, device="cuda").to(dtype)
        return buf[offset:].view(shape)
    return (rand(e, c, fan_in), rand(e, c, out),
            _rand_idx((spec.n_shards,), spec, gen))


def _check_batched(tag, x, dy, idx, spec, instances, reps=10):
    """Each instance against the plain version (fp32 sums over C in another
    order: 1e-4 of the largest output); returns {instance: (ms, err)}."""
    from repro_torch.kernels import ops, ref
    want = ref.batched_dw_ref(x, dy, idx, spec.block)
    tol = 1e-4 * float(want.abs().max())
    res = {}
    for pipe in instances:
        got = ops.block_sparse_dw_batched(x, dy, idx, spec, pipelined=pipe)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        inst = "pipelined" if pipe else "grid"
        check(got.shape == want.shape and err <= tol,
              f"batched_dw {inst} {tag}: max_abs_err {err} > {tol}")
        res[inst] = (cuda_ms(lambda: ops.block_sparse_dw_batched(
            x, dy, idx, spec, pipelined=pipe), reps=reps), err, tol)
    return res


def check_batched_dw(gen, sums: dict):
    """The expert-batched dW at the three expert leaf shapes of the MoE path
    (E = 64, capacity 481, bf16, both instances), one fp32 case, one with
    its base pointers off alignment (the wrapper takes the grid instance
    and refuses the pipelined one), one at a long capacity, and the
    dense-scatter form's dW, exactly zero outside the selected blocks. The
    main path's instance, in bf16, goes into the sums."""
    from repro_torch.core.sparse_update import gather_param_blocks, smm
    from repro_torch.kernels import ops, ref
    e, c, leaves = _moe_leaves()
    cases = [(leaf, torch.bfloat16) for leaf in leaves] + \
        [("w_gate", torch.float32)]
    for leaf, dtype in cases:
        fan_in, out, spec = leaves[leaf]
        x, dy, idx = _batched_case(e, c, fan_in, out, spec, dtype, gen)
        main_pipe = ops.use_pipelined(x, dy, spec.block)
        dy_sel = ref.gather_dy_blocks(dy.reshape(e * c, out), idx,
                                      spec.block).reshape(e, c, -1)
        dy_sel = dy_sel.contiguous()
        lib = cuda_ms(lambda: torch.bmm(x.transpose(1, 2), dy_sel))
        plain = cuda_ms(lambda: ref.batched_dw_ref(x, dy, idx, spec.block))
        cols = spec.n_shards * spec.n_sel * spec.block
        flops = 2.0 * e * c * fan_in * cols
        # x once, the selected dy columns once, idx, the fp32 output
        nbytes = e * c * (fan_in + cols) * x.element_size() \
            + idx.numel() * 4 + e * fan_in * cols * 4
        b_ms, b_by = bound_ms(flops, nbytes, _dname(dtype))
        res = _check_batched(f"{leaf} {_dname(dtype)}", x, dy, idx, spec,
                             (False, True))
        for inst, (ms, err, tol) in res.items():
            main = (inst == "pipelined") == main_pipe
            print(f"[kernel] batched_dw {inst} {leaf} {_dname(dtype)} E={e} "
                  f"C={c} K={fan_in} N={out} n_sel={spec.n_sel} "
                  f"block={spec.block} main_path={main} kernel_ms={ms:.4f} "
                  f"plain_ms={plain:.4f} library_ms={lib:.4f} "
                  f"bound_ms={b_ms:.4f} ({b_by}) max_abs_err={err:.3e} "
                  f"tol={tol:.3e}", flush=True)
            if dtype == torch.bfloat16 and main:
                for key, val in (("ms", ms), ("plain_ms", plain),
                                 ("library_ms", lib), ("flops", flops),
                                 ("bytes", nbytes)):
                    sums[key] += val
                sums["max_abs_err"] = max(sums["max_abs_err"], err)
        del x, dy, dy_sel

    fan_in, out, spec = leaves["w_gate"]
    x, dy, idx = _batched_case(e, c, fan_in, out, spec, torch.bfloat16, gen,
                               offset=1)
    check(not ops.use_pipelined(x, dy, spec.block),
          "batched_dw: a misaligned base pointer must take the grid instance")
    try:
        ops.block_sparse_dw_batched(x, dy, idx, spec, pipelined=True)
    except ValueError:
        pass
    else:
        raise SmokeError("batched_dw: the pipelined instance took a "
                         "misaligned pointer")
    (ms, err, tol), = _check_batched("w_gate misaligned", x, dy, idx, spec,
                                     (None,)).values()
    print(f"[kernel] batched_dw grid (picked: base pointers off alignment) "
          f"w_gate bfloat16 E={e} C={c} kernel_ms={ms:.4f} "
          f"max_abs_err={err:.3e} tol={tol:.3e}", flush=True)
    del x, dy

    x, dy, idx = _batched_case(8, C_LONG, fan_in, out, spec, torch.bfloat16,
                               gen)
    for inst, (ms, err, tol) in _check_batched(
            f"w_gate C={C_LONG}", x, dy, idx, spec, (True, False),
            reps=3).items():
        print(f"[kernel] batched_dw {inst} w_gate bfloat16 E=8 C={C_LONG} "
              f"K={fan_in} N={out} kernel_ms={ms:.4f} max_abs_err={err:.3e} "
              f"tol={tol:.3e}", flush=True)
    del x, dy

    # the dense-scatter form: its weight gradient is the compact dW in the
    # selected blocks and exactly zero everywhere else
    x, dy, idx = _batched_case(e, c, fan_in, out, spec, torch.bfloat16, gen)
    w = (torch.randn(e, fan_in, out, generator=gen, device="cuda") * 0.02) \
        .to(torch.bfloat16).requires_grad_(True)
    smm(x, w, ({"w": idx}, {"w": spec}), "w").backward(dy)
    mask = _selected_mask(w.detach()[None], idx[None], spec)[0]
    compact = ops.block_sparse_dw_batched(x, dy, idx, spec).to(torch.bfloat16)
    check(bool((w.grad[~mask] == 0).all()),
          "batched dense-scatter: a deselected block of dW is not zero")
    check(torch.equal(gather_param_blocks(w.grad[None], idx[None], spec)[0],
                      compact),
          "batched dense-scatter: the selected blocks are not the compact dW")
    print(f"[kernel] batched_dw dense-scatter form w_gate E={e} C={c}: "
          f"deselected blocks exactly zero, selected blocks the compact dW",
          flush=True)
    del x, dy, w, mask, compact


def cuda_ms_flushed(fn, flush, reps: int = 10, warmup: int = 2) -> float:
    """CUDA events around each call alone, `flush` (larger than the 50 MB
    L2) zeroed before it, so the call reads its inputs from device memory;
    the mean over `reps` calls."""
    for _ in range(warmup):
        fn()
    total = 0.0
    pairs = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    for start, end in pairs:
        total += start.elapsed_time(end)
    return total / reps


def _wave_leaves() -> dict:
    """{leaf: (fan_in, out, SelSpec)} of the online wave on full-width
    llama3-8b: the reference launcher's personalization defaults (K = 2,
    r = 0.25, channel block 8)."""
    from repro_torch.configs import SparseUpdateConfig, get_config
    from repro_torch.core.selection import build_plan
    from repro_torch.models.registry import abstract_params
    cfg = get_config("llama3-8b")
    plan = build_plan(cfg, SparseUpdateConfig(update_ratio=SERVE_RATIO,
                                              num_update_layers=K_LAYERS,
                                              channel_block=8))
    shapes = abstract_params(cfg)["segments"]["blocks"]
    return {name: tuple(shapes[group][name].shape[1:]) + (spec,)
            for group in ("attn", "mlp")
            for name, spec in plan.spec["blocks"][group].items()}


def _scatter_case(tag, w, upd, idx, spec, flush, timed=False):
    """The kernel against its plain version on one input: bitwise equal,
    every unselected element's bits unchanged. Returns (ms, plain_ms,
    library_ms, bytes) when `timed`."""
    from repro_torch.kernels import ops, ref
    k, n = w.shape[0], w.shape[-1]
    r = w[0].numel() // n
    w3, u5 = w.view(k, r, n), upd.view(k, r, spec.n_shards, spec.n_sel,
                                       spec.block)
    want = ref.block_scatter_update_ref(w3, u5, idx, spec.block)
    got = w.clone()
    ops.block_scatter_update(got, upd, idx, spec)
    torch.cuda.synchronize()
    ib = torch.int16 if w.dtype == torch.bfloat16 else torch.int32
    check(torch.equal(got.view(k, r, n).view(ib), want.view(ib)),
          f"block_scatter_update {tag}: not bitwise equal to the plain "
          f"version")
    mask = _selected_mask(w3, idx, spec)
    check(torch.equal(got.view(k, r, n).view(ib)[~mask], w3.view(ib)[~mask]),
          f"block_scatter_update {tag}: an unselected element changed")
    line = (f"[kernel] block_scatter_update {tag} w={tuple(w.shape)} "
            f"{_dname(w.dtype)} upd={_dname(upd.dtype)} n_sel={spec.n_sel} "
            f"block={spec.block} bitwise=True unselected_unchanged=True")
    if not timed:
        print(line, flush=True)
        return None
    ms = cuda_ms_flushed(lambda: ops.block_scatter_update(got, upd, idx,
                                                          spec), flush)
    plain = cuda_ms_flushed(lambda: ref.block_scatter_update_ref(
        w3, u5, idx, spec.block), flush)
    # the library call: one Tensor.scatter_ on the blocked view, the upd
    # already cast to w's type and its index already built
    blocked = got.view(k, r, spec.n_shards * spec.n_blocks, spec.block)
    u_cast = u5.to(w.dtype).reshape(k, r, -1, spec.block)
    offs = (torch.arange(spec.n_shards, device=idx.device)
            * spec.n_blocks)[None, :, None]
    index = (idx.long() + offs).reshape(k, 1, -1, 1).expand(
        k, r, spec.n_shards * spec.n_sel, spec.block).contiguous()
    lib = cuda_ms_flushed(lambda: blocked.scatter_(2, index, u_cast), flush)
    # upd read once, the selected elements of w written once, idx read
    nbytes = upd.numel() * (upd.element_size() + w.element_size()) \
        + idx.numel() * 4
    b_ms, _ = bound_ms(0.0, nbytes, "float32")
    print(f"{line} kernel_ms={ms:.4f} plain_ms={plain:.4f} "
          f"library_ms={lib:.4f} bound_ms={b_ms:.4f} (bytes)", flush=True)
    return ms, plain, lib, nbytes


def check_scatter(gen, sums: dict):
    """The block scatter-update at the 7 wave leaf shapes of full-width
    llama3-8b (w [2, d_in, N] bf16, upd fp32, block 8, r = 0.25), timed into
    the sums; then an fp32 case, a lead-dim case [K, E, d, N] and an
    unaligned case (block 5) that takes the scalar loop."""
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    for leaf, (fan_in, out, spec) in _wave_leaves().items():
        w = (torch.randn(K_LAYERS, fan_in, out, generator=gen, device="cuda")
             * 0.02).to(torch.bfloat16)
        upd = torch.randn(K_LAYERS, fan_in, spec.n_shards, spec.n_sel,
                          spec.block, generator=gen, device="cuda") * 0.02
        idx = _rand_idx((K_LAYERS, spec.n_shards), spec, gen)
        ms, plain, lib, nbytes = _scatter_case(leaf, w, upd, idx, spec,
                                               flush, timed=True)
        for key, val in (("ms", ms), ("plain_ms", plain),
                         ("library_ms", lib), ("bytes", nbytes)):
            sums[key] += val
        del w, upd, idx
    from repro_torch.core.sparse_update import SelSpec
    cases = [("fp32 wk", (K_LAYERS, 4096, 1024), (1, 32, 8, 128),
              torch.float32),
             ("lead dims [K,E,d,N]", (K_LAYERS, 8, 512, 1408),
              (1, 44, 8, 176), torch.bfloat16),
             ("unaligned block 5", (K_LAYERS, 333, 2 * 7 * 5),
              (2, 3, 5, 7), torch.bfloat16)]
    for tag, shape, (n_shards, n_sel, block, n_blocks), dtype in cases:
        spec = SelSpec(block=block, n_shards=n_shards, n_sel=n_sel,
                       n_blocks=n_blocks)
        w = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        upd = torch.randn(shape[:-1] + (n_shards, n_sel, block),
                          generator=gen, device="cuda")
        idx = _rand_idx((K_LAYERS, n_shards), spec, gen)
        _scatter_case(tag, w, upd, idx, spec, flush)
    del flush


def phase_kernels(results: dict):
    gen = torch.Generator(device="cuda").manual_seed(0)
    leaves = _main_path_leaves()
    results["block_sparse_dw"] = _new_sums()
    results["fused_block_opt"] = _new_sums()
    check_dw(leaves, gen, results["block_sparse_dw"])
    check_dw_long(leaves, gen)
    results["batched_dw"] = _new_sums()
    check_batched_dw(gen, results["batched_dw"])
    check_opt(leaves, gen, results["fused_block_opt"])
    results["block_act_prune"] = _new_sums()
    results["block_act_prune_bwd"] = _new_sums()
    check_prune(gen, results["block_act_prune"],
                results["block_act_prune_bwd"])
    check_prune_paths(gen)
    results["block_scatter_update"] = _new_sums()
    check_scatter(gen, results["block_scatter_update"])
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
        check(row["launches"]["batched_dw"] == 0,
              f"step {row['step']}: the expert dW ran on the LM path")
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
    # each row to the first port kernel name it holds (the batched dW's
    # names hold the dense dW's, so they come first in PORT_KERNELS)
    by_kernel = {}
    for us, key, _ in rows:
        name = next((k for k in PORT_KERNELS if k in key), None)
        if name is not None:
            by_kernel[name] = by_kernel.get(name, 0.0) + us / 1e3
    ours = sum(by_kernel.values())
    print(f"[profile] {tag}: wall_ms={wall_ms:.1f} "
          f"device_busy_ms={busy_ms:.1f} "
          f"idle_share={max(0.0, 1 - busy_ms / wall_ms):.3f} "
          f"port_kernels_ms={ours:.2f} port_kernels_share="
          f"{ours / busy_ms:.4f} by_kernel_ms="
          f"{ {k: round(v, 3) for k, v in by_kernel.items()} } "
          f"by_kernel_share="
          f"{ {k: round(v / busy_ms, 4) for k, v in by_kernel.items()} }",
          flush=True)
    for us, key, count in rows[:15]:
        print(f"[profile] {us / 1e3:9.2f} ms {100 * us / 1e3 / busy_ms:5.1f}% "
              f"x{count:<5d} {key[:90]}", flush=True)


def phase_profile(tc, out, tag: str = "one fixed-phase step"):
    """One more step of a run's state (the late fixed phase) under
    torch.profiler."""
    from repro_torch.data import lm_batches
    from repro_torch.train import make_train_step

    step_fn = make_train_step(tc, out["plan"])
    batch = next(lm_batches(tc.shape.global_batch, tc.shape.seq_len,
                            tc.model.vocab_size, seed=tc.seed, start_step=6))
    batch = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
    profile_step(tag, lambda: step_fn(out["state"], batch))


def phase_compact_vs_dense(cfg, tag: str = "compact-vs-dense"):
    """`cfg` from seed 1, K trainable layers: 2 fixed-phase SGD steps of
    the compact path and of the dense-scatter path from one start; losses
    and every trainable leaf bitwise equal."""
    from repro_torch.configs import (OptimizerConfig, ShapeConfig,
                                     SparseUpdateConfig, TrainConfig)
    from repro_torch.core.sparse_update import tree_leaves, tree_map
    from repro_torch.data import lm_batches
    from repro_torch.train import make_train_state, make_train_step

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
        print(f"[{tag}] step {i + 1} loss compact="
              f"{float(m_c['loss']):.6f} dense_scatter="
              f"{float(m_d['loss']):.6f}", flush=True)
        check(float(m_c["loss"]) == float(m_d["loss"]),
              f"{tag} step {i + 1}: losses differ")
    a = tree_leaves(state_c["params_trainable"])
    b = tree_leaves(state_d["params_trainable"])
    unequal = sum(not torch.equal(x, y) for x, y in zip(a, b))
    check(unequal == 0, f"{tag}: {unequal} of {len(a)} trainable leaves "
                        f"differ")
    print(f"[{tag}] {cfg.name} {cfg.num_layers} layers, sgd, 2 fixed-phase "
          f"steps: all {len(a)} trainable leaves bitwise equal", flush=True)


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
        check(delta["block_sparse_dw"] == delta["fused_block_opt"]
              == delta["batched_dw"] == 0,
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


EXPERT_LEAVES = ("w_gate", "w_up", "w_down")


def phase_moe_path(results: dict):
    """The MoE path: 6 compact AdamW steps of full-width deepseek-moe-16b
    through the launcher, counts zeroed just before and read just after."""
    from repro_torch.core.selection import build_plan, selected_fraction
    from repro_torch.kernels import ops
    from repro_torch.launch import train

    args = train.build_argparser().parse_args(MOE_ARGV)
    tc = train.train_config(args)
    cfg = tc.model
    plan = build_plan(cfg, tc.sparse,
                      tc.shape.global_batch * tc.shape.seq_len)
    print(f"[moe] deepseek-moe-16b full width, {cfg.num_layers} layers (no "
          f"depth cut), {cfg.moe.num_experts} routed experts top-"
          f"{cfg.moe.top_k} + {cfg.moe.num_shared_experts} shared, "
          f"{cfg.dtype}, batch {args.batch} x seq {args.seq}, "
          f"{args.optimizer}, trainable {plan.seg_trainable}, selected share "
          f"of params per step {selected_fraction(plan, cfg):.6f}",
          flush=True)
    per_step = []
    last = {"counts": {k: 0 for k in ops.LAUNCHES}}
    snap = {}

    def on_step(step, state, metrics):
        counts = ops.launch_counts()
        delta = {k: counts[k] - last["counts"][k] for k in counts}
        last["counts"] = counts
        if step == MOE_J:
            # the expert leaves at the end of the first fixed phase, with
            # its selection: held against the init after the run
            moe = state["params_trainable"]["segments"]["blocks"]["moe"]
            idx = state["sel_idx"]["blocks"]["moe"]
            snap.update({n: (moe[n].clone(), idx[n].clone())
                         for n in EXPERT_LEAVES})
        row = {"step": step, "loss": float(metrics["loss"]),
               "load_balance": float(metrics["load_balance"]),
               "router_z": float(metrics["router_z"]),
               "step_ms": metrics["step_ms"],
               "max_memory_allocated": torch.cuda.max_memory_allocated(),
               "launches": delta}
        per_step.append(row)
        print(f"[moe] step {step} loss={row['loss']:.6f} "
              f"load_balance={row['load_balance']:.4f} "
              f"router_z={row['router_z']:.4f} step_ms={row['step_ms']:.1f} "
              f"max_memory_allocated={row['max_memory_allocated']} "
              f"launches={delta}", flush=True)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    out = train.main(MOE_ARGV, on_step=on_step)
    totals = ops.launch_counts()

    check(len(per_step) == 6, f"ran {len(per_step)} MoE steps, want 6")
    for row in per_step:
        for name, n in MOE_PER_STEP.items():
            check(row["launches"][name] == n,
                  f"MoE step {row['step']}: {row['launches'][name]} {name} "
                  f"launches, want {n}")
        check(bool(torch.isfinite(torch.tensor(row["loss"]))),
              f"MoE step {row['step']}: loss {row['loss']} is not finite")
    for name, n in MOE_PER_STEP.items():
        check(totals[name] == 6 * n, f"MoE run: {totals[name]} {name} "
                                     f"launches, want 6 x {n}")
    results["launches"]["batched_dw"] = totals["batched_dw"]

    # the share of routed choices the capacity dropped, over every MoE
    # layer of one forward of the trained model on the next batch
    from repro_torch.data import lm_batches
    from repro_torch.models import moe as MOE
    from repro_torch.models import transformer as T
    state = out["state"]
    batch = next(lm_batches(args.batch, args.seq, cfg.vocab_size,
                            seed=args.seed, start_step=6))
    batch = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
    with torch.no_grad(), MOE.record_routing() as routed:
        T.forward(cfg, (state["params_frozen"], state["params_trainable"]),
                  batch)
    dropped = [float(d) / n for d, n in routed]
    steady = [r["step_ms"] for r in per_step[1:]]
    print(f"[moe] launches over 6 steps: {totals}; batched_dw by instance: "
          f"{dict(ops.BATCHED_DW_INSTANCES)}", flush=True)
    print(f"[moe] step_ms steps 2-6: {[round(t, 1) for t in steady]} "
          f"median={statistics.median(steady):.1f} tokens_per_s="
          f"{M_TOKENS / statistics.median(steady) * 1e3:.0f} step1_ms="
          f"{per_step[0]['step_ms']:.1f} peak_bytes="
          f"{torch.cuda.max_memory_allocated()} selected_fraction="
          f"{selected_fraction(plan, cfg):.6f} dropped_share="
          f"{sum(dropped) / len(dropped):.4f} (per MoE layer min "
          f"{min(dropped):.4f} max {max(dropped):.4f}, {len(dropped)} "
          f"layers)", flush=True)
    return tc, out, snap


def phase_moe_frozen(tc, out, snap):
    """After the run: the frozen params (embedding, head, final norm, the
    dense first layer, the 25 frozen MoE layers) bitwise equal to a fresh
    init from the run's seed, and every expert leaf's unselected blocks at
    the end of the first fixed phase bitwise their init, its selected
    blocks moved. The optimizer state goes first: the run's params and a
    fresh init fit the card together (2 x 32.8 GB)."""
    from repro_torch.core.sparse_update import tree_leaves
    from repro_torch.models import transformer as T
    from repro_torch.train import split_params

    state, plan = out["state"], out["plan"]
    state["opt"] = None
    torch.cuda.empty_cache()
    init = T.init_params(tc.model, tc.seed, "cuda")
    frozen0, trainable0 = split_params(init, plan)
    a, b = tree_leaves(frozen0), tree_leaves(state["params_frozen"])
    check(len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b)),
          "MoE: a frozen param changed")
    check("first" in state["params_frozen"]["segments"]
          and "first" not in state["params_trainable"]["segments"],
          "MoE: the dense first layer is not frozen")
    moe0 = trainable0["segments"]["blocks"]["moe"]
    for name, (w, idx) in snap.items():
        spec = plan.spec["blocks"]["moe"][name]
        mask = _selected_mask(moe0[name], idx, spec)
        check(torch.equal(w[~mask], moe0[name][~mask]),
              f"MoE: an unselected block of {name} changed in the first "
              f"fixed phase")
        check(not torch.equal(w[mask], moe0[name][mask]),
              f"MoE: the selected blocks of {name} did not move")
    print(f"[moe] frozen params bitwise equal to a fresh init ({len(a)} "
          f"leaves: embedding, head, final norm, the dense first layer, "
          f"{tc.model.num_layers - 1 - K_LAYERS} frozen MoE layers); every "
          f"expert leaf's unselected blocks bitwise their init through the "
          f"first fixed phase ({MOE_J} steps)", flush=True)


# the serving path: full-width llama3-8b, 4 slots, pages of 16 tokens, 8
# requests of 128 prompt + 32 new tokens (max_len 160, 40 pages), greedy;
# run B adds 2 users with the reference launcher's personalization defaults
SERVE_ARGV = ["--arch", "llama3-8b", "--requests", "8", "--batch", "4",
              "--prompt-len", "128", "--gen-len", "32", "--page-size", "16",
              "--prefix-mode", "off", "--seed", "0"]
WAVE_LAUNCHES = {"block_scatter_update": 7, "block_sparse_dw": K_LAYERS * 7,
                 "fused_block_opt": 7}
COVERED = {"attn": ("wq", "wk", "wv", "wo"),
           "mlp": ("w_gate", "w_up", "w_down")}


def _serve_summary(tag, stats):
    steps = [t * 1e3 for t in stats.decode_step_s]
    waves = stats.train_waves
    print(f"[{tag}] {stats.requests_completed}/{len(stats.results)} "
          f"completed, {stats.requests_cancelled} cancelled, "
          f"{stats.tokens_out} tokens, wall_s={stats.wall_s:.3f} "
          f"prefill_tok_per_s={stats.prefill_tok_per_s:.1f} "
          f"decode_tok_per_s={stats.decode_tok_per_s:.1f} "
          f"decode_steps={len(steps)} decode_step_ms_median="
          f"{statistics.median(steps):.3f} (min {min(steps):.3f}, max "
          f"{max(steps):.3f}) prefill_chunks={stats.prefill_chunks} "
          f"train_waves={waves} ms_per_wave="
          f"{stats.train_wave_s * 1e3 / max(1, waves):.3f} "
          f"delta_resident_bytes={stats.delta_resident_bytes} "
          f"max_memory_allocated={torch.cuda.max_memory_allocated()} "
          f"pages_peak={stats.pages_peak}/{stats.pages_total}", flush=True)


def _forced_oracle(cfg, params, toks, forced, max_len):
    """Contiguous prefill + decode_step fed the given tokens: the logits at
    every step, [len(forced), V] fp32."""
    from repro_torch.models import decoding as D
    logits, cache = D.prefill(cfg, params,
                              {"tokens": torch.as_tensor(toks).cuda()[None]},
                              pad_to=max_len)
    out = [logits[0]]
    for i, t in enumerate(range(len(toks), len(toks) + len(forced) - 1)):
        logits, cache = D.decode_step(
            cfg, params,
            {"tokens": torch.tensor([[forced[i]]], device="cuda"),
             "positions": torch.full((1, 1), t, device="cuda")}, cache)
        out.append(logits[0])
    return torch.stack(out)


def _record_logits(engine):
    """Keep every sampled step's logits rows (on the card)."""
    seen, sample = [], engine._sample

    def rec(logits):
        seen.append(logits.detach().clone())
        return sample(logits)
    engine._sample = rec
    return seen


def phase_serve(results: dict):
    """Paged serving of full-width llama3-8b through the serve launcher's
    `build_engine`, twice on one copy of the weights. Run A: plain. Run B:
    2 users, online waves; counts zeroed just before each run and read just
    after."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    ap = serve.add_serve_args(__import__("argparse").ArgumentParser())
    args_a = ap.parse_args(SERVE_ARGV + ["--users", "0"])
    cfg, eng_a = serve.build_engine(args_a)
    params = eng_a.params
    n_param_bytes = sum(t.numel() * t.element_size()
                        for t in _leaves(params))
    print(f"[serve] llama3-8b full width, {cfg.num_layers} layers (no depth "
          f"cut), {cfg.dtype}, params {n_param_bytes} bytes, 4 slots, page "
          f"16, prefix_mode off, greedy, 8 requests x (128 prompt + 32 new)",
          flush=True)

    # one request, paged against contiguous at full width in bf16: report
    # the largest logit difference (teacher-forced on the served tokens)
    reqs = serve.build_requests(args_a, cfg)
    seen = _record_logits(eng_a)
    one = eng_a.run([reqs[0]])
    paged = torch.cat([row[:1] for row in seen])
    forced = one.results[0].tokens
    contig = _forced_oracle(cfg, params, reqs[0].tokens, forced,
                            args_a.prompt_len + args_a.gen_len)
    print(f"[serve] paged vs contiguous, one request, bf16: max |logit "
          f"diff| = {float((paged - contig).abs().max()):.6f} over "
          f"{len(forced)} steps (logits max |x| "
          f"{float(contig.abs().max()):.3f})", flush=True)
    del seen, paged, contig
    del eng_a._sample              # the engine's own sampling again

    reqs = serve.build_requests(args_a, cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    stats_a = eng_a.run(reqs)
    counts_a = ops.launch_counts()
    _serve_summary("serve A", stats_a)
    check(stats_a.requests_completed == 8 and stats_a.requests_cancelled == 0,
          f"run A: {stats_a.requests_completed} completed + "
          f"{stats_a.requests_cancelled} cancelled of 8")
    for name in WAVE_LAUNCHES:
        check(counts_a[name] == 0, f"run A (no users) launched {name} "
                                   f"{counts_a[name]} times")

    # the covered leaves of the K trainable layers, held against the
    # served base after the waves
    blocks = params["segments"]["blocks"]
    snap = {(g, n): blocks[g][n][-K_LAYERS:].clone()
            for g, names in COVERED.items() for n in names}
    args_b = ap.parse_args(SERVE_ARGV + ["--users", "2"])
    _, eng_b = serve.build_engine(args_b, cfg, params=params)
    del eng_a
    gc.collect()
    torch.cuda.empty_cache()
    reqs = serve.build_requests(args_b, cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    stats_b = eng_b.run(reqs)
    counts_b = ops.launch_counts()
    _serve_summary("serve B", stats_b)
    print(f"[serve B] launches {counts_b}; wave losses "
          f"{[(u, round(l, 4)) for u, l in stats_b.wave_losses]}",
          flush=True)
    check(stats_b.requests_completed + stats_b.requests_cancelled == 8
          and stats_b.requests_completed == 8,
          f"run B: {stats_b.requests_completed} completed + "
          f"{stats_b.requests_cancelled} cancelled of 8")
    check(stats_b.train_waves == 8, f"run B: {stats_b.train_waves} waves")
    for name, per_wave in WAVE_LAUNCHES.items():
        check(counts_b[name] == 8 * per_wave,
              f"run B: {counts_b[name]} {name} launches, want 8 x "
              f"{per_wave}")
    for rid in range(4):
        check(stats_b.results[rid].tokens == stats_a.results[rid].tokens,
              f"run B request {rid} (admitted before any wave) differs "
              f"from run A: zero delta rows are not a no-op")
    for (g, n), old in snap.items():
        check(torch.equal(blocks[g][n][-K_LAYERS:], old),
              f"the waves wrote the served base leaf {g}/{n}")
    for user in (0, 1):
        vals = _leaves(eng_b._deltas.peek(user).vals)
        check(all(bool(v.any()) for v in vals),
              f"user {user}: a leaf of the delta is still zero")
    check(all(torch.isfinite(torch.tensor(l)) for _, l in stats_b.wave_losses),
          "a wave loss is not finite")
    results["launches"]["block_scatter_update"] = \
        counts_b["block_scatter_update"]
    print("[serve] checks passed: 8/8 completed in both runs, run B's first "
          "4 requests bitwise run A's, base leaves bitwise unchanged, every "
          "user's delta nonzero, 8 waves of 7 / 14 / 7 launches, none in "
          "run A", flush=True)
    del snap
    return cfg, eng_b


def phase_serve_profile(cfg, eng):
    """One decode step of run B's engine (4 active slots at position 150,
    every page allocated, the delta rows of its last run) under
    torch.profiler, beside its byte bound: the weights it reads (all but
    the embedding table) plus the delta rows the gather-add reads plus the
    pages."""
    from repro_torch.models import decoding as D
    b, ps = eng.num_slots, eng.page_size
    pt = torch.arange(b * eng.max_pages, dtype=torch.int32,
                      device="cuda").view(b, eng.max_pages)
    batch = {"tokens": torch.ones((b, 1), dtype=torch.int32, device="cuda"),
             "start": torch.full((b,), 150, dtype=torch.int32, device="cuda"),
             "active": torch.ones((b,), dtype=torch.bool, device="cuda"),
             "length": torch.ones((b,), dtype=torch.int32, device="cuda")}
    step = lambda: D.paged_step(cfg, eng.params, batch, {}, eng._pools, pt,
                                page_size=ps, deltas=eng._dbatch)
    step()
    ms = statistics.median(
        [cuda_ms(step, reps=1, warmup=0) for _ in range(5)])
    emb = eng.params["embed"]["tok"]
    w_bytes = sum(t.numel() * t.element_size() for t in _leaves(eng.params)) \
        - emb.numel() * emb.element_size()
    d_bytes = sum(t.numel() * t.element_size() for t in _leaves(eng._dbatch))
    p_bytes = sum(t.numel() * t.element_size() for t in _leaves(eng._pools))
    bound = (w_bytes + d_bytes + p_bytes) / PEAK_BYTES * 1e3
    print(f"[serve profile] decode step (4 slots, run B's deltas): "
          f"{ms:.3f} ms (median of 5, synced); byte bound {bound:.3f} ms = "
          f"(weights {w_bytes} + delta rows {d_bytes} + pools {p_bytes} "
          f"bytes) / 3.35 TB/s; without the delta rows "
          f"{(w_bytes + p_bytes) / PEAK_BYTES * 1e3:.3f} ms", flush=True)
    profile_step("one decode step of run B", step)


def phase_serve_oracle():
    """Full llama3-8b widths cut to 4 layers, f32: the engine's greedy
    tokens against the contiguous prefill + decode_step oracle, plain and,
    after one wave, personalized (the oracle on params with the delta
    dense-scattered in); every sampled step's top-2 gap probed."""
    from repro_torch.configs import (OptimizerConfig, SparseUpdateConfig,
                                     get_config)
    from repro_torch.core.delta import apply_delta_tree
    from repro_torch.models import transformer as T
    from repro_torch.serve import (PersonalizationConfig, Request,
                                   ServeEngine)
    from repro_torch.train.steps import merge_params
    cfg = dataclasses.replace(get_config("llama3-8b"), num_layers=4,
                              dtype="float32")
    params = T.init_params(cfg, 0, "cuda")
    plen, gen, max_len = 40, 8, 48
    draw = torch.Generator().manual_seed(3)
    prompts = [torch.randint(0, cfg.vocab_size, (plen,), generator=draw,
                             dtype=torch.int32).numpy() for _ in range(3)]

    def greedy_oracle(p, toks):
        from repro_torch.models import decoding as D
        logits, cache = D.prefill(cfg, p, {"tokens": torch.as_tensor(
            toks).cuda()[None]}, pad_to=max_len)
        out = [int(logits.argmax(-1)[0])]
        for t in range(plen, plen + gen - 1):
            logits, cache = D.decode_step(
                cfg, p, {"tokens": torch.tensor([[out[-1]]], device="cuda"),
                         "positions": torch.full((1, 1), t, device="cuda")},
                cache)
            out.append(int(logits.argmax(-1)[0]))
        return out

    def min_gap(seen):
        top = torch.topk(torch.cat(seen).float(), 2, dim=-1).values
        return float((top[:, 0] - top[:, 1]).min())

    plain = ServeEngine(cfg, params, num_slots=2, max_len=max_len,
                        page_size=16)
    seen = _record_logits(plain)
    stats = plain.run([Request(i, gen, tokens=t)
                       for i, t in enumerate(prompts[:2])])
    gap = min_gap(seen)
    check(gap > 1e-4, f"oracle parity: a near-tie (top-2 gap {gap}) makes "
                      f"the token comparison unsound")
    for i in range(2):
        check(stats.results[i].tokens == greedy_oracle(params, prompts[i]),
              f"oracle parity: request {i} differs from the contiguous "
              f"oracle")
    del plain, seen
    p13n = PersonalizationConfig(
        sparse=SparseUpdateConfig(update_ratio=SERVE_RATIO,
                                  num_update_layers=K_LAYERS,
                                  channel_block=8),
        optimizer=OptimizerConfig(kind="sgd", learning_rate=0.05),
        train_tokens=16)
    eng = ServeEngine(cfg, params, num_slots=1, max_len=max_len,
                      page_size=16, personalization=p13n)
    seen = _record_logits(eng)
    r1 = eng.run([Request(0, gen, tokens=prompts[0], user=9)]).results[0]
    entry = eng._deltas.peek(9)
    trainable = dict(eng._trainable)
    trainable["segments"] = apply_delta_tree(
        eng._trainable["segments"],
        _tree_to(entry.vals, "cuda"), _tree_to(entry.idx, "cuda"),
        eng._plan.spec)
    pers = merge_params(eng._frozen, trainable)
    r2 = eng.run([Request(1, gen, tokens=prompts[2], user=9)]).results[1]
    gap = min_gap(seen)
    check(gap > 1e-4, f"personalized oracle parity: a near-tie (top-2 gap "
                      f"{gap})")
    check(r1.tokens == stats.results[0].tokens,
          "zero-delta personalized serving differs from the base model")
    check(r2.tokens == greedy_oracle(pers, prompts[2]),
          "personalized serving differs from the dense-scatter oracle")
    print(f"[serve oracle] llama3-8b widths cut to {cfg.num_layers} layers, "
          f"f32: engine == contiguous oracle for 2 requests ({plen} prompt + "
          f"{gen} new), zero-delta personalized == base, post-wave "
          f"personalized == dense-scatter oracle; min top-2 gap {gap:.3e}",
          flush=True)


def _leaves(tree) -> list:
    from repro_torch.core.sparse_update import tree_leaves
    return tree_leaves(tree)


def _tree_to(tree, device):
    from repro_torch.core.sparse_update import tree_map
    return tree_map(lambda a: a.to(device), tree)


def kernels_line(results: dict) -> dict:
    """The kernels' JSON line. Times: block_sparse_dw summed over the 7 leaf
    shapes of one trainable LM layer, fused_block_opt over the 7 leaves of
    the K trainable layers; block_act_prune over the 35 activations of one
    full-width CNN forward at batch 32, block_act_prune_bwd over the 5 that
    one dynamic-method step differentiates; batched_dw over the 3 expert
    leaf shapes of one trainable MoE layer. Launches: the LM path's run
    (6 steps), the MoE path's run (6 steps; batched_dw) and the CNN path's
    run (12 steps of `dynamic`)."""
    dtypes = {"block_sparse_dw": "bfloat16", "batched_dw": "bfloat16"}
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
            "library_ms": s["library_ms"] if name in LIBRARY else None,
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
    from repro_torch.configs import get_config

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
    phase_compact_vs_dense(get_config("llama3-8b"))
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[chip_smoke] LM phases done at {time.perf_counter() - t0:.0f} s;"
          f" {torch.cuda.memory_allocated()} bytes still allocated",
          flush=True)
    tc, out, snap = phase_moe_path(results)
    print(f"[chip_smoke] MoE path done at {time.perf_counter() - t0:.0f} s",
          flush=True)
    phase_profile(tc, out, "one fixed-phase MoE step")
    phase_moe_frozen(tc, out, snap)
    del out, snap
    gc.collect()
    torch.cuda.empty_cache()
    phase_compact_vs_dense(dataclasses.replace(
        get_config("deepseek-moe-16b"), num_layers=4),
        "moe-compact-vs-dense")
    torch.cuda.empty_cache()
    print(f"[chip_smoke] MoE phases done at {time.perf_counter() - t0:.0f} s",
          flush=True)
    init = phase_cnn(results)
    print(f"[chip_smoke] CNN path done at {time.perf_counter() - t0:.0f} s",
          flush=True)
    phase_cnn_profile(init)
    del init
    torch.cuda.empty_cache()
    phase_table2()
    print(f"[chip_smoke] CNN phases done at {time.perf_counter() - t0:.0f} s",
          flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    cfg, eng = phase_serve(results)
    print(f"[chip_smoke] serving runs done at {time.perf_counter() - t0:.0f}"
          f" s", flush=True)
    phase_serve_profile(cfg, eng)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    phase_serve_oracle()
    print(f"[chip_smoke] all phases passed in {time.perf_counter() - t0:.0f} s",
          flush=True)
    # again at the end, beside the numbers: a log cut to its tail keeps it
    print(card_line(), flush=True)
    print(json.dumps(kernels_line(results)), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

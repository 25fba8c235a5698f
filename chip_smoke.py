#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA H100 and check it end to end.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):

1. environment: torch version, the card's name and power limit, TF32 off;
2. build: nvcc builds every kernel of the port from `src/repro_torch/kernels/csrc`;
3. kernels against their plain versions at the main path's shapes
   (M = 4096 tokens, full llama3-8b widths), with their times, bounds and
   the library call's time;
4. the main path: the compact sparse-update train step on full-width
   llama3-8b (32 layers, bf16), batch 4 x seq 1024, AdamW, 6 steps across
   the fixed / dynamic / fixed phases, through `repro_torch.launch.train`;
   the kernels' launch counts are zeroed just before and read just after;
5. one more main-path step under torch.profiler: device time by op and the
   device's idle share;
6. compact against dense-scatter on the card: SGD, 2 fixed-phase steps,
   trainable params bitwise equal.

The last lines are one JSON object with every kernel's numbers, and then
`{"ok": true, "device": {...}}`.
"""
from __future__ import annotations

import json
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
# name -> (route, source, the TPU kernel it replaces). block_sparse_dw also
# replaces block_sparse_dw_pipelined_kernel (masked_dw.py:131) with its
# pipelined instance, which the wrapper picks wherever the shape is aligned.
SOURCES = {
    "block_sparse_dw": ("cuda",
                        "src/repro_torch/kernels/csrc/block_sparse_dw.cu",
                        "src/repro/kernels/masked_dw.py:65"),
    "fused_block_opt": ("cuda",
                        "src/repro_torch/kernels/csrc/fused_block_opt.cu",
                        "src/repro/kernels/fused_block_opt.py:88"),
}
# the port's kernels as the profiler names them
PORT_KERNELS = ("dw_grid_kernel", "dw_pipelined_kernel",
                "fused_block_opt_kernel")


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


def phase_kernels(results: dict):
    gen = torch.Generator(device="cuda").manual_seed(0)
    leaves = _main_path_leaves()
    results["block_sparse_dw"] = _new_sums()
    results["fused_block_opt"] = _new_sums()
    check_dw(leaves, gen, results["block_sparse_dw"])
    check_dw_long(leaves, gen)
    check_opt(leaves, gen, results["fused_block_opt"])
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
    for name in SOURCES:
        check(totals[name] > 0, f"{name} was never launched on the main path")
    results["launches"] = totals
    print(f"[main] launches over 6 steps: {totals}; block_sparse_dw by "
          f"instance: {dict(ops.DW_INSTANCES)}", flush=True)
    return tc, out


def phase_profile(tc, out):
    """One more main-path step (fixed phase) under torch.profiler: device
    time by op, the share of the step's wall time the device sits idle,
    and the port's kernels' share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data import lm_batches
    from repro_torch.train import make_train_step

    step_fn = make_train_step(tc, out["plan"])
    batch = next(lm_batches(tc.shape.global_batch, tc.shape.seq_len,
                            tc.model.vocab_size, seed=tc.seed, start_step=6))
    batch = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_fn(out["state"], batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    # kernel rows only: a CPU op's row repeats its kernels' device time
    rows = sorted(((dev_us(e), e.key, e.count) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and dev_us(e) > 0),
                  reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    check(busy_ms > 0, "the profiler saw no device time")
    ours = sum(r[0] for r in rows if any(
        k in r[1] for k in PORT_KERNELS)) / 1e3
    print(f"[profile] one fixed-phase step: wall_ms={wall_ms:.1f} "
          f"device_busy_ms={busy_ms:.1f} "
          f"idle_share={max(0.0, 1 - busy_ms / wall_ms):.3f} "
          f"port_kernels_ms={ours:.2f}", flush=True)
    for us, key, count in rows[:15]:
        print(f"[profile] {us / 1e3:9.2f} ms {100 * us / 1e3 / busy_ms:5.1f}% "
              f"x{count:<5d} {key[:90]}", flush=True)


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


def kernels_line(results: dict) -> dict:
    """The kernels' JSON line. Times are sums over the 7 leaf shapes of one
    trainable layer at the main path's shapes; launches are the main path's
    run (6 steps)."""
    rows = []
    for name, (route, source, replaces) in SOURCES.items():
        s = results[name]
        b_ms, b_by = bound_ms(s["flops"], s["bytes"], "bfloat16" if
                              name == "block_sparse_dw" else "float32")
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
    results: dict = {}
    phase_environment()
    phase_build()
    phase_kernels(results)
    print(f"[chip_smoke] kernels checked at {time.perf_counter() - t0:.0f} s",
          flush=True)
    tc, out = phase_main_path(results)
    print(f"[chip_smoke] main path done at {time.perf_counter() - t0:.0f} s",
          flush=True)
    phase_profile(tc, out)
    del out
    torch.cuda.empty_cache()
    phase_compact_vs_dense()
    print(f"[chip_smoke] all phases passed in {time.perf_counter() - t0:.0f} s",
          flush=True)
    print(json.dumps(kernels_line(results)), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

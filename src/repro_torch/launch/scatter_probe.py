"""Probe the block scatter-update kernel's design choices on the card.

    python -m repro_torch.launch.scatter_probe [--reps 20]

Builds, with nvcc into `build/scatter_probe/`, all started together:

- shipped: `kernels/csrc/block_scatter_update.cu` as it ships (the
  column-order walk with a table in shared memory, both modes);
- upd_order: the walk undone: one thread a 16-byte piece of upd in upd's
  memory order, its destination found from idx in 32-bit arithmetic, and
  out of place a copy of w first (two passes);
- no_table: the table undone: each thread scans idx[k, s] for its block;
- old: the kernel before the redesign (`launch/scatter_old.cu`): in place
  only, upd's order, three 64-bit divisions a piece.

Each runs on the serving wave's 7 llama3-8b leaves (w [2, d_in, N] bf16,
upd fp32, block 8, r = 0.25), in place and out of place (the old kernel
out of place as `clone()` + kernel, as the wave computed it before), held
bitwise against the plain version (`kernels.ref`), then timed by CUDA
events with the L2 flushed before each call, summed over the 7 leaves, in
turns: every build, then every build again in reverse order. Beside them:
`Tensor.scatter_` / `Tensor.scatter` on the pre-cast upd with its index
pre-built (the library calls), and both modes' byte bounds.

Where the in-place mode misses half its bound, the `paired` selection
says whether partial sectors set its pace: the same number of blocks, but
chosen in aligned pairs, so that every 32-byte sector of w it touches is
written whole. The sector floor printed beside the bound counts every
touched sector of w read and written back whole. Needs one card.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch.kernels import build, ref

SRC = build.CSRC / "block_scatter_update.cu"
OLD = Path(__file__).resolve().parent / "scatter_old.cu"
OUT = build.BUILD_DIR / "scatter_probe"
PEAK_BYTES = 3.35e12                 # H100 SXM device memory, bytes/s
SECTOR = 32                          # bytes

# name -> [(text in the shipped source, its replacement)]
VARIANTS = {
    "shipped": [],
    "upd_order": [("constexpr bool kColumnOrder = true;",
                   "constexpr bool kColumnOrder = false;")],
    "no_table": [("constexpr bool kTable = true;",
                  "constexpr bool kTable = false;")],
}


def edit(src: str, edits, name: str) -> str:
    for old, new in edits:
        if old not in src:
            raise RuntimeError(f"variant {name}: {old!r} is not in the "
                               f"source")
        src = src.replace(old, new)
    return src


def build_all() -> dict:
    """{build: loaded library}: the variants of the shipped source and the
    old kernel, one nvcc each, all started together."""
    OUT.mkdir(parents=True, exist_ok=True)
    src = SRC.read_text()
    sources = {name: edit(src, edits, name)
               for name, edits in VARIANTS.items()}
    sources["old"] = OLD.read_text()
    procs = {}
    for name, text in sources.items():
        cu, so = OUT / f"{name}.cu", OUT / f"lib{name}.so"
        cu.write_text(text)
        procs[name] = (subprocess.Popen(
            [build.nvcc_path(), *build._flags("block_scatter_update"), "-o",
             str(so), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        for line in log.splitlines():
            if "registers" in line:
                print(f"[scatter_probe] {name} ptxas: {line.strip()}",
                      flush=True)
        lib = ctypes.CDLL(str(so))
        fn = lib.block_scatter_update_launch
        fn.argtypes = ([p] * (3 if name == "old" else 4)
                       + [i64, i64, i64, i32, i32, i32, i32, i32, p])
        fn.restype = ctypes.c_int
        libs[name] = lib
    return libs


def launch(lib, old: bool, out, w, upd, idx, spec):
    """One call of `lib` at w [K, R, N] (out is w: in place)."""
    k, r, n = w.shape
    ptrs = ([] if old else [out.data_ptr()]) + [w.data_ptr(),
                                                upd.data_ptr(),
                                                idx.data_ptr()]
    rc = lib.block_scatter_update_launch(
        *ptrs, k, r, n, spec.n_shards, spec.n_sel, spec.block,
        1 if w.dtype == torch.bfloat16 else 0,
        1 if upd.dtype == torch.bfloat16 else 0,
        torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"scatter launch failed with CUDA error {rc}")


def events_ms(fn, flush, reps: int) -> float:
    """Mean CUDA-event time of `fn` alone, the L2 flushed before each call."""
    fn()
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
    return sum(s.elapsed_time(e) for s, e in pairs) / reps


def wave_cases(gen, paired: bool) -> dict:
    """{leaf: (w, upd, idx, spec)} of the online wave on full-width
    llama3-8b (K = 2, r = 0.25, block 8); `paired` draws the same number
    of blocks as aligned pairs (2m, 2m + 1)."""
    from repro_torch.launch.dw_probe import _plan_leaves
    cases = {}
    for (_, name), (_, fan_in, out, spec) in _plan_leaves(
            "llama3-8b", ("attn", "mlp"), 0.25, 8).items():
        w = (torch.randn(2, fan_in, out, generator=gen, device="cuda")
             * 0.02).to(torch.bfloat16)
        upd = torch.randn(2, fan_in, spec.n_shards, spec.n_sel, spec.block,
                          generator=gen, device="cuda") * 0.02
        rows = []
        for _ in range(2 * spec.n_shards):
            if paired:
                m = torch.randperm(spec.n_blocks // 2, generator=gen,
                                   device="cuda")[: spec.n_sel // 2]
                rows.append(torch.stack([2 * m, 2 * m + 1], 1).reshape(-1))
            else:
                rows.append(torch.randperm(spec.n_blocks, generator=gen,
                                           device="cuda")[: spec.n_sel])
        idx = torch.stack(rows).reshape(2, spec.n_shards, spec.n_sel).to(
            torch.int32).contiguous()
        cases[name] = (w, upd, idx, spec)
    return cases


def bounds(cases: dict) -> tuple[float, float, float]:
    """(in place, out of place, in-place sector floor), ms at 3.35 TB/s:
    upd's selected values and idx read, and in place the selected elements
    of w written; out of place also the rest of w read and all of out
    written; the floor reads and writes every touched sector of w whole."""
    inp = outp = floor = 0.0
    for w, upd, idx, spec in cases.values():
        mask = ref.scatter_blocks3(
            torch.zeros(w.shape, dtype=torch.int8, device="cuda"),
            torch.ones(upd.shape, dtype=torch.int8, device="cuda"), idx,
            spec.block).bool()
        sel = int(mask.sum())
        es = w.element_size()
        touched = int(mask.view(-1, SECTOR // es).any(-1).sum())
        upd_bytes = sel * upd.element_size() + idx.numel() * 4
        inp += upd_bytes + sel * es
        outp += (w.numel() - sel) * es + upd_bytes + w.numel() * es
        floor += upd_bytes + 2 * touched * SECTOR
    return tuple(b / PEAK_BYTES * 1e3 for b in (inp, outp, floor))


def check(libs: dict, cases: dict) -> bool:
    ok = True
    for name, lib in libs.items():
        old = name == "old"
        for leaf, (w, upd, idx, spec) in cases.items():
            want = ref.block_scatter_update_ref(w, upd, idx, spec.block)
            got = w.clone()
            launch(lib, old, got, got, upd, idx, spec)
            same = torch.equal(got.view(torch.int16), want.view(torch.int16))
            if not old:
                before = w.clone()
                out = torch.empty_like(w)
                launch(lib, old, out, w, upd, idx, spec)
                same &= torch.equal(out.view(torch.int16),
                                    want.view(torch.int16))
                same &= torch.equal(w.view(torch.int16),
                                    before.view(torch.int16))
            if not same:
                print(f"[scatter_probe] {name} {leaf}: NOT bitwise equal to "
                      f"the plain version", flush=True)
            ok &= same
    return ok


def time_modes(libs: dict, cases: dict, flush, reps: int) -> dict:
    """{(build, mode): ms summed over the leaves}, in turns."""
    calls = {}
    for name, lib in libs.items():
        old = name == "old"
        inp = [lambda lib=lib, old=old, c=c: launch(lib, old, c[0], c[0],
                                                    *c[1:])
               for c in cases.values()]
        calls[(name, "in place")] = inp
        if old:
            calls[(name, "clone + kernel")] = [
                lambda lib=lib, c=c: launch(lib, True, None, c[0].clone(),
                                            *c[1:])
                for c in cases.values()]
        else:
            outs = [torch.empty_like(c[0]) for c in cases.values()]
            calls[(name, "out of place")] = [
                lambda lib=lib, c=c, o=o: launch(lib, False, o, *c)
                for c, o in zip(cases.values(), outs)]
    lib_in, lib_out = [], []
    for w, upd, idx, spec in cases.values():
        k, r, _ = w.shape
        blocked = w.view(k, r, -1, spec.block)
        cast = upd.to(w.dtype).reshape(k, r, -1, spec.block)
        offs = (torch.arange(spec.n_shards, device="cuda")
                * spec.n_blocks)[None, :, None]
        index = (idx.long() + offs).reshape(k, 1, -1, 1).expand(
            k, r, spec.n_shards * spec.n_sel, spec.block).contiguous()
        lib_in.append(lambda b=blocked, i=index, v=cast: b.scatter_(2, i, v))
        lib_out.append(lambda b=blocked, i=index, v=cast: b.scatter(2, i, v))
    calls[("library", "in place")] = lib_in
    calls[("library", "out of place")] = lib_out
    order = list(calls) + list(reversed(list(calls)))
    times: dict = {key: [] for key in calls}
    for key in order:
        times[key].append(sum(events_ms(fn, flush, reps)
                              for fn in calls[key]))
    return times


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("scatter_probe: needs a card (torch.cuda.is_available() is "
              "false)")
        return 1
    libs = build_all()
    print(f"[scatter_probe] {torch.cuda.get_device_name(0)}; CUDA events, "
          f"L2 flushed, {args.reps} calls each, summed over the wave's 7 "
          f"leaves; each time twice, in turns", flush=True)
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    ok = True
    for selection in ("random", "paired"):
        cases = wave_cases(gen, selection == "paired")
        ok &= check(libs, cases)
        b_in, b_out, b_floor = bounds(cases)
        print(f"[scatter_probe] {selection} selection: bounds in place "
              f"{b_in:.4f} ms, out of place {b_out:.4f} ms; in-place sector "
              f"floor {b_floor:.4f} ms", flush=True)
        for (name, mode), ms in time_modes(libs, cases, flush,
                                           args.reps).items():
            bound = b_in if mode == "in place" else b_out
            print(f"[scatter_probe] {selection} {name} {mode}: "
                  f"{' / '.join(f'{t:.4f}' for t in ms)} ms "
                  f"({bound / min(ms):.0%} of its bound)", flush=True)
        del cases
    print(f"[scatter_probe] checks {'held' if ok else 'FAILED'}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

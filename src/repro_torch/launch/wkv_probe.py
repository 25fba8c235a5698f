"""Probe the WKV kernels' design choices on the card.

    python -m repro_torch.launch.wkv_probe [--reps 10] [--variants a,b]
                                           [--trace]

Builds the WKV source `kernels/csrc/wkv6.cu` as it ships and in variants
that each undo one design choice, with nvcc into `build/wkv_probe/`:

- fwd_c32: forward chunks of 32 steps instead of 16 (the backward's chunk
  stays 16: its per-channel walks keep C^2 / 4 values in registers);
- e32: 32 value columns a scan CTA instead of 64, two CTAs a head, in the
  forward and the backward's scans (value-column slicing);
- tf32: the products in plain TF32, one `mma.sync` a step, instead of
  3xTF32 (each operand split into a high and a low TF32 part);
- fma: the products as fp32 FMAs on the CUDA cores, no tensor cores;
- serial: the scans' two-stage pipeline undone: a chunk's prep, then its
  main part, one after the other.

Every build is held against the plain versions (`kernels.ref`) at the
rwkv path's shapes (batch 4 x 1024 steps x 40 heads x 64, fp32), with
w = 1e-12 on half the channels, at T = 1001 and at T around the chunk
sizes, each within 1e-4 of the largest |value| of the plain result; then
the forward and the backward are timed at the rwkv shapes with CUDA
events, the L2 flushed before every call, and each kernel by the
profiler's device time. A variant that misses the bound is reported and
still timed.

--trace builds the shipped source once more with clock64() stamps in the
forward's CTA (0, 0) and prints, per warp, the median cycles a chunk of
work, of waiting for the copies and at the barrier, and the prep warps'
phases. Needs one card.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys

import torch

from repro_torch.kernels import build, ref

# (text in the shipped source, its replacement) per variant
VARIANTS = {
    "shipped": [],
    "fwd_c32": [("constexpr int FWD_C = 16;", "constexpr int FWD_C = 32;")],
    "e32": [("constexpr int FWD_E = 64;", "constexpr int FWD_E = 32;"),
            ("constexpr int BWD_E = 64;", "constexpr int BWD_E = 32;")],
    "tf32": [("constexpr int kMma = 3;", "constexpr int kMma = 1;")],
    "fma": [("constexpr int kMma = 3;", "constexpr int kMma = 0;")],
    "serial": [("constexpr bool kPipe = true;",
                "constexpr bool kPipe = false;")],
}
# clock64() stamps for --trace: per warp and chunk, before the work (and
# warp 0's issue of the next copies), after it, after the wait for the
# copies and after the barrier; per prep warp, at the start of prep and
# after its decays, its copy of v and its scores
TRACE = [
    ("#include <stdint.h>\n",
     "#include <stdint.h>\n"
     "__device__ unsigned long long wkv_trace[8 * 64 * 4];\n"
     "__device__ unsigned long long wkv_trace_prep[4 * 64 * 4];\n"),
    ("  for (int j = 0; j < nc; ++j) {\n    if (kPipe) {\n",
     "  for (int j = 0; j < nc; ++j) {\n"
     "    const bool tr = OUT && !REV && blockIdx.x == 0 &&\n"
     "                    blockIdx.y == 0 && lane == 0 && j < 64;\n"
     "    unsigned long long* tp = wkv_trace + (warp * 64 + j) * 4;\n"
     "    if (tr) tp[0] = clock64();\n"
     "    if (kPipe) {\n"),
    ("        main_step(j);\n      }\n    } else {\n",
     "        main_step(j);\n      }\n      if (tr) tp[1] = clock64();\n"
     "    } else {\n"),
    ("    if (j + 2 < nc) await(j + 2);\n    __syncthreads();\n  }\n",
     "    if (j + 2 < nc) await(j + 2);\n    if (tr) tp[2] = clock64();\n"
     "    __syncthreads();\n    if (tr) tp[3] = clock64();\n  }\n"),
    ("  auto prep = [&](int j) {\n",
     "  auto prep = [&](int j) {\n"
     "    const bool tq_on = OUT && !REV && blockIdx.x == 0 &&\n"
     "                       blockIdx.y == 0 && lane == 0 && j < 64;\n"
     "    unsigned long long* tq = wkv_trace_prep + (warp * 64 + j) * 4;\n"
     "    if (tq_on) tq[0] = clock64();\n"),
    ("      sl[L::PI + d] = bb;\n    }\n",
     "      sl[L::PI + d] = bb;\n    }\n"
     "    if (tq_on) tq[1] = clock64();\n"),
    ("    if (!OUT) return;\n",
     "    if (tq_on) tq[2] = clock64();\n    if (!OUT) return;\n"),
    ("        sl[L::ATT + (tl + i) * L::CP + jj] = part[i];\n    }\n",
     "        sl[L::ATT + (tl + i) * L::CP + jj] = part[i];\n    }\n"
     "    if (tq_on) tq[3] = clock64();\n"),
]
TRACE_READ = """
extern "C" int wkv_trace_read(void* main, void* prep) {
  cudaError_t e = cudaMemcpyFromSymbol(main, wkv_trace, sizeof(wkv_trace));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaMemcpyFromSymbol(prep, wkv_trace_prep,
                                   sizeof(wkv_trace_prep));
}
"""
OUT = build.BUILD_DIR / "wkv_probe"
SHAPE = (4, 1024, 40, 64)          # the rwkv6-3b path's WKV calls
TOL = 1e-4                          # of the largest |value| of the plain


def _edit(src: str, edits, name: str) -> str:
    for old, new in edits:
        if old not in src:
            raise RuntimeError(f"variant {name}: {old!r} is not in the "
                               f"source")
        src = src.replace(old, new)
    return src


def build_variants(sources: dict) -> dict:
    """{name: loaded library} from {name: CUDA source}, one nvcc each, all
    started together; each build's register and stack lines of ptxas are
    printed."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        cu, so = OUT / f"{name}.cu", OUT / f"lib{name}.so"
        cu.write_text(text)
        procs[name] = (subprocess.Popen(
            [build.nvcc_path(), *build._flags("wkv6"), "-o", str(so),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        for line in log.splitlines():
            if "registers" in line or "stack frame" in line:
                print(f"[wkv_probe] {name} ptxas: {line.strip()}")
        libs[name] = ctypes.CDLL(str(so))
        build._declare("wkv6", libs[name])
    return libs


def fwd(lib, r, k, v, w, u):
    b, t, h, d = r.shape
    y = torch.empty_like(r)
    rc = lib.wkv6_fwd_launch(r.data_ptr(), k.data_ptr(), v.data_ptr(),
                             w.data_ptr(), u.data_ptr(), y.data_ptr(), None,
                             None, b, t, h, d,
                             torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"wkv6 forward launch failed with CUDA error {rc}")
    return y


def bwd(lib, r, k, v, w, u, dy):
    b, t, h, d = r.shape
    dr, dk, dv, dw = (torch.empty_like(r) for _ in range(4))
    du_part = torch.empty((b, h, lib.wkv6_bwd_chunks(t), d), device="cuda")
    ckpt = torch.empty(lib.wkv6_ckpt_floats(b, t, h), device="cuda")
    rc = lib.wkv6_bwd_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        dy.data_ptr(), dr.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        dw.data_ptr(), du_part.data_ptr(), ckpt.data_ptr(), b, t, h, d,
        torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"wkv6 backward launch failed with CUDA error "
                           f"{rc}")
    return dr, dk, dv, dw, du_part.sum((0, 2))


def inputs(shape, gen, log_decay: float, strong: bool = False):
    """r, k, v, dy ~ N(0, 1), w = exp(-exp(log_decay + 0.5 N)) (w0 = -6,
    the model's init, gives w ~ 0.9975), u ~ 0.1 N; `strong` sets w =
    1e-12 on every other channel."""
    b, t, h, d = shape
    r, k, v, dy = (torch.randn(shape, generator=gen, device="cuda")
                   for _ in range(4))
    w = torch.exp(-torch.exp(log_decay + 0.5 * torch.randn(
        shape, generator=gen, device="cuda")))
    if strong:
        w[..., ::2] = 1e-12
    u = 0.1 * torch.randn((h, d), generator=gen, device="cuda")
    return r, k, v, w, u, dy


def cases(gen) -> dict:
    """{tag: (inputs, plain y, plain grads)}, the plain results once for
    every variant."""
    found = {}
    specs = [("rwkv6-3b shapes", SHAPE, -6.0, False),
             ("strong decay", (2, 256, 8, 64), -6.0, True),
             ("T=1001", (2, 1001, 8, 64), -1.0, False)]
    specs += [(f"T={t}", (1, t, 4, 64), -1.0, False)
              for t in (1, 15, 16, 17, 31, 32, 33)]
    for tag, shape, log_decay, strong in specs:
        x = inputs(shape, gen, log_decay, strong)
        found[tag] = (x, ref.wkv6_ref(*x[:5]), ref.wkv6_bwd_ref(*x))
    torch.cuda.synchronize()
    return found


def worst(got, want) -> tuple[float, bool]:
    """(max abs err / max |want|, within TOL and finite)."""
    scale = max(float(want.abs().max()), 1e-30)
    err = float((got - want).abs().max())
    ok = bool(torch.isfinite(got).all()) and err <= TOL * scale
    return err / scale, ok


def flushed_ms(fn, flush, reps: int) -> float:
    """CUDA events around each call alone, the L2 flushed before it."""
    fn()
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def kernel_ms(fn, reps: int) -> dict:
    """{kernel name: profiler device ms a call} over `reps` calls."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    found = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0.0)
        name = next((n for n in ("wkv6_fwd_chunk_kernel",
                                 "wkv6_bwd_scan_kernel",
                                 "wkv6_bwd_chunk_kernel") if n in e.key),
                    "other")
        if us > 0:
            found[name] = found.get(name, 0.0) + us / reps / 1e3
    return found


def trace(lib, x) -> None:
    """The forward once at the rwkv shapes, then the stamps of CTA (0, 0):
    medians over chunks 2 .. 61."""
    import numpy as np
    fwd(lib, *x[:5])
    torch.cuda.synchronize()
    main = np.zeros(8 * 64 * 4, dtype=np.uint64)
    prep = np.zeros(4 * 64 * 4, dtype=np.uint64)
    rc = lib.wkv_trace_read(main.ctypes.data_as(ctypes.c_void_p),
                            prep.ctypes.data_as(ctypes.c_void_p))
    if rc != 0:
        raise RuntimeError(f"reading the trace failed with CUDA error {rc}")
    t = main.reshape(8, 64, 4).astype(np.int64)[:, 2:62]
    step = np.diff(t[0, :, 0])
    print(f"[wkv_probe] trace: a chunk takes {int(np.median(step))} cycles "
          f"(warp 0's start to start)")
    for w in range(8):
        work, wait, bar = (np.median(t[w, :, i + 1] - t[w, :, i])
                           for i in range(3))
        print(f"[wkv_probe] trace: warp {w} ({'prep' if w < 4 else 'main'})"
              f" work {int(work)} wait {int(wait)} barrier {int(bar)}")
    p = prep.reshape(4, 64, 4).astype(np.int64)[:, 2:62]
    for w in range(4):
        dec, vv, sc = (np.median(p[w, :, i + 1] - p[w, :, i])
                       for i in range(3))
        print(f"[wkv_probe] trace: prep warp {w} decays {int(dec)} copy of "
              f"v {int(vv)} scores {int(sc)}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help="comma-separated subset of " + ", ".join(VARIANTS))
    ap.add_argument("--trace", action="store_true",
                    help="also clock64() stamps of the shipped forward")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("wkv_probe: needs a card (torch.cuda.is_available() is false)")
        return 1
    names = [n for n in args.variants.split(",") if n]
    unknown = set(names) - set(VARIANTS)
    if unknown:
        ap.error(f"unknown variants {sorted(unknown)}")
    src = (build.CSRC / "wkv6.cu").read_text()
    sources = {n: _edit(src, VARIANTS[n], n) for n in names}
    if args.trace:
        sources["trace"] = _edit(src, TRACE, "trace") + TRACE_READ
    libs = build_variants(sources)
    found = cases(torch.Generator(device="cuda").manual_seed(0))
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    print(f"[wkv_probe] {torch.cuda.get_device_name(0)}; CUDA events, L2 "
          f"flushed, {args.reps} calls each; errors as max abs err / max "
          f"|plain|, bound {TOL}", flush=True)
    failed = []
    for name in names:
        lib = libs[name]
        for tag, (x, want_y, want_g) in found.items():
            errs, ok_all = [], True
            e, ok = worst(fwd(lib, *x[:5]), want_y)
            errs.append(f"y {e:.2e}")
            ok_all &= ok
            for gname, got, want in zip("rkvwu", bwd(lib, *x), want_g):
                e, ok = worst(got, want)
                errs.append(f"d{gname} {e:.2e}")
                ok_all &= ok
            if not ok_all:
                failed.append(f"{name} {tag}")
            print(f"[wkv_probe] {name}: {tag} {tuple(x[0].shape)} "
                  f"{'ok' if ok_all else 'OUT OF BOUND'}: {', '.join(errs)}",
                  flush=True)
        x = found["rwkv6-3b shapes"][0]
        f_ms = flushed_ms(lambda: fwd(lib, *x[:5]), flush, args.reps)
        b_ms = flushed_ms(lambda: bwd(lib, *x), flush, args.reps)
        dev = kernel_ms(lambda: fwd(lib, *x[:5]), args.reps)
        dev.update(kernel_ms(lambda: bwd(lib, *x), args.reps))
        print(f"[wkv_probe] {name}: {SHAPE} forward_ms={f_ms:.4f} "
              f"backward_ms={b_ms:.4f}; profiler device ms a call: "
              f"{ {k: round(v, 4) for k, v in dev.items()} }", flush=True)
    if args.trace:
        trace(libs["trace"], found["rwkv6-3b shapes"][0])
    if failed:
        print(f"[wkv_probe] out of bound: {failed}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Probe the compact dW kernel's design choices on the card.

    python -m repro_torch.launch.dw_probe [--reps 20] [--variants a,b]

Builds the dW source `kernels/csrc/block_sparse_dw.cu` as it ships and in
variants that each undo one design choice, with nvcc into
`build/dw_probe/`, all started together.

Variants of the TMA + wgmma instance, run on the bf16 leaves of one
trainable llama3-8b layer (M = 4096 tokens) and of one deepseek-moe-16b
layer's three expert leaves (64 experts, capacity 481):

- swapped: the wgmma descriptors' leading and stride byte offsets swapped
  (a wrong MN-major descriptor): counted on the one-hot layout probe;
- narrow: 128-column tiles only, never the 256-column tile;
- one_cta: the 128-column tile with 4 stages and one CTA an SM, so no
  second CTA hides a tile's epilogue;
- fill_splits: the contraction split into as many slices (up to 4) as
  fill the last wave of CTA slots best, instead of the fewest that make
  two waves of SMs.

Variants of the grid instance, run on the fp32 llama3-8b leaves (M =
4096), the fp32 expert w_gate (E = 64, capacity 481) and the serving
wave's 7 llama3-8b leaves (M = 16 tokens, r = 0.25, block 8) in bf16 and
in fp32:

- old_grid: the grid tile before packing (`launch/dw_old_grid.cuh`): one
  CTA a selected block's 64-column piece and 64 fan-in rows, element
  loads, bf16 widened to fp32, 4 x 4 fp32 outputs a thread; its fp32
  results must equal the shipped ones bit for bit;
- one_block_tile: no packing: a tile takes 128 columns of one selected
  block (16 of 128 at block 8);
- fma_bf16: bf16 on the CUDA cores (fp32 FMAs) instead of mma.sync;
- no_cp_async: element loads through registers instead of 16-byte
  cp.async pieces;
- rows128: tiles of 128 fan-in rows and 256 threads, two CTAs an SM,
  instead of 64 rows and 128 threads, four an SM.

Two more builds of the grid instance compute wrong sums on purpose and
are timed only, to split its time: no_smem_reads (the CUDA cores' FMA
stream alone: each stage's operands are read from shared memory once,
for its first row, and used for all its rows) and one_fma (everything
but that stream: one FMA a row instead of 64).

Every other build is held against the plain version (`kernels.ref`)
within 1e-4 of the largest |value|, and every call's time is the card's
(profiler device time); sums are printed per group. Needs one card; a
TMA variant that breaks the layout probe is not timed.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch.kernels import build, ref

_SRC = build.CSRC / "block_sparse_dw.cu"
_OLD_GRID = Path(__file__).resolve().parent / "dw_old_grid.cuh"
_RUN = "int run(const void* x, const void* dy, const void* idx, void* out,"
_GRID_F32 = ("    return (int)launch_grid<float>(x, dy, ip, op, g, experts, "
             "batched, st);")
_GRID_BF16 = ("    return (int)launch_grid<__nv_bfloat16>(x, dy, ip, op, g, "
              "experts,\n                                           "
              "batched, st);")


def _old_grid_edits() -> list:
    """Splice the earlier grid tile in and route both grid calls to it."""
    args = "(x, dy, ip, op, e, m, k, n, n_shards, n_sel, block, batched, st)"
    return [(_RUN, _OLD_GRID.read_text() + "\n" + _RUN),
            (_GRID_F32, f"    return (int)old_grid::launch<float>{args};"),
            (_GRID_BF16,
             f"    return (int)old_grid::launch<__nv_bfloat16>{args};")]


_LOADS = """    float a[8], b[8];
    load4(xs + r * S::kLdX + l.r0, a);
    load4(xs + r * S::kLdX + l.r0 + 16, a + 4);
    load4(ds + r * S::kLdD + l.c0, b);
    load4(ds + r * S::kLdD + l.c0 + 32, b + 4);
"""
_ROW_LOOP = """#pragma unroll
  for (int r = 0; r < S::kRows; ++r) {
"""
_FMAS = """#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        acc[i * 8 + j] = fmaf(a[i], b[j], acc[i * 8 + j]);"""

# name -> (the instance it probes, [(text in the shipped source, its
# replacement)]); "shipped" runs both instances, "timing" builds of the grid
# instance are timed and not checked
VARIANTS = {
    "shipped": ("both", []),
    "swapped": ("pipelined", [
        ("mn_major_desc(a0 + kk * 2048, BOX_BYTES, 1024)",
         "mn_major_desc(a0 + kk * 2048, 1024, BOX_BYTES)"),
        ("mn_major_desc(b0 + kk * 2048, BOX_BYTES, 1024)",
         "mn_major_desc(b0 + kk * 2048, 1024, BOX_BYTES)")]),
    "narrow": ("pipelined", [("const bool wide = g.C % 256 == 0",
                              "const bool wide = false && g.C % 256 == 0")]),
    "one_cta": ("pipelined", [("kStages = NH == 1 ? 3 : 4", "kStages = 4"),
                              ("kCtasPerSm = NH == 1 ? 2 : 1",
                               "kCtasPerSm = 1")]),
    "fill_splits": ("pipelined", [
        ("  g.splits = (int)(splits > 1 ? splits : 1);\n", """\
  g.splits = 1;
  const int64_t slots = (int64_t)sms * S::kCtasPerSm;
  if (tiles < 2 * slots) {
    double best = 0.0;
    for (int s = 1; s <= MAX_SPLITS && s <= g.m_stages; ++s) {
      const int64_t ctas = tiles * s;
      const double fill =
          (double)ctas / (double)(((ctas + slots - 1) / slots) * slots);
      if (fill > best + 0.05) {
        best = fill;
        g.splits = s;
      }
    }
  }
""")]),
    "old_grid": ("grid", None),   # edits from _old_grid_edits()
    "one_block_tile": ("grid", [("constexpr bool kPackColumns = true;",
                                 "constexpr bool kPackColumns = false;")]),
    "fma_bf16": ("grid", [("constexpr bool kBf16Mma = true;",
                           "constexpr bool kBf16Mma = false;")]),
    "no_cp_async": ("grid", [("constexpr bool kCpAsync = true;",
                              "constexpr bool kCpAsync = false;")]),
    "rows128": ("grid", [("constexpr int TR = 64;",
                          "constexpr int TR = 128;")]),
    "no_smem_reads": ("timing", [(
        _ROW_LOOP + _LOADS,
        "  const int r = 0;\n" + _LOADS + _ROW_LOOP)]),
    "one_fma": ("timing", [(_FMAS,
                            "    acc[r] = fmaf(a[r % 8], b[r % 8], acc[r]);")]),
}
OUT = build.BUILD_DIR / "dw_probe"
TOL = 1e-4                          # of the largest |value| of the plain


def edits_of(name: str) -> list:
    edits = VARIANTS[name][1]
    return _old_grid_edits() if edits is None else edits


def _edit(src: str, edits, name: str) -> str:
    for old, new in edits:
        if old not in src:
            raise RuntimeError(f"variant {name}: {old!r} is not in the "
                               f"source")
        src = src.replace(old, new)
    return src


def build_variants(names) -> dict:
    """{variant: loaded library}, one nvcc each, all started together; each
    build's register and spill lines of ptxas are printed."""
    src = _SRC.read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        cu, so = OUT / f"{name}.cu", OUT / f"lib{name}.so"
        cu.write_text(_edit(src, edits_of(name), name))
        procs[name] = (subprocess.Popen(
            [build.nvcc_path(), *build._flags("block_sparse_dw"), "-o",
             str(so), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        print_ptxas(name, log)
        libs[name] = ctypes.CDLL(str(so))
        build._declare("block_sparse_dw", libs[name])
    return libs


def print_ptxas(name: str, log: str) -> None:
    """One line per kernel of nvcc's -Xptxas -v output: its (mangled) name,
    registers and spills."""
    kernel, spills = "?", ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            kernel = line.split("'")[1]
        elif "spill" in line:
            spills = line.strip()
        elif "registers" in line:
            regs = line.split(":", 1)[1].strip()
            print(f"[dw_probe] {name} ptxas {kernel}: {regs}; {spills}")


def launch(lib, x, dy, idx, block: int, pipelined: bool = True):
    """One instance of `lib` on x [E?, M, K], dy [E?, M, N] (fp32 or bf16);
    3-D inputs take the batched entry point."""
    n_shards, n_sel = idx.shape
    stream = torch.cuda.current_stream().cuda_stream
    dtype = 1 if x.dtype == torch.bfloat16 else 0
    if x.dim() == 3:
        e, m, k = x.shape
        out = torch.empty((e, k, n_shards, n_sel, block), device="cuda")
        rc = lib.batched_dw_launch(
            x.data_ptr(), dy.data_ptr(), idx.data_ptr(), out.data_ptr(), e,
            m, k, dy.shape[-1], n_shards, n_sel, block, dtype,
            int(pipelined), stream)
    else:
        m, k = x.shape
        out = torch.empty((k, n_shards, n_sel, block), device="cuda")
        rc = lib.block_sparse_dw_launch(
            x.data_ptr(), dy.data_ptr(), idx.data_ptr(), out.data_ptr(), m,
            k, dy.shape[-1], n_shards, n_sel, block, dtype, int(pipelined),
            stream)
    if rc != 0:
        raise RuntimeError(f"dW launch failed with CUDA error {rc}")
    return out


def device_ms(fn, reps: int) -> float:
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(getattr(e, "self_device_time_total", 0.0)
               for e in prof.key_averages()) / reps / 1e3


def layout_errors(lib) -> tuple[int, int]:
    """(wrong, total) values of the one-hot probe: x[i, i] = 1, dy a ramp
    of its column index (exact in bf16), so out[k, c] must be dy[k, column
    of c]; block 128, the second of two blocks selected."""
    x = torch.eye(128, device="cuda").to(torch.bfloat16)
    dy = (torch.arange(256, device="cuda") % 128).float().expand(128, 256)
    dy = dy.to(torch.bfloat16).contiguous()
    idx = torch.tensor([[1]], dtype=torch.int32, device="cuda")
    got = launch(lib, x, dy, idx, 128)
    want = ref.block_sparse_dw_ref(x, dy, idx, 128)
    return int((got != want).sum()), got.numel()


def _plan_leaves(arch: str, group_names, ratio: float, block: int) -> dict:
    """{(group, leaf): (lead, fan_in, out, spec)} of one trainable layer
    of `arch` as the paths' plans give them (K = 2 trainable layers); an
    expert leaf's lead is (experts, capacity) at 4096 tokens."""
    from repro_torch.configs import SparseUpdateConfig, get_config
    from repro_torch.core.selection import build_plan
    from repro_torch.models import moe
    from repro_torch.models.registry import abstract_params
    cfg = get_config(arch)
    plan = build_plan(cfg, SparseUpdateConfig(
        update_ratio=ratio, num_update_layers=2, channel_block=block))
    shapes = abstract_params(cfg)["segments"]["blocks"]
    found = {}
    for group in group_names:
        for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
            spec = plan.spec["blocks"][group].get(name)
            if spec is None:
                continue
            lead = (cfg.moe.num_experts, moe._capacity(
                4096, cfg.moe.top_k, cfg.moe.capacity_factor,
                cfg.moe.num_experts)) if group == "moe" else (4096,)
            fan_in, out = shapes[group][name].shape[-2:]
            found[(group, name)] = (lead, fan_in, out, spec)
    return found


def _case(gen, lead, fan_in, out, spec, dtype):
    idx = torch.stack([torch.randperm(
        spec.n_blocks, generator=gen, device="cuda")[:spec.n_sel]
        for _ in range(spec.n_shards)]).to(torch.int32)
    return (torch.randn(lead + (fan_in,), generator=gen,
                        device="cuda").to(dtype),
            torch.randn(lead + (out,), generator=gen,
                        device="cuda").to(dtype),
            idx, spec.block)


def tma_cases(gen) -> dict:
    """{tag: (x, dy, idx, block)}: the llama3-8b layer's 7 bf16 leaves at
    M = 4096 and deepseek-moe-16b's 3 expert leaves (E = 64, C = 481), as
    the paths' plans give them (r = 0.2, block 128)."""
    found = {}
    for arch, groups in (("llama3-8b", ("attn", "mlp")),
                         ("deepseek-moe-16b", ("moe",))):
        for (_, name), (lead, fan_in, out, spec) in _plan_leaves(
                arch, groups, 0.2, 128).items():
            found[f"{arch} {name}"] = _case(gen, lead, fan_in, out, spec,
                                            torch.bfloat16)
    return found


def grid_cases(gen) -> dict:
    """{group: {tag: (x, dy, idx, block)}}: the fp32 llama3-8b leaves
    (M = 4096, r = 0.2, block 128), the fp32 expert w_gate (E = 64,
    C = 481) and the serving wave's 7 leaves (M = 16, r = 0.25, block 8)
    in bf16 and in fp32."""
    lm = _plan_leaves("llama3-8b", ("attn", "mlp"), 0.2, 128)
    experts = _plan_leaves("deepseek-moe-16b", ("moe",), 0.2, 128)
    wave = _plan_leaves("llama3-8b", ("attn", "mlp"), 0.25, 8)
    groups = {"lm fp32": {name: _case(gen, *leaf, torch.float32)
                          for (_, name), leaf in lm.items()},
              "expert fp32": {"w_gate": _case(
                  gen, *experts[("moe", "w_gate")], torch.float32)}}
    for dtype in (torch.bfloat16, torch.float32):
        groups[f"wave {str(dtype).split('.')[-1]}"] = {
            name: _case(gen, (16,), fan_in, out, spec, dtype)
            for (_, name), (_, fan_in, out, spec) in wave.items()}
    return groups


def probe_tma(name, lib, inputs, reps):
    wrong, total = layout_errors(lib)
    print(f"[dw_probe] {name}: layout probe {wrong} of {total} values "
          f"wrong", flush=True)
    if wrong:
        return
    sums = {"llama3-8b": 0.0, "deepseek-moe-16b": 0.0}
    for tag, (x, dy, idx, block) in inputs.items():
        ms = device_ms(lambda: launch(lib, x, dy, idx, block), reps)
        sums[tag.split()[0]] += ms
        print(f"[dw_probe] {name}: {tag} x {tuple(x.shape)} N="
              f"{dy.shape[-1]} kernel_ms={ms:.4f}", flush=True)
    print(f"[dw_probe] {name}: sums llama3-8b 7 leaves "
          f"{sums['llama3-8b']:.4f} ms, deepseek-moe-16b 3 expert "
          f"leaves {sums['deepseek-moe-16b']:.4f} ms", flush=True)


def probe_grid(name, lib, groups, reps, kept: dict) -> bool:
    """Every grid case against the plain version (unless a timing build)
    and timed; the fp32 results of `shipped` are kept in `kept`, and those
    of old_grid held against them bit for bit. Returns whether every check
    held."""
    checked = VARIANTS[name][0] != "timing"
    ok = True
    for group, cases in groups.items():
        total = 0.0
        for tag, (x, dy, idx, block) in cases.items():
            got = launch(lib, x, dy, idx, block, pipelined=False)
            plain = ref.batched_dw_ref(x, dy, idx, block) if x.dim() == 3 \
                else ref.block_sparse_dw_ref(x, dy, idx, block)
            err = float((got - plain).abs().max())
            tol = TOL * float(plain.abs().max())
            line = f"max_abs_err={err:.3e} tol={tol:.3e}"
            if checked:
                ok &= err <= tol
            else:
                line += " (timing build: not checked)"
            key = (group, tag)
            if x.dtype == torch.float32:
                if name == "shipped":
                    kept[key] = got
                elif name == "old_grid" and key in kept:
                    same = torch.equal(got.view(torch.int32),
                                       kept[key].view(torch.int32))
                    ok &= same
                    line += f" bitwise_vs_shipped={same}"
            del plain
            ms = device_ms(lambda: launch(lib, x, dy, idx, block,
                                          pipelined=False), reps)
            total += ms
            print(f"[dw_probe] {name}: {group} {tag} x {tuple(x.shape)} "
                  f"N={dy.shape[-1]} block={block} kernel_ms={ms:.4f} "
                  f"{line}", flush=True)
        print(f"[dw_probe] {name}: {group} sum over {len(cases)} calls "
              f"{total:.4f} ms", flush=True)
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help="comma-separated subset of " + ", ".join(VARIANTS))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("dw_probe: needs a card (torch.cuda.is_available() is false)")
        return 1
    names = [n for n in VARIANTS if n in args.variants.split(",")]
    libs = build_variants(names)
    gen = torch.Generator(device="cuda").manual_seed(0)
    print(f"[dw_probe] {torch.cuda.get_device_name(0)}; profiler device "
          f"time, {args.reps} calls each", flush=True)
    ok = True
    kept: dict = {}
    tma = [n for n in names if VARIANTS[n][0] in ("both", "pipelined")]
    grid = [n for n in names if VARIANTS[n][0] != "pipelined"]
    if tma:
        inputs = tma_cases(gen)
        for name in tma:
            probe_tma(name, libs[name], inputs, args.reps)
        del inputs
    if grid:
        groups = grid_cases(gen)
        for name in grid:
            ok &= probe_grid(name, libs[name], groups, args.reps, kept)
    print(f"[dw_probe] grid checks {'held' if ok else 'FAILED'}",
          flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

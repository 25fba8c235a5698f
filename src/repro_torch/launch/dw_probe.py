"""Probe the compact dW kernel's design choices on the card.

    python -m repro_torch.launch.dw_probe [--reps 20]

Builds the dW source `kernels/csrc/block_sparse_dw.cu` as it ships and in
variants that each undo one design choice, with nvcc into
`build/dw_probe/`, and runs every build through its TMA + wgmma instance
on the same inputs:

- swapped: the wgmma descriptors' leading and stride byte offsets swapped
  (a wrong MN-major descriptor): counted on the one-hot layout probe;
- narrow: 128-column tiles only, never the 256-column tile;
- one_cta: the 128-column tile with 4 stages and one CTA an SM, so no
  second CTA hides a tile's epilogue;
- fill_splits: the contraction split into as many slices (up to 4) as
  fill the last wave of CTA slots best, instead of the fewest that make
  two waves of SMs.

For each build it prints the layout probe's wrong values and the card's
time (profiler device time) of every bf16 leaf of one trainable
llama3-8b layer (M = 4096 tokens) and of one deepseek-moe-16b layer's
three expert leaves (64 experts, capacity 481), with their sums. Needs
one card; a variant that breaks the probe is not timed.
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
    "swapped": [("mn_major_desc(a0 + kk * 2048, BOX_BYTES, 1024)",
                 "mn_major_desc(a0 + kk * 2048, 1024, BOX_BYTES)"),
                ("mn_major_desc(b0 + kk * 2048, BOX_BYTES, 1024)",
                 "mn_major_desc(b0 + kk * 2048, 1024, BOX_BYTES)")],
    "narrow": [("const bool wide = g.C % 256 == 0",
                "const bool wide = false && g.C % 256 == 0")],
    "one_cta": [("kStages = NH == 1 ? 3 : 4", "kStages = 4"),
                ("kCtasPerSm = NH == 1 ? 2 : 1", "kCtasPerSm = 1")],
    "fill_splits": [("  g.splits = (int)(splits > 1 ? splits : 1);\n", """\
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
""")],
}
OUT = build.BUILD_DIR / "dw_probe"


def build_variants() -> dict:
    """{variant: loaded library}, one nvcc each, all started together."""
    src = (build.CSRC / "block_sparse_dw.cu").read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"variant {name}: {old!r} is not in the "
                                   f"source")
            text = text.replace(old, new)
        cu, so = OUT / f"{name}.cu", OUT / f"lib{name}.so"
        cu.write_text(text)
        procs[name] = (subprocess.Popen(
            [build.nvcc_path(), *build._flags("block_sparse_dw"), "-o",
             str(so), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(so))
        build._declare("block_sparse_dw", libs[name])
    return libs


def launch(lib, x, dy, idx, block: int):
    """The TMA + wgmma instance of `lib` on bf16 x [E?, M, K], dy [E?, M,
    N]; 3-D inputs take the batched entry point."""
    n_shards, n_sel = idx.shape
    stream = torch.cuda.current_stream().cuda_stream
    if x.dim() == 3:
        e, m, k = x.shape
        out = torch.empty((e, k, n_shards, n_sel, block), device="cuda")
        rc = lib.batched_dw_launch(
            x.data_ptr(), dy.data_ptr(), idx.data_ptr(), out.data_ptr(), e,
            m, k, dy.shape[-1], n_shards, n_sel, block, 1, 1, stream)
    else:
        m, k = x.shape
        out = torch.empty((k, n_shards, n_sel, block), device="cuda")
        rc = lib.block_sparse_dw_launch(
            x.data_ptr(), dy.data_ptr(), idx.data_ptr(), out.data_ptr(), m,
            k, dy.shape[-1], n_shards, n_sel, block, 1, 1, stream)
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


def cases(gen) -> dict:
    """{tag: (x, dy, idx, block)}: the llama3-8b layer's 7 leaves at
    M = 4096 and deepseek-moe-16b's 3 expert leaves (E = 64, C = 481), as
    the paths' plans give them (r = 0.2, block 128)."""
    from repro_torch.configs import SparseUpdateConfig, get_config
    from repro_torch.core.selection import build_plan
    from repro_torch.models import moe
    from repro_torch.models.registry import abstract_params
    found = {}
    for arch, group_names in (("llama3-8b", ("attn", "mlp")),
                              ("deepseek-moe-16b", ("moe",))):
        cfg = get_config(arch)
        plan = build_plan(cfg, SparseUpdateConfig(
            update_ratio=0.2, num_update_layers=2, channel_block=128))
        shapes = abstract_params(cfg)["segments"]["blocks"]
        for group in group_names:
            for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
                spec = plan.spec["blocks"][group].get(name)
                if spec is None:
                    continue
                lead = (cfg.moe.num_experts, moe._capacity(
                    4096, cfg.moe.top_k, cfg.moe.capacity_factor,
                    cfg.moe.num_experts)) if group == "moe" else (4096,)
                fan_in, out = shapes[group][name].shape[-2:]
                idx = torch.stack([torch.randperm(
                    spec.n_blocks, generator=gen, device="cuda")[:spec.n_sel]
                    for _ in range(spec.n_shards)]).to(torch.int32)
                found[f"{arch} {name}"] = (
                    torch.randn(lead + (fan_in,), generator=gen,
                                device="cuda").to(torch.bfloat16),
                    torch.randn(lead + (out,), generator=gen,
                                device="cuda").to(torch.bfloat16),
                    idx, spec.block)
    return found


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("dw_probe: needs a card (torch.cuda.is_available() is false)")
        return 1
    libs = build_variants()
    inputs = cases(torch.Generator(device="cuda").manual_seed(0))
    print(f"[dw_probe] {torch.cuda.get_device_name(0)}; profiler device "
          f"time, {args.reps} calls each", flush=True)
    for name, lib in libs.items():
        wrong, total = layout_errors(lib)
        print(f"[dw_probe] {name}: layout probe {wrong} of {total} values "
              f"wrong", flush=True)
        if wrong:
            continue
        sums = {"llama3-8b": 0.0, "deepseek-moe-16b": 0.0}
        for tag, (x, dy, idx, block) in inputs.items():
            ms = device_ms(lambda: launch(lib, x, dy, idx, block),
                           args.reps)
            sums[tag.split()[0]] += ms
            print(f"[dw_probe] {name}: {tag} x {tuple(x.shape)} N="
                  f"{dy.shape[-1]} kernel_ms={ms:.4f}", flush=True)
        print(f"[dw_probe] {name}: sums llama3-8b 7 leaves "
              f"{sums['llama3-8b']:.4f} ms, deepseek-moe-16b 3 expert "
              f"leaves {sums['deepseek-moe-16b']:.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

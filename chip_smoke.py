#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA H100 and check it end to end.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):

1. environment: torch version, the card's name and power limit, TF32 off,
   deterministic cuDNN;
2. build: nvcc builds every kernel of the port from `src/repro_torch/kernels/csrc`;
3. kernels against their plain versions at the main paths' shapes
   (M = 4096 tokens, full llama3-8b widths; every activation shape of the
   full-width MobileNetV2 at batch 32), with their times, bounds and the
   library call's time; the dW on both instances at every bf16 leaf of
   one trainable llama3-8b, deepseek-moe-16b, rwkv6-3b, gemma3-4b,
   nemotron-4-15b, command-r-35b and llama4-scout-17b-a16e layer (its
   experts E = 16, capacity 321), of llama3-8b at train_4k (M = 8192) and
   of one layer of the jamba cut (M = 2048; its experts E = 4, capacity
   1281), at M = 32768, capacity 17 and 8192, two shards with the last
   block
   selected, with exact layout probes (one-hot x, ramp dy) for both tile
   widths, two calls bitwise equal, and the calls that take the grid
   instance (fp32, block 8, block 96, misaligned, ragged K or N, capacity
   17), among them the serving wave's 7 llama3-8b leaves (M = 16 tokens,
   block 8) in bf16 and in fp32, each timed beside torch.matmul and its
   bound;
4. the LM path: the compact sparse-update train step on full-width
   llama3-8b (32 layers, bf16), batch 4 x seq 1024, AdamW, 6 steps across
   the fixed / dynamic / fixed phases, through `repro_torch.launch.train`;
   the kernels' launch counts are zeroed just before and read just after:
   exactly K x 7 block_sparse_dw and 7 fused_block_opt a step, the
   unselected blocks of mlp/w_gate unchanged every step;
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
8. one more CNN step under torch.profiler, after timing it with cuDNN's
   deterministic algorithms against its free choice;
9. the reference's Table II at the smoke config (150 pretraining steps,
   120 transfer steps, five methods), twice from one seed, every row
   bitwise equal, and the learnability check;
10. the MoE path: the compact train step on full-width deepseek-moe-16b
   (all 28 layers, bf16, 64 routed experts top-6 plus 2 shared), batch
   4 x seq 1024, AdamW, 6 steps across the fixed / dynamic / fixed phases,
   through `repro_torch.launch.train`, counts zeroed just before and read
   just after: exactly K x 7 block_sparse_dw, K x 3 batched_dw and 10
   fused_block_opt launches a step (as the plan derives them); the
   unselected blocks of attn/wo unchanged every step; the expert leaves'
   unselected blocks bitwise their init through the first fixed phase;
   the share of routed choices the capacity dropped;
11. one more MoE step under torch.profiler, then the frozen params (the
   dense first layer and the 25 frozen MoE layers) bitwise against a fresh
   init from the same seed;
12. MoE compact against dense-scatter on the card: SGD, 2 fixed-phase
   steps at full width cut to 4 layers, trainable params bitwise equal;
12a. the rwkv path: the compact train step on full-width rwkv6-3b (32
   layers, bf16, 40 heads of 64), batch 4 x seq 1024, AdamW, 6 steps
   across the fixed / dynamic / fixed phases, through
   `repro_torch.launch.train`, counts zeroed just before and read just
   after: exactly 34 wkv6 (32 layers + 2 recomputed under checkpoint),
   2 wkv6_bwd, K x 8 block_sparse_dw and 8 fused_block_opt launches a
   step; the unselected blocks of time/wo unchanged every step;
12b. one more rwkv step under torch.profiler, then the frozen params
   bitwise against a fresh init from the same seed;
12c. rwkv compact against dense-scatter: SGD, 2 fixed-phase steps at full
   width cut to 4 layers, trainable params bitwise equal;
12d. the gemma path: the compact train step on full-width gemma3-4b (34
   layers, no depth cut: 5 super-blocks of 5 local + 1 global layers and
   a tail of 4 local ones; bf16, tied embeddings, vocab 262144, head_dim
   320, window 1024), batch 1 x seq 4096 (the flash path; the same 4096
   tokens a step as batch 2 x 2048), K = 5 scan steps (the tail and
   the last super-block), AdamW, 6 steps through
   `repro_torch.launch.train`, counts zeroed just before and read just
   after: exactly the launches its plan derives (60 block_sparse_dw and
   42 fused_block_opt) every step, no grid dW, the unselected blocks of
   the global layer's wo unchanged every step; one profiled step with the
   flash path's share; the frozen params bitwise against a fresh init;
   compact against dense-scatter (SGD, 2 steps) bitwise at full width cut
   to 10 layers;
12e. the jamba path: jamba-1.5-large-398b at published widths (d_model
   8192, d_ff 24576, vocab 65536, d_inner 16384, d_state 16) CUT to one
   super-block (72 -> 8 layers: 7 mamba, attention at index 4, MoE on the
   odd FFNs) and 16 -> 4 experts, passed to the launcher as `model=`;
   K = 1, SGD lr 0.1, batch 2 x seq 1024, 6 steps: exactly the launches
   its plan derives (30 block_sparse_dw, 12 batched_dw, 42
   fused_block_opt) every step, the unselected blocks of a mamba
   out_proj unchanged every step; the share of routed choices dropped;
   one profiled step and the mamba scan's share of its device time
   (beside the scan's chunks as step-by-step loops); the frozen params
   and every expert leaf's unselected blocks through the first fixed
   phase bitwise against a fresh init; compact against dense-scatter
   (SGD, 2 steps) bitwise, cut further to a super-block of 4 layers and
   2 experts (the dense-scatter path's full-shape gradients and updated
   copy of every trainable leaf do not fit beside the 8-layer one);
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
   then bf16 online waves under torch.profiler (a profiler window drops
   the first kernels launched in it: the wave's scatter launches in a
   first window, per call, and all 14 of two waves after a discarded
   warm-up wave, as required; its 7 scatter calls replayed as a copy +
   the in-place kernel and as one out-of-place launch), and the bf16
   online wave against
   the f32 wave on the same bf16 inputs, within a bound derived from bf16
   rounding;
15. oracle parity at full widths cut to 4 layers, f32: the engine's greedy
   tokens against the contiguous prefill + decode_step oracle, plain and,
   after one wave, personalized (the delta dense-scattered into the
   oracle's params), with every step's top-2 logit gap probed;
16. flash attention (the path past 2048 tokens) against the dense path at
   layer level: llama3-8b's attention (32 / 8 heads of 128, batch 2 x
   4096) and gemma3-4b's local layers (8 / 4 heads of 320, window 1024,
   batch 1 x 4096), bf16 and fp32, the output and the gradients of
   (out²).sum(), and the custom backward against autograd through the
   forward (naive_vjp), each within its stated bound; forward + backward
   timed beside the dense path and F.scaled_dot_product_attention (a
   yardstick only), with each one's peak bytes;
17. the LM path at the reference's train_4k shape: full-width llama3-8b,
   batch 2 x seq 4096 (the cell's global batch of 256 is a pod's), AdamW,
   6 steps, launches as the plan derives them, one profiled step with the
   flash path's share of device time, the frozen params bitwise against a
   fresh init, compact against dense-scatter bitwise at full depth;
18. prefill of 32768 tokens (prefill_32k, batch 32 cut to 1) through
   `models.decoding.prefill` on full-width llama3-8b: wall and synced ms,
   tokens/s, peak bytes, finite last-token logits, cache pos and shapes;
   and a 4096-token prefill against the same model's forced through the
   dense path, within a stated bf16 bound;
19. the reference's other text-only archs at train_4k, batch 1 x seq
   4096, K = 2, 6 steps through the launcher, each with the LM path's
   checks (launches as its plan derives them, one profiled step with the
   flash path's share, frozen params against a fresh init, compact
   against dense-scatter bitwise): nemotron-4-15b at full depth (32
   layers; layernorm, squared ReLU) with AdamW; command-r-35b (layernorm,
   tied embeddings) cut 40 -> 24 layers, AdamW; llama4-scout-17b-a16e
   (MoE in every layer, 16 experts top-1 + 1 shared) cut 48 -> 8 layers
   with all 16 experts, SGD lr 0.1, its dropped share and every expert
   leaf's unselected blocks through the first fixed phase against the
   init, its compact against dense-scatter cut further to 4 layers; the
   cuts pass to the launcher as `model=`;
20. musicgen-medium (embedding inputs from a stub frontend, gelu,
   layernorm) at train_4k, full depth (48 layers): batch 2 x seq 4096 of
   standard-normal bf16 embeddings and uniform labels, drawn on the card
   from a generator seeded by the step (`embed_batches`) and fed through
   the launcher's `batches=` hook, K = 2, block 128, AdamW, 6 steps:
   launches as the plan derives them, one profiled step with the flash
   path's share, the frozen params against a fresh init, compact against
   dense-scatter bitwise at full depth;
21. qwen2-vl-7b (embedding inputs, M-RoPE) the same way, at full depth
   (28 layers), its [3, B, S] positions a 32 x 32 patch grid (t 0; h, w
   the grid's coordinates) and then text continuing from 32 in all three
   components (`mrope_positions`): the three components differ;
22. both archs served at full depth through the serve launcher's
   `build_engine` (4 slots, pages of 16, 8 requests of 128 prompt
   embeddings + 32 new tokens, prefix_mode off, greedy, fresh placeholder
   embeddings a decode step): 8/8 completed, no port kernel launched;
   then at full widths cut to 4 layers in f32 every request's tokens
   against the contiguous prefill + decode_step oracle fed the same
   prompt and decode embeddings, every sampled step's top-2 gap probed;
23. checkpoint and resume: phase 20's argv with --ckpt-dir and
   --ckpt-every 3 (the reference's file format; zlib level 0 where the
   card's host has no `zstandard`), its losses bitwise phase 20's; the
   step-6 file deleted and the same argv again: "resumed from step 3",
   steps 4-6 bitwise the same losses, the final trainable params and
   optimizer state bitwise the first run's; a save torn by a
   `FaultSchedule` (`torn` rate 1) and the restore falling back to the
   intact step; the codec, file bytes, save and restore seconds and the
   host's peak RSS.

24. gemma3-4b served at full width (34 layers: the 29 local ones from
   per-slot rings of 1024 slots, the 5 global ones from pages of 64)
   through the serve launcher's `build_engine`: 4 slots, prefix_mode
   off, greedy, 4 requests of 1088 + 32 tokens (every ring wraps in
   prefill) and 4 of 128 + 32; all complete, no port kernel launched;
   then at published widths cut to one super-block (6 layers) in f32, 3
   requests (the 1088-token prompt and two of 128) on 2 slots against
   the contiguous prefill + decode_step oracle, every sampled step's
   top-2 gap probed;
25. rwkv6-3b served at full width (32 layers, state only: no pages), 4
   slots, pages of 16, 8 requests of 128 + 32: exactly 32 wkv6 launches
   (the forward's state form) a prefill chunk and a decode step, no
   other port kernel; the oracle at 4 layers in f32;
26. deepseek-moe-16b at full width and the jamba cut of phase 12e (one
   super-block of 8 layers: 7 mamba layers with per-slot state, the
   attention layer on pages; 4 of 16 experts) with one more request of
   a 3-token prompt (shorter than d_conv - 1), the same traffic as phase
   25; then the oracles in f32 (deepseek cut to 4 layers, the jamba cut
   further to 4 layers and 2 experts), with the capacity factor at E / k
   (no choice dropped on either side) and the router near-tie probe: a
   difference where some routing's k-th and (k+1)-th probabilities lie
   within 1e-5 is reported, not failed;
27. flash-decoding: phase 13's run A (full-width llama3-8b, 8 x (128 +
   32)) plain and with `--flash-decode` on one copy of the weights: the
   plain run's tokens bitwise run A's, the flash run's equal except at a
   printed near tie (the plain top-2 gap at the first differing token no
   larger than twice the two runs' largest logit difference there); the
   decode-step medians side by side.

Each serving phase prints the decode-step median, prefill and decode
tokens/s, the peak memory and the card's name and power limit, and frees
its model before the next. The long-sequence phases 16-23, and the
serving phases 24-27 after them, run last, so that the profiler windows
of the earlier phases open where they did before them (a window can lose
kernels, more often late in the process; PERF.md §6).

Phase 3 also holds the expert-batched dW (`batched_dw`) against its plain
version at the three expert leaf shapes of the MoE path (64 experts,
capacity 481), the block scatter-update in place and out of place
bitwise against its plain version at the online wave's 7 leaf shapes of
full-width llama3-8b and at an fp32, a lead-dim, an unaligned and a
duplicate-index case, and the WKV recurrence forward
and backward against its plain version and torch.autograd of it at the
rwkv path's shapes (batch 4 x 1024 steps x 40 heads x 64, fp32), with w
down to 1e-12, with T = 1001 and with T = 1 and T one step either side of
the kernels' chunk of 16 steps, and two calls bitwise equal; and the
forward's state form (serving: s0 in, s_last out) against the plain
version with a nonzero s0 at B = 4 slots, 40 heads and T = 1, 16 and
128, timed at T = 1 (B = 4) and T = 16 (B = 1).

The last lines are one JSON object with every kernel's numbers, and then
`{"ok": true, "device": {...}}`.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
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
M_LONG = 32768             # the dW at long M
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
RWKV_ARGV = ["--arch", "rwkv6-3b"] + MAIN_ARGV[2:]
MOE_J = 2                  # the first fixed phase of the MoE run
C_LONG = 8192              # the batched dW at a long capacity
# the LM at the reference's train_4k shape (seq 4096, past the dense path's
# 2048: the flash path): its global batch of 256 is a pod's, cut to 2
TRAIN4K_ARGV = ["--arch", "llama3-8b", "--steps", "6", "--batch", "2",
                "--seq", "4096"] + MAIN_ARGV[8:]
PREFILL_TOKENS = 32768     # the reference's prefill_32k, batch 32 cut to 1
# the gemma path: full-width gemma3-4b (34 layers), batch 1 x seq 4096 (the
# flash path; the 1024-token window restricts the local layers to 3 of 8
# diagonals), K = 5 scan steps (the 4-layer tail and the last super-block,
# which holds a global layer)
GEMMA_K = 5
GEMMA_TOKENS = 1 * 4096
GEMMA_ARGV = ["--arch", "gemma3-4b", "--steps", "6", "--batch", "1",
              "--seq", "4096", "--compact-grads",
              "--update-layers", str(GEMMA_K), "--update-ratio", "0.2",
              "--channel-block", "128", "--optimizer", "adamw",
              "--phase-j", "2", "--phase-k", "2", "--log-every", "1",
              "--seed", "0"]
# the jamba path: jamba-1.5-large-398b at published widths, cut to one
# super-block (72 -> 8 layers) and 16 -> 4 experts (jamba_cut), one
# super-block trainable, SGD (the paper's optimizer, lr 0.1), batch 2 x
# seq 1024
JAMBA_LAYERS, JAMBA_EXPERTS = 8, 4
JAMBA_TOKENS = 2 * 1024
JAMBA_J = 2                # the first fixed phase of the jamba run
JAMBA_ARGV = ["--arch", "jamba-1.5-large-398b", "--steps", "6", "--batch",
              "2", "--seq", "1024", "--compact-grads", "--update-layers",
              "1", "--update-ratio", "0.2", "--channel-block", "128",
              "--optimizer", "sgd", "--lr", "0.1", "--phase-j",
              str(JAMBA_J), "--phase-k", "2", "--log-every", "1",
              "--seed", "0"]
# the reference's other text-only archs at its train_4k shape, batch 1,
# K = 2: nemotron-4-15b at full depth; command-r-35b cut 40 -> 24 layers
# (the uncut 60.6 GB of bf16 params, the tied head's 8.4 GB fp32 copy in
# the loss and AdamW's state leave no room for a step's activations);
# llama4-scout-17b-a16e cut 48 -> 8 layers with all 16 experts (~108 B
# params uncut) and SGD, the paper's optimizer (AdamW's fp32 state on one
# 2.2 B-param layer alone is ~17.6 GB). The cuts pass to the launcher as
# `model=`; the config files keep the published depths.
TEXT_ARGV = ["--steps", "6", "--batch", "1", "--seq", "4096"] + MAIN_ARGV[8:]
NEMOTRON_ARGV = ["--arch", "nemotron-4-15b"] + TEXT_ARGV
COMMAND_R_LAYERS = 24
COMMAND_R_ARGV = ["--arch", "command-r-35b"] + TEXT_ARGV
SCOUT_LAYERS = 8
SCOUT_J = 2                # the first fixed phase of the llama4-scout run
SCOUT_ARGV = ["--arch", "llama4-scout-17b-a16e", "--steps", "6", "--batch",
              "1", "--seq", "4096", "--compact-grads", "--update-layers",
              str(K_LAYERS), "--update-ratio", "0.2", "--channel-block",
              "128", "--optimizer", "sgd", "--lr", "0.1", "--phase-j",
              str(SCOUT_J), "--phase-k", "2", "--log-every", "1", "--seed",
              "0"]
# the audio and vlm archs at the reference's train_4k shape, full depth,
# batch 2 x seq 4096 (the LM's train_4k cut), K = 2, AdamW; the launcher
# takes their embedding inputs through `main(argv, batches=...)`
# (embed_batches), qwen2-vl's positions a patch grid and then text
# (mrope_positions)
AV_ARGV = ["--steps", "6", "--batch", "2", "--seq", "4096"] + MAIN_ARGV[8:]
MUSICGEN_ARGV = ["--arch", "musicgen-medium"] + AV_ARGV
QWEN_ARGV = ["--arch", "qwen2-vl-7b"] + AV_ARGV
MROPE_GRID = 32
SERVE_RATIO = 0.25         # the serving launcher's per-user update ratio
# name -> (route, source, the TPU kernel it replaces, the path that launches
# it). block_sparse_dw also replaces block_sparse_dw_pipelined_kernel
# (masked_dw.py:131) with its pipelined (TMA + wgmma) instance, which the
# wrapper picks for every bf16 call whose rows, block and bases suit TMA
# wherever the shape is aligned; batched_dw, the same source's expert entry
# point, likewise replaces batched_dw_pipelined_kernel (batched_dw.py:130).
# block_act_prune_bwd is the same kernel's backward entry point (the
# reference differentiates its jnp version), and wkv6_bwd the WKV source's
# (the TPU kernel has no backward; the reference differentiates its scan).
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
    "wkv6": ("cuda", "src/repro_torch/kernels/csrc/wkv6.cu",
             "src/repro/kernels/wkv6_chunk.py:80", "rwkv"),
    "wkv6_bwd": ("cuda", "src/repro_torch/kernels/csrc/wkv6.cu",
                 "src/repro/kernels/wkv6_chunk.py:80", "rwkv"),
}
# kernels with a one-call PyTorch yardstick (library_ms)
LIBRARY = ("block_sparse_dw", "batched_dw", "block_scatter_update")
# the port's kernels as the profiler names them
PORT_KERNELS = ("batched_dw_grid_kernel", "batched_dw_tma_kernel",
                "dw_grid_kernel", "dw_tma_kernel",
                "fused_block_opt_kernel", "prune_kernel",
                "scatter_columns_kernel",
                "wkv6_fwd_chunk_kernel", "wkv6_bwd_scan_kernel",
                "wkv6_bwd_chunk_kernel")
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


def _rows(prof) -> list:
    """The profile's kernel rows (a CPU op's row repeats its kernels'
    device time)."""
    from torch.autograd import DeviceType
    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]


# windows that lose kernels come at random, more often late in a long
# process (PERF.md §6-7): a window that lost one is profiled again, up to
# this many windows in all
PROFILE_ATTEMPTS = 8


def device_ms(fn, reps: int = 20, warmup: int = 2, flush=None,
              kernel=None) -> float:
    """The card's time per call: the device time of every kernel `fn`
    launches, from torch.profiler over `reps` calls. Where the host takes
    longer to submit a call than the card takes to run it (a small
    element-wise kernel), CUDA events around back-to-back calls time the
    host; this times the card. flush: a tensor larger than the 50 MB L2,
    zeroed before every call (its fill kernel is not counted), so that the
    call reads its inputs from device memory, as the byte bound assumes.
    kernel: (name, launches per call) of a port kernel `fn` launches; the
    window must hold all reps x launches of it, else it is profiled again
    (at most PROFILE_ATTEMPTS times): a profiler window on the card can
    lose kernels (PERF.md §6), and one that did would time fewer calls
    than reps."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                if flush is not None:
                    flush.zero_()
                fn()
            torch.cuda.synchronize()
        rows = _rows(prof)
        if kernel is None:
            break
        name, per_call = kernel
        seen = sum(e.count for e in rows if name in e.key)
        if seen == reps * per_call:
            break
        print(f"[profile] the window recorded {seen} of {reps * per_call} "
              f"{name} launches: profiled again", flush=True)
    else:
        raise SmokeError(f"{PROFILE_ATTEMPTS} profiler windows lost {name} "
                         f"launches")
    us = sum(_dev_us(e) for e in rows
             if not (flush is not None and "FillFunctor" in e.key))
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


def _dense_leaves(arch: str, ratio: float = 0.2, block: int = 128,
                  model=None, seg: str = "blocks") -> dict:
    """{group/leaf: (fan_in, out, SelSpec)} of the dense (not per-expert)
    selectable leaves of one trainable step of segment `seg` of `arch` (or
    of `model`, a cut of it), as its plan gives them with the paths' flags
    (update ratio, channel block). A super-block's `sub{i}` levels are
    dropped: each leaf shape is listed once."""
    import re
    from repro_torch.configs import SparseUpdateConfig, get_config
    from repro_torch.core.selection import build_plan
    from repro_torch.models.registry import abstract_params
    cfg = model or get_config(arch)
    plan = build_plan(cfg, SparseUpdateConfig(update_ratio=ratio,
                                              num_update_layers=K_LAYERS,
                                              channel_block=block))
    found = {}

    def walk(spec, shapes, path):
        if isinstance(spec, dict):
            for name in spec:
                sub = path if re.fullmatch(r"sub\d+", name) else (
                    f"{path}/{name}" if path else name)
                walk(spec[name], shapes[name], sub)
        elif len(shapes.shape) == 3:      # [L, fan_in, out]; experts are 4-D
            found.setdefault(path, tuple(shapes.shape[1:]) + (spec,))

    walk(plan.spec[seg], abstract_params(cfg)["segments"][seg], "")
    return found


def jamba_cut(experts: int = JAMBA_EXPERTS, period: int = JAMBA_LAYERS):
    """jamba-1.5-large-398b at published widths cut to one super-block and
    `experts` routed experts (16 in the config): the 16-expert super-block
    alone holds ~45 B params, ~90 GB in bf16. period: the super-block's
    layers (8 in the config; attention at period // 2, MoE at the odd
    indices); fewer only for the compact-against-dense-scatter check, whose
    full-shape gradients and updated copy of every trainable leaf do not
    fit beside an 8-layer super-block."""
    from repro_torch.configs import get_config
    cfg = get_config("jamba-1.5-large-398b")
    return dataclasses.replace(
        cfg, num_layers=period, attn_every=period,
        moe=dataclasses.replace(cfg.moe, num_experts=experts))


def _main_path_leaves() -> dict:
    """{leaf: (fan_in, out, SelSpec)} of one trainable llama3-8b layer, as
    the main path's plan gives them."""
    return {path.split("/")[-1]: leaf
            for path, leaf in _dense_leaves("llama3-8b").items()}


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
    # the CNN phases' results are functions of their seeds: deterministic
    # cuDNN algorithms only, none picked by timing
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    print(f"[env] device={torch.cuda.get_device_name(0)} "
          f"count={torch.cuda.device_count()} "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"cudnn.deterministic={torch.backends.cudnn.deterministic} "
          f"cudnn.benchmark={torch.backends.cudnn.benchmark}", flush=True)


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


def _dw_case(tag, x, dy, idx, spec, want_inst: str, reps: int = 20,
             profiled: bool = True):
    """One dW call shape: the instance the wrapper picks must be
    `want_inst`; each instance that can take the call against the plain
    version (fp32 sums over M in another order: 1e-4 of the largest output),
    the picked one twice, bitwise equal. Times are the card's (profiler
    device time over `reps` calls): CUDA events around back-to-back calls
    also count the gaps between launches, ~5 us a call, a seventh of the
    smallest leaves' time; the events' time is returned beside.
    profiled=False: CUDA events only (ms is events_ms), one profiler
    window fewer per call. Returns ({instance: (ms, err, events_ms)},
    plain_ms, tol)."""
    from repro_torch.kernels import ops, ref
    batched = x.dim() == 3
    fn = ops.block_sparse_dw_batched if batched else ops.block_sparse_dw
    plain_fn = ref.batched_dw_ref if batched else ref.block_sparse_dw_ref
    picked = "pipelined" if ops.use_pipelined(x, dy, spec.block) else "grid"
    check(picked == want_inst, f"dW {tag}: the wrapper picks {picked}, "
                               f"want {want_inst}")
    want = plain_fn(x, dy, idx, spec.block)
    tol = 1e-4 * float(want.abs().max())
    res = {}
    for inst in ("pipelined", "grid") if picked == "pipelined" else ("grid",):
        got = fn(x, dy, idx, spec, pipelined=inst == "pipelined")
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(got.shape == want.shape and err <= tol,
              f"dW {inst} {tag}: max_abs_err {err} > {tol}")
        if inst == picked:
            again = fn(x, dy, idx, spec)
            check(torch.equal(got, again),
                  f"dW {inst} {tag}: two calls differ")
        call = functools.partial(fn, x, dy, idx, spec,
                                 pipelined=inst == "pipelined")
        ev = cuda_ms(call, reps=reps)
        res[inst] = (device_ms(call, reps=reps, kernel=("dw_", 1))
                     if profiled else ev, err, ev)
        del got
    if picked == "grid":
        try:
            fn(x, dy, idx, spec, pipelined=True)
        except ValueError:
            pass
        else:
            raise SmokeError(f"dW {tag}: the pipelined instance took a call "
                             f"it cannot run")
    plain_call = lambda: plain_fn(x, dy, idx, spec.block)
    plain = device_ms(plain_call, reps=reps) if profiled \
        else cuda_ms(plain_call, reps=reps)
    del want
    return res, plain, tol


def _dw_bound(m, fan_in, spec, experts: int, dtype):
    """(flops, bytes, bound_ms, bound_by) of one dW call: x once, the
    selected dy columns once, idx, the fp32 output."""
    cols = spec.n_shards * spec.n_sel * spec.block
    size = 2 if dtype == torch.bfloat16 else 4
    flops = 2.0 * experts * m * fan_in * cols
    nbytes = experts * m * (fan_in + cols) * size \
        + spec.n_shards * spec.n_sel * 4 + experts * fan_in * cols * 4
    return (flops, nbytes) + bound_ms(flops, nbytes, _dname(dtype))


# the dW paths timed with CUDA events only (check_dw)
EVENTS_ONLY = ("lm-train4k", "nemotron", "command-r", "scout", "musicgen",
               "qwen2-vl")


def check_dw(leaves: dict, gen, sums: dict):
    """The dense dW at every leaf shape of one trainable layer of the LM
    (llama3-8b, bf16 and fp32), MoE (deepseek-moe-16b: 4 attention and 3
    shared-expert leaves), rwkv (rwkv6-3b: 8 leaves), gemma (gemma3-4b:
    wq, wk, wv, wo, w_up, w_down), nemotron-4-15b (6 leaves),
    command-r-35b (7) and llama4-scout (4 attention and 3 shared-expert
    leaves) paths at M = 4096, of the LM, musicgen-medium (6 leaves) and
    qwen2-vl-7b (7) at train_4k (M = 8192) and of the
    jamba cut (mamba in_proj / out_proj, 4 attention and 3 dense FFN
    leaves) at its M = 2048:
    bf16 takes the pipelined (TMA + wgmma) instance, fp32 the grid one
    (exact products), each held against the plain version. The LM's bf16
    times go into the sums; each path's sums are printed. The train_4k and
    text-arch leaves are timed with CUDA events only: a profiler window on
    this card can lose kernels (PERF.md §7), and every window more is one
    more chance of a spurious failure."""
    from repro_torch.kernels import ref
    bf16 = (torch.bfloat16,)
    paths = (("lm", leaves, (torch.bfloat16, torch.float32), M_TOKENS),
             ("moe", _dense_leaves("deepseek-moe-16b"), bf16, M_TOKENS),
             ("rwkv", _dense_leaves("rwkv6-3b"), bf16, M_TOKENS),
             ("gemma", _dense_leaves("gemma3-4b", seg="tail"), bf16,
              GEMMA_TOKENS),
             ("jamba", _dense_leaves("", model=jamba_cut()), bf16,
              JAMBA_TOKENS),
             ("lm-train4k", leaves, bf16, 2 * 4096),
             ("nemotron", _dense_leaves("nemotron-4-15b"), bf16, 4096),
             ("command-r", _dense_leaves("command-r-35b"), bf16, 4096),
             ("scout", _dense_leaves("llama4-scout-17b-a16e"), bf16, 4096),
             ("musicgen", _dense_leaves("musicgen-medium"), bf16, 2 * 4096),
             ("qwen2-vl", _dense_leaves("qwen2-vl-7b"), bf16, 2 * 4096))
    for path, path_leaves, dtypes, m in paths:
        for dtype in dtypes:
            tot = {"ms": 0.0, "events_ms": 0.0, "library_ms": 0.0,
                   "bound_ms": 0.0}
            for leaf, (fan_in, out, spec) in path_leaves.items():
                x = torch.randn(m, fan_in, generator=gen,
                                device="cuda").to(dtype)
                dy = torch.randn(m, out, generator=gen,
                                 device="cuda").to(dtype)
                idx = _rand_idx((spec.n_shards,), spec, gen)
                main = "pipelined" if dtype == torch.bfloat16 else "grid"
                profiled = path not in EVENTS_ONLY
                res, plain, tol = _dw_case(f"{path} {leaf} {_dname(dtype)}",
                                           x, dy, idx, spec, main,
                                           profiled=profiled)
                dy_sel = ref.gather_dy_blocks(dy, idx, spec.block).reshape(
                    m, -1).contiguous()
                lib = (device_ms if profiled else cuda_ms)(
                    lambda: torch.matmul(x.t(), dy_sel))
                flops, nbytes, b_ms, b_by = _dw_bound(m, fan_in, spec, 1,
                                                      dtype)
                for inst, (ms, err, ev) in res.items():
                    print(f"[kernel] block_sparse_dw {inst} {path} {leaf} "
                          f"{_dname(dtype)} M={m} K={fan_in} N={out} "
                          f"n_sel={spec.n_sel} block={spec.block} "
                          f"main_path={inst == main} kernel_ms={ms:.4f} "
                          f"events_ms={ev:.4f} "
                          f"plain_ms={plain:.4f} library_ms={lib:.4f} "
                          f"bound_ms={b_ms:.4f} ({b_by}) max_abs_err={err:.3e}"
                          f" tol={tol:.3e}", flush=True)
                ms, err, ev = res[main]
                tot["ms"] += ms
                tot["events_ms"] += ev
                tot["library_ms"] += lib
                tot["bound_ms"] += b_ms
                if path == "lm" and dtype == torch.bfloat16:
                    for key, val in (("ms", ms), ("plain_ms", plain),
                                     ("library_ms", lib), ("flops", flops),
                                     ("bytes", nbytes)):
                        sums[key] += val
                    sums["max_abs_err"] = max(sums["max_abs_err"], err)
                del x, dy, dy_sel
            print(f"[kernel] block_sparse_dw {path} {_dname(dtype)} sum over "
                  f"{len(path_leaves)} leaves: kernel_ms={tot['ms']:.4f} "
                  f"events_ms={tot['events_ms']:.4f} "
                  f"library_ms={tot['library_ms']:.4f} "
                  f"bound_ms={tot['bound_ms']:.4f}", flush=True)


def check_dw_long(leaves: dict, gen):
    """Both instances at M = 32768 rows, bf16."""
    for leaf in ("wk", "w_down"):
        fan_in, out, spec = leaves[leaf]
        x = torch.randn(M_LONG, fan_in, generator=gen,
                        device="cuda").to(torch.bfloat16)
        dy = torch.randn(M_LONG, out, generator=gen,
                         device="cuda").to(torch.bfloat16)
        idx = _rand_idx((spec.n_shards,), spec, gen)
        res, _, tol = _dw_case(f"{leaf} M={M_LONG}", x, dy, idx, spec,
                               "pipelined", reps=3)
        for inst, (ms, err, _) in res.items():
            print(f"[kernel] block_sparse_dw {inst} {leaf} bfloat16 "
                  f"M={M_LONG} K={fan_in} N={out} n_sel={spec.n_sel} "
                  f"kernel_ms={ms:.4f} max_abs_err={err:.3e} tol={tol:.3e}",
                  flush=True)
        del x, dy


def _layout_probe(e: int, m: int, fan_in: int, spec, gen):
    """Structured inputs that show where each product lands: x rows one-hot
    (x[e, i, i] = 1 for i < min(m, fan_in)), dy a ramp of its own column
    index, then of its own row index (small integers, exact in bf16), so
    out[e, k, c] is dy[e, k, column of c]; held bitwise against the plain
    version."""
    from repro_torch.kernels import ops, ref
    n = spec.n_shards * spec.n_blocks * spec.block
    x = torch.zeros(e, m, fan_in, device="cuda")
    diag = torch.arange(min(m, fan_in), device="cuda")
    x[:, diag, diag] = 1
    x = x.to(torch.bfloat16)
    idx = _rand_idx((spec.n_shards,), spec, gen)
    idx[-1, -1] = spec.n_blocks - 1
    cols = torch.arange(n, device="cuda") % 128 + 64 * torch.arange(
        e, device="cuda")[:, None]
    rows = torch.arange(m, device="cuda") % 128 + 64 * torch.arange(
        e, device="cuda")[:, None]
    for tag, dy in (("column ramp", cols[:, None, :].expand(e, m, n)),
                    ("row ramp", rows[:, :, None].expand(e, m, n))):
        dy = dy.to(torch.bfloat16).contiguous()
        if e == 1:
            got = ops.block_sparse_dw(x[0], dy[0], idx, spec, pipelined=True)
            want = ref.block_sparse_dw_ref(x[0], dy[0], idx, spec.block)
        else:
            got = ops.block_sparse_dw_batched(x, dy, idx, spec,
                                              pipelined=True)
            want = ref.batched_dw_ref(x, dy, idx, spec.block)
        torch.cuda.synchronize()
        check(torch.equal(got, want),
              f"dW layout probe ({tag}, E={e}, M={m}, K={fan_in}): "
              f"{int((got != want).sum())} of {got.numel()} differ")
    print(f"[kernel] dW layout probe E={e} M={m} K={fan_in} "
          f"n_shards={spec.n_shards} n_sel={spec.n_sel} block={spec.block}: "
          f"column and row ramps bitwise equal", flush=True)


def check_dw_edges(gen):
    """The dW's edge cases: the layout probes (dense and batched, two
    shards, the last block selected, ragged rows and columns, both tile
    widths); two shards
    with the last block selected at full size; a base pointer one element
    off alignment, the serving wave's block 8, block 96 (a packed tile
    ends inside a block), a ragged fan-in (K = 4100 in bf16, 4099 in fp32:
    element loads), a ragged width (block 60: N = 14340) and fp32 experts
    at capacity 17 (all take the grid instance and refuse the pipelined
    one); bf16 experts at capacity 17."""
    from repro_torch.core.sparse_update import SelSpec
    spec2 = SelSpec(block=128, n_shards=2, n_sel=3, n_blocks=16)
    _layout_probe(1, 256, 256, spec2, gen)
    _layout_probe(3, 130, 200, SelSpec(block=64, n_shards=2, n_sel=3,
                                       n_blocks=4), gen)
    _layout_probe(1, 64, 128, SelSpec(block=256, n_shards=1, n_sel=2,
                                      n_blocks=3), gen)
    # long enough, and tiles enough, for the 256-column tile
    _layout_probe(1, 1024, 4096, SelSpec(block=128, n_shards=1, n_sel=18,
                                         n_blocks=20), gen)
    fan_in, n = 4096, 2 * 16 * 128
    x = torch.randn(M_TOKENS, fan_in, generator=gen,
                    device="cuda").to(torch.bfloat16)
    dy = torch.randn(M_TOKENS, n, generator=gen,
                     device="cuda").to(torch.bfloat16)
    idx = _rand_idx((2,), spec2, gen)
    idx[-1, -1] = spec2.n_blocks - 1
    cases = [("two shards, last block", x, dy, idx, spec2, "pipelined")]
    # one element off: every row of x starts off 16-byte alignment
    xs = torch.empty(M_TOKENS * fan_in + 1, device="cuda",
                     dtype=torch.bfloat16)[1:].view(M_TOKENS, fan_in)
    xs.copy_(x)
    cases.append(("x one element off alignment", xs, dy, idx, spec2, "grid"))
    fan_w, out_w, spec_w = _wave_leaves()["w_gate"]
    cases.append(("serving wave w_gate block 8 M=16",
                  torch.randn(16, fan_w, generator=gen, device="cuda")
                  .to(torch.bfloat16),
                  torch.randn(16, out_w, generator=gen, device="cuda")
                  .to(torch.bfloat16),
                  _rand_idx((spec_w.n_shards,), spec_w, gen), spec_w,
                  "grid"))
    for tag, fan_in, block, n_blocks, n_sel, dtype in (
            ("block 96", 4096, 96, 144, 29, torch.bfloat16),
            ("ragged fan-in K=4100", 4100, 128, 112, 22, torch.bfloat16),
            ("ragged fan-in K=4099", 4099, 128, 112, 22, torch.float32),
            ("ragged width block 60 N=14340", 4096, 60, 239, 48,
             torch.bfloat16)):
        spec = SelSpec(block=block, n_shards=1, n_sel=n_sel,
                       n_blocks=n_blocks)
        idx_r = _rand_idx((1,), spec, gen)
        idx_r[-1, -1] = n_blocks - 1
        cases.append((f"{tag} {_dname(dtype)}",
                      torch.randn(M_TOKENS, fan_in, generator=gen,
                                  device="cuda").to(dtype),
                      torch.randn(M_TOKENS, n_blocks * block, generator=gen,
                                  device="cuda").to(dtype),
                      idx_r, spec, "grid"))
    e, _, moe = _moe_leaves()
    fan_g, out_g, spec_g = moe["w_gate"]
    for dtype, want in ((torch.bfloat16, "pipelined"),
                        (torch.float32, "grid")):
        xb, dyb, idxb = _batched_case(e, 17, fan_g, out_g, spec_g, dtype,
                                      gen)
        cases.append((f"experts E={e} C=17 {_dname(dtype)}", xb, dyb, idxb,
                      spec_g, want))
    from repro_torch.kernels import ref
    for tag, xc, dyc, idxc, spec, want in cases:
        res, plain, tol = _dw_case(tag, xc, dyc, idxc, spec, want)
        # the library call in the call's type, on a pre-gathered dy_sel
        n = dyc.shape[-1]
        dy_sel = ref.gather_dy_blocks(dyc.reshape(-1, n), idxc,
                                      spec.block).reshape(
            dyc.shape[:-1] + (-1,)).contiguous()
        lib = device_ms(lambda: torch.matmul(xc.transpose(-1, -2), dy_sel))
        print(f"[kernel] dW {tag}: picked {want}; "
              + "; ".join(f"{inst} kernel_ms={ms:.4f} max_abs_err="
                          f"{err:.3e}" for inst, (ms, err, _) in res.items())
              + f" tol={tol:.3e} plain_ms={plain:.4f} library_ms={lib:.4f}",
              flush=True)
        del dy_sel
    del x, dy, xs, xb, dyb, cases


def check_dw_wave(gen):
    """The grid instance at the serving wave's 7 leaves of full-width
    llama3-8b (M = 16 train tokens, r = 0.25, block 8), in bf16 (the
    wave's type) and in fp32 (the f32 wave and the oracle's): each against
    the plain version, two calls bitwise equal, timed beside torch.matmul
    on a pre-gathered dy and its bound; a wave makes these 7 calls for
    each of its K trainable layers."""
    from repro_torch.kernels import ref
    m = 16
    for dtype in (torch.bfloat16, torch.float32):
        tot = {"ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0, "bytes": 0.0}
        for leaf, (fan_in, out, spec) in _wave_leaves().items():
            x = torch.randn(m, fan_in, generator=gen,
                            device="cuda").to(dtype)
            dy = torch.randn(m, out, generator=gen, device="cuda").to(dtype)
            idx = _rand_idx((spec.n_shards,), spec, gen)
            res, plain, tol = _dw_case(f"wave {leaf} {_dname(dtype)}", x,
                                       dy, idx, spec, "grid")
            ms, err, ev = res["grid"]
            dy_sel = ref.gather_dy_blocks(dy, idx, spec.block).reshape(
                m, -1).contiguous()
            lib = device_ms(lambda: torch.matmul(x.t(), dy_sel))
            _, nbytes, b_ms, b_by = _dw_bound(m, fan_in, spec, 1, dtype)
            print(f"[kernel] block_sparse_dw grid wave {leaf} "
                  f"{_dname(dtype)} M={m} K={fan_in} N={out} "
                  f"n_sel={spec.n_sel} block={spec.block} kernel_ms={ms:.4f} "
                  f"events_ms={ev:.4f} plain_ms={plain:.4f} "
                  f"library_ms={lib:.4f} bound_ms={b_ms:.4f} ({b_by}) "
                  f"max_abs_err={err:.3e} tol={tol:.3e}", flush=True)
            for key, val in (("ms", ms), ("library_ms", lib),
                             ("bound_ms", b_ms), ("bytes", nbytes)):
                tot[key] += val
            del x, dy, dy_sel
        print(f"[kernel] block_sparse_dw grid wave {_dname(dtype)} sum over "
              f"7 leaves: kernel_ms={tot['ms']:.4f} "
              f"library_ms={tot['library_ms']:.4f} "
              f"bound_ms={tot['bound_ms']:.4f} bytes={tot['bytes']:.0f}; "
              f"a wave's {K_LAYERS * 7} calls: "
              f"kernel_ms={K_LAYERS * tot['ms']:.4f} "
              f"bound_ms={K_LAYERS * tot['bound_ms']:.4f}", flush=True)


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
                t = {k: device_ms(fn, flush=flush, kernel=None if "plain"
                                  in k else ("prune_kernel", 1))
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


def _moe_leaves(arch: str = "deepseek-moe-16b", model=None,
                tokens: int = M_TOKENS, group=("moe",)):
    """(experts, capacity, {leaf: (fan_in, out, SelSpec)}) of the routed
    experts of one trainable layer of `arch` (or `model`, a cut of it), as
    the path's plan and its batch of `tokens` tokens give them; `group` is
    the path to the layer's MoE params inside a stacked step."""
    from repro_torch.configs import SparseUpdateConfig, get_config
    from repro_torch.core.selection import build_plan
    from repro_torch.models import moe
    from repro_torch.models.registry import abstract_params
    cfg = model or get_config(arch)
    plan = build_plan(cfg, SparseUpdateConfig(update_ratio=0.2,
                                              num_update_layers=K_LAYERS,
                                              channel_block=128))
    shapes = abstract_params(cfg)["segments"]["blocks"]
    spec = plan.spec["blocks"]
    for key in group:
        shapes, spec = shapes[key], spec[key]
    leaves = {name: tuple(shapes[name].shape[2:]) + (spec[name],)
              for name in ("w_gate", "w_up", "w_down")}
    mc = cfg.moe
    return (mc.num_experts,
            moe._capacity(tokens, mc.top_k, mc.capacity_factor,
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


def check_batched_dw(gen, sums: dict):
    """The expert-batched dW at the three expert leaf shapes of the MoE path
    (E = 64, capacity 481, bf16: the pipelined instance, and the grid one
    beside it), of the jamba cut (E = 4, capacity 1281 for 2048 tokens
    top-2) and of llama4-scout (E = 16, capacity 321 for 4096 tokens
    top-1), an fp32 case and one with its base pointers off alignment
    (both take the grid instance and refuse the pipelined one), one at a
    long capacity, and the dense-scatter form's dW, exactly zero outside the
    selected blocks. The bf16 main-path times go into the sums."""
    from repro_torch.core.sparse_update import gather_param_blocks, smm
    from repro_torch.kernels import ops, ref
    jamba = _moe_leaves(model=jamba_cut(), tokens=JAMBA_TOKENS,
                        group=("sub1", "moe"))
    scout = _moe_leaves("llama4-scout-17b-a16e", tokens=4096)
    paths = {"moe": _moe_leaves(), "jamba": jamba, "scout": scout}
    cases = [("moe", leaf, torch.bfloat16, 0, "pipelined")
             for leaf in paths["moe"][2]] + \
        [("moe", "w_gate", torch.float32, 0, "grid"),
         ("moe", "w_gate", torch.bfloat16, 1, "grid")] + \
        [(path, leaf, torch.bfloat16, 0, "pipelined")
         for path in ("jamba", "scout") for leaf in paths[path][2]]
    for path, leaf, dtype, offset, main in cases:
        e, c, leaves = paths[path]
        fan_in, out, spec = leaves[leaf]
        x, dy, idx = _batched_case(e, c, fan_in, out, spec, dtype, gen,
                                   offset)
        tag = f"{path} experts {leaf} {_dname(dtype)}" + (
            " base pointers off alignment" if offset else "")
        profiled = path not in EVENTS_ONLY
        res, plain, tol = _dw_case(tag, x, dy, idx, spec, main,
                                   profiled=profiled)
        dy_sel = ref.gather_dy_blocks(dy.reshape(e * c, out), idx,
                                      spec.block).reshape(e, c, -1)
        dy_sel = dy_sel.contiguous()
        lib = (device_ms if profiled else cuda_ms)(
            lambda: torch.bmm(x.transpose(1, 2), dy_sel))
        flops, nbytes, b_ms, b_by = _dw_bound(c, fan_in, spec, e, dtype)
        for inst, (ms, err, ev) in res.items():
            print(f"[kernel] batched_dw {inst} {tag} E={e} C={c} K={fan_in} "
                  f"N={out} n_sel={spec.n_sel} block={spec.block} "
                  f"main_path={inst == main} kernel_ms={ms:.4f} "
                  f"events_ms={ev:.4f} "
                  f"plain_ms={plain:.4f} library_ms={lib:.4f} "
                  f"bound_ms={b_ms:.4f} ({b_by}) max_abs_err={err:.3e} "
                  f"tol={tol:.3e}", flush=True)
        if path == "moe" and dtype == torch.bfloat16 and not offset:
            ms, err, _ = res[main]
            for key, val in (("ms", ms), ("plain_ms", plain),
                             ("library_ms", lib), ("flops", flops),
                             ("bytes", nbytes)):
                sums[key] += val
            sums["max_abs_err"] = max(sums["max_abs_err"], err)
        del x, dy, dy_sel

    e, c, leaves = _moe_leaves()
    fan_in, out, spec = leaves["w_gate"]
    x, dy, idx = _batched_case(8, C_LONG, fan_in, out, spec, torch.bfloat16,
                               gen)
    res, _, tol = _dw_case(f"experts w_gate C={C_LONG}", x, dy, idx, spec,
                           "pipelined", reps=3)
    for inst, (ms, err, _) in res.items():
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
    return {path.split("/")[-1]: leaf for path, leaf in
            _dense_leaves("llama3-8b", SERVE_RATIO, 8).items()}


def _scatter_bytes(w, upd, idx, spec) -> tuple[int, int]:
    """(in place, out of place) bytes the function must move on these
    inputs: upd's values for the selected blocks and idx read; in place the
    selected elements of w written, out of place the rest of w read and
    all of out written."""
    k, n = w.shape[0], w.shape[-1]
    r = w[0].numel() // n
    sel = int(_selected_mask(w.view(k, r, n), idx, spec).sum())
    es = w.element_size()
    read = sel * upd.element_size() + idx.numel() * 4
    return read + sel * es, read + (w.numel() - sel) * es + w.numel() * es


def _scatter_case(tag, w, upd, idx, spec, flush, timed=False):
    """Both modes of the kernel against its plain version on one input,
    bitwise: in place, every unselected element keeps its bits; out of
    place, every element of `out` is the plain version's and w keeps its
    bits. Returns {mode: (ms, library_ms)}, "plain", "before" (the out-of-
    place function as clone + the in-place kernel) and the bytes of both
    modes when `timed`."""
    from repro_torch.kernels import ops, ref
    k, n = w.shape[0], w.shape[-1]
    r = w[0].numel() // n
    w3, u5 = w.view(k, r, n), upd.view(k, r, spec.n_shards, spec.n_sel,
                                       spec.block)
    ib = torch.int16 if w.dtype == torch.bfloat16 else torch.int32
    bits = lambda t: t.view(k, r, n).view(ib)
    want = ref.block_scatter_update_ref(w3, u5, idx, spec.block)
    got = w.clone()
    ops.block_scatter_update(got, upd, idx, spec)
    before = w.clone()
    out = torch.full_like(w, 7.0)
    check(ops.block_scatter_update(w, upd, idx, spec, out=out) is out,
          f"block_scatter_update {tag}: out of place returned another tensor")
    torch.cuda.synchronize()
    for mode, t in (("in place", got), ("out of place", out)):
        check(torch.equal(bits(t), bits(want)),
              f"block_scatter_update {tag} {mode}: not bitwise equal to the "
              f"plain version")
    mask = _selected_mask(w3, idx, spec)
    check(torch.equal(bits(got)[~mask], bits(w)[~mask]),
          f"block_scatter_update {tag} in place: an unselected element "
          f"changed")
    check(torch.equal(bits(w), bits(before)),
          f"block_scatter_update {tag} out of place: w changed")
    line = (f"[kernel] block_scatter_update {tag} w={tuple(w.shape)} "
            f"{_dname(w.dtype)} upd={_dname(upd.dtype)} n_sel={spec.n_sel} "
            f"block={spec.block} in place and out of place bitwise=True "
            f"unselected_unchanged=True w_unchanged=True")
    if not timed:
        print(line, flush=True)
        return None
    t_in = cuda_ms_flushed(lambda: ops.block_scatter_update(got, upd, idx,
                                                            spec), flush)
    t_out = cuda_ms_flushed(lambda: ops.block_scatter_update(
        w, upd, idx, spec, out=out), flush)
    t_before = cuda_ms_flushed(lambda: ops.block_scatter_update(
        w.clone(), upd, idx, spec), flush)
    plain = cuda_ms_flushed(lambda: ref.block_scatter_update_ref(
        w3, u5, idx, spec.block), flush)
    # the library calls: one Tensor.scatter_ (in place) or Tensor.scatter
    # (out of place) on the blocked view, the upd already cast to w's type
    # and its index already built
    blocked = got.view(k, r, spec.n_shards * spec.n_blocks, spec.block)
    w_blocked = w.view(blocked.shape)
    u_cast = u5.to(w.dtype).reshape(k, r, -1, spec.block)
    offs = (torch.arange(spec.n_shards, device=idx.device)
            * spec.n_blocks)[None, :, None]
    index = (idx.long() + offs).reshape(k, 1, -1, 1).expand(
        k, r, spec.n_shards * spec.n_sel, spec.block).contiguous()
    lib_in = cuda_ms_flushed(lambda: blocked.scatter_(2, index, u_cast),
                             flush)
    lib_out = cuda_ms_flushed(lambda: w_blocked.scatter(2, index, u_cast),
                              flush)
    b_in, b_out = _scatter_bytes(w, upd, idx, spec)
    print(f"{line} in_place_ms={t_in:.4f} library_ms={lib_in:.4f} "
          f"bound_ms={b_in / PEAK_BYTES * 1e3:.4f}; out_of_place_ms="
          f"{t_out:.4f} library_ms={lib_out:.4f} bound_ms="
          f"{b_out / PEAK_BYTES * 1e3:.4f} clone_plus_in_place_ms="
          f"{t_before:.4f}; plain_ms={plain:.4f} (bytes)", flush=True)
    return {"in place": (t_in, lib_in), "out of place": (t_out, lib_out),
            "plain": plain, "before": t_before, "bytes": (b_in, b_out)}


def check_scatter(gen, sums: dict):
    """The block scatter-update, both modes, at the 7 wave leaf shapes of
    full-width llama3-8b (w [2, d_in, N] bf16, upd fp32, block 8, r =
    0.25), timed; the out-of-place mode (the one the wave runs) goes into
    the sums. Then, untimed: an fp32 case, a lead-dim case [K, E, d, N], an
    unaligned case (block 5) that takes one element a thread, and a case
    whose idx names blocks twice (the highest j wins)."""
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    tot = {"in place": 0.0, "lib in place": 0.0, "bytes in place": 0.0,
           "before": 0.0}
    for leaf, (fan_in, out, spec) in _wave_leaves().items():
        w = (torch.randn(K_LAYERS, fan_in, out, generator=gen, device="cuda")
             * 0.02).to(torch.bfloat16)
        upd = torch.randn(K_LAYERS, fan_in, spec.n_shards, spec.n_sel,
                          spec.block, generator=gen, device="cuda") * 0.02
        idx = _rand_idx((K_LAYERS, spec.n_shards), spec, gen)
        got = _scatter_case(leaf, w, upd, idx, spec, flush, timed=True)
        sums["ms"] += got["out of place"][0]
        sums["library_ms"] += got["out of place"][1]
        sums["plain_ms"] += got["plain"]
        sums["bytes"] += got["bytes"][1]
        tot["in place"] += got["in place"][0]
        tot["lib in place"] += got["in place"][1]
        tot["bytes in place"] += got["bytes"][0]
        tot["before"] += got["before"]
        del w, upd, idx, got
    print(f"[kernel] block_scatter_update, the wave's 7 leaves: in place "
          f"{tot['in place']:.4f} ms (bound "
          f"{tot['bytes in place'] / PEAK_BYTES * 1e3:.4f}, Tensor.scatter_ "
          f"{tot['lib in place']:.4f}); out of place {sums['ms']:.4f} ms "
          f"(bound {sums['bytes'] / PEAK_BYTES * 1e3:.4f}, Tensor.scatter "
          f"{sums['library_ms']:.4f}, clone + in-place kernel "
          f"{tot['before']:.4f}); plain {sums['plain_ms']:.4f}", flush=True)
    from repro_torch.core.sparse_update import SelSpec
    cases = [("fp32 wk", (K_LAYERS, 4096, 1024), (1, 32, 8, 128),
              torch.float32),
             ("lead dims [K,E,d,N]", (K_LAYERS, 8, 512, 1408),
              (1, 44, 8, 176), torch.bfloat16),
             ("unaligned block 5", (K_LAYERS, 333, 2 * 7 * 5),
              (2, 3, 5, 7), torch.bfloat16),
             ("duplicate indices", (K_LAYERS, 4096, 1024), (2, 48, 8, 64),
              torch.bfloat16)]
    for tag, shape, (n_shards, n_sel, block, n_blocks), dtype in cases:
        spec = SelSpec(block=block, n_shards=n_shards, n_sel=n_sel,
                       n_blocks=n_blocks)
        w = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        upd = torch.randn(shape[:-1] + (n_shards, n_sel, block),
                          generator=gen, device="cuda")
        if tag == "duplicate indices":     # 48 draws of 64 blocks
            idx = torch.randint(0, n_blocks, (K_LAYERS, n_shards, n_sel),
                                generator=gen, device="cuda",
                                dtype=torch.int32)
            idx[0, 0, -3:] = idx[0, 0, 0]
            check(any(len(set(row.tolist())) < n_sel
                      for row in idx.view(-1, n_sel)),
                  "the duplicate-index case has no duplicate")
        else:
            idx = _rand_idx((K_LAYERS, n_shards), spec, gen)
        _scatter_case(tag, w, upd, idx, spec, flush)
    del flush


# the rwkv6-3b path's WKV shapes: batch 4 x seq 1024, 40 heads of 64
WKV_SHAPE = (4, 1024, 40, 64)
# operations per (b, t, h, d, e) that the function needs: forward, S (k v,
# w S, the add) and y (r S); backward, S again, dS, and the four
# contractions for dr, dk, dv, dw
WKV_OPS = {"wkv6": 5, "wkv6_bwd": 14}


def _wkv_inputs(shape, gen, log_decay: float):
    """r, k, v ~ N(0, 1) (the projections of a layer-normed input), w =
    exp(-exp(log_decay + 0.5 N)) (the model's decay: w0 = -6 at init gives
    w ~ 0.9975, a memory of ~400 steps), u ~ 0.1 N per head."""
    b, t, h, d = shape
    r, k, v = (torch.randn(shape, generator=gen, device="cuda")
               for _ in range(3))
    w = torch.exp(-torch.exp(log_decay + 0.5 * torch.randn(
        shape, generator=gen, device="cuda")))
    u = 0.1 * torch.randn((h, d), generator=gen, device="cuda")
    return r, k, v, w, u


def _wkv_errors(tag, inputs, dy):
    """The kernels against the plain versions on one input: y against
    `ref.wkv6_ref`, the gradients against torch.autograd of it. fp32 on
    both sides, summed in other orders (four partial sums per step, FMA
    contraction) over D products a step and the state over up to T steps:
    each result is held within 1e-4 of the largest |value| of its plain
    tensor. Returns (max abs err forward, max abs err backward)."""
    from repro_torch.kernels import ops, ref
    y = ops.wkv6_fwd(*inputs)
    xs = [a.clone().requires_grad_(True) for a in inputs]
    want = ref.wkv6_ref(*xs)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(y).all()), f"wkv6 {tag}: not finite")
    scale = float(want.detach().abs().max())
    err_f = float((y - want.detach()).abs().max())
    check(err_f <= 1e-4 * max(scale, 1e-30),
          f"wkv6 {tag}: max abs err {err_f} against max |y| {scale}")
    want.backward(dy)
    got = ops.wkv6_bwd(*inputs, dy)
    torch.cuda.synchronize()
    err_b, parts = 0.0, []
    for name, g, x in zip("rkvwu", got, xs):
        check(bool(torch.isfinite(g).all()), f"wkv6_bwd {tag}: d{name} not "
                                             f"finite")
        # autograd leaves no gradient where none flows (w at T = 1: the
        # state after the last step reaches no output): it is zero
        want_g = x.grad if x.grad is not None else torch.zeros_like(x)
        sc = float(want_g.abs().max())
        e = float((g - want_g).abs().max())
        check(e <= 1e-4 * max(sc, 1e-30),
              f"wkv6_bwd {tag}: d{name} max abs err {e} against max "
              f"|d{name}| {sc}")
        err_b = max(err_b, e)
        parts.append(f"d{name} {e:.3e}/{sc:.3e}")
    print(f"[kernel] wkv6 {tag} {tuple(y.shape)}: forward max_abs_err="
          f"{err_f:.3e} (max |y| {scale:.3e}); backward err/max "
          f"{', '.join(parts)}", flush=True)
    del xs, want, got
    return err_f, err_b


# the kernels' chunk of time (csrc/wkv6.cu FWD_C, BWD_C)
WKV_CHUNK = 16


def check_wkv(gen, fwd: dict, bwd: dict):
    """The WKV kernels at the rwkv path's shapes, forward and backward,
    against the plain versions, two calls bitwise equal, timed with the L2
    flushed into the sums; then a strong-decay case (w down to 1e-12,
    where the reference's log-space chunks overflow), a case with
    T = 1001, not a multiple of the kernels' chunk, and T = 1 and T one
    step either side of the chunk."""
    from repro_torch.kernels import ops, ref
    inputs = _wkv_inputs(WKV_SHAPE, gen, -6.0)
    dy = torch.randn(WKV_SHAPE, generator=gen, device="cuda")
    err_f, err_b = _wkv_errors("rwkv6-3b shapes", inputs, dy)
    # no atomics anywhere, du summed in a fixed order: bitwise repeatable
    y1, y2 = ops.wkv6_fwd(*inputs), ops.wkv6_fwd(*inputs)
    g1, g2 = ops.wkv6_bwd(*inputs, dy), ops.wkv6_bwd(*inputs, dy)
    torch.cuda.synchronize()
    check(torch.equal(y1.view(torch.int32), y2.view(torch.int32)),
          "wkv6: two calls differ")
    for name, a, b in zip("rkvwu", g1, g2):
        check(torch.equal(a.view(torch.int32), b.view(torch.int32)),
              f"wkv6_bwd: two calls differ in d{name}")
    print("[kernel] wkv6 / wkv6_bwd rwkv6-3b shapes: two calls bitwise "
          "equal (y, dr, dk, dv, dw, du)", flush=True)
    del y1, y2, g1, g2
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    n = inputs[0].numel()
    d = WKV_SHAPE[-1]
    for name, sums, fn, plain, n_in, n_out, err in (
            ("wkv6", fwd, lambda: ops.wkv6_fwd(*inputs),
             lambda: ref.wkv6_ref(*inputs), 4, 1, err_f),
            ("wkv6_bwd", bwd, lambda: ops.wkv6_bwd(*inputs, dy),
             lambda: ref.wkv6_bwd_ref(*inputs, dy), 5, 4, err_b)):
        ms = cuda_ms_flushed(fn, flush)
        plain_ms = cuda_ms_flushed(plain, flush, reps=2, warmup=1)
        # each input read once, each output written once; u (and du)
        nbytes = (n_in + n_out) * n * 4 + inputs[4].numel() * 4 * (
            1 if name == "wkv6" else 2)
        flops = WKV_OPS[name] * n * d
        b_ms, b_by = bound_ms(flops, nbytes, "float32")
        sums.update(ms=ms, plain_ms=plain_ms, flops=flops, bytes=nbytes,
                    max_abs_err=err)
        print(f"[kernel] {name} {WKV_SHAPE} fp32: kernel_ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} library_ms=none bound_ms="
              f"{b_ms:.4f} ({b_by}: {flops / 1e9:.2f} GFLOP, "
              f"{nbytes / 1e6:.1f} MB)", flush=True)
    del inputs, dy, flush
    torch.cuda.empty_cache()
    # strong decay: half the channels at w = 1e-12, the rest the model's
    r, k, v, w, u = _wkv_inputs((2, 256, 8, 64), gen, -6.0)
    w[..., ::2] = 1e-12
    dy = torch.randn(r.shape, generator=gen, device="cuda")
    _wkv_errors("strong decay (w = 1e-12 on half the channels)",
                (r, k, v, w, u), dy)
    # T not a multiple of the chunk, T = 1 and T one step either side of
    # the chunk: partial chunks, zero-filled past T
    for t in (1001, 1, WKV_CHUNK - 1, WKV_CHUNK + 1):
        r, k, v, w, u = _wkv_inputs((2, t, 8, 64), gen, -1.0)
        dy = torch.randn(r.shape, generator=gen, device="cuda")
        _wkv_errors(f"T={t}", (r, k, v, w, u), dy)
    torch.cuda.empty_cache()


# the serving path's WKV calls: 4 slots x 40 heads of 64, a decode step
# (T = 1), a prefill chunk of one page (T = 16), and a longer run
WKV_STATE_T = (1, 16, 128)


def check_wkv_state(gen, out: dict):
    """The forward's state form, the one serving launches: from a nonzero
    s0, y and the state after the last step against `ref.wkv6_ref` with
    the same s0, at B = 4 (slots), H = 40 and T = 1, 16 and 128 (y and
    s_last within 1e-4 of the largest |value| of each plain tensor, as the
    stateless form), then at T = 1 (B = 4) and T = 16 (B = 1) timed with
    CUDA events (L2 flushed before each call) and by the profiler's device
    time beside the plain version and the byte bound: r, k, v, w read and
    y written once, s0 read and s_last written once."""
    from repro_torch.kernels import ops, ref
    h, d = WKV_SHAPE[2], WKV_SHAPE[3]
    for t in WKV_STATE_T:
        r, k, v, w, u = _wkv_inputs((4, t, h, d), gen, -1.0)
        s0 = 0.3 * torch.randn((4, h, d, d), generator=gen, device="cuda")
        y, s_last = ops.wkv6_fwd(r, k, v, w, u, s0=s0, want_state=True)
        want_y, want_s = ref.wkv6_ref(r, k, v, w, u, s0=s0, want_state=True)
        torch.cuda.synchronize()
        errs = []
        for name, got, want in (("y", y, want_y), ("s_last", s_last, want_s)):
            check(bool(torch.isfinite(got).all()),
                  f"wkv6 state T={t}: {name} not finite")
            sc = float(want.abs().max())
            e = float((got - want).abs().max())
            check(e <= 1e-4 * max(sc, 1e-30),
                  f"wkv6 state T={t}: {name} max abs err {e} against max "
                  f"|{name}| {sc}")
            errs.append(f"{name} {e:.3e}/{sc:.3e}")
        out.setdefault("max_abs_err", 0.0)
        out["max_abs_err"] = max(out["max_abs_err"],
                                 float((y - want_y).abs().max()),
                                 float((s_last - want_s).abs().max()))
        print(f"[kernel] wkv6 state form B=4 T={t} H={h} D={d}, s0 ~ "
              f"0.3 N: err/max {', '.join(errs)}", flush=True)
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    for b, t in ((4, 1), (1, 16)):
        r, k, v, w, u = _wkv_inputs((b, t, h, d), gen, -6.0)
        s0 = 0.3 * torch.randn((b, h, d, d), generator=gen, device="cuda")
        fn = lambda: ops.wkv6_fwd(r, k, v, w, u, s0=s0, want_state=True)
        ms = cuda_ms_flushed(fn, flush, reps=20)
        dev = device_ms(fn, flush=flush,
                        kernel=("wkv6_fwd_chunk_kernel", 1))
        plain = cuda_ms_flushed(
            lambda: ref.wkv6_ref(r, k, v, w, u, s0=s0, want_state=True),
            flush, reps=5, warmup=1)
        n = b * t * h * d
        nbytes = 5 * n * 4 + 2 * b * h * d * d * 4 + u.numel() * 4
        flops = WKV_OPS["wkv6"] * n * d
        b_ms, b_by = bound_ms(flops, nbytes, "float32")
        out[f"T={t}"] = dict(ms=ms, device_ms=dev, plain_ms=plain,
                             bound_ms=b_ms, bytes=nbytes)
        print(f"[kernel] wkv6 state form B={b} T={t} fp32: kernel_ms={ms:.4f}"
              f" (events) device_ms={dev:.4f} plain_ms={plain:.4f} "
              f"library_ms=none bound_ms={b_ms:.5f} ({b_by}: "
              f"{nbytes / 1e6:.3f} MB, {flops / 1e6:.2f} MFLOP) "
              f"[{card_line()}]", flush=True)
    del flush
    torch.cuda.empty_cache()


def phase_kernels(results: dict):
    gen = torch.Generator(device="cuda").manual_seed(0)
    leaves = _main_path_leaves()
    results["block_sparse_dw"] = _new_sums()
    results["fused_block_opt"] = _new_sums()
    check_dw(leaves, gen, results["block_sparse_dw"])
    check_dw_long(leaves, gen)
    check_dw_edges(gen)
    check_dw_wave(gen)
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
    results["wkv6"] = _new_sums()
    results["wkv6_bwd"] = _new_sums()
    check_wkv(gen, results["wkv6"], results["wkv6_bwd"])
    results["wkv6_state"] = {}
    check_wkv_state(gen, results["wkv6_state"])
    torch.cuda.empty_cache()


def phase_main_path(results: dict):
    """The LM path: 6 compact AdamW steps of full-width llama3-8b through
    the launcher (K x 7 dW and 7 optimizer launches a step, as its plan
    derives them), the unselected blocks of mlp/w_gate unchanged every
    step."""
    from repro_torch.configs import get_config
    cfg = get_config("llama3-8b")
    print(f"[main] llama3-8b full width, {cfg.num_layers} layers (no depth "
          f"cut), {cfg.dtype}", flush=True)
    tc, out, totals = _train_path("main", MAIN_ARGV, "blocks/mlp/w_gate")
    for name, (_, _, _, path) in SOURCES.items():
        if path == "lm":
            results["launches"][name] = totals[name]
    return tc, out


FLASH_RANGE = "flash_attention"


@contextlib.contextmanager
def flash_ranges():
    """Within the block every `layers._sdpa_flash` call runs inside the
    profiler range "flash_attention"; its backward is the autograd node
    `_FlashAttnBackward`, a range of its own."""
    from repro_torch.models import layers as L
    inner = L._sdpa_flash

    def ranged(*args, **kw):
        with torch.profiler.record_function(FLASH_RANGE):
            return inner(*args, **kw)

    L._sdpa_flash = ranged
    try:
        yield
    finally:
        L._sdpa_flash = inner


def attention_ms(prof) -> float:
    """Device ms of the flash path in a profile taken under
    `flash_ranges`: every kernel inside a "flash_attention" range (forward
    and checkpoint recompute) and inside the `_FlashAttnBackward` node (the
    largest of its nested ranges, which hold the same kernels)."""
    from torch.autograd import DeviceType
    incl = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CPU:
            incl[e.key] = getattr(e, "device_time_total",
                                  getattr(e, "cuda_time_total", 0.0))
    bwd = max((us for key, us in incl.items()
               if "_FlashAttnBackward" in key), default=0.0)
    return (incl.get(FLASH_RANGE, 0.0) + bwd) / 1e3


def profile_step(tag: str, run, attention: bool = False):
    """`run()` once under torch.profiler, then synced: device time by
    kernel, the share of the wall time the device sits idle, and the port's
    kernels' share; with `attention`, the flash path's device time and
    share too."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    ranges = flash_ranges() if attention else contextlib.nullcontext()
    with ranges, profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    # a record_function range shows as a device row of its own (its span
    # on the card): not a kernel
    rows = sorted(((_dev_us(e), e.key, e.count) for e in _rows(prof)
                   if _dev_us(e) > 0 and e.key != FLASH_RANGE), reverse=True)
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
          f"{ {k: round(v / busy_ms, 4) for k, v in by_kernel.items()} } "
          f"[{card_line()}]", flush=True)
    if attention:
        att = attention_ms(prof)
        print(f"[profile] {tag}: flash attention (forward, recompute and "
              f"backward) device_ms={att:.1f} share_of_busy="
              f"{att / busy_ms:.4f}", flush=True)
    for us, key, count in rows[:15]:
        print(f"[profile] {us / 1e3:9.2f} ms {100 * us / 1e3 / busy_ms:5.1f}% "
              f"x{count:<5d} {key[:90]}", flush=True)
    return busy_ms


def phase_profile(tc, out, tag: str = "one fixed-phase step",
                  attention: bool = False, batches=None):
    """One more step of a run's state (the late fixed phase) under
    torch.profiler (`attention`: with the flash path's share; `batches`:
    the run's `batches=` stream, else its token stream); returns its device
    busy ms."""
    from repro_torch.data import lm_batches
    from repro_torch.train import make_train_step

    step_fn = make_train_step(tc, out["plan"])
    if batches is not None:
        batch = next(batches(6))
    else:
        batch = next(lm_batches(tc.shape.global_batch, tc.shape.seq_len,
                                tc.model.vocab_size, seed=tc.seed,
                                start_step=6))
        batch = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
    return profile_step(tag, lambda: step_fn(out["state"], batch),
                        attention)


def phase_compact_vs_dense(cfg, tag: str = "compact-vs-dense",
                           k: int = K_LAYERS, batch: int = 4,
                           seq: int = 1024, one_at_a_time: bool = False,
                           batches=None):
    """`cfg` from seed 1, `k` trainable scan steps: 2 fixed-phase SGD steps
    of the compact path and of the dense-scatter path from one start (on
    the first two batches of `batches`, a `batches=` stream, else of the
    token stream); losses and every trainable leaf bitwise equal.
    one_at_a_time: the
    compact run first, its trainable leaves kept on the host, then the
    dense-scatter run from a fresh init of the same seed (for a model
    whose params, a copy of the trainable ones and the dense-scatter
    path's full-shape gradients do not fit the card together)."""
    from repro_torch.configs import (OptimizerConfig, ShapeConfig,
                                     SparseUpdateConfig, TrainConfig)
    from repro_torch.core.sparse_update import tree_leaves, tree_map
    from repro_torch.data import lm_batches
    from repro_torch.train import make_train_state, make_train_step

    tc = TrainConfig(model=cfg, shape=ShapeConfig("smoke", seq, batch,
                                                  "train"),
                     sparse=SparseUpdateConfig(update_ratio=0.2,
                                               num_update_layers=k,
                                               channel_block=128,
                                               phase_fixed_early=10),
                     optimizer=OptimizerConfig(kind="sgd", learning_rate=0.1),
                     seed=1)
    if batches is not None:
        batches = [b for _, b in zip(range(2), batches(0))]
    else:
        batches = [{key: torch.from_numpy(v).cuda() for key, v in b.items()}
                   for _, b in zip(range(2), lm_batches(
                       batch, seq, cfg.vocab_size, seed=1))]

    def run(state, plan, compact):
        step = make_train_step(tc, plan, compact_grads=compact)
        losses = []
        for b in batches:
            state, m = step(state, b)
            losses.append(float(m["loss"]))
        return state, losses

    state_c, plan = make_train_state(tc, device="cuda")
    if one_at_a_time:
        state_c, loss_c = run(state_c, plan, True)
        kept = [t.cpu() for t in tree_leaves(state_c["params_trainable"])]
        del state_c
        gc.collect()
        torch.cuda.empty_cache()
        state_d, plan = make_train_state(tc, device="cuda")
        state_d, loss_d = run(state_d, plan, False)
        b = tree_leaves(state_d["params_trainable"])
        unequal = sum(not torch.equal(x.cuda(), y) for x, y in zip(kept, b))
        n = len(kept)
        del kept, b, state_d
    else:
        # the compact step updates its trainable tensors in place: the
        # dense-scatter run starts from its own copy
        state_d = dict(state_c)
        state_d["params_trainable"] = tree_map(torch.clone,
                                               state_c["params_trainable"])
        state_c, loss_c = run(state_c, plan, True)
        state_d, loss_d = run(state_d, plan, False)
        a = tree_leaves(state_c["params_trainable"])
        b = tree_leaves(state_d["params_trainable"])
        unequal = sum(not torch.equal(x, y) for x, y in zip(a, b))
        n = len(a)
        del a, b, state_c, state_d
    for i, (lc, ld) in enumerate(zip(loss_c, loss_d)):
        print(f"[{tag}] step {i + 1} loss compact={lc:.6f} "
              f"dense_scatter={ld:.6f}", flush=True)
        check(lc == ld, f"{tag} step {i + 1}: losses differ")
    check(unequal == 0, f"{tag}: {unequal} of {n} trainable leaves differ")
    print(f"[{tag}] {cfg.name} {cfg.num_layers} layers, K={k}, batch "
          f"{batch} x seq {seq}, sgd, 2 fixed-phase steps: all {n} trainable "
          f"leaves bitwise equal", flush=True)
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# past 2048 tokens: the flash path (ROADMAP item 7a)
# ---------------------------------------------------------------------------

def _attention_shape(arch: str, batch: int, seq: int) -> tuple:
    """(batch, seq, query heads, KV heads, head dim, window) of `arch`'s
    attention; the window of gemma's local layers."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    return (batch, seq, cfg.num_heads, cfg.num_kv_heads,
            cfg.resolved_head_dim, cfg.sliding_window)


def _sdpa_yardstick(q, k, v, window: int):
    """F.scaled_dot_product_attention on the same function (the library's
    own choice of kernel), the KV heads expanded: causal, or under a window
    with its boolean mask. A yardstick only: no path of the port calls
    it."""
    import torch.nn.functional as F
    from repro_torch.models import layers as L
    hq, s = q.shape[2], q.shape[1]
    qt, kt, vt = (t.transpose(1, 2) for t in
                  (q, L._expand_kv(k, hq), L._expand_kv(v, hq)))
    if window:
        i = torch.arange(s, device=q.device)
        mask = (i[None, :] <= i[:, None]) & (i[:, None] - i[None, :] < window)
        out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
    else:
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    return out.transpose(1, 2)


def _peak_bytes(fn) -> int:
    """Device bytes `fn()` allocates at its peak beyond what was allocated
    before it."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def _flash_case(arch: str, shape: tuple, dtype, gen, card: str):
    """One attention shape in one dtype: the flash path's output and the
    gradients of (out²).sum() for q, k and v against the dense path and
    against its own forward differentiated by autograd (naive_vjp), then
    forward + backward timed beside the dense path and
    F.scaled_dot_product_attention, with each one's peak bytes.

    fp32: the reference test's tolerances, 1e-4 / 1e-5 on the output and
    1e-3 / 1e-4 on the gradients, against dense and naive alike.
    bf16: the output within 2^-7 of max|v| of the dense path's (each path
    rounds the probabilities to bf16, 2^-9 relative, at another point, and
    the output once more: 2 x 2^-9 max|v| + 2 x 2^-9 max|out|); the
    gradients no further from the fp32 flash gradients on the same bf16
    values than twice the dense path's, plus half a bf16 ulp of the largest
    (2^-9 of it); against naive, the same output and gradients within 2^-6
    of the largest (p and ds round to bf16 only in the custom backward)."""
    from repro_torch.models import layers as L
    b, s, hq, hkv, d, window = shape
    base = [torch.randn((b, s, h, d), generator=gen,
                        device="cuda").to(dtype) for h in (hq, hkv, hkv)]

    def fwd_bwd(fn, inputs=base):
        ins = [t.clone().requires_grad_(True) for t in inputs]
        out = fn(*ins)
        (out.float() ** 2).sum().backward()
        return out.detach(), [t.grad for t in ins]

    fns = {"flash": lambda q, k, v: L._sdpa_flash(q, k, v, window),
           "naive": lambda q, k, v: L._sdpa_flash(q, k, v, window,
                                                  naive_vjp=True),
           "dense": lambda q, k, v: L._sdpa_dense(q, k, v, window),
           "sdpa": lambda q, k, v: _sdpa_yardstick(q, k, v, window)}
    res = {name: fwd_bwd(fn) for name, fn in fns.items()}
    err = lambda a, b: float((a.float() - b.float()).abs().max())
    (fo, fg), (no, ng), (do, dg) = res["flash"], res["naive"], res["dense"]
    tag = f"{arch} {_dname(dtype)} {b} x {s}, {hq} / {hkv} heads of {d}, " \
          f"window {window}"
    check(torch.equal(fo, no), f"flash {tag}: the custom forward differs "
                               f"from the naive one")
    out_err = err(fo, do)
    g_dense = [err(a, c) for a, c in zip(fg, dg)]
    g_naive = [err(a, c) for a, c in zip(fg, ng)]
    if dtype == torch.float32:
        check(torch.allclose(fo, do, rtol=1e-4, atol=1e-5),
              f"flash {tag}: output differs from dense by {out_err}")
        for name, ref_g in (("dense", dg), ("naive", ng)):
            for a, c, n in zip(fg, ref_g, "qkv"):
                check(torch.allclose(a, c, rtol=1e-3, atol=1e-4),
                      f"flash {tag}: d{n} differs from {name} by {err(a, c)}")
        bounds = "fp32 1e-4/1e-5 out, 1e-3/1e-4 grads"
    else:
        out_tol = 2.0 ** -7 * float(base[2].float().abs().max())
        check(out_err <= out_tol,
              f"flash {tag}: output differs from dense by {out_err} > "
              f"{out_tol}")
        _, g32 = fwd_bwd(fns["flash"], [t.float() for t in base])
        for a, c, ref, n in zip(fg, dg, g32, "qkv"):
            tol = 2 * err(c, ref) + 2.0 ** -9 * float(ref.abs().max())
            check(err(a, ref) <= tol,
                  f"flash {tag}: d{n} is {err(a, ref)} from fp32, more than "
                  f"{tol} (twice the dense path's {err(c, ref)} + 2^-9 of "
                  f"the largest)")
            tol_n = 2.0 ** -6 * float(ng["qkv".index(n)].float().abs().max())
            check(err(a, ng["qkv".index(n)]) <= tol_n,
                  f"flash {tag}: d{n} differs from naive by more than "
                  f"{tol_n}")
        del g32
        bounds = "bf16 out 2^-7 max|v|, grads 2 x dense's + 2^-9 from fp32"
    del res, fo, fg, no, ng, do, dg
    times = {name: cuda_ms(lambda fn=fns[name]: fwd_bwd(fn), reps=3,
                           warmup=1) for name in ("flash", "dense", "sdpa")}
    peaks = {name: _peak_bytes(lambda fn=fns[name]: fwd_bwd(fn))
             for name in ("flash", "naive", "dense", "sdpa")}
    print(f"[flash] {tag}: forward equal to naive; max abs err vs dense out "
          f"{out_err:.3e} dq/dk/dv {[f'{e:.3e}' for e in g_dense]}, vs naive "
          f"{[f'{e:.3e}' for e in g_naive]} ({bounds}); forward + backward "
          f"ms: flash {times['flash']:.3f} dense {times['dense']:.3f} "
          f"F.scaled_dot_product_attention (yardstick) {times['sdpa']:.3f}; "
          f"peak bytes: flash {peaks['flash']} naive {peaks['naive']} dense "
          f"{peaks['dense']} sdpa {peaks['sdpa']} [{card}]", flush=True)
    del base
    gc.collect()
    torch.cuda.empty_cache()


def phase_flash():
    """The flash path against the dense one on the card at layer level:
    llama3-8b's attention (32 / 8 heads of 128, batch 2 x 4096) and
    gemma3-4b's local layers (8 / 4 heads of 320, window 1024, batch 1 x
    4096), bf16 and fp32."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    card = card_line()
    for arch, batch in (("llama3-8b", 2), ("gemma3-4b", 1)):
        for dtype in (torch.bfloat16, torch.float32):
            _flash_case(arch, _attention_shape(arch, batch, 4096), dtype, gen,
                        card)


def _add_launches(results: dict, totals: dict) -> None:
    for name, n in totals.items():
        results["launches"][name] = results["launches"].get(name, 0) + n


def phase_train4k(results: dict):
    """The LM path at the reference's train_4k shape: 6 compact AdamW steps
    of full-width llama3-8b, batch 2 x seq 4096, through the launcher
    (launches as the plan derives them), one profiled step with the flash
    path's share, the frozen params against a fresh init."""
    from repro_torch.configs import get_config
    cfg = get_config("llama3-8b")
    print(f"[train4k] llama3-8b full width, {cfg.num_layers} layers (no "
          f"depth cut), batch 2 x seq 4096 (the train_4k cell; its global "
          f"batch of 256 is a pod's, cut to 2), attention on the flash path "
          f"[{card_line()}]", flush=True)
    tc, out, totals = _train_path("train4k", TRAIN4K_ARGV, "blocks/mlp/w_gate")
    _add_launches(results, totals)
    busy = phase_profile(tc, out, "one fixed-phase train_4k step",
                         attention=True)
    n = _check_frozen(tc, out, "train4k")
    print(f"[train4k] frozen params bitwise equal to a fresh init ({n} "
          f"leaves); profiled step busy {busy:.1f} ms", flush=True)


def phase_prefill():
    """llama3-8b at full width through `models.decoding.prefill`: one
    prompt of 32768 tokens (the prefill_32k cell; its batch of 32 cut to
    1), padded to 32768, with its wall and synced ms, tokens/s and peak
    bytes; the last-token logits finite, the cache's pos 32768 and its k,
    v shaped [layers, 1, 32768, KV heads, head dim]. Then a 4096-token
    prefill against the same model's prefill forced through the dense path:
    the last-token logits within 2^-5 of the largest (each of 32 layers
    rounds its attention output to bf16 at another point on each path,
    2^-9 relative, which the residual stream carries on: sqrt(32) x 2 x
    2^-9 = 2^-5.5)."""
    from repro_torch.configs import get_config
    from repro_torch.models import decoding as D
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    card = card_line()
    cfg = get_config("llama3-8b")
    params = T.init_params(cfg, 0, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(13)

    def run(tokens, pad_to):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = D.prefill(cfg, params, {"tokens": tokens},
                                  pad_to=pad_to)
        wall = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        return logits, cache, wall, (time.perf_counter() - t0) * 1e3

    with torch.no_grad():
        toks = torch.randint(0, cfg.vocab_size, (1, 4096), generator=gen,
                             device="cuda")
        flash, _, _, flash_ms = run(toks, 4096)
        threshold = L.FLASH_THRESHOLD
        L.FLASH_THRESHOLD = 4096
        try:
            dense, _, _, dense_ms = run(toks, 4096)
        finally:
            L.FLASH_THRESHOLD = threshold
        diff = float((flash - dense).abs().max())
        tol = 2.0 ** -5 * float(dense.abs().max())
        check(bool(torch.isfinite(flash).all()) and diff <= tol,
              f"prefill 4096: flash logits differ from dense by {diff} > "
              f"{tol}")
        print(f"[prefill] llama3-8b 1 x 4096: last-token logits flash vs "
              f"dense max abs diff {diff:.4e} (bound {tol:.4e}, max |logit| "
              f"{float(dense.abs().max()):.4f}); synced ms flash "
              f"{flash_ms:.1f} dense {dense_ms:.1f} [{card}]", flush=True)
        del flash, dense, toks

        toks = torch.randint(0, cfg.vocab_size, (1, PREFILL_TOKENS),
                             generator=gen, device="cuda")
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        logits, cache, wall_ms, synced_ms = run(toks, PREFILL_TOKENS)
        peak = torch.cuda.max_memory_allocated()
    c = cache["blocks"]
    want = (cfg.num_layers, 1, PREFILL_TOKENS, cfg.num_kv_heads,
            cfg.resolved_head_dim)
    check(tuple(logits.shape) == (1, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()),
          "prefill 32k: the last-token logits are not finite")
    check(bool((c["pos"] == PREFILL_TOKENS).all()),
          f"prefill 32k: cache pos {c['pos'].flatten().tolist()[:4]}")
    check(tuple(c["k"].shape) == want == tuple(c["v"].shape),
          f"prefill 32k: cache k {tuple(c['k'].shape)}, want {want}")
    print(f"[prefill] llama3-8b full width ({cfg.num_layers} layers), 1 x "
          f"{PREFILL_TOKENS} tokens (prefill_32k, batch 32 cut to 1), pad_to "
          f"{PREFILL_TOKENS}: wall_ms={wall_ms:.1f} synced_ms={synced_ms:.1f} "
          f"tokens_per_s={PREFILL_TOKENS / synced_ms * 1e3:.0f} "
          f"peak_bytes={peak}; logits finite, cache pos {PREFILL_TOKENS}, "
          f"k / v {want} [{card}]", flush=True)
    del logits, cache, c, params, toks
    gc.collect()
    torch.cuda.empty_cache()


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
    # the cost of deterministic cuDNN: the same step, free and deterministic
    # algorithms in turns (free, det, det, free), 10 synced steps each
    times = {False: [], True: []}
    for det in (False, True, True, False):
        torch.backends.cudnn.deterministic = det
        run()
        times[det] += [cuda_ms(run, reps=1, warmup=0) for _ in range(10)]
    torch.backends.cudnn.deterministic = True
    med = {k: statistics.median(v) for k, v in times.items()}
    print(f"[cnn profile] dynamic step ms, median of 20: cudnn.deterministic"
          f"=False {med[False]:.3f}, True {med[True]:.3f} (ratio "
          f"{med[True] / med[False]:.3f})", flush=True)
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
    # the table is a function of its seed: a second run equals it bitwise
    again = CT.main(["--config", "smoke", "--seed", "0"])
    from repro_torch.core.sparse_update import tree_leaves
    for a, b in zip(out["rows"], again["rows"]):
        same = (a["acc"] == b["acc"] and a.get("losses") == b.get("losses")
                and all(torch.equal(x, y) for x, y in zip(
                    tree_leaves(a["params"]), tree_leaves(b["params"]))))
        check(same, f"table2: {a['method']} differs between two runs from "
                    f"one seed")
    print(f"[table2] two runs from seed 0: all {len(out['rows'])} rows "
          f"bitwise equal (accuracies, losses, final params)", flush=True)
    del again
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
    through the launcher (K x 7 dW, K x 3 expert dW and 10 optimizer
    launches a step, as its plan derives them: the router takes the plain
    optimizer), the expert leaves kept at the end of the first fixed
    phase, and the share of routed choices the capacity dropped."""
    from repro_torch.configs import get_config
    from repro_torch.data import lm_batches
    from repro_torch.models import moe as MOE
    from repro_torch.models import transformer as T

    cfg = get_config("deepseek-moe-16b")
    print(f"[moe] deepseek-moe-16b full width, {cfg.num_layers} layers (no "
          f"depth cut), {cfg.moe.num_experts} routed experts top-"
          f"{cfg.moe.top_k} + {cfg.moe.num_shared_experts} shared, "
          f"{cfg.dtype}", flush=True)
    snap = {}

    def at_first_phase_end(step, state):
        if step == MOE_J:
            # the expert leaves at the end of the first fixed phase, with
            # its selection: held against the init after the run
            moe = state["params_trainable"]["segments"]["blocks"]["moe"]
            idx = state["sel_idx"]["blocks"]["moe"]
            snap.update({n: (moe[n].clone(), idx[n].clone())
                         for n in EXPERT_LEAVES})

    tc, out, totals = _train_path("moe", MOE_ARGV, "blocks/attn/wo",
                                  extra=at_first_phase_end)
    results["launches"]["batched_dw"] = totals["batched_dw"]

    # the share of routed choices the capacity dropped, over every MoE
    # layer of one forward of the trained model on the next batch
    state = out["state"]
    batch = next(lm_batches(tc.shape.global_batch, tc.shape.seq_len,
                            cfg.vocab_size, seed=tc.seed, start_step=6))
    batch = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
    with torch.no_grad(), MOE.record_routing() as routed:
        T.forward(cfg, (state["params_frozen"], state["params_trainable"]),
                  batch)
    dropped = [float(d) / n for d, n in routed]
    print(f"[moe] dropped_share={sum(dropped) / len(dropped):.4f} (per MoE "
          f"layer min {min(dropped):.4f} max {max(dropped):.4f}, "
          f"{len(dropped)} layers)", flush=True)
    return tc, out, snap


def phase_moe_frozen(tc, out, snap):
    """After the run: the frozen params (embedding, head, final norm, the
    dense first layer, the 25 frozen MoE layers) bitwise equal to a fresh
    init from the run's seed, and every expert leaf's unselected blocks at
    the end of the first fixed phase bitwise their init, its selected
    blocks moved."""
    plan = out["plan"]
    check("first" in out["state"]["params_frozen"]["segments"]
          and "first" not in out["state"]["params_trainable"]["segments"],
          "MoE: the dense first layer is not frozen")

    def experts_unselected_unchanged(trainable0):
        moe0 = trainable0["segments"]["blocks"]["moe"]
        for name, (w, idx) in snap.items():
            spec = plan.spec["blocks"]["moe"][name]
            mask = _selected_mask(moe0[name], idx, spec)
            check(torch.equal(w[~mask], moe0[name][~mask]),
                  f"MoE: an unselected block of {name} changed in the first "
                  f"fixed phase")
            check(not torch.equal(w[mask], moe0[name][mask]),
                  f"MoE: the selected blocks of {name} did not move")

    n = _check_frozen(tc, out, "MoE", experts_unselected_unchanged)
    print(f"[moe] frozen params bitwise equal to a fresh init ({n} leaves: "
          f"embedding, head, final norm, the dense first layer, "
          f"{tc.model.num_layers - 1 - K_LAYERS} frozen MoE layers); every "
          f"expert leaf's unselected blocks bitwise their init through the "
          f"first fixed phase ({MOE_J} steps)", flush=True)


def phase_rwkv_path(results: dict):
    """The rwkv path: 6 compact AdamW steps of full-width rwkv6-3b through
    the launcher. Launches a step: the dW and optimizer as its plan derives
    them (K x 8 and 8: time wr wk wv wg wo, channel wk wv wr; u, mu, w0,
    wA, wB and the norms take the plain dense rule), the WKV forward once a
    layer (the frozen ones under no_grad) and once more for each trainable
    layer, which `torch.utils.checkpoint` recomputes in the backward, and
    the WKV backward once per trainable layer."""
    from repro_torch.configs import get_config
    cfg = get_config("rwkv6-3b")
    print(f"[rwkv] rwkv6-3b full width, {cfg.num_layers} layers (no depth "
          f"cut), d_model {cfg.d_model}, {cfg.d_model // cfg.rwkv.head_dim} "
          f"heads of {cfg.rwkv.head_dim}, d_ff {cfg.d_ff}, {cfg.dtype}",
          flush=True)
    tc, out, totals = _train_path(
        "rwkv", RWKV_ARGV, "blocks/time/wo",
        extra_launches={"wkv6": cfg.num_layers + K_LAYERS,
                        "wkv6_bwd": K_LAYERS})
    for name, (_, _, _, path) in SOURCES.items():
        if path == "rwkv":
            results["launches"][name] = totals[name]
    return tc, out


def phase_rwkv_frozen(tc, out):
    """After the run: the frozen params (embedding, ln0, head, final norm,
    the 30 frozen layers) bitwise equal to a fresh init from the run's
    seed."""
    check("ln0" in out["state"]["params_frozen"], "rwkv: ln0 is not frozen")
    n = _check_frozen(tc, out, "rwkv")
    print(f"[rwkv] frozen params bitwise equal to a fresh init ({n} "
          f"leaves: embedding, ln0, head, final norm, "
          f"{tc.model.num_layers - K_LAYERS} frozen layers)", flush=True)


def plan_per_step(cfg, plan) -> dict:
    """Launches a step of a compact path, derived from its plan: the dW
    once per selectable leaf and trainable scan step (`batched_dw` for a
    stacked expert leaf [steps, E, fan_in, out], `block_sparse_dw` for the
    rest; a super-block's sub-layers are leaves of their own), and the fused
    optimizer once per selectable stacked leaf (norms, routers and the
    mamba leaves outside the selection take the plain dense rule). No other
    kernel of the port runs on an attention / mamba / MoE path."""
    from repro_torch.core.sparse_update import SelSpec
    from repro_torch.kernels import ops
    from repro_torch.models.registry import abstract_params
    want = {k: 0 for k in ops.LAUNCHES}
    shapes = abstract_params(cfg)["segments"]

    def walk(spec, shape, steps):
        if isinstance(spec, SelSpec):
            want["batched_dw" if shape.dim() == 4
                 else "block_sparse_dw"] += steps
            want["fused_block_opt"] += 1
            return
        for name in spec:
            walk(spec[name], shape[name], steps)

    for seg, steps in plan.seg_trainable.items():
        if steps:
            walk(plan.spec[seg], shapes[seg], steps)
    return want


def _train_path(tag: str, argv, watch: str, model=None, extra=None,
                extra_launches=None, batches=None):
    """6 compact steps through the launcher (`model` replaces the arch's
    config, `batches` its token stream), counts zeroed just before and
    read just after: every step
    launches exactly `plan_per_step` plus `extra_launches` (the path's
    other kernels), every bf16 dW on the pipelined instance, the loss
    finite, and the unselected blocks of the `watch` leaf (a path below
    the segments) unchanged every step, its selected blocks moved.
    extra(step, state) runs after each step's checks. Returns (tc, out,
    totals)."""
    from repro_torch.core.selection import build_plan, selected_fraction
    from repro_torch.kernels import ops
    from repro_torch.launch import train

    args = train.build_argparser().parse_args(argv)
    tc = train.train_config(args, model)
    cfg = tc.model
    plan = build_plan(cfg, tc.sparse,
                      tc.shape.global_batch * tc.shape.seq_len)
    spec = _leaf(plan.spec, watch)
    want = plan_per_step(cfg, plan)
    want.update(extra_launches or {})
    print(f"[{tag}] trainable {plan.seg_trainable}, {args.optimizer} lr "
          f"{args.lr}, batch {args.batch} x seq {args.seq}, selected share "
          f"of params per step {selected_fraction(plan, cfg):.6f}; launches "
          f"a step, derived from the plan: {want}", flush=True)
    per_step = []
    last = {"counts": {k: 0 for k in ops.LAUNCHES}, "leaf": None}

    def on_step(step, state, metrics):
        counts = ops.launch_counts()
        delta = {k: counts[k] - last["counts"][k] for k in counts}
        leaf = _leaf(state["params_trainable"]["segments"], watch)
        if last["leaf"] is not None:
            mask = _selected_mask(leaf, _leaf(state["sel_idx"], watch), spec)
            check(torch.equal(leaf[~mask], last["leaf"][~mask]),
                  f"{tag} step {step}: an unselected block of {watch} "
                  f"changed")
            check(not torch.equal(leaf[mask], last["leaf"][mask]),
                  f"{tag} step {step}: the selected blocks of {watch} did "
                  f"not move")
        last["counts"], last["leaf"] = counts, leaf.clone()
        if extra is not None:
            extra(step, state)
        row = {"step": step, "loss": float(metrics["loss"]),
               "step_ms": metrics["step_ms"],
               "max_memory_allocated": torch.cuda.max_memory_allocated(),
               "launches": delta}
        per_step.append(row)
        print(f"[{tag}] step {step} loss={row['loss']:.6f} "
              f"load_balance={float(metrics['load_balance']):.4f} "
              f"router_z={float(metrics['router_z']):.4f} "
              f"step_ms={row['step_ms']:.1f} "
              f"max_memory_allocated={row['max_memory_allocated']} "
              f"launches={delta}", flush=True)

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    out = train.main(argv, on_step=on_step, model=model, batches=batches)
    totals = ops.launch_counts()
    last["leaf"] = None

    check(len(per_step) == 6, f"ran {len(per_step)} {tag} steps, want 6")
    for row in per_step:
        check(row["launches"] == want,
              f"{tag} step {row['step']}: launches {row['launches']}, want "
              f"{want}")
        check(bool(torch.isfinite(torch.tensor(row["loss"]))),
              f"{tag} step {row['step']}: loss {row['loss']} is not finite")
    check(totals == {k: 6 * n for k, n in want.items()},
          f"{tag} run: launches {totals}, want 6 x {want}")
    check(ops.DW_INSTANCES == {"grid": 0,
                               "pipelined": totals["block_sparse_dw"]}
          and ops.BATCHED_DW_INSTANCES == {"grid": 0,
                                           "pipelined": totals["batched_dw"]},
          f"{tag} run: dW instances {ops.DW_INSTANCES}, batched "
          f"{ops.BATCHED_DW_INSTANCES}, want every bf16 launch on the "
          f"pipelined one")
    steady = [r["step_ms"] for r in per_step[1:]]
    tokens = args.batch * args.seq
    print(f"[{tag}] launches over 6 steps: {totals}; dW by instance: "
          f"{dict(ops.DW_INSTANCES)}, batched_dw by instance: "
          f"{dict(ops.BATCHED_DW_INSTANCES)}", flush=True)
    print(f"[{tag}] step_ms steps 2-6: {[round(t, 1) for t in steady]} "
          f"median={statistics.median(steady):.1f} tokens_per_s="
          f"{tokens / statistics.median(steady) * 1e3:.0f} step1_ms="
          f"{per_step[0]['step_ms']:.1f} peak_bytes="
          f"{torch.cuda.max_memory_allocated()} losses="
          f"{[round(r['loss'], 6) for r in per_step]} [{card_line()}]",
          flush=True)
    return tc, out, totals


def _same(x, y) -> bool:
    """torch.equal in slices of the leading axis of at most ~2^27 elements
    (y may lie on the host): no comparison temporary is large."""
    if x.shape != y.shape or x.dtype != y.dtype:
        return False
    if x.dim() == 0:
        return torch.equal(x, y.to(x.device))
    rows = max(1, 2**27 // max(1, x[0].numel()))
    return all(torch.equal(a, b.to(a.device))
               for a, b in zip(x.split(rows), y.split(rows)))


def _check_frozen(tc, out, tag: str, trainable_too=None):
    """After a run: its frozen params bitwise equal to a fresh init from
    the run's seed. The run's trainable params and optimizer state go
    first. The frozen leaves are views of the run's stacked params, which
    keep the trainable layers' memory too: where a second copy of the
    model does not fit beside them, they wait on the host. trainable_too(
    init trainable tree), when given, runs on the fresh init's trainable
    part before it is freed. Returns the number of frozen leaves."""
    from repro_torch.core.sparse_update import tree_leaves
    from repro_torch.models import transformer as T
    from repro_torch.train import split_params

    state, plan = out["state"], out["plan"]
    frozen = state["params_frozen"]
    out.clear()
    del state
    gc.collect()
    torch.cuda.empty_cache()
    model_bytes = sum(t.numel() * t.element_size()
                      for t in _leaves(T.init_params(tc.model, 0, "meta")))
    if torch.cuda.mem_get_info()[0] < model_bytes + 8 * 2**30:
        frozen = _tree_to(frozen, "cpu")
        gc.collect()
        torch.cuda.empty_cache()
    init = T.init_params(tc.model, tc.seed, "cuda")
    frozen0, trainable0 = split_params(init, plan)
    a, b = tree_leaves(frozen0), tree_leaves(frozen)
    check(len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b)),
          f"{tag}: a frozen param changed")
    if trainable_too is not None:
        trainable_too(trainable0)
    n = len(a)
    del init, frozen0, trainable0, frozen, a, b
    gc.collect()
    torch.cuda.empty_cache()
    return n


def phase_gemma_path(results: dict):
    """The gemma path: 6 compact AdamW steps of full-width gemma3-4b (34
    layers, no depth cut) at batch 1 x seq 4096 (the flash path) through
    the launcher, one profiled step with the flash path's share, the frozen
    params against a fresh init."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    cfg = get_config("gemma3-4b")
    layout = T.segment_layout(cfg)
    print(f"[gemma] gemma3-4b full width, {cfg.num_layers} layers (no depth "
          f"cut: {[tuple(s) for s in layout]}), {cfg.dtype}, d_model "
          f"{cfg.d_model}, {cfg.num_heads} heads / {cfg.num_kv_heads} KV of "
          f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
          f"tied embeddings {cfg.tie_embeddings}, {cfg.attn_pattern} with "
          f"window {cfg.sliding_window}, K = {GEMMA_K} scan steps, batch 1 "
          f"x seq 4096 [{card_line()}]", flush=True)
    tc, out, totals = _train_path("gemma", GEMMA_ARGV, "blocks/sub5/attn/wo")
    for name in ("block_sparse_dw", "fused_block_opt"):
        results["launches"][name] += totals[name]
    busy = phase_profile(tc, out, "one fixed-phase gemma step",
                         attention=True)
    n = _check_frozen(tc, out, "gemma")
    print(f"[gemma] frozen params bitwise equal to a fresh init ({n} leaves: "
          f"the tied embedding, the final norm, 4 frozen super-blocks); "
          f"profiled step busy {busy:.1f} ms", flush=True)


def _loop_chunk(a, h0, dt, xc, b_ssm, c):
    """The chunk's recurrence one step at a time (the design the port did
    not take): the same arithmetic as `models.mamba._ssm_chunk` on
    [B, d_inner, d_state] slices, Q launches deep."""
    from repro_torch.models import mamba as M
    h, ys = h0, []
    for t in range(dt.shape[1]):
        dA, dBx = M._discretize(a, dt[:, t], xc[:, t], b_ssm[:, t])
        h = dA * h + dBx
        ys.append(torch.einsum("bdn,bn->bd", h, c[:, t]))
    return h, torch.stack(ys, dim=1)


def mamba_scan_cost(cfg, batch: int, seq: int) -> dict:
    """One mamba layer's selective scan at a path's shapes, run as the train
    step runs it: inside the super-block's checkpoint and its own
    per-chunk checkpoints, so each chunk runs forward three times (the
    step's forward, the super-block's recompute, the chunk's own) and
    backward once. For the shipped chunk form (a log-depth scan over the
    chunk's 64 steps) and, beside it, the chunk as a 64-step loop: device
    ms and kernel launches from torch.profiler, and the host's ms (synced)
    for one layer."""
    from torch.profiler import ProfilerActivity, profile
    from torch.utils.checkpoint import checkpoint
    from repro_torch.models import mamba as M

    gen = torch.Generator(device="cuda").manual_seed(3)
    di, ns = M.d_inner(cfg), cfg.ssm.d_state
    leaf = lambda *shape: torch.randn(shape, generator=gen, device="cuda")
    a = -torch.arange(1, ns + 1, dtype=torch.float32,
                      device="cuda").repeat(di, 1)
    dt = M.softplus(leaf(batch, seq, di) - 4.0)
    args = [t.requires_grad_(True) for t in
            (a, dt, leaf(batch, seq, di), leaf(batch, seq, ns),
             leaf(batch, seq, ns))]
    h0 = torch.zeros((batch, di, ns), device="cuda")
    gy = leaf(batch, seq, di)

    def once():
        y = checkpoint(lambda *t: M.selective_scan(*t, h0)[0], *args,
                       use_reentrant=False)
        y.backward(gy)

    out = {}
    shipped = M._ssm_chunk
    for form, chunk in (("log-depth", shipped), ("loop", _loop_chunk)):
        M._ssm_chunk = chunk
        try:
            once()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            once()
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - t0) * 1e3
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                once()
                torch.cuda.synchronize()
        finally:
            M._ssm_chunk = shipped
        rows = _rows(prof)
        out[form] = {"device_ms": sum(_dev_us(e) for e in rows) / 1e3,
                     "kernels": sum(e.count for e in rows),
                     "host_ms": host_ms}
    return out


def phase_jamba_path(results: dict):
    """The jamba path at published widths, cut to one super-block and 4
    experts: 6 compact SGD steps through the launcher (`model=` the cut),
    the share of routed choices dropped, one profiled step with the mamba
    scan's share of device time, the frozen params and every expert leaf's
    unselected blocks through the first fixed phase against a fresh
    init."""
    from repro_torch.configs import get_config
    from repro_torch.data import lm_batches
    from repro_torch.models import mamba as M
    from repro_torch.models import moe as MOE
    from repro_torch.models import transformer as T

    full, cfg = get_config("jamba-1.5-large-398b"), jamba_cut()
    n_params = sum(t.numel() for t in _leaves(T.init_params(cfg, 0, "meta")))
    print(f"[jamba] jamba-1.5-large-398b at published widths (d_model "
          f"{cfg.d_model}, {cfg.num_heads} heads / {cfg.num_kv_heads} KV, "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, d_inner "
          f"{M.d_inner(cfg)}, d_state {cfg.ssm.d_state}, d_conv "
          f"{cfg.ssm.d_conv}, dt_rank {M.dt_rank(cfg)}, top-"
          f"{cfg.moe.top_k}); CUT: {full.num_layers} -> {cfg.num_layers} "
          f"layers (one super-block: attention at index "
          f"{cfg.attn_every // 2}, 7 mamba, MoE at the odd indices) and "
          f"{full.moe.num_experts} -> {cfg.moe.num_experts} experts; "
          f"{n_params} params, {2 * n_params} bytes in {cfg.dtype}",
          flush=True)
    snap = {}
    moe_subs = [f"sub{i}" for i in range(cfg.attn_every) if i % 2]

    def at_first_phase_end(step, state):
        if step == JAMBA_J:
            # the expert leaves at the end of the first fixed phase, with
            # its selection, kept on the host: held against a fresh init
            # after the run
            for sub in moe_subs:
                moe = state["params_trainable"]["segments"]["blocks"][sub][
                    "moe"]
                idx = state["sel_idx"]["blocks"][sub]["moe"]
                for n in EXPERT_LEAVES:
                    snap[f"{sub}/moe/{n}"] = (moe[n].cpu(), idx[n].clone())

    tc, out, totals = _train_path("jamba", JAMBA_ARGV,
                                  "blocks/sub0/mamba/out_proj", model=cfg,
                                  extra=at_first_phase_end)
    for name in ("block_sparse_dw", "batched_dw", "fused_block_opt"):
        results["launches"][name] += totals[name]

    # the share of routed choices the capacity dropped, over the 4 MoE
    # layers of one forward of the trained model on the next batch
    state = out["state"]
    batch = next(lm_batches(tc.shape.global_batch, tc.shape.seq_len,
                            cfg.vocab_size, seed=tc.seed, start_step=6))
    batch = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
    with torch.no_grad(), MOE.record_routing() as routed:
        T.forward(cfg, (state["params_frozen"], state["params_trainable"]),
                  batch)
    dropped = [float(d) / n for d, n in routed]
    print(f"[jamba] dropped share of routed choices "
          f"{sum(dropped) / len(dropped):.4f} (per MoE layer "
          f"{[round(x, 4) for x in dropped]})", flush=True)
    del state, batch
    busy = phase_profile(tc, out, "one fixed-phase jamba step")
    cost = mamba_scan_cost(cfg, tc.shape.global_batch, tc.shape.seq_len)
    scan = cost["log-depth"]
    n_mamba = cfg.attn_every - 1
    print(f"[jamba] mamba scan (plain PyTorch, chunks of {M.CHUNK}, the "
          f"step's checkpoints): one layer {scan['device_ms']:.1f} ms device "
          f"time, {scan['kernels']} kernels, host {scan['host_ms']:.1f} ms; "
          f"x {n_mamba} mamba layers = {n_mamba * scan['device_ms']:.1f} ms "
          f"and {n_mamba * scan['kernels']} kernels a step, "
          f"{n_mamba * scan['device_ms'] / busy:.4f} of the profiled step's "
          f"device busy {busy:.1f} ms. The chunk as a {M.CHUNK}-step loop "
          f"instead, one layer: {cost['loop']['device_ms']:.1f} ms device "
          f"time, {cost['loop']['kernels']} kernels, host "
          f"{cost['loop']['host_ms']:.1f} ms", flush=True)

    plan = out["plan"]

    def experts_unselected_unchanged(trainable0):
        for path, (w, idx) in snap.items():
            spec = _leaf(plan.spec["blocks"], path)
            w0 = _leaf(trainable0["segments"]["blocks"], path)
            w = w.cuda()
            mask = _selected_mask(w0, idx, spec)
            check(torch.equal(w[~mask], w0[~mask]),
                  f"jamba: an unselected block of {path} changed in the "
                  f"first fixed phase")
            check(not torch.equal(w[mask], w0[mask]),
                  f"jamba: the selected blocks of {path} did not move")
            del w, mask

    n = _check_frozen(tc, out, "jamba", experts_unselected_unchanged)
    print(f"[jamba] frozen params bitwise equal to a fresh init ({n} leaves: "
          f"embedding, head, final norm); the {len(snap)} expert leaves' "
          f"unselected blocks bitwise their init through the first fixed "
          f"phase ({JAMBA_J} steps), their selected blocks moved", flush=True)
    snap.clear()


def command_r_cut():
    """command-r-35b at published widths cut to COMMAND_R_LAYERS of its 40
    layers (see COMMAND_R_ARGV)."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("command-r-35b"),
                               num_layers=COMMAND_R_LAYERS)


def scout_cut(layers: int = SCOUT_LAYERS):
    """llama4-scout-17b-a16e at published widths, all 16 experts, cut to
    `layers` of its 48 (see SCOUT_ARGV); fewer than SCOUT_LAYERS only for
    the compact-against-dense-scatter check, whose fp32 update of the two
    trainable layers' full-shape expert leaves (~20 GB of temporaries)
    does not fit beside the 8-layer model."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("llama4-scout-17b-a16e"),
                               num_layers=layers)


def phase_text_arch(results: dict, tag: str, argv, watch: str, model=None,
                    cut: str = "no depth cut"):
    """One of the reference's other text-only archs at train_4k, batch 1:
    6 compact steps through the launcher (`model`: a stated cut), launches
    as the plan derives them, one profiled step with the flash path's
    share, the frozen params against a fresh init. With MoE layers
    (llama4-scout) also the share of routed choices dropped and every
    expert leaf's unselected blocks through the first fixed phase against
    the init."""
    from repro_torch.configs import get_config
    from repro_torch.data import lm_batches
    from repro_torch.models import moe as MOE
    from repro_torch.models import transformer as T

    full = get_config(argv[1])
    cfg = model or full
    n_params = sum(t.numel() for t in _leaves(T.init_params(cfg, 0, "meta")))
    moe = cfg.moe
    print(f"[{tag}] {full.name} at published widths (d_model {cfg.d_model}, "
          f"{cfg.num_heads} heads / {cfg.num_kv_heads} KV of "
          f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
          f"{cfg.mlp_kind}, {cfg.norm_kind}, tied embeddings "
          f"{cfg.tie_embeddings}"
          + (f", {moe.num_experts} experts top-{moe.top_k} + "
             f"{moe.num_shared_experts} shared" if moe else "")
          + f"); {cfg.num_layers} of {full.num_layers} layers ({cut}); "
          f"{n_params} params, {2 * n_params} bytes in {cfg.dtype} "
          f"[{card_line()}]", flush=True)
    snap = {}

    def at_first_phase_end(step, state):
        if moe is not None and step == SCOUT_J:
            # the expert leaves at the end of the first fixed phase, with
            # its selection, kept on the host: held against a fresh init
            # after the run
            leaves = state["params_trainable"]["segments"]["blocks"]["moe"]
            idx = state["sel_idx"]["blocks"]["moe"]
            snap.update({n: (leaves[n].cpu(), idx[n].clone())
                         for n in EXPERT_LEAVES})

    tc, out, totals = _train_path(tag, argv, watch, model=model,
                                  extra=at_first_phase_end)
    _add_launches(results, totals)
    if moe is not None:
        # the share of routed choices the capacity dropped, over every MoE
        # layer of one forward of the trained model on the next batch
        state = out["state"]
        batch = next(lm_batches(tc.shape.global_batch, tc.shape.seq_len,
                                cfg.vocab_size, seed=tc.seed, start_step=6))
        batch = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
        with torch.no_grad(), MOE.record_routing() as routed:
            T.forward(cfg, (state["params_frozen"],
                            state["params_trainable"]), batch)
        dropped = [float(d) / n for d, n in routed]
        print(f"[{tag}] dropped share of routed choices "
              f"{sum(dropped) / len(dropped):.4f} (per MoE layer "
              f"{[round(x, 4) for x in dropped]})", flush=True)
        del state, batch
    busy = phase_profile(tc, out, f"one fixed-phase {tag} step",
                         attention=True)
    plan = out["plan"]

    def experts_unselected_unchanged(trainable0):
        # one trainable layer at a time, masked with torch.where: boolean
        # indexing would build int64 indices, 8 bytes a dim an element
        for name, (w, idx) in snap.items():
            spec = plan.spec["blocks"]["moe"][name]
            w0 = trainable0["segments"]["blocks"]["moe"][name]
            mask = _selected_mask(w0, idx, spec)
            moved = False
            for layer in range(w0.shape[0]):
                a, b, m = w[layer].cuda(), w0[layer], mask[layer]
                check(torch.equal(torch.where(m, 0, a), torch.where(m, 0, b)),
                      f"{tag}: an unselected block of moe/{name} changed in "
                      f"the first fixed phase")
                moved |= not torch.equal(torch.where(m, a, 0),
                                         torch.where(m, b, 0))
                del a
            check(moved, f"{tag}: the selected blocks of moe/{name} did not "
                         f"move")
            del mask

    n = _check_frozen(tc, out, tag,
                      experts_unselected_unchanged if moe else None)
    print(f"[{tag}] frozen params bitwise equal to a fresh init ({n} "
          f"leaves: embedding, {'' if cfg.tie_embeddings else 'head, '}"
          f"final norm, {cfg.num_layers - K_LAYERS} frozen layers)"
          + (f"; the {len(snap)} expert leaves' unselected blocks bitwise "
             f"their init through the first fixed phase ({SCOUT_J} steps), "
             f"their selected blocks moved" if moe else "")
          + f"; profiled step busy {busy:.1f} ms", flush=True)
    snap.clear()


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


def _min_gap(seen) -> float:
    """The smallest top-2 logit gap over the recorded logits rows."""
    top = torch.topk(torch.cat(seen).float(), 2, dim=-1).values
    return float((top[:, 0] - top[:, 1]).min())


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
    results["serve_a"] = {
        "tokens": {k: list(r.tokens) for k, r in stats_a.results.items()},
        "median_ms": statistics.median(stats_a.decode_step_s) * 1e3}
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


def _bf16_ulp(x):
    """The spacing of bf16 numbers at |x| (8 significant bits)."""
    _, exp = torch.frexp(x.float().abs().clamp_min(2.0 ** -126))
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), exp - 8)


def profile_wave_scatter(wave):
    """The bf16 online wave's scatter launches under torch.profiler. A
    window that opens on the wave (CUDA activity only, as this phase first
    ran it) has missed some of its 7 launches; so the wave runs again with
    each scatter call inside a `record_function` range (a range with no
    device time names a launch the profiler missed; each launch's CUDA
    error is checked by its wrapper, and the wave is synced), and then
    under a schedule that discards one wave of warm-up and records the two
    after it, where all 14 must appear (a window that loses some anyway is
    profiled again, up to PROFILE_ATTEMPTS windows, as in `device_ms`).
    Then the wave's 7 scatter calls,
    recorded as it made them, replayed the way the wave computed them
    before the out-of-place mode (a copy of the leaf, then the in-place
    kernel) and as it computes them now (one out-of-place launch), device
    time each."""
    from torch.profiler import (ProfilerActivity, profile, record_function,
                                schedule)
    from repro_torch.kernels import ops

    calls = []
    launch = ops.block_scatter_update

    def record(w, vals, idx, spec, out=None):
        calls.append((w, vals, idx, spec))
        with record_function(f"scatter call {(len(calls) - 1) % 7}"):
            return launch(w, vals, idx, spec, out=out)

    def scatter_rows(prof):
        return [e for e in _rows(prof) if "scatter_columns_kernel" in e.key]

    both = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    ops.block_scatter_update = record
    before = ops.launch_counts()["block_scatter_update"]
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            wave()
            torch.cuda.synchronize()
        first = list(calls)
        with profile(activities=both) as ranged:
            wave()
            torch.cuda.synchronize()
        for windows in range(1, PROFILE_ATTEMPTS + 1):
            with profile(activities=both,
                         schedule=schedule(wait=0, warmup=1, active=2,
                                           repeat=1)) as warm:
                for _ in range(3):
                    wave()
                    torch.cuda.synchronize()
                    warm.step()
            if sum(e.count for e in scatter_rows(warm)) == 14:
                break
    finally:
        ops.block_scatter_update = launch
    launches = ops.launch_counts()["block_scatter_update"] - before
    n_waves = 2 + 3 * windows
    check(len(first) == 7 and len(calls) == 7 * n_waves
          and launches == 7 * n_waves,
          f"the profiled waves made {len(calls)} scatter calls and "
          f"{launches} scatter launches, want 7 a wave ({n_waves} waves)")
    busy = sum(_dev_us(e) for e in _rows(prof)) / 1e3
    ms = sum(_dev_us(e) for e in scatter_rows(prof)) / 1e3
    seen = {tag: sum(e.count for e in scatter_rows(p))
            for tag, p in (("first", prof), ("ranged", ranged),
                           ("warm", warm))}
    total = lambda e: getattr(e, "device_time_total",
                              getattr(e, "cuda_time_total", 0.0))
    per_call = {e.key: total(e) for e in ranged.key_averages()
                if e.key.startswith("scatter call ")}
    missing = sorted(k for k in (f"scatter call {i}" for i in range(7))
                     if per_call.get(k, 0.0) <= 0.0)
    kernels = {tag: sum(e.count for e in _rows(p))
               for tag, p in (("first", prof), ("ranged", ranged),
                              ("warm", warm))}
    print(f"[serve wave] scatter launches the profiler recorded: a window "
          f"opening on the wave (CUDA activity only) {seen['first']} of 7; "
          f"with CPU activity and a range per call {seen['ranged']} of 7 "
          f"(calls without device time: {missing or 'none'}); after one "
          f"wave of warm-up, {seen['warm']} of the next 2 waves' 14 (window "
          f"{windows} of at most {PROFILE_ATTEMPTS}). Kernels "
          f"of any kind recorded a wave: {kernels['first']}, "
          f"{kernels['ranged']}, {kernels['warm'] / 2:.1f}", flush=True)
    check(seen["warm"] == 14,
          f"the profiler recorded {seen['warm']} of 2 waves' 14 scatter "
          f"launches after a warm-up wave")
    first = first[:7]
    outs = [torch.empty_like(w) for w, _, _, _ in first]
    old = device_ms(lambda: [launch(w.clone(), v, i, s)
                             for w, v, i, s in first], reps=5,
                    kernel=("scatter_columns_kernel", 7))
    now = device_ms(lambda: [launch(w, v, i, s, out=o)
                             for (w, v, i, s), o in zip(first, outs)],
                    reps=5, kernel=("scatter_columns_kernel", 7))
    print(f"[serve wave] one bf16 wave under torch.profiler: device busy "
          f"{busy:.3f} ms; its scatter launches {ms:.4f} ms; the same 7 "
          f"calls replayed (L2 warm, device time): before, clone + in-place "
          f"kernel {old:.4f} ms; now, one out-of-place launch each "
          f"{now:.4f} ms", flush=True)
    del calls, first, outs


def phase_wave_bf16(cfg, eng):
    """The bf16 online wave against the f32 wave on the same bf16 inputs:
    run B's engine, user 0's selection, a zero delta, 16 tokens; the f32
    wave runs on the served bf16 weights cast to fp32 (exact) with
    `make_online_wave` on the f32 config. Both are one SGD step, so each
    delta element is -lr * dW on its selected block, and the bf16 one
    differs from the f32 one by
    - the rounding of the updated weight to bf16: at most half a bf16 ulp
      of max(|p|, |p + delta|), as the delta is read back as new - base;
    - the error of its dW, which comes from bf16 activations and weights
      (each rounding relative 2^-8 of the terms it rounds; about 16 of them
      in series along the 32-layer forward, the loss and the K-layer
      backward) and from the dW's own cast to bf16 (2^-8): bounded by
      2^-4 of the leaf's largest |delta|, since cancellation makes the
      error scale with the terms summed, not with each result.
    Each element is held within the sum of the two."""
    from repro_torch.core.delta import zeros_delta_tree
    from repro_torch.core.sparse_update import (SelSpec, gather_param_blocks,
                                                tree_map)
    from repro_torch.train.steps import make_online_wave

    eng._dbatch = None          # the slots' delta rows are not needed here
    gc.collect()
    torch.cuda.empty_cache()
    p13n, plan = eng._p13n, eng._plan
    idx = tree_map(lambda a: a.cuda(), eng._deltas.peek(0).idx)
    zeros = zeros_delta_tree(eng._trainable["segments"], idx, plan.spec,
                             device="cuda")
    draw = torch.Generator().manual_seed(5)
    toks = torch.randint(0, cfg.vocab_size, (1, p13n.train_tokens + 1),
                         generator=draw)
    batch = {"tokens": eng._tensor(toks[:, :-1]),
             "labels": eng._tensor(toks[:, 1:])}
    new_b, m_b = eng._wave(eng._trainable, eng._frozen, zeros, idx, batch)
    profile_wave_scatter(lambda: eng._wave(eng._trainable, eng._frozen, zeros,
                                           idx, batch))
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    wave32 = make_online_wave(cfg32, p13n.sparse, p13n.optimizer, plan,
                              wave_tokens=p13n.train_tokens)
    to32 = lambda a: a.float()
    new_f, m_f = wave32(tree_map(to32, eng._trainable),
                        tree_map(to32, eng._frozen), zeros, idx, batch)
    torch.cuda.synchronize()
    rows = []

    def walk(base, db, df, ix, spec, path):
        if isinstance(spec, SelSpec):
            p = gather_param_blocks(base, ix, spec).float()
            tol = 0.5 * _bf16_ulp(torch.maximum(p.abs(), (p + df).abs())) \
                + 2.0 ** -4 * float(df.abs().max())
            err = (db - df).abs()
            check(bool(torch.isfinite(db).all()) and bool((err <= tol).all()),
                  f"bf16 wave {path}: max |bf16 - f32| {float(err.max())} "
                  f"exceeds its bound at {int((err > tol).sum())} elements")
            rows.append((path, float(err.max()), float(df.abs().max()),
                         float(err.norm() / df.norm().clamp_min(1e-30)),
                         float((db == 0).float().mean())))
            return
        for name in spec:
            walk(base[name], db[name], df[name], ix[name], spec[name],
                 f"{path}/{name}")

    for seg, spec in plan.spec.items():
        walk(eng._trainable["segments"][seg], new_b[seg], new_f[seg],
             idx[seg], spec, seg)
    print(f"[serve wave] bf16 wave against the f32 wave on the same bf16 "
          f"inputs (llama3-8b full width, {p13n.train_tokens} tokens, sgd "
          f"lr {p13n.optimizer.learning_rate}): loss bf16="
          f"{float(m_b['loss']):.6f} f32={float(m_f['loss']):.6f}; per leaf "
          f"(max |bf16 - f32|, max |f32 delta|, relative norm, bf16 zero "
          f"share): " + "; ".join(f"{n} {e:.3e} {m:.3e} {r:.4f} {z:.3f}"
                                  for n, e, m, r, z in rows), flush=True)
    del new_b, new_f, zeros
    torch.cuda.empty_cache()


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

    greedy_oracle = lambda p, toks: _greedy_oracle(cfg, p, toks, gen,
                                                    max_len)

    plain = ServeEngine(cfg, params, num_slots=2, max_len=max_len,
                        page_size=16)
    seen = _record_logits(plain)
    stats = plain.run([Request(i, gen, tokens=t)
                       for i, t in enumerate(prompts[:2])])
    gap = _min_gap(seen)
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
    gap = _min_gap(seen)
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


# ---------------------------------------------------------------------------
# the audio and vlm archs (embedding inputs, M-RoPE) and checkpointing
# ---------------------------------------------------------------------------

def mrope_positions(batch: int, seq: int):
    """[3, batch, seq] M-RoPE positions on the card: a MROPE_GRID x
    MROPE_GRID patch grid (t 0; h, w its row and column), then text whose
    positions continue in all three components from the grid's largest + 1
    (qwen2-vl's rule): the three components differ."""
    n = MROPE_GRID * MROPE_GRID
    i = torch.arange(seq, device="cuda")
    grid = i < n
    text = i - n + MROPE_GRID
    thw = torch.stack([torch.where(grid, 0, text),
                       torch.where(grid, i // MROPE_GRID, text),
                       torch.where(grid, i % MROPE_GRID, text)])
    return thw.to(torch.int32)[:, None].expand(3, batch, seq)


def embed_batches(cfg, batch: int, seq: int, seed: int):
    """A `batches=` stream for the launcher (start_step -> iterator): step
    s's batch is drawn on the card from a generator seeded by (seed, s), so
    a resumed run sees the batches the uninterrupted one saw: standard
    normal embeddings in the model's dtype (the stub frontend's), uniform
    labels and, for M-RoPE, `mrope_positions`."""
    from repro_torch.models.transformer import dtype_of

    def stream(start: int):
        step = start
        while True:
            g = torch.Generator(device="cuda").manual_seed(
                seed * 1_000_003 + step)
            out = {"embeds": torch.randn((batch, seq, cfg.d_model),
                                         generator=g, device="cuda",
                                         dtype=dtype_of(cfg)),
                   "labels": torch.randint(0, cfg.vocab_size, (batch, seq),
                                           generator=g, device="cuda",
                                           dtype=torch.int32)}
            if cfg.mrope:
                out["positions"] = mrope_positions(batch, seq)
            yield out
            step += 1
    return stream


def phase_av_arch(results: dict, tag: str, argv, watch: str):
    """musicgen-medium or qwen2-vl-7b at train_4k, full depth: 6 compact
    AdamW steps through the launcher fed `embed_batches`, launches as the
    plan derives them, one profiled step with the flash path's share, the
    frozen params against a fresh init, then compact against dense-scatter
    bitwise at full depth. Returns the run's losses."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    cfg = get_config(argv[1])
    n_params = sum(t.numel() for t in _leaves(T.init_params(cfg, 0, "meta")))
    inputs = (f"positions a {MROPE_GRID} x {MROPE_GRID} patch grid (t 0, h, "
              f"w its coordinates) then text from {MROPE_GRID} in all three "
              f"components" if cfg.mrope else "1-D positions")
    print(f"[{tag}] {cfg.name} at published widths (d_model {cfg.d_model}, "
          f"{cfg.num_heads} heads / {cfg.num_kv_heads} KV of "
          f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff} {cfg.mlp_kind}, "
          f"{cfg.norm_kind}, vocab {cfg.vocab_size}, no token table: "
          f"embedding inputs, M-RoPE {cfg.mrope}); {cfg.num_layers} layers "
          f"(no depth cut); {n_params} params, {2 * n_params} bytes in "
          f"{cfg.dtype}; batch 2 x seq 4096 of standard-normal embeddings, "
          f"{inputs} [{card_line()}]", flush=True)
    batches = embed_batches(cfg, 2, 4096, seed=0)
    tc, out, totals = _train_path(tag, argv, watch, batches=batches)
    _add_launches(results, totals)
    losses = list(out["losses"])
    busy = phase_profile(tc, out, f"one fixed-phase {tag} step",
                         attention=True, batches=batches)
    n = _check_frozen(tc, out, tag)
    print(f"[{tag}] frozen params bitwise equal to a fresh init ({n} leaves: "
          f"head, final norm, {cfg.num_layers - K_LAYERS} frozen layers); "
          f"profiled step busy {busy:.1f} ms", flush=True)
    phase_compact_vs_dense(cfg, f"{tag}-compact-vs-dense", batch=2,
                           seq=4096, batches=embed_batches(cfg, 2, 4096, 1))
    return losses


def _capture_decode_embeds(engine):
    """Record, per request id, the placeholder embedding each of its decode
    steps fed (the engine draws a fresh [slots, 1, d] a step): returns
    ({rid: [[d] tensors]}, undo). A request's first token is its prefill's;
    each later one samples a decode step's logits at the request's slot."""
    from repro_torch.serve import scheduler as S
    fed, last = {}, {}
    make_decode, make_chunk = engine._decode_batch, engine._chunk_batch
    record = S.Scheduler.record_token

    def decode_batch(*args):
        batch = make_decode(*args)
        last["embeds"] = batch["embeds"][:, 0].clone()
        return batch

    def chunk_batch(*args):
        last.clear()
        return make_chunk(*args)

    def record_token(sched, slot, token):
        if last:
            fed.setdefault(slot.request.rid, []).append(
                last["embeds"][slot.index])
        return record(sched, slot, token)

    def undo():
        S.Scheduler.record_token = record
        del engine._decode_batch, engine._chunk_batch

    engine._decode_batch, engine._chunk_batch = decode_batch, chunk_batch
    S.Scheduler.record_token = record_token
    return fed, undo


def _embed_oracle(cfg, params, prompt, fed, max_len: int) -> list:
    """Greedy tokens of the contiguous prefill + decode_step path fed the
    prompt's embeddings [plen, d] and then the decode embeddings `fed`, at
    the positions the engine gives them ([3, 1, S] equal components for
    M-RoPE)."""
    from repro_torch.models import decoding as D

    def pos(start, n):
        p = torch.arange(start, start + n, device="cuda")[None]
        return p.expand(3, 1, n) if cfg.mrope else p
    plen = len(prompt)
    logits, cache = D.prefill(cfg, params, {
        "embeds": torch.as_tensor(prompt).cuda()[None],
        "positions": pos(0, plen)}, pad_to=max_len)
    out = [int(logits.argmax(-1)[0])]
    for j, e in enumerate(fed):
        logits, cache = D.decode_step(cfg, params, {
            "embeds": e[None, None], "positions": pos(plen + j, 1)}, cache)
        out.append(int(logits.argmax(-1)[0]))
    return out


def phase_serve_av():
    """Both archs served at full depth through the serve launcher's
    `build_engine`: 4 slots, pages of 16, 8 requests of 128 + 32 (prompt
    embeddings from `make_random_requests`, fresh placeholder embeddings a
    decode step), prefix_mode off, greedy; no port kernel launched. Then at
    full widths cut to 4 layers in f32, 3 requests on 2 slots: every
    request's tokens equal the contiguous oracle's fed the same prompt and
    decode embeddings, every sampled step's top-2 gap probed."""
    import argparse
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    from repro_torch.serve import ServeEngine, make_random_requests
    ap = serve.add_serve_args(argparse.ArgumentParser())
    for arch in ("musicgen-medium", "qwen2-vl-7b"):
        tag = f"serve {arch}"
        args = ap.parse_args(["--arch", arch] + SERVE_ARGV[2:]
                             + ["--users", "0"])
        cfg, eng = serve.build_engine(args)
        n_bytes = sum(t.numel() * t.element_size()
                      for t in _leaves(eng.params))
        print(f"[{tag}] {cfg.num_layers} layers (no depth cut), {cfg.dtype}, "
              f"params {n_bytes} bytes, 4 slots, page 16, prefix_mode "
              f"{eng.prefix_mode}, greedy, 8 requests x (128 prompt + 32 "
              f"new), placeholder decode embeddings [{card_line()}]",
              flush=True)
        reqs = serve.build_requests(args, cfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        stats = eng.run(reqs)
        counts = ops.launch_counts()
        _serve_summary(tag, stats)
        check(stats.requests_completed == 8 and stats.requests_cancelled == 0
              and stats.tokens_out == 8 * 32,
              f"{tag}: {stats.requests_completed} completed, "
              f"{stats.tokens_out} tokens")
        check(all(0 <= t < cfg.vocab_size for r in stats.results.values()
                  for t in r.tokens), f"{tag}: a token out of the vocab")
        check(not any(counts.values()),
              f"{tag}: a port kernel launched on plain serving: {counts}")
        del eng, reqs
        gc.collect()
        torch.cuda.empty_cache()

    for arch in ("musicgen-medium", "qwen2-vl-7b"):
        cfg = dataclasses.replace(get_config(arch), num_layers=4,
                                  dtype="float32")
        params = T.init_params(cfg, 0, "cuda")
        plen, gen, max_len = 40, 8, 48
        reqs = make_random_requests(cfg, 3, plen, gen, seed=3)
        eng = ServeEngine(cfg, params, num_slots=2, max_len=max_len,
                          page_size=16)
        seen = _record_logits(eng)
        fed, undo = _capture_decode_embeds(eng)
        try:
            stats = eng.run(reqs)
        finally:
            undo()
        gap = _min_gap(seen)
        check(gap > 1e-4, f"{arch} oracle parity: a near-tie (top-2 gap "
                          f"{gap}) makes the token comparison unsound")
        for r in reqs:
            check(len(fed[r.rid]) == gen - 1,
                  f"{arch} request {r.rid}: {len(fed[r.rid])} decode steps")
            check(stats.results[r.rid].tokens == _embed_oracle(
                      cfg, params, r.embeds, fed[r.rid], max_len),
                  f"{arch} request {r.rid}: the engine's tokens differ from "
                  f"the contiguous oracle's")
        print(f"[serve oracle] {arch} widths cut to {cfg.num_layers} layers, "
              f"f32, 3 requests on 2 slots: engine == contiguous oracle fed "
              f"the same prompt and decode embeddings ({plen} prompt + {gen} "
              f"new); min top-2 gap {gap:.3e}", flush=True)
        del eng, params, seen, fed
        gc.collect()
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# serving for every cache family (phases 24-27)
# ---------------------------------------------------------------------------

# sliding-window rings: 4 of 1088 + 32 (every 1024-slot ring wraps in
# prefill) and 4 of 128 + 32, pages of 64
GEMMA_SERVE = ("gemma3-4b", 64, [(4, 1088, 32), (4, 128, 32)])
# recurrent state, MoE, hybrid: the LM serving cell's traffic, pages of 16
FAMILY_SERVE = [(8, 128, 32)]


def _family_requests(cfg, specs, seed: int = 0):
    """[(n, prompt, new)] groups of random requests, rids in order."""
    from repro_torch.serve import make_random_requests
    reqs = []
    for i, (n, plen, gen) in enumerate(specs):
        for r in make_random_requests(cfg, n, plen, gen, seed=seed + i):
            r.rid = len(reqs)
            reqs.append(r)
    return reqs


def _serve_family(tag, arch, page_size, specs, results, model=None,
                  watch=None, cut=""):
    """One full-width (or stated-cut) serve run through the serve
    launcher's `build_engine`: 4 slots, prefix_mode off, greedy; counts
    zeroed just before the run and read just after. Every request
    completes with in-vocab tokens; the launches are checked by the
    caller's `watch(stats, counts)`. Frees the model. Returns the stats."""
    import argparse
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    longest = max(plen + gen for _, plen, gen in specs)
    args = serve.add_serve_args(argparse.ArgumentParser()).parse_args(
        ["--arch", arch, "--batch", "4", "--page-size", str(page_size),
         "--prompt-len", str(longest - specs[0][2]), "--gen-len",
         str(specs[0][2]), "--prefix-mode", "off", "--seed", "0"])
    cfg, eng = serve.build_engine(args, cfg=model)
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(eng.params))
    reqs = _family_requests(cfg, specs)
    print(f"[{tag}] {cfg.name}: {cfg.num_layers} layers{cut}, {cfg.dtype}, "
          f"params {n_bytes} bytes, 4 slots, page {page_size} "
          f"({eng.num_pages} pages), prefix_mode off, greedy, requests "
          f"{[(n, p, g) for n, p, g in specs]} (n, prompt, new) "
          f"[{card_line()}]", flush=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    stats = eng.run(reqs)
    counts = ops.launch_counts()
    _serve_summary(tag, stats)
    n_new = sum(r.max_new_tokens for r in reqs)
    check(stats.requests_completed == len(reqs)
          and stats.tokens_out == n_new,
          f"{tag}: {stats.requests_completed} of {len(reqs)} completed, "
          f"{stats.tokens_out} of {n_new} tokens")
    check(all(0 <= t < cfg.vocab_size for r in stats.results.values()
              for t in r.tokens), f"{tag}: a token out of the vocab")
    (watch or _no_port_kernel)(tag, stats, counts)
    print(f"[{tag}] launches {counts} [{card_line()}]", flush=True)
    profile_decode(tag, eng)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return stats


def profile_decode(tag, eng):
    """One decode step of the engine's model (every slot active, at its
    last position: every page allocated, the rings full) under
    torch.profiler after one warm step: wall and device time, the idle
    share, the port's kernels' share, the largest kernel rows. The state
    is zero: the step's work does not depend on its values."""
    from repro_torch.models import decoding as D
    b, ps = eng.num_slots, eng.page_size
    state, pools = D.init_serve_cache(eng.cfg, b, eng.max_len,
                                      max(1, eng.num_pages), ps,
                                      device="cuda")
    pt = torch.arange(b * eng.max_pages, dtype=torch.int32,
                      device="cuda").view(b, eng.max_pages)
    if eng.has_pages:
        pt = pt % max(1, eng.num_pages)
    batch = {"tokens": torch.ones((b, 1), dtype=torch.int32, device="cuda"),
             "start": torch.full((b,), eng.max_len - 1, dtype=torch.int32,
                                 device="cuda"),
             "active": torch.ones((b,), dtype=torch.bool, device="cuda"),
             "length": torch.ones((b,), dtype=torch.int32, device="cuda")}
    step = lambda: D.paged_step(eng.cfg, eng.params, batch, state, pools,
                                pt, page_size=ps,
                                flash_decode=eng.flash_decode)
    step()
    profile_step(f"{tag}: one decode step ({b} slots at position "
                 f"{eng.max_len - 1})", step)
    del state, pools


def _no_port_kernel(tag, stats, counts):
    check(not any(counts.values()),
          f"{tag}: a port kernel launched on plain serving: {counts}")


@contextlib.contextmanager
def _route_gaps():
    """Within the block, every MoE routing records the smallest gap between
    a token's k-th and (k+1)-th router probabilities (a device tensor):
    where it is under 1e-5 two computations of the same token may route it
    differently (ROADMAP queue C). Yields the list."""
    from repro_torch.models import moe as MOE
    route, gaps = MOE.route, []

    def recording(router, x_flat, k):
        out = route(router, x_flat, k)
        top = torch.topk(out[1], min(k + 1, out[1].shape[-1]), dim=-1).values
        if top.shape[-1] > k:
            gaps.append((top[:, k - 1] - top[:, k]).min())
        return out
    MOE.route = recording
    try:
        yield gaps
    finally:
        MOE.route = route


def _greedy_oracle(cfg, params, toks, gen: int, max_len: int) -> list:
    """Greedy tokens of the contiguous prefill + decode_step path."""
    from repro_torch.models import decoding as D
    logits, cache = D.prefill(cfg, params, {"tokens": torch.as_tensor(
        toks).cuda()[None]}, pad_to=max_len)
    out = [int(logits.argmax(-1)[0])]
    for t in range(len(toks), len(toks) + gen - 1):
        logits, cache = D.decode_step(
            cfg, params, {"tokens": torch.tensor([[out[-1]]], device="cuda"),
                          "positions": torch.full((1, 1), t, device="cuda")},
            cache)
        out.append(int(logits.argmax(-1)[0]))
    return out


def _family_oracle(tag, cfg, specs, page_size, moe_probe=False):
    """At the stated cut in f32: every request's engine tokens (2 slots,
    so the third request refills a slot) against the contiguous oracle's,
    every sampled step's top-2 logit gap probed (under 1e-4 fails: the
    comparison would be unsound). With moe_probe a mismatch is reported,
    not failed, when some routing had its k-th and (k+1)-th router
    probabilities within 1e-5 (ROADMAP queue C); the capacity factor is
    raised to E / k, so no choice is dropped on either side (chunked and
    whole-prompt prefill route different token sets), as the reference's
    own prefill / decode test does."""
    from repro_torch.models import transformer as T
    from repro_torch.serve import ServeEngine
    params = T.init_params(cfg, 0, "cuda")
    reqs = _family_requests(cfg, specs, seed=3)
    max_len = max(r.prompt_len + r.max_new_tokens for r in reqs)
    eng = ServeEngine(cfg, params, num_slots=2, max_len=max_len,
                      page_size=page_size)
    seen = _record_logits(eng)
    with _route_gaps() as gaps:
        stats = eng.run(reqs)
        want = {r.rid: _greedy_oracle(cfg, params, r.tokens,
                                      r.max_new_tokens, max_len)
                for r in reqs}
        route_gap = float(torch.stack(gaps).min()) if gaps else None
    gap = _min_gap(seen)
    check(gap > 1e-4, f"{tag} oracle parity: a near-tie (top-2 gap {gap}) "
                      f"makes the token comparison unsound")
    differ = [r.rid for r in reqs if stats.results[r.rid].tokens
              != want[r.rid]]
    if differ and moe_probe and route_gap is not None and route_gap < 1e-5:
        print(f"[{tag} oracle] requests {differ} differ from the oracle "
              f"with a router near-tie (smallest k-th / (k+1)-th gap "
              f"{route_gap:.3e} < 1e-5): reported, not failed", flush=True)
    else:
        check(not differ, f"{tag} oracle parity: requests {differ} differ "
                          f"from the contiguous oracle (router gap "
                          f"{route_gap})")
    shapes = [(r.prompt_len, r.max_new_tokens) for r in reqs]
    print(f"[{tag} oracle] {cfg.name} widths, {cfg.num_layers} layers, f32, "
          f"{len(reqs)} requests {shapes} on 2 slots, page {page_size}: "
          f"engine == contiguous oracle for "
          f"{len(reqs) - len(differ)}; min top-2 gap {gap:.3e}; min router "
          f"gap {route_gap}", flush=True)
    del eng, params, seen
    gc.collect()
    torch.cuda.empty_cache()


def phase_serve_gemma(results: dict):
    """Phase 24: full-width gemma3-4b (34 layers: 5 super-blocks of 5
    local + 1 global, 4 local in the tail; window 1024, tied vocab
    262144): the 29 local layers serve from 1024-slot rings, the 5 global
    ones from pages of 64. No port kernel on the path. Then the oracle at
    published widths cut to one super-block (6 layers), f32, the
    1088-token prompt (its rings wrap) and a 128-token one."""
    from repro_torch.configs import get_config
    arch, page, specs = GEMMA_SERVE
    _serve_family("serve gemma3-4b", arch, page, specs, results)
    cfg = dataclasses.replace(get_config(arch), num_layers=6,
                              dtype="float32")
    _family_oracle("serve gemma3-4b", cfg, [(1, 1088, 8), (2, 128, 8)], page)


def phase_serve_rwkv(results: dict):
    """Phase 25: full-width rwkv6-3b (32 layers; state only, no pages):
    exactly 32 wkv6 launches (the state form) a prefill chunk and a decode
    step, nothing else. Then the oracle at 4 layers, f32."""
    from repro_torch.configs import get_config

    def watch(tag, stats, counts):
        steps = stats.prefill_chunks + len(stats.decode_step_s)
        check(counts["wkv6"] == 32 * steps,
              f"{tag}: {counts['wkv6']} wkv6 launches, want 32 x "
              f"({stats.prefill_chunks} prefill chunks + "
              f"{len(stats.decode_step_s)} decode steps)")
        check(sum(counts.values()) == counts["wkv6"],
              f"{tag}: another port kernel launched: {counts}")
        check(stats.pages_total == stats.pages_peak == 0,
              f"{tag}: a state-only arch allocated pages")
        print(f"[{tag}] wkv6 launches {counts['wkv6']} = 32 x "
              f"({stats.prefill_chunks} prefill chunks + "
              f"{len(stats.decode_step_s)} decode steps)", flush=True)
        results["launches"]["wkv6"] += counts["wkv6"]

    _serve_family("serve rwkv6-3b", "rwkv6-3b", 16, FAMILY_SERVE, results,
                  watch=watch)
    cfg = dataclasses.replace(get_config("rwkv6-3b"), num_layers=4,
                              dtype="float32")
    _family_oracle("serve rwkv6-3b", cfg, [(3, 40, 8)], 16)


def _no_drop(cfg):
    """The capacity factor at E / k: capacity >= the tokens of a call."""
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))


def phase_serve_moe(results: dict):
    """Phase 26: full-width deepseek-moe-16b (28 layers, 64 experts top-6
    + 2 shared; its capacity factor as configured), then the jamba cut of
    the train phase (published widths, one super-block of 8 layers: 7
    mamba with per-slot state, attention at index 4 on pages, MoE of 4 of
    16 experts on the odd FFNs) with one more request of a 3-token prompt
    (shorter than d_conv - 1). Then each oracle in f32: deepseek cut to 4
    layers, the jamba cut further to a 4-layer super-block and 2 experts
    (the 8-layer cut in f32 would hold 65 GB), with the router near-tie
    probe."""
    from repro_torch.configs import get_config
    _serve_family("serve deepseek-moe-16b", "deepseek-moe-16b", 16,
                  FAMILY_SERVE, results)
    _serve_family("serve jamba", "jamba-1.5-large-398b", 16,
                  FAMILY_SERVE + [(1, 3, 32)], results, model=jamba_cut(),
                  cut=f" (cut 72 -> {JAMBA_LAYERS}, experts 16 -> "
                      f"{JAMBA_EXPERTS})")
    cfg = _no_drop(dataclasses.replace(get_config("deepseek-moe-16b"),
                                       num_layers=4, dtype="float32"))
    _family_oracle("serve deepseek-moe-16b", cfg, [(3, 40, 8)], 16,
                   moe_probe=True)
    cfg = _no_drop(dataclasses.replace(jamba_cut(experts=2, period=4),
                                       dtype="float32"))
    _family_oracle("serve jamba", cfg, [(2, 40, 8), (1, 3, 8)], 16,
                   moe_probe=True)


def _capture_request_logits(engine):
    """Record, per request id, the logits row each of its tokens was
    sampled from (fp32, on the card): returns ({rid: [[V] tensors]},
    undo)."""
    from repro_torch.serve import scheduler as S
    rows, last = {}, {}
    sample, record = engine._sample, S.Scheduler.record_token

    def keep(logits):
        last["logits"] = logits
        return sample(logits)

    def record_token(sched, slot, token):
        lg = last["logits"]
        rows.setdefault(slot.request.rid, []).append(
            lg[0 if lg.shape[0] == 1 else slot.index].float().clone())
        return record(sched, slot, token)

    def undo():
        S.Scheduler.record_token = record
        del engine._sample

    engine._sample = keep
    S.Scheduler.record_token = record_token
    return rows, undo


def phase_flash_decode(results: dict):
    """Phase 27: serve run A of phase 13 (full-width llama3-8b, 8 x (128 +
    32), bf16) again, plain and with --flash-decode, on one copy of the
    weights. The plain run's tokens equal phase 13's run A bitwise; the
    flash run's equal them except where a request first differs at a near
    tie: the plain run's top-2 logit gap at that step no larger than twice
    the largest difference between the two runs' logits there (the split
    softmax rounds its unnormalized probabilities to bf16 where the
    monolithic one rounds normalized ones). Every such tie is printed;
    any other difference fails."""
    import argparse
    from repro_torch.launch import serve
    ap = serve.add_serve_args(argparse.ArgumentParser())
    args_a = ap.parse_args(SERVE_ARGV + ["--users", "0"])
    args_f = ap.parse_args(SERVE_ARGV + ["--users", "0", "--flash-decode"])
    cfg, eng_a = serve.build_engine(args_a)
    _, eng_f = serve.build_engine(args_f, cfg, params=eng_a.params)
    check(eng_f.flash_decode and not eng_a.flash_decode,
          "--flash-decode did not reach the engine")
    runs = {}
    for tag, eng in (("plain", eng_a), ("flash-decode", eng_f)):
        rows, undo = _capture_request_logits(eng)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        try:
            stats = eng.run(serve.build_requests(args_a, cfg))
        finally:
            undo()
        _serve_summary(f"serve flash-decode: {tag}", stats)
        profile_decode(f"serve flash-decode: {tag}", eng)
        runs[tag] = (stats, rows)
    plain, flash = runs["plain"], runs["flash-decode"]
    want = results["serve_a"]["tokens"]
    check({k: r.tokens for k, r in plain[0].results.items()} == want,
          "phase 27's plain run differs from phase 13's run A")
    ties = []
    for rid, toks in want.items():
        got = flash[0].results[rid].tokens
        first = next((i for i, (a, b) in enumerate(zip(toks, got))
                      if a != b), None)
        if first is None:
            continue
        la, lf = plain[1][rid][first], flash[1][rid][first]
        top = torch.topk(la, 2).values
        gap = float(top[0] - top[1])
        diff = float((la - lf).abs().max())
        check(gap <= 2 * diff,
              f"flash-decode request {rid} differs at token {first} with a "
              f"top-2 gap {gap} over twice the logit difference {diff}")
        ties.append((rid, first, gap, diff))
        print(f"[serve flash-decode] near tie: request {rid} token {first}: "
              f"plain top-2 gap {gap:.4f}, max |logit diff| {diff:.4f}; "
              f"the rest of the request is not compared", flush=True)
    # the logits of the steps both runs fed the same tokens
    upto = {rid: first for rid, first, _, _ in ties}
    diffs = [float((a - b).abs().max()) for rid in want
             for a, b in list(zip(plain[1][rid], flash[1][rid]))[
                 :upto.get(rid, len(want[rid])) + 1]]
    med_a = statistics.median(plain[0].decode_step_s) * 1e3
    med_f = statistics.median(flash[0].decode_step_s) * 1e3
    print(f"[serve flash-decode] llama3-8b full width, bf16: tokens equal "
          f"run A's for {len(want) - len(ties)} of {len(want)} requests, "
          f"{len(ties)} near ties; max |logit diff| before any divergence "
          f"{max(diffs):.4f}; decode_step_ms_median flash-decode {med_f:.3f}"
          f" vs plain {med_a:.3f} (phase 13 run A "
          f"{results['serve_a']['median_ms']:.3f}) [{card_line()}]",
          flush=True)
    del eng_a, eng_f, runs, plain, flash
    gc.collect()
    torch.cuda.empty_cache()


def _rss_kib() -> int:
    """This process's resident set (VmRSS) in KiB."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1])
    raise SmokeError("/proc/self/status has no VmRSS")


class _RssPeak:
    """The largest VmRSS seen between `start()` and `stop()`, sampled every
    20 ms by a thread: the host's peak over one phase (/proc/self/status
    may lack VmHWM, and the process-lifetime peak holds earlier phases')."""

    def start(self):
        import threading
        self.before = self.peak = _rss_kib()
        self._done = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()

    def _sample(self):
        while not self._done.wait(0.02):
            self.peak = max(self.peak, _rss_kib())

    def stop(self):
        self._done.set()
        self._thread.join(timeout=5)
        self.peak = max(self.peak, _rss_kib())


class _Tee:
    """stdout that keeps a copy of what is written."""

    def __init__(self, out):
        self.out, self.seen = out, []

    def write(self, text):
        self.seen.append(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()


def phase_checkpoint(musicgen_losses: list):
    """Checkpoint and resume: phase 20's argv with --ckpt-dir and
    --ckpt-every 3 (saves at steps 3 and 6, the reference's file format),
    its losses bitwise phase 20's; the step-6 file deleted and the same
    argv again: it resumes from step 3, steps 4-6 give bitwise the same
    losses and the final trainable params and optimizer state are bitwise
    the first run's. Then a save made torn by a `FaultSchedule` (`torn`
    rate 1): restore falls back to the intact step 6. Prints the codec, the
    file bytes, save and restore seconds and the host's peak RSS during the
    phase."""
    import os
    import shutil
    import warnings
    from repro_torch import bridge
    from repro_torch.checkpoint import manager as CM
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.runtime import FaultSchedule

    cfg = get_config("musicgen-medium")
    ckdir = ROOT / "build" / "checkpoint_phase"
    shutil.rmtree(ckdir, ignore_errors=True)
    argv = MUSICGEN_ARGV + ["--ckpt-dir", str(ckdir), "--ckpt-every", "3"]
    batches = embed_batches(cfg, 2, 4096, seed=0)
    times = {"save": [], "restore": []}
    real = {k: getattr(CM.CheckpointManager, k) for k in times}

    def timed(kind):
        def call(self, *args, **kw):
            t0 = time.perf_counter()
            try:
                return real[kind](self, *args, **kw)
            finally:
                times[kind].append(time.perf_counter() - t0)
        return call

    def leaves_of(state):
        return _leaves(state["params_trainable"]) + _leaves(state["opt"])

    print(f"[checkpoint] codec {CM.codec()} (zlib level "
          f"{CM.ZLIB_LEVEL} when zstandard is missing), {cfg.name} full "
          f"depth, argv {' '.join(argv[:2])} ... --ckpt-every 3; disk free "
          f"{shutil.disk_usage(ROOT).free} bytes", flush=True)
    for kind in times:
        setattr(CM.CheckpointManager, kind, timed(kind))
    rss = _RssPeak()
    rss.start()
    try:
        out = train.main(argv, batches=batches)
        files = sorted(os.listdir(ckdir))
        check(files == ["step_000000003.ckpt", "step_000000006.ckpt"],
              f"checkpoint run: files {files}")
        sizes = [os.path.getsize(ckdir / f) for f in files]
        losses_a = out["losses"]
        check(losses_a == musicgen_losses,
              f"checkpointing changed the run: losses {losses_a} against "
              f"{musicgen_losses}")
        kept = [t.cpu() for t in leaves_of(out["state"])]
        del out
        gc.collect()
        torch.cuda.empty_cache()
        os.remove(ckdir / files[-1])

        tee = _Tee(sys.stdout)
        with contextlib.redirect_stdout(tee):
            out = train.main(argv, batches=batches)
        check("resumed from step 3" in "".join(tee.seen)
              and out["start"] == 3,
              "the second run did not resume from step 3")
        check(out["losses"] == losses_a[3:],
              f"resumed losses {out['losses']} against {losses_a[3:]}")
        got = leaves_of(out["state"])
        check(len(got) == len(kept) and all(
            torch.equal(a, b.cuda()) for a, b in zip(got, kept)),
              "the resumed run's trainable params or optimizer state differ "
              "from the uninterrupted run's")
        del got, kept

        torn = CM.CheckpointManager(str(ckdir), chaos=FaultSchedule(
            0, rates={"torn": 1.0}))
        torn.save(7, bridge.state_to_tree(out["state"]))
        check(torn.torn_writes == 1, "the torn save was not torn")
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            tree, meta = CM.CheckpointManager(str(ckdir)).restore(
                target=bridge.state_to_tree(out["state"]))
        check(meta["step"] == 6 and any("step 7" in str(w.message)
                                        for w in caught),
              f"restore past the torn step 7 gave step {meta['step']}")
        check(all(torch.equal(a, b) for a, b in zip(
            _leaves(tree), _leaves(bridge.state_to_tree(out["state"])))),
              "the restored step 6 differs from the run's state")
        del tree, out
    finally:
        rss.stop()
        for kind, fn in real.items():
            setattr(CM.CheckpointManager, kind, fn)
        shutil.rmtree(ckdir, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    print(f"[checkpoint] resumed from step 3: steps 4-6 losses bitwise the "
          f"uninterrupted run's, final trainable params and optimizer state "
          f"bitwise equal; a torn step 7 fell back to step 6. codec "
          f"{CM.codec()}, file bytes {sizes} (steps 3, 6), save_s "
          f"{[round(t, 3) for t in times['save']]} (steps 3, 6, 6 resumed, "
          f"7 torn), restore_s {[round(t, 3) for t in times['restore']]} "
          f"(the resume, then past the torn file), host peak RSS during the "
          f"phase {rss.peak} KiB (before it {rss.before} KiB) "
          f"[{card_line()}]", flush=True)


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
    leaf shapes of one trainable MoE layer; wkv6 / wkv6_bwd one call at the
    rwkv path's shapes (batch 4 x 1024 x 40 heads x 64);
    block_scatter_update its out-of-place mode (the one the serving wave
    runs) over the wave's 7 leaves. Launches: the LM path's run (6 steps),
    the MoE path's run (6 steps; batched_dw), the rwkv path's run (6 steps;
    wkv6, wkv6_bwd), the CNN path's run (12 steps of `dynamic`) and
    serving run B (8 waves; block_scatter_update), plus the gemma path's
    (6 steps; block_sparse_dw, fused_block_opt), the jamba path's (6
    steps; block_sparse_dw, batched_dw, fused_block_opt) and the train_4k,
    nemotron, command-r, llama4-scout, musicgen-medium and qwen2-vl-7b
    runs' (6 steps each; the scout's batched_dw too)."""
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
    tc, out = phase_rwkv_path(results)
    print(f"[chip_smoke] rwkv path done at {time.perf_counter() - t0:.0f} s",
          flush=True)
    phase_profile(tc, out, "one fixed-phase rwkv step")
    phase_rwkv_frozen(tc, out)
    del out
    gc.collect()
    torch.cuda.empty_cache()
    phase_compact_vs_dense(dataclasses.replace(
        get_config("rwkv6-3b"), num_layers=4), "rwkv-compact-vs-dense")
    torch.cuda.empty_cache()
    print(f"[chip_smoke] rwkv phases done at {time.perf_counter() - t0:.0f} s",
          flush=True)
    phase_gemma_path(results)
    phase_compact_vs_dense(dataclasses.replace(
        get_config("gemma3-4b"), num_layers=10), "gemma-compact-vs-dense",
        k=GEMMA_K, batch=1, seq=4096)
    print(f"[chip_smoke] gemma phases done at {time.perf_counter() - t0:.0f}"
          f" s", flush=True)
    phase_jamba_path(results)
    phase_compact_vs_dense(jamba_cut(experts=2, period=4),
                           "jamba-compact-vs-dense", k=1, batch=2, seq=1024,
                           one_at_a_time=True)
    print(f"[chip_smoke] jamba phases done at {time.perf_counter() - t0:.0f}"
          f" s", flush=True)
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
    phase_wave_bf16(cfg, eng)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    phase_serve_oracle()
    print(f"[chip_smoke] serving phases done at "
          f"{time.perf_counter() - t0:.0f} s", flush=True)
    # the long-sequence paths last: the earlier phases' profiler windows
    # then open at the same point of the process as before them
    phase_flash()
    print(f"[chip_smoke] flash against dense done at "
          f"{time.perf_counter() - t0:.0f} s", flush=True)
    phase_train4k(results)
    phase_compact_vs_dense(get_config("llama3-8b"), "train4k-compact-vs-dense",
                           batch=2, seq=4096)
    print(f"[chip_smoke] train_4k phases done at "
          f"{time.perf_counter() - t0:.0f} s", flush=True)
    phase_prefill()
    print(f"[chip_smoke] prefill phases done at "
          f"{time.perf_counter() - t0:.0f} s", flush=True)
    phase_text_arch(results, "nemotron", NEMOTRON_ARGV, "blocks/mlp/w_up")
    phase_compact_vs_dense(get_config("nemotron-4-15b"),
                           "nemotron-compact-vs-dense", batch=1, seq=4096)
    phase_text_arch(results, "command-r", COMMAND_R_ARGV, "blocks/mlp/w_gate",
                    model=command_r_cut(),
                    cut=f"cut 40 -> {COMMAND_R_LAYERS}: the uncut bf16 "
                        f"params, the tied head's fp32 copy and AdamW's "
                        f"state leave no room for a step")
    phase_compact_vs_dense(command_r_cut(), "command-r-compact-vs-dense",
                           batch=1, seq=4096, one_at_a_time=True)
    phase_text_arch(results, "scout", SCOUT_ARGV, "blocks/attn/wo",
                    model=scout_cut(),
                    cut=f"cut 48 -> {SCOUT_LAYERS}, all 16 experts: ~108 B "
                        f"params uncut; SGD, AdamW's state on one layer "
                        f"alone ~17.6 GB")
    phase_compact_vs_dense(scout_cut(layers=4), "scout-compact-vs-dense",
                           batch=1, seq=4096, one_at_a_time=True)
    print(f"[chip_smoke] text-arch phases done at "
          f"{time.perf_counter() - t0:.0f} s", flush=True)
    musicgen_losses = phase_av_arch(results, "musicgen", MUSICGEN_ARGV,
                                    "blocks/mlp/w_up")
    phase_av_arch(results, "qwen2-vl", QWEN_ARGV, "blocks/mlp/w_gate")
    print(f"[chip_smoke] audio / vlm train phases done at "
          f"{time.perf_counter() - t0:.0f} s", flush=True)
    phase_serve_av()
    print(f"[chip_smoke] audio / vlm serving phases done at "
          f"{time.perf_counter() - t0:.0f} s", flush=True)
    phase_checkpoint(musicgen_losses)
    print(f"[chip_smoke] checkpoint phase done at "
          f"{time.perf_counter() - t0:.0f} s", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    for phase in (phase_serve_gemma, phase_serve_rwkv, phase_serve_moe,
                  phase_flash_decode):
        phase(results)
        print(f"[chip_smoke] {phase.__name__} done at "
              f"{time.perf_counter() - t0:.0f} s", flush=True)
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

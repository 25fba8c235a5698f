"""The paper's own experiment end to end (Table II workflow): MobileNetV2 +
GroupNorm, pretrained on one synthetic domain, transferred to another with
No-FT / Last / Full / Fixed / Dynamic, block activation pruning on every
training forward.

    PYTHONPATH=src python -m repro_torch.launch.cnn_transfer --config smoke
    PYTHONPATH=src python -m repro_torch.launch.cnn_transfer --config smoke \
        --device cpu --steps 6 --pretrain-steps 4 --methods none,fixed

Runs on the card (`--device cuda`, the default) or on the CPU
(`--device cpu`). The defaults are the reference's
`benchmarks/table2_evaluation.py` constants: 150 pretraining steps, 120
transfer steps of batch 32, phases j = 30 / k = 60, the last 6 convs
trainable with 20% of their output-channel blocks (blocks of 4), SGD with
momentum 0.9. Prints one CSV row per method,
`table2/<method>,<microseconds>,acc=<acc>;extra_mem=<bytes>B`.

The paper's numbers (CIFAR-10, 256 KB): 36.83 / 59.34 / 90.33 / 84.30 /
85.77. The synthetic task checks the ordering and the memory ratios, not
those absolutes.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.configs.base import OptimizerConfig
from repro_torch.configs.mobilenetv2_cifar import CONFIG, smoke_config
from repro_torch.core.act_prune import make_act_pruner
from repro_torch.core.selection import draw_seed
from repro_torch.core.sparse_update import SelSpec, tree_leaves, tree_map
from repro_torch.data import TransferTask
from repro_torch.models import mobilenet_v2 as MN
from repro_torch.optim import apply_updates, init_opt_state

STEPS = 120
BATCH = 32
PRETRAIN_STEPS = 150
EVAL_BATCHES = 6
# 3-phase schedule (paper: 10/20/20 epochs -> steps here)
PHASE_J, PHASE_K = 30, 60
UPDATE_RATIO = 0.2
LAST_K_CONVS = 6
BLOCK = 4
PRUNE_THRESHOLD, PRUNE_BLOCK = 0.15, 2
METHODS = ("none", "last", "full", "fixed", "dynamic")


def _to_device(batch: dict, device) -> dict:
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def _eval(cfg, task, params, device, n: int = EVAL_BATCHES,
          first: int = 10_000) -> float:
    """Target-domain accuracy over n batches of 64 (data steps first, ...),
    without pruning."""
    accs = []
    with torch.no_grad():
        for s in range(n):
            b = _to_device(task.batch(64, first + s, "target"), device)
            _, m = MN.loss_fn(cfg, (None, params), b)
            accs.append(float(m["acc"]))
    return sum(accs) / len(accs)


def _grads(loss_of, trainable):
    """(loss, grads shaped like `trainable`). Autograd runs on detached
    aliases, so the caller's tensors (shared with other methods' trees)
    never get requires_grad."""
    tp = tree_map(lambda t: t.detach().requires_grad_(), trainable)
    loss = loss_of(tp)
    it = iter(torch.autograd.grad(loss, tree_leaves(tp)))
    return loss.detach(), tree_map(lambda _: next(it), tp)


def train_step(cfg, oc, frozen, trainable, opt_state, batch, step: int,
               sel=None, act_prune=None):
    """One step: loss and gradients of the trainable tree, then the dense
    optimizer sweep. Returns (loss, trainable, opt_state), new trees."""
    loss, g = _grads(lambda tp: MN.loss_fn(cfg, (frozen, tp), batch, sel=sel,
                                           act_prune=act_prune)[0],
                     trainable)
    trainable, opt_state = apply_updates(oc, trainable, g, opt_state, step)
    return loss, trainable, opt_state


def _pretrain(cfg, task, steps: int, batch: int, seed: int, device):
    """Stand-in for ImageNet pretraining: the port's init from `seed`,
    trained on the 'pretrain' domain."""
    p = MN.init_params(cfg, torch.Generator(device=device).manual_seed(seed))
    oc = OptimizerConfig(kind="momentum", momentum=0.9, learning_rate=0.05,
                         warmup_steps=10, decay_steps=steps)
    st = init_opt_state(oc, p)
    for step in range(steps):
        b = _to_device(task.batch(batch, step, "pretrain"), device)
        _, p, st = train_step(cfg, oc, None, p, st, b, step)
    return p


def learnability(cfg, task, params, device, steps: int = 30):
    """(acc0, acc) of full fine-tuning from `params` (momentum 0.9, lr 0.05,
    no schedule, no pruning; batches of 32), accuracy on 4 x 64 target
    images: the reference's `test_cnn_transfer_learns` recipe."""
    oc = OptimizerConfig(kind="momentum", momentum=0.9, learning_rate=0.05)
    acc0 = _eval(cfg, task, params, device, n=4, first=1000)
    st = init_opt_state(oc, params)
    for step in range(steps):
        b = _to_device(task.batch(32, step, "target"), device)
        _, params, st = train_step(cfg, oc, None, params, st, b, step)
    return acc0, _eval(cfg, task, params, device, n=4, first=1000)


def transfer_optimizer(method: str, steps: int) -> OptimizerConfig:
    lr = 0.01 if method == "full" else 0.03   # full FT needs the smaller lr
    return OptimizerConfig(kind="momentum", momentum=0.9, learning_rate=lr,
                           warmup_steps=12, decay_steps=steps)


def _selection(cfg, params, ratio: float, last_k: int, seed: int = 0,
               step: int = 0, magnitude: bool = True):
    """Per-conv output-channel-block selection for the last-K convs:
    ({name: int32 [1, n_sel]}, {name: SelSpec}). Magnitude: the blocks of
    largest sum |w|. Random: a draw on the weights' device from a generator
    seeded by (seed, step, name), as the LM's dynamic phase draws."""
    idx, spec = {}, {}
    for name in MN.conv_layer_names(cfg)[-last_k:]:
        node = params
        for part in name.split("/")[:-1]:
            node = node[part]
        w = node[name.split("/")[-1]]
        out = w.shape[-1]
        block = BLOCK if out % BLOCK == 0 else 1
        nb = out // block
        ns = max(1, int(round(ratio * nb)))
        spec[name] = SelSpec(block=block, n_shards=1, n_sel=ns, n_blocks=nb)
        if magnitude:
            norms = w.abs().reshape(-1, nb, block).sum(dim=(0, 2))
            sel = torch.argsort(-norms, stable=True)[:ns]
        else:
            gen = torch.Generator(device=w.device).manual_seed(
                draw_seed(seed, step, "cnn", name))
            sel = torch.argsort(torch.rand(nb, generator=gen,
                                           device=w.device))[:ns]
        idx[name] = sel.to(torch.int32)[None, :]
    return idx, spec


def split_for(cfg, pretrained, method: str):
    """(frozen, trainable) of a method. fixed / dynamic train the classifier
    and the whole blocks (convs and GroupNorms) that hold the last-K convs,
    as the reference's code does."""
    if method == "last":
        return ({k: v for k, v in pretrained.items() if k != "classifier"},
                {"classifier": pretrained["classifier"]})
    if method == "full":
        return None, dict(pretrained)
    keep = {n.split("/")[0] for n in MN.conv_layer_names(cfg)[-LAST_K_CONVS:]}
    keep.add("classifier")
    return ({k: v for k, v in pretrained.items() if k not in keep},
            {k: pretrained[k] for k in keep})


def prune_launches(cfg, method: str) -> tuple[int, int]:
    """(forward, backward) activation pruning launches in one training step
    of `method`: one forward launch at every prune site, one backward launch
    at every site at or after the first trainable conv (autograd reaches no
    other). `none` trains no step."""
    names = MN.conv_layer_names(cfg)
    if method == "none":
        return 0, 0
    tops = {n.split("/")[0]: None for n in names} | {"classifier": None}
    _, trainable = split_for(cfg, tops, method)
    first = min((i for i, n in enumerate(names)
                 if n.split("/")[0] in trainable), default=len(names))
    sites = [names.index(n) for n, _ in MN.prune_sites(cfg, cfg.img_size)]
    return len(sites), sum(i >= first for i in sites)


def _transfer(cfg, task, pretrained, method: str, *, steps: int, batch: int,
              phase_j: int, phase_k: int, seed: int, device,
              on_step=None) -> dict:
    """Run one Table II row: {"method", "acc", "extra_mem", "losses",
    "peak_bytes" (the card's peak over the training steps, None on the
    CPU), "params" (the final tree, frozen and trainable)}."""
    if method == "none":
        return {"method": method, "acc": _eval(cfg, task, pretrained, device),
                "extra_mem": 0, "losses": [], "peak_bytes": None,
                "params": pretrained}
    oc = transfer_optimizer(method, steps)
    act_prune = make_act_pruner(PRUNE_THRESHOLD, PRUNE_BLOCK)
    frozen, p = split_for(cfg, pretrained, method)
    idx = spec = None
    if method in ("fixed", "dynamic"):
        idx, spec = _selection(cfg, pretrained, UPDATE_RATIO, LAST_K_CONVS)
    st = init_opt_state(oc, p)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    losses = []
    for step in range(steps):
        t0 = time.perf_counter()
        if method == "dynamic" and phase_j <= step < phase_j + phase_k:
            idx, _ = _selection(cfg, pretrained, UPDATE_RATIO, LAST_K_CONVS,
                                seed=seed, step=step, magnitude=False)
        b = _to_device(task.batch(batch, step, "target"), device)
        t1 = time.perf_counter()
        loss, p, st = train_step(cfg, oc, frozen, p, st, b, step,
                                 sel=(idx, spec) if idx is not None else None,
                                 act_prune=act_prune)
        if cuda:
            torch.cuda.synchronize(device)
        metrics = {"loss": float(loss),
                   "step_ms": (time.perf_counter() - t1) * 1e3,
                   "data_ms": (t1 - t0) * 1e3}
        losses.append(metrics["loss"])
        if on_step is not None:
            on_step(step + 1, {"method": method, "trainable": p,
                               "frozen": frozen, "opt": st, "idx": idx,
                               "spec": spec}, metrics)
    peak = torch.cuda.max_memory_allocated(device) if cuda else None
    merged = dict(frozen or {})
    merged.update(p)
    # extra memory = trainable grads (+selected-only for sparse) + momentum
    n_tr = sum(x.numel() for x in tree_leaves(p))
    ratio = UPDATE_RATIO if method in ("fixed", "dynamic") else 1.0
    return {"method": method, "acc": _eval(cfg, task, merged, device),
            "extra_mem": int(n_tr * ratio * 4 * 2), "losses": losses,
            "peak_bytes": peak, "params": merged}


def build_argparser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default="smoke", choices=["smoke", "full"],
                    help="smoke: the CPU-sized cut; full: MobileNetV2 at "
                         "width 1.0, 224 x 224")
    ap.add_argument("--img", type=int, default=0,
                    help="image size (0 = the config's)")
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--pretrain-steps", type=int, default=PRETRAIN_STEPS)
    ap.add_argument("--methods", default=",".join(METHODS),
                    help=f"comma-separated subset of {','.join(METHODS)}")
    ap.add_argument("--phase-j", type=int, default=PHASE_J)
    ap.add_argument("--phase-k", type=int, default=PHASE_K)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card) or cpu")
    return ap


def main(argv=None, on_step=None):
    """Parse `argv`, pretrain, run each method, print its row; returns
    {"cfg", "pretrained", "rows"}.

    on_step(step, state, metrics), when given, runs after every transfer
    step with the method's state ("method", "trainable", "frozen", "opt",
    "idx", "spec") and the step's "loss", "step_ms" (the synced train step)
    and "data_ms" (the selection draw and the batch, made on the host)."""
    ap = build_argparser()
    args = ap.parse_args(argv)
    methods = [m for m in args.methods.split(",") if m]
    bad = [m for m in methods if m not in METHODS]
    if bad:
        ap.error(f"--methods: unknown {bad}; choose from {METHODS}")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        ap.error("--device cuda: no CUDA device; pass --device cpu to run "
                 "on the CPU")
    # the reference's convs and matmuls are full fp32: no TF32 on the card;
    # and its table is a function of its seed: deterministic cuDNN
    # algorithms only, none picked by timing
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    cfg = CONFIG if args.config == "full" else smoke_config()
    if args.img:
        cfg = dataclasses.replace(cfg, img_size=args.img)
    print(f"[cnn] {cfg.name} img={cfg.img_size} width={cfg.width_mult} "
          f"batch={args.batch} steps={args.steps} "
          f"pretrain_steps={args.pretrain_steps} device={device} "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"cudnn.deterministic={torch.backends.cudnn.deterministic}",
          flush=True)
    task = TransferTask(img=cfg.img_size, seed=args.seed)
    pre = _pretrain(cfg, task, args.pretrain_steps, args.batch, args.seed,
                    device)
    rows = []
    for method in methods:
        t0 = time.perf_counter()
        row = _transfer(cfg, task, pre, method, steps=args.steps,
                        batch=args.batch, phase_j=args.phase_j,
                        phase_k=args.phase_k, seed=args.seed, device=device,
                        on_step=on_step)
        row["seconds"] = time.perf_counter() - t0
        rows.append(row)
        print(f"table2/{method},{row['seconds'] * 1e6:.0f},"
              f"acc={row['acc']:.4f};extra_mem={row['extra_mem']}B",
              flush=True)
    return {"cfg": cfg, "pretrained": pre, "rows": rows}


if __name__ == "__main__":
    main()

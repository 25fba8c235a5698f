"""Compact train steps on a (data, model) process mesh, one job after
another on every rank of a spawned world.

    from repro_torch.launch import mesh, mesh_train
    results = mesh.spawn(mesh_train.run_jobs, 4, args=(jobs,))

A job is a dict:

    name      a label for its results
    cfg       the ModelConfig
    mesh      (n_data, n_model): the first n_data * n_model ranks of the
              world (the others build the mesh too, then skip the job)
    rules     "train" (`launch.specs.rules_for`: kv heads whole) or
              "default" (`sharding.default_rules`)
    tc        the TrainConfig (tc.shape: the GLOBAL batch and sequence)
    steps     how many steps
    compact   the compact step (True) or the dense-scatter one (False)
    cgr       the dense-scatter step under `compact_allreduce`
    device    "cpu" or "cuda" (every rank on cuda:0 with gloo)
    params    the whole params (numpy); None draws them from tc.seed,
              each rank keeping its slice (`init_params(..., rules=)`)
    sel_idx   the plan's selection (numpy); None selects by magnitude
    batches   the global batches (numpy dicts), one a step; None takes
              `data.lm_batches` from tc.seed
    returns   any of "params" (the rank's trainable shards at the end),
              "sel_idx" (its selection), "grads" (the first step's
              gradients after every reduction), "frozen" (check the
              frozen shards unchanged), "blocks" (the selected blocks of
              the rank's trainable shards at the end, `local_blocks`, as
              tensors on the CPU), "block_sums" (the same summed over
              each block's columns in fp32: a 1/block of the bytes),
              "blocks_digest" (a sha256 of their bytes: two runs' updates
              compared bitwise without moving them), "unselected" (check
              their other blocks unchanged: for a run whose selection
              stays fixed)
    kind      "train" (the default), or "collectives": `collective_probe`
              on the job's mesh (only `mesh` is read)

A rank's result per job: its coords, the seconds it took to set the job
up (params, state, selection), and per step the loss and metrics
(summed over the data group), the step's wall ms, the kernels' launches,
the bytes all-reduced by kind (`sharding.collective_bytes`), the dropped
share of MoE choices and `max_memory_allocated`; and what `returns` asks.
The ranks import only torch and this package.
"""
from __future__ import annotations

import hashlib
import time

import torch

from repro_torch import bridge
from repro_torch import sharding as SH
from repro_torch.core.sparse_update import (compact_allreduce, tree_leaves,
                                           tree_map)
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.launch.specs import batch_shardings, rules_for, shard_local
from repro_torch.models import moe as MOE
from repro_torch.train.steps import make_train_state, make_train_step


def run_jobs(jobs: list) -> list:
    """Every job in order on this rank; a result per job (None where the
    rank is outside the job's mesh). Between jobs on the card the rank
    hands its cached memory back, for the other ranks on the same card."""
    out = []
    for job in jobs:
        out.append(run_job(job))
        if job.get("device", "cpu") != "cpu":
            import gc
            gc.collect()
            torch.cuda.empty_cache()
    return out


def job_rules(job, mesh):
    if job.get("rules", "train") == "train":
        return rules_for(mesh, job["cfg"], job["tc"].shape)
    return SH.default_rules(mesh)


def run_job(job: dict):
    n_data, n_model = job["mesh"]
    mesh = make_debug_mesh(n_data, n_model)
    if not mesh.member:
        return None
    device = torch.device(job.get("device", "cpu"))
    if device.type == "cpu":
        torch.set_num_threads(1)
    else:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    out = {"name": job.get("name"), "coords": dict(mesh.coords),
           "rank": mesh.rank}
    if job.get("kind") == "collectives":
        with SH.use_rules(SH.default_rules(mesh)), \
                SH.mapped_model_axis("model"):
            out.update(collective_probe())
        return out
    with SH.use_rules(job_rules(job, mesh)) as rules:
        _train(job, rules, mesh, device, out)
    return out


def collective_probe() -> dict:
    """The model-group collectives and their backward passes on small
    tensors, x = (model index + 1) * [1, 2, 3] on every rank: forward
    values and the gradients of sum(out * w) for fixed weights w ("bytes":
    the first three's). The local-use forms are read as ranks that use
    their result differently: rank m's loss is (m + 1) * sum(out * w), so
    the gradient each rank must get is the sum of the ranks' partial ones,
    n (n + 1) / 2 * w, where the plain forms give (m + 1) * w
    ("bytes_local": theirs)."""
    m = SH.model_index()
    w = torch.tensor([1.0, 10.0, 100.0])
    out = {}

    def x0():
        return ((m + 1) * torch.tensor([1.0, 2.0, 3.0])).requires_grad_(True)
    SH.reset_collective_bytes()
    for name, fn in (("copy", SH.copy_to_model), ("psum", SH.psum_mapped),
                     ("gather", lambda t: SH.all_gather_mapped(t, 0))):
        x = x0()
        y = fn(x)
        ww = w.repeat(y.numel() // w.numel())
        (g,) = torch.autograd.grad((y * ww).sum(), [x])
        out[name] = (y.detach().tolist(), g.tolist())
    out["bytes"] = SH.collective_bytes()
    SH.reset_collective_bytes()
    for name, fn in (("gather_local",
                      lambda t: SH.all_gather_local_use(t, 0)),
                     ("psum_local", SH.psum_local_use)):
        x = x0()
        y = fn(x)
        ww = w.repeat(y.numel() // w.numel())
        (g,) = torch.autograd.grad((y * ww).sum() * (m + 1), [x])
        out[name] = (y.detach().tolist(), g.tolist())
    out["bytes_local"] = SH.collective_bytes()
    return out


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _batches(job, tc):
    if job.get("batches") is not None:
        return iter(job["batches"])
    from repro_torch.data import lm_batches
    return lm_batches(tc.shape.global_batch, tc.shape.seq_len,
                      job["cfg"].vocab_size, seed=tc.seed)


def _train(job, rules, mesh, device, out) -> None:
    t0 = time.perf_counter()
    cfg, tc = job["cfg"], job["tc"]
    returns = set(job.get("returns", ()))
    params = None
    if job.get("params") is not None:
        params = bridge.params_to_rank(job["params"], cfg, rules, device)
    given = job.get("sel_idx")
    state, plan = make_train_state(
        tc, params=params, device=device,
        selection_init="random" if given is not None else "magnitude")
    if given is not None:
        state["sel_idx"] = bridge.selection_to_rank(plan, given, rules,
                                                    device)
    frozen0 = trainable0 = None
    if "frozen" in returns:
        frozen0 = [t.clone() for t in tree_leaves(state["params_frozen"])]
    if "unselected" in returns:
        trainable0 = {seg: {k: v.clone() for k, v in _flat(t).items()}
                      for seg, t in state["params_trainable"]["segments"]
                      .items()}
    captured = {}

    def on_grads(dense, compact):
        if "dense" not in captured:
            captured["dense"] = bridge.to_numpy(dense)
            captured["compact"] = bridge.to_numpy(compact)

    step_fn = make_train_step(tc, plan, compact_grads=job.get("compact",
                                                              True),
                              on_grads=on_grads if "grads" in returns
                              else None)
    bsh = batch_shardings(cfg, tc.shape, rules)
    data = _batches(job, tc)
    _sync(device)
    out["setup_s"] = time.perf_counter() - t0
    rows = []
    for _ in range(job["steps"]):
        batch = shard_local(next(data), bsh, mesh.shape, mesh.coords)
        batch = {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
        _sync(device)
        ops.reset_launch_counts()
        SH.reset_collective_bytes()
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        with compact_allreduce(job.get("cgr", False)), \
                MOE.record_routing() as routing:
            state, metrics = step_fn(state, batch)
        _sync(device)
        ms = (time.perf_counter() - t0) * 1e3
        row = {k: float(v) for k, v in metrics.items()}
        row.update(step_ms=ms, launches=ops.launch_counts(),
                   bytes=SH.collective_bytes())
        if routing:
            row["dropped"] = sum(int(d) for d, _ in routing) / \
                sum(n for _, n in routing)
        if device.type == "cuda":
            row["max_memory_allocated"] = torch.cuda.max_memory_allocated(
                device)
        rows.append(row)
    out["steps"] = rows
    out["plan_trainable"] = dict(plan.seg_trainable)
    out["compact_bytes"] = _compact_bytes(state, plan)
    if "params" in returns:
        out["params"] = bridge.to_numpy(state["params_trainable"])
    if "sel_idx" in returns:
        out["sel_idx"] = bridge.to_numpy(state["sel_idx"])
    if "grads" in returns:
        out["grads"] = captured
    if frozen0 is not None:
        out["frozen_unchanged"] = all(
            torch.equal(a, b) for a, b in
            zip(frozen0, tree_leaves(state["params_frozen"])))
    if "blocks" in returns:
        out["blocks"] = tree_map(
            lambda t: None if t is None else t.detach().cpu(),
            local_blocks(state, plan))
    if "block_sums" in returns:
        out["block_sums"] = tree_map(
            lambda t: None if t is None else t.float().sum(-1).cpu(),
            local_blocks(state, plan))
    if "blocks_digest" in returns:
        digest = hashlib.sha256()
        for t in tree_leaves(local_blocks(state, plan)):
            digest.update(t.detach().cpu().contiguous().view(torch.uint8)
                          .numpy().tobytes())
        out["blocks_digest"] = digest.hexdigest()
    if trainable0 is not None:
        out["unselected_unchanged"] = _unselected_unchanged(
            state, plan, trainable0)


def _compact_bytes(state, plan) -> int:
    """The bytes of the rank's compact dW tensors: for each selectable
    leaf [K, *lead, N] and its local selection [K, 1 or n_shards, n_sel],
    K * lead * n_sel * block values of the leaf's dtype."""
    from repro_torch.core.selection import local_spec_tree
    from repro_torch.core.sparse_update import SelSpec

    def walk(p, spec):
        if isinstance(spec, SelSpec):
            n = p.numel() // p.shape[-1] * spec.n_shards * spec.n_sel * \
                spec.block
            return n * p.element_size()
        return sum(walk(p[k], spec[k]) for k in spec)
    segs = state["params_trainable"].get("segments", {})
    spec = local_spec_tree(plan.spec)
    return sum(walk(segs[s], spec[s]) for s in segs if spec.get(s))


def _flat(tree, prefix: str = "") -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def local_blocks(state, plan):
    """The selected blocks of the rank's trainable shards, per segment:
    {seg: nested {leaf: [K, *lead, n_shards_local, n_sel, block]}}."""
    from repro_torch.core.selection import local_spec_tree
    from repro_torch.core.sparse_update import gather_selected_tree
    return gather_selected_tree(state["params_trainable"]["segments"],
                                state["sel_idx"],
                                local_spec_tree(plan.spec))


def _unselected_unchanged(state, plan, start) -> bool:
    """Every selectable trainable leaf equal to its start outside the
    selected blocks."""
    from repro_torch.core.selection import local_spec_tree
    from repro_torch.kernels.ref import scatter_blocks3
    spec = local_spec_tree(plan.spec)
    ok = True
    for seg, tree in state["params_trainable"]["segments"].items():
        flat = _flat(tree)
        specs, idx = _flat(spec.get(seg, {})), _flat(state["sel_idx"][seg]
                                                     or {})
        for path, sp in specs.items():
            w, w0 = flat[path], start[seg][path]
            k, n = w.shape[0], w.shape[-1]
            ones = torch.ones((k, 1, sp.n_shards, sp.n_sel, sp.block),
                              dtype=torch.int32, device=w.device)
            mask = scatter_blocks3(torch.zeros((k, 1, n), dtype=torch.int32,
                                               device=w.device), ones,
                                   idx[path], sp.block).bool()
            mask = mask.reshape((k,) + (1,) * (w.dim() - 2) + (n,))
            ok &= bool(torch.equal(torch.where(mask, 0, w),
                                   torch.where(mask, 0, w0)))
    return ok


def block_shardings(param_shardings, spec_tree):
    """The shardings of `local_blocks`' tree, from the trainable params'
    (`launch.specs.tree_shardings`): a leaf's lead dims as the weight's, its
    out dim's split on the shard axis, the selected blocks whole."""
    from repro_torch.core.sparse_update import SelSpec

    def walk(sh, spec):
        if isinstance(spec, SelSpec):
            return tuple(sh[:-1]) + (sh[-1], None, None)
        return {k: walk(sh[k], spec[k]) for k in spec}
    return {seg: walk(param_shardings[seg], spec)
            for seg, spec in spec_tree.items() if spec
            and seg in param_shardings}

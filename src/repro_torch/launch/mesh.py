"""Process meshes over `torch.distributed`, and a helper that runs a
function on n ranks.

A mesh lays the world's ranks out on named axes, the last axis fastest
(rank = data * n_model + model on a (data, model) mesh, the order of the
reference's device meshes), and holds this rank's coordinates and one
process group per axis (and one over the batch axes together where there
are two). `torch.distributed` must be initialized first (`spawn` does it).

Which backend:

- `gloo` where the ranks share one device: the CPU, or one card (gloo runs
  all-reduce on CUDA tensors). A collective gloo refuses on a CUDA tensor
  fails the run; nothing is detoured through the host.
- `nccl` where every rank has a card of its own.
"""
from __future__ import annotations

import datetime
import itertools
import math
import os
import tempfile
from pathlib import Path
from typing import Optional, Sequence

import torch
import torch.distributed as dist

# a collective that waits longer than this fails the run
DEFAULT_TIMEOUT_S = 300.0


class ProcessMesh:
    """Ranks `ranks[0] .. ranks[n-1]` of the world laid out as `shape`
    ({axis: size}, the last axis fastest). Building one is collective: every
    rank of the world must build the same mesh, in the same order, also
    the ranks outside it (`member` is then False and the mesh is not used
    there)."""

    def __init__(self, shape: dict, ranks: Optional[Sequence[int]] = None,
                 timeout_s: float = DEFAULT_TIMEOUT_S):
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)
        n = math.prod(self.shape.values())
        world = dist.get_world_size()
        self.ranks = list(range(n)) if ranks is None else list(ranks)
        if len(self.ranks) != n or max(self.ranks) >= world:
            raise ValueError(f"a {self.shape} mesh needs {n} of the world's "
                             f"{world} ranks, got {self.ranks}")
        self.rank = dist.get_rank()
        self.member = self.rank in self.ranks
        self.coords = self._coords(self.ranks.index(self.rank)) \
            if self.member else None
        self.timeout = datetime.timedelta(seconds=timeout_s)
        sets = [(a,) for a in self.axis_names]
        batch = tuple(a for a in ("pod", "data") if a in self.shape)
        if len(batch) > 1:
            sets.append(batch)
        self._groups = {axes: self._new_groups(axes) for axes in sets}

    def _coords(self, i: int) -> dict:
        out = {}
        for a in reversed(self.axis_names):
            out[a] = i % self.shape[a]
            i //= self.shape[a]
        return {a: out[a] for a in self.axis_names}

    def _flat(self, coords: dict) -> int:
        i = 0
        for a in self.axis_names:
            i = i * self.shape[a] + coords[a]
        return i

    def _new_groups(self, axes: tuple):
        """One group per setting of the other axes; this rank's, or None
        where it holds one rank (a collective over it is the identity)."""
        others = [a for a in self.axis_names if a not in axes]
        mine = None
        for fixed in itertools.product(*(range(self.shape[a])
                                         for a in others)):
            base = dict(zip(others, fixed))
            members = []
            for moving in itertools.product(*(range(self.shape[a])
                                              for a in axes)):
                members.append(self.ranks[self._flat(
                    {**base, **dict(zip(axes, moving))})])
            if len(members) == 1:
                continue
            group = dist.new_group(members, timeout=self.timeout)
            if self.rank in members:
                mine = group
        return mine

    def group(self, axes):
        """The process group over `axes` (one name or a tuple) holding this
        rank; None where it holds this rank alone."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        if len(axes) == 1 and axes not in self._groups:
            raise KeyError(f"no mesh axis {axes[0]!r} in {self.shape}")
        return self._groups[axes]

    def index(self, axes) -> int:
        """This rank's coordinate over `axes` (mixed radix, first major)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        i = 0
        for a in axes:
            i = i * self.shape[a] + self.coords[a]
        return i

    def size(self, axes) -> int:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return math.prod(self.shape[a] for a in axes)


def make_debug_mesh(n_data: int = 1, n_model: int = 1,
                    timeout_s: float = DEFAULT_TIMEOUT_S) -> ProcessMesh:
    """A (data, model) mesh over the first n_data * n_model ranks of the
    world (the others build it too and stay out of it: see ProcessMesh)."""
    return ProcessMesh({"data": n_data, "model": n_model},
                       timeout_s=timeout_s)


def make_production_mesh(*, multi_pod: bool = False,
                         timeout_s: float = DEFAULT_TIMEOUT_S) -> ProcessMesh:
    """The reference's production meshes: 16 x 16 (data, model), or with
    `multi_pod` 2 x 16 x 16 (pod, data, model). Refuses a world of another
    size."""
    shape = {"pod": 2, "data": 16, "model": 16} if multi_pod \
        else {"data": 16, "model": 16}
    want = math.prod(shape.values())
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != want:
        raise ValueError(f"the production mesh {shape} needs a world of "
                         f"{want} ranks, this one has {world}")
    return ProcessMesh(shape, timeout_s=timeout_s)


def make_serve_mesh(n_model: int = 1,
                    timeout_s: float = DEFAULT_TIMEOUT_S) -> ProcessMesh:
    """A (1, n_model) serve mesh over the FIRST n_model ranks of the world
    (serving wants exactly the shards asked for, e.g. 2 on a world of 4;
    the other ranks build it too and stay out of it). Raises where the
    world has fewer ranks."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world < n_model:
        raise ValueError(
            f"serve mesh wants {n_model} model shards but only {world} "
            f"rank(s) exist")
    return ProcessMesh({"data": 1, "model": n_model},
                       ranks=list(range(n_model)), timeout_s=timeout_s)


# ---------------------------------------------------------------------------
# spawn
# ---------------------------------------------------------------------------

def _rank_main(rank: int, fn, n: int, backend: str, rdzv: str, out: str,
               timeout_s: float, args: tuple) -> None:
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=f"file://{rdzv}", world_size=n, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    try:
        result = fn(*args)
        torch.save(result, Path(out) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def spawn(fn, n: int, args: tuple = (), *, backend: str = "gloo",
          timeout_s: float = DEFAULT_TIMEOUT_S) -> list:
    """Run `fn(*args)` on `n` fresh processes (start method `spawn`) joined
    in one process group; returns the ranks' return values in rank order
    (each saved with torch.save and read back here).

    The rendezvous is a `file://` store in a new temporary directory, so
    concurrent spawns never meet; every collective times out after
    `timeout_s`, and any rank raising (a timeout included) kills the others
    and raises here. `fn` must be importable by name (a module-level
    function). The processes build no kernel: build them first
    (`kernels.build.build_all`), and every rank loads the same libraries."""
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend {backend!r}: gloo (ranks share a device) "
                         f"or nccl (a card each)")
    with tempfile.TemporaryDirectory(prefix="mesh-") as tmp:
        rdzv = os.path.join(tmp, "rendezvous")
        torch.multiprocessing.start_processes(
            _rank_main, args=(fn, n, backend, rdzv, tmp, timeout_s, args),
            nprocs=n, join=True, start_method="spawn")
        return [torch.load(Path(tmp) / f"rank{r}.pt", weights_only=False)
                for r in range(n)]

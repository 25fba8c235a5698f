"""Build the port's CUDA kernels with `nvcc` and load them with `ctypes`.

Each source under `csrc/` becomes one shared library with a plain C
interface (no PyTorch headers, so a build takes seconds). Libraries go into
`build/` at the root of the checkout, named by a hash of the source and its
flags, and are built at first use: the first kernel call of a process
builds every source at once, one `nvcc` each, all started together. Nothing
here runs when the module is imported.

    python -c "from repro_torch.kernels import build; build.build_all()"
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
BASE_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]
# per source: extra nvcc flags. fused_block_opt must round as PyTorch's
# separate element-wise ops do, so no multiply-add contraction there.
SOURCES = {
    "block_sparse_dw": [],
    "fused_block_opt": ["-fmad=false"],
    "block_act_prune": [],
    "block_scatter_update": [],
    "wkv6": [],
}

_LIBS: dict[str, ctypes.CDLL] = {}
BUILD_SECONDS: dict[str, float] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the port's "
                       "CUDA kernels are built on the machine with the card")


def _flags(name: str) -> list[str]:
    return ARCH_FLAGS + BASE_FLAGS + SOURCES[name]


def lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    key = hashlib.sha256(src + " ".join(_flags(name)).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{key[:16]}.so"


def _declare(name: str, lib: ctypes.CDLL) -> None:
    p, i64, i32, f32 = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                        ctypes.c_float)
    if name == "block_sparse_dw":
        fns = [(lib.block_sparse_dw_launch,
                [p, p, p, p, i64, i64, i64, i32, i32, i32, i32, i32, p]),
               (lib.batched_dw_launch,
                [p, p, p, p, i64, i64, i64, i64, i32, i32, i32, i32, i32,
                 p])]
    elif name == "fused_block_opt":
        fns = [(lib.fused_block_opt_launch,
                [p, p, p, p, p, p, i64, i64, i64, i32, i32, i32, i32, i32,
                 i32, f32, f32, f32, f32, f32, f32, f32, p])]
    elif name == "block_scatter_update":
        fns = [(lib.block_scatter_update_launch,
                [p, p, p, p, i64, i64, i64, i32, i32, i32, i32, i32, p])]
    elif name == "wkv6":
        fns = [(lib.wkv6_fwd_launch, [p] * 8 + [i32] * 4 + [p]),
               (lib.wkv6_bwd_launch, [p] * 12 + [i32] * 4 + [p])]
        lib.wkv6_ckpt_floats.argtypes = [i32] * 3
        lib.wkv6_ckpt_floats.restype = i64
        lib.wkv6_bwd_chunks.argtypes = [i32]
        lib.wkv6_bwd_chunks.restype = i32
    else:
        fns = [(lib.block_act_prune_fwd_launch,
                [p, p, i64, i32, f32, i32, p]),
               (lib.block_act_prune_bwd_launch,
                [p, p, p, i64, i32, f32, i32, p])]
    for fn, argtypes in fns:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int


def build_all() -> dict[str, Path]:
    """Compile every source whose library is missing, in parallel; returns
    {name: library path}. Raises with nvcc's output if a build fails."""
    paths = {name: lib_path(name) for name in SOURCES}
    todo = {name: path for name, path in paths.items() if not path.exists()}
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    t0 = time.perf_counter()
    for name, path in todo.items():
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *_flags(name), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        log = open(path.with_suffix(".log"), "w")
        procs[name] = (subprocess.Popen(cmd, stdout=log,
                                        stderr=subprocess.STDOUT), tmp, log)
    failed = []
    for name, (proc, tmp, log) in procs.items():
        rc = proc.wait()
        log.close()
        BUILD_SECONDS[name] = time.perf_counter() - t0
        if rc != 0:
            failed.append(name)
            continue
        os.replace(tmp, todo[name])
    if failed:
        logs = "\n".join(todo[n].with_suffix(".log").read_text()
                         for n in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{logs}")
    return paths


def build_log(name: str) -> str:
    """nvcc's output for the current library (ptxas register/smem report)."""
    log = lib_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `name`, building all sources first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        path = build_all()[name]
        lib = ctypes.CDLL(str(path))
        _declare(name, lib)
        _LIBS[name] = lib
    return lib

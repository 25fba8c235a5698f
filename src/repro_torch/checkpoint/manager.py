"""Fault-tolerant checkpointing: msgpack + zstd, atomic rename, checksum
footer, corrupt-file fallback, retention. The port's counterpart of the
reference package's `checkpoint/manager.py`, in its file format.

Format: one `.ckpt` file per save: a compressed msgpack map of
{"/"-joined tree path: {"d": dtype name, "s": shape, "b": raw bytes}} plus
a `__meta__` entry, followed by an 8-byte footer (the crc32 of the
compressed body, little-endian, then `RCK1`). The body is a zstd frame
(level 3) when the `zstandard` module imports, else `ZLB0` followed by a
zlib stream. bf16 travels as its raw bytes. A file written here reads in
the reference's `load_pytree`, and one written there reads here.

How, not what, differs from the reference:
- msgpack comes from the port's own codec (`checkpoint/msgpack.py`), and
  zlib stands in for zstd, so neither package is needed;
- a file is written and read leaf by leaf through streaming compression,
  so the host holds about one leaf at a time where the reference holds
  the payload about four times. The zstd frame carries the payload's
  total size in its header: the reference reads it with
  `ZstdDecompressor().decompress`, which needs it.

Corruption: a torn or bit-flipped file raises `CheckpointCorruptError`
(checksum mismatch, or a body without its footer that fails to
decompress or parse), and `CheckpointManager.restore` warns and falls back
to the latest intact step. `CheckpointManager(chaos=...)` takes a
`runtime.chaos.FaultSchedule` whose `torn` draws make `save` publish a
truncated file.
"""
from __future__ import annotations

import os
import re
import threading
import time
import warnings
import zlib
from typing import Any, Optional

import torch

from repro_torch.checkpoint import msgpack

try:
    import zstandard
except ImportError:          # the zlib frame stands in
    zstandard = None

_CKPT_RE = re.compile(r"step_(\d+)\.ckpt$")
_ZLIB_MAGIC = b"ZLB0"        # the zlib frame's marker (zstd's is 28b52ffd)
_FOOTER_MAGIC = b"RCK1"      # checksum footer: crc32(payload) LE + magic
ZSTD_LEVEL = 3               # the reference's
# The reference's zlib fallback is level 6. bf16 weights compress only to
# ~0.79 of their size at levels 1-6, and on the H100 machine's host, which
# has no `zstandard`, level 6 runs at ~10 MB/s and level 1 at ~26 MB/s: a
# 3 GB train state would take minutes to save. Level 0 (stored blocks,
# ~700 MB/s there) keeps the format, and the reference reads it.
ZLIB_LEVEL = 0
_CHUNK = 1 << 24             # bytes handed to the codec at a time

# dtype names on disk (numpy's) <-> torch dtypes
_DTYPES = {"float32": torch.float32, "float64": torch.float64,
           "float16": torch.float16, "bfloat16": torch.bfloat16,
           "int8": torch.int8, "int16": torch.int16, "int32": torch.int32,
           "int64": torch.int64, "uint8": torch.uint8,
           "uint16": torch.uint16, "uint32": torch.uint32,
           "uint64": torch.uint64, "bool": torch.bool}
_NAMES = {v: k for k, v in _DTYPES.items()}


class CheckpointCorruptError(RuntimeError):
    """A checkpoint file failed its integrity check (torn write, truncated
    file, bit flip). Restore paths catch this and fall back to the latest
    intact step instead of crashing."""


def codec() -> str:
    """The codec `save_pytree` writes: "zstd" or "zlib"."""
    return "zstd" if zstandard is not None else "zlib"


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------

def _flatten(tree, prefix: str = "", out=None) -> dict[str, Any]:
    """{"/"-joined path: leaf} in the reference's order (dict keys sorted,
    list items in order; None and empty containers hold no leaf)."""
    out = {} if out is None else out
    if isinstance(tree, dict):
        for k in sorted(tree):
            _flatten(tree[k], f"{prefix}{k}/", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}{i}/", out)
    elif tree is not None:
        out[prefix[:-1]] = tree
    return out


def _rebuild(tree, leaves: dict, prefix: str = ""):
    """`tree`'s structure with each leaf replaced by leaves[its path]."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves, f"{prefix}{k}/")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, leaves, f"{prefix}{i}/")
                          for i, v in enumerate(tree))
    return None if tree is None else leaves[prefix[:-1]]


def _unflatten_strs(flat: dict[str, Any]):
    root: dict = {}
    for key, val in flat.items():
        node = root
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return root


# ---------------------------------------------------------------------------
# streams
# ---------------------------------------------------------------------------

class _Deflater:
    """Compresses what is written to it into `f`, keeping the crc32 of the
    compressed bytes (the footer's)."""

    def __init__(self, f, raw_size: int):
        self._f, self.crc = f, 0
        if zstandard is not None:
            self._c = zstandard.ZstdCompressor(
                level=ZSTD_LEVEL, threads=-1).compressobj(size=raw_size)
        else:
            self._c = zlib.compressobj(ZLIB_LEVEL)
            self._emit(_ZLIB_MAGIC)

    def _emit(self, data: bytes) -> None:
        if data:
            self._f.write(data)
            self.crc = zlib.crc32(data, self.crc)

    def write(self, data) -> None:
        mv = memoryview(data).cast("B")
        for i in range(0, len(mv), _CHUNK):
            self._emit(self._c.compress(mv[i:i + _CHUNK]))

    def close(self) -> None:
        self._emit(self._c.flush())


class _Inflater:
    """Reads the decompressed body: `read(n)` gives exactly n bytes and
    `readinto(mv)` fills mv, or EOFError when the body ends first."""

    def __init__(self, f, nbytes: int):
        self._f, self._left = f, nbytes
        head = f.read(min(4, nbytes))
        self._left -= len(head)
        if head == _ZLIB_MAGIC:
            self._d, self._pending = zlib.decompressobj(), b""
        elif zstandard is None:
            raise RuntimeError("checkpoint is zstd-compressed but the "
                               "zstandard module is not installed")
        else:
            self._d, self._pending = zstandard.ZstdDecompressor() \
                .decompressobj(), head
        self._buf, self._pos, self._flushed = b"", 0, False

    def _more(self) -> bytes:
        while self._left > 0 or self._pending:
            data = self._pending or self._f.read(min(_CHUNK, self._left))
            if not self._pending:
                if not data:
                    break
                self._left -= len(data)
            self._pending = b""
            out = self._d.decompress(data)
            if out:
                return out
        if not self._flushed:
            self._flushed = True
            out = self._d.flush()
            if out:
                return out
        raise EOFError("checkpoint body ended early")

    def _take(self, n: int) -> memoryview:
        """Up to n buffered bytes (at least one)."""
        if self._pos == len(self._buf):
            self._buf, self._pos = memoryview(self._more()), 0
        out = self._buf[self._pos:self._pos + n]
        self._pos += len(out)
        return out

    def read(self, n: int) -> bytes:
        parts, got = [], 0
        while got < n:
            part = self._take(n - got)
            parts.append(bytes(part))
            got += len(part)
        return b"".join(parts)

    def readinto(self, mv) -> None:
        off = 0
        while off < len(mv):
            part = self._take(len(mv) - off)
            mv[off:off + len(part)] = part
            off += len(part)


# ---------------------------------------------------------------------------
# save / load
# ---------------------------------------------------------------------------

def _record_head(key: str, dtype: str, shape, nbytes: int) -> bytes:
    """A leaf's entry up to its raw bytes: the key, then the map
    {"d", "s", "b"} with b's bin header (its bytes follow)."""
    if nbytes > msgpack.MAX_BIN:
        raise ValueError(f"leaf {key}: {nbytes} bytes exceed a msgpack bin "
                         f"({msgpack.MAX_BIN} bytes)")
    out: list = []
    msgpack.pack_into(out, key)
    out.append(msgpack.map_header(3))
    for k, v in (("d", dtype), ("s", [int(n) for n in shape])):
        msgpack.pack_into(out, k)
        msgpack.pack_into(out, v)
    msgpack.pack_into(out, "b")
    out.append(msgpack.bin_header(nbytes))
    return b"".join(out)


def save_pytree(path: str, tree, meta: Optional[dict] = None):
    """Write `tree` (nested dicts / lists of tensors) and `meta` to `path`:
    a temporary file, fsynced, then renamed over `path`. Leaves go to the
    host one at a time."""
    flat = {k: v.detach() for k, v in _flatten(tree).items()}
    heads = {k: _record_head(k, _NAMES[t.dtype], t.shape,
                             t.numel() * t.element_size())
             for k, t in flat.items()}
    top = [msgpack.map_header(len(flat) + 1)]
    msgpack.pack_into(top, "__meta__")
    msgpack.pack_into(top, meta or {})
    top = b"".join(top)
    total = len(top) + sum(len(h) for h in heads.values()) + sum(
        t.numel() * t.element_size() for t in flat.values())
    tmp = path + f".tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        z = _Deflater(f, total)
        z.write(top)
        for key, t in flat.items():
            z.write(heads[key])
            host = t.reshape(-1).cpu()
            if host.numel():
                z.write(host.view(torch.uint8).numpy())
            del host
        z.close()
        f.write((z.crc & 0xFFFFFFFF).to_bytes(4, "little") + _FOOTER_MAGIC)
        f.flush()
        os.fsync(f.fileno())
    os.rename(tmp, path)  # atomic publish


def _body_length(path: str) -> int:
    """Verify a file's checksum footer and return its body's length. A file
    without the footer (written before it existed) is taken whole: its
    decompression and parsing still catch corruption."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        if size < 8:
            return size
        f.seek(size - 8)
        tail = f.read(8)
        if tail[4:] != _FOOTER_MAGIC:
            return size
        f.seek(0)
        crc, left = 0, size - 8
        while left:
            chunk = f.read(min(_CHUNK, left))
            if not chunk:
                break
            crc = zlib.crc32(chunk, crc)
            left -= len(chunk)
        if left or (crc & 0xFFFFFFFF) != int.from_bytes(tail[:4], "little"):
            raise CheckpointCorruptError(
                f"{path}: checksum mismatch (torn write or bit flip)")
    return size - 8


_DATA_ERRORS = (EOFError, ValueError, KeyError, IndexError, TypeError,
                UnicodeDecodeError, zlib.error) + (
    (zstandard.ZstdError,) if zstandard is not None else ())


def _records(path: str):
    """Yield ("__meta__", meta) and (key, host tensor) in file order, one
    leaf in memory at a time."""
    body = _body_length(path)
    if not body:
        raise CheckpointCorruptError(f"{path}: empty checkpoint file "
                                     "(torn write)")
    with open(path, "rb") as f:
        try:
            up = msgpack.Unpacker(_Inflater(f, body))
            n = up.map_header()
        except _DATA_ERRORS as e:
            raise CheckpointCorruptError(
                f"{path}: truncated or corrupt checkpoint ({e!r})") from e
        for _ in range(n):
            held = []

            def into(nbytes):
                held.append(torch.empty(nbytes, dtype=torch.uint8))
                return held[-1].numpy()
            try:
                key = up.unpack()
                rec = up.unpack(bin_into=into)
                if key != "__meta__":
                    rec = held[0].view(_DTYPES[rec["d"]]).reshape(rec["s"])
            except _DATA_ERRORS + (RuntimeError,) as e:   # torch's view
                raise CheckpointCorruptError(
                    f"{path}: truncated or corrupt checkpoint ({e!r})") from e
            yield key, rec


def load_pytree(path: str, target=None):
    """Load a checkpoint -> (tree, meta). With `target` (a tree of tensors)
    the result mirrors its structure, each leaf with the target leaf's
    shape (else `ValueError`), dtype and device; leaves of the file that the
    target lacks are skipped. Without it, a nested dict of host tensors.
    Torn or corrupt files raise `CheckpointCorruptError`."""
    flat_t = None if target is None else _flatten(target)
    meta, out = {}, {}
    for key, val in _records(path):
        if key == "__meta__":
            meta = val
        elif flat_t is None:
            out[key] = val
        elif key in flat_t:
            tgt = flat_t[key]
            if tuple(val.shape) != tuple(tgt.shape):
                raise ValueError(f"shape mismatch for {key}: "
                                 f"{tuple(val.shape)} vs {tuple(tgt.shape)}")
            out[key] = val.to(device=tgt.device, dtype=tgt.dtype)
        del val
    if flat_t is None:
        return _unflatten_strs(out), meta
    missing = [k for k in flat_t if k not in out]
    if missing:
        raise KeyError(f"checkpoint missing leaf {missing[0]}")
    return _rebuild(target, out), meta


def save_delta_store(path: str, store, meta: Optional[dict] = None):
    """Serialize a serve-engine per-user delta store (`serve.deltas.
    DeltaStore` holding `core.delta.DeltaState` entries) into the standard
    .ckpt format: one subtree per resident user, keyed by str(user), with
    the user ids (LRU order, least recent first) in meta["delta_users"].
    Duck-typed: `store` needs `users()` / `peek()` and entries a
    `to_tree()`, so this module imports nothing of serving."""
    users = store.users()
    tree = {str(u): store.peek(u).to_tree() for u in users}
    meta = dict(meta or {})
    meta["delta_users"] = [u if isinstance(u, (int, str)) else str(u)
                           for u in users]
    save_pytree(path, tree, meta)


def restore_delta_store(path: str, store):
    """Restore entries written by `save_delta_store` (here or by the
    reference) into `store` via its `load()` (unpinned, LRU order kept,
    capacity bound honoured: restoring more users than capacity evicts
    from the least-recent end), as host tensors. Returns the meta."""
    from repro_torch.core.delta import DeltaState
    arrays, meta = load_pytree(path)
    for user in meta.get("delta_users", sorted(arrays)):
        store.load(user, DeltaState.from_tree(arrays[str(user)]))
    return meta


class CheckpointManager:
    """Save-every-N, keep-last-K manager with atomic writes, checksum
    verification with fall-back-to-intact restore, and latest-checkpoint
    discovery (restart / resume). `chaos` is an optional
    `runtime.chaos.FaultSchedule`: when its `torn` draws fire, `save`
    publishes a deliberately truncated file instead of the real payload,
    the stand-in for a crash mid-write on a non-atomic filesystem, which
    `restore` must survive."""

    def __init__(self, directory: str, keep: int = 3, chaos=None):
        self.dir = directory
        self.keep = keep
        self.chaos = chaos
        self.torn_writes = 0
        os.makedirs(directory, exist_ok=True)
        self._lock = threading.Lock()

    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:09d}.ckpt")

    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            m = _CKPT_RE.search(name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, tree, meta: Optional[dict] = None):
        with self._lock:
            meta = dict(meta or {})
            meta["step"] = int(step)
            meta["time"] = time.time()
            path = self._path(step)
            if self.chaos is not None and self.chaos.draw("torn", site=step):
                # torn publish: write the real bytes, then publish their
                # first half, what a crash mid-write leaves behind on a
                # non-atomic path
                tmp = path + ".chaos"
                save_pytree(tmp, tree, meta)
                with open(tmp, "rb") as f:
                    f.seek(0, os.SEEK_END)
                    half = max(1, f.tell() // 2)
                    f.seek(0)
                    with open(path, "wb") as g:
                        while half:
                            chunk = f.read(min(_CHUNK, half))
                            g.write(chunk)
                            half -= len(chunk)
                os.remove(tmp)
                self.torn_writes += 1
            else:
                save_pytree(path, tree, meta)
            self._prune()

    def restore(self, step: Optional[int] = None, target=None):
        """Restore `step` (default: the latest). A torn or corrupt file is
        detected (`CheckpointCorruptError`), warned about and skipped: the
        restore falls back to the latest intact earlier step. Raises only
        when no intact checkpoint at or below `step` exists; (None, None)
        when there is none at all."""
        steps = self.all_steps()
        if step is None:
            candidates = list(reversed(steps))
        else:
            candidates = [step] + [s for s in reversed(steps) if s < step]
        if not candidates:
            return None, None
        for s in candidates:
            try:
                return load_pytree(self._path(s), target=target)
            except CheckpointCorruptError as e:
                warnings.warn(f"checkpoint step {s} is torn/corrupt ({e}); "
                              "falling back to the previous intact step")
        raise CheckpointCorruptError(
            f"no intact checkpoint in {self.dir} "
            f"(tried steps {candidates})")

    def _prune(self):
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            try:
                os.remove(self._path(s))
            except OSError:
                pass

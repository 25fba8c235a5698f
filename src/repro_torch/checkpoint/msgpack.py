"""The subset of MessagePack that checkpoints use: map, str, bin, int,
float, bool, nil and array.

`packb(obj)` gives the bytes `msgpack.packb(obj, use_bin_type=True)` gives
for the same object (the smallest encoding of each int and length, floats
as float64, tuples as arrays), so a file written here is what the
reference writes. `Unpacker` reads one object at a time from a stream and
can hand a bin's bytes straight into a caller's buffer, so a checkpoint
loads without holding its whole payload. Neither needs the `msgpack`
package.
"""
from __future__ import annotations

import struct

__all__ = ["packb", "unpackb", "Unpacker", "pack_into", "bin_header",
           "map_header", "MAX_BIN"]

MAX_BIN = 2**32 - 1        # a bin's length is at most a uint32


def _len_header(n: int, fix: int, fix_max: int, codes) -> bytes:
    """The header of a str / bin / array / map of length n: fix | n below
    fix_max (fix None: no fix form), else the 8- / 16- / 32-bit form."""
    if fix is not None and n < fix_max:
        return bytes([fix | n])
    for code, fmt, lim in zip(codes, (">B", ">H", ">I"),
                              (2**8, 2**16, 2**32)):
        if code is not None and n < lim:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack: length {n} does not fit a uint32")


def bin_header(n: int) -> bytes:
    return _len_header(n, None, 0, (0xC4, 0xC5, 0xC6))


def map_header(n: int) -> bytes:
    return _len_header(n, 0x80, 16, (None, 0xDE, 0xDF))


def _int(v: int) -> bytes:
    if 0 <= v < 0x80:
        return bytes([v])
    if -32 <= v < 0:
        return struct.pack(">b", v)
    if v >= 0:
        for code, fmt, lim in ((0xCC, ">B", 2**8), (0xCD, ">H", 2**16),
                               (0xCE, ">I", 2**32), (0xCF, ">Q", 2**64)):
            if v < lim:
                return bytes([code]) + struct.pack(fmt, v)
    else:
        for code, fmt, lim in ((0xD0, ">b", 2**7), (0xD1, ">h", 2**15),
                               (0xD2, ">i", 2**31), (0xD3, ">q", 2**63)):
            if v >= -lim:
                return bytes([code]) + struct.pack(fmt, v)
    raise ValueError(f"msgpack: integer {v} does not fit 64 bits")


def pack_into(out: list, obj) -> None:
    """Append the encoding of `obj` to `out` (a list of bytes pieces)."""
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        out.append(_int(obj))
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        out.append(_len_header(len(raw), 0xA0, 32, (0xD9, 0xDA, 0xDB)))
        out.append(raw)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = memoryview(obj).cast("B")
        out.append(bin_header(len(raw)))
        out.append(bytes(raw))
    elif isinstance(obj, (list, tuple)):
        out.append(_len_header(len(obj), 0x90, 16, (None, 0xDC, 0xDD)))
        for v in obj:
            pack_into(out, v)
    elif isinstance(obj, dict):
        out.append(map_header(len(obj)))
        for k, v in obj.items():
            pack_into(out, k)
            pack_into(out, v)
    else:
        raise TypeError(f"msgpack: cannot pack {type(obj).__name__}")


def packb(obj) -> bytes:
    out: list = []
    pack_into(out, obj)
    return b"".join(out)


class Unpacker:
    """Reads objects one at a time from `stream`, which has `read(n)`
    (exactly n bytes, or EOFError) and `readinto(memoryview)` (fills it).
    `unpack(bin_into=f)` passes every bin's length to `f`, which returns a
    writable buffer of that size or None; the bin's bytes are read into the
    buffer, which then stands for the bin (None: they are returned as
    bytes)."""

    def __init__(self, stream):
        self._s = stream

    def _u(self, fmt: str):
        return struct.unpack(fmt, self._s.read(struct.calcsize(fmt)))[0]

    def unpack(self, bin_into=None):
        code = self._s.read(1)[0]
        if code <= 0x7F:
            return code
        if code >= 0xE0:
            return code - 0x100
        if 0x80 <= code <= 0x8F:
            return self._map(code & 0x0F, bin_into)
        if 0x90 <= code <= 0x9F:
            return [self.unpack(bin_into) for _ in range(code & 0x0F)]
        if 0xA0 <= code <= 0xBF:
            return self._s.read(code & 0x1F).decode("utf-8")
        if code == 0xC0:
            return None
        if code in (0xC2, 0xC3):
            return code == 0xC3
        if code in (0xC4, 0xC5, 0xC6):
            n = self._u({0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}[code])
            buf = bin_into(n) if bin_into is not None else None
            if buf is None:
                return self._s.read(n)
            self._s.readinto(memoryview(buf).cast("B"))
            return buf
        if code in (0xCA, 0xCB):
            return self._u(">f" if code == 0xCA else ">d")
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if code in ints:
            return self._u(ints[code])
        if code in (0xD9, 0xDA, 0xDB):
            n = self._u({0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[code])
            return self._s.read(n).decode("utf-8")
        if code in (0xDC, 0xDD):
            n = self._u(">H" if code == 0xDC else ">I")
            return [self.unpack(bin_into) for _ in range(n)]
        if code in (0xDE, 0xDF):
            return self._map(self._u(">H" if code == 0xDE else ">I"),
                             bin_into)
        raise ValueError(f"msgpack: unsupported type byte 0x{code:02x}")

    def map_header(self) -> int:
        """The entry count of the map that comes next."""
        code = self._s.read(1)[0]
        if 0x80 <= code <= 0x8F:
            return code & 0x0F
        if code in (0xDE, 0xDF):
            return self._u(">H" if code == 0xDE else ">I")
        raise ValueError(f"msgpack: expected a map, got type byte "
                         f"0x{code:02x}")

    def _map(self, n: int, bin_into):
        out = {}
        for _ in range(n):
            k = self.unpack(bin_into)
            out[k] = self.unpack(bin_into)
        return out


class _BytesStream:
    def __init__(self, data: bytes):
        self._v, self._pos = memoryview(data), 0

    def read(self, n: int) -> bytes:
        if self._pos + n > len(self._v):
            raise EOFError("msgpack: data ended early")
        out = bytes(self._v[self._pos:self._pos + n])
        self._pos += n
        return out

    def readinto(self, mv) -> None:
        mv[:] = self.read(len(mv))


def unpackb(data: bytes):
    return Unpacker(_BytesStream(data)).unpack()

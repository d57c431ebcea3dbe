"""The subset of MessagePack that the checkpoint format uses: maps, str,
bin, int and arrays, each in MessagePack's smallest encoding, as
``msgpack.packb(obj, use_bin_type=True)`` writes them and
``msgpack.unpackb(blob, raw=False)`` reads them. The card's machine has
no ``msgpack`` package, so the port carries this codec; a CPU test holds
its bytes equal to the package's.
"""
from __future__ import annotations

import struct
from typing import Any, List, Tuple


def _len_header(n: int, fix_base: int, fix_max: int, codes: Tuple[int, ...],
                widths: Tuple[str, ...], out: List[bytes]) -> None:
    """The header of a str/bin/array/map of ``n`` items: the fix form where
    there is one, else the smallest of the sized forms."""
    if fix_base is not None and n <= fix_max:
        out.append(bytes([fix_base | n]))
        return
    for code, w in zip(codes, widths):
        if n < 1 << (8 * struct.calcsize(w)):
            out.append(bytes([code]) + struct.pack(">" + w, n))
            return
    raise ValueError(f"msgpack: length {n} too large")


def _int(v: int, out: List[bytes]) -> None:
    if 0 <= v <= 0x7F:
        out.append(bytes([v]))
    elif -32 <= v < 0:
        out.append(struct.pack(">b", v))
    elif v > 0:
        for code, w in ((0xCC, "B"), (0xCD, "H"), (0xCE, "I"), (0xCF, "Q")):
            if v < 1 << (8 * struct.calcsize(w)):
                out.append(bytes([code]) + struct.pack(">" + w, v))
                return
        raise ValueError(f"msgpack: int {v} too large")
    else:
        for code, w in ((0xD0, "b"), (0xD1, "h"), (0xD2, "i"), (0xD3, "q")):
            if v >= -(1 << (8 * struct.calcsize(w) - 1)):
                out.append(bytes([code]) + struct.pack(">" + w, v))
                return
        raise ValueError(f"msgpack: int {v} too small")


def _pack(obj: Any, out: List[bytes]) -> None:
    if isinstance(obj, bool) or obj is None:
        raise TypeError(f"msgpack subset: {obj!r} is not packed by the checkpoint format")
    if isinstance(obj, int):
        _int(obj, out)
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _len_header(len(raw), 0xA0, 31, (0xD9, 0xDA, 0xDB), ("B", "H", "I"), out)
        out.append(raw)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = bytes(obj)
        _len_header(len(raw), None, -1, (0xC4, 0xC5, 0xC6), ("B", "H", "I"), out)
        out.append(raw)
    elif isinstance(obj, (list, tuple)):
        _len_header(len(obj), 0x90, 15, (0xDC, 0xDD), ("H", "I"), out)
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        _len_header(len(obj), 0x80, 15, (0xDE, 0xDF), ("H", "I"), out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"msgpack subset: cannot pack {type(obj).__name__}")


def packb(obj: Any) -> bytes:
    out: List[bytes] = []
    _pack(obj, out)
    return b"".join(out)


class _Reader:
    def __init__(self, blob: bytes):
        self.b = memoryview(blob)
        self.i = 0

    def take(self, n: int) -> bytes:
        if self.i + n > len(self.b):
            raise ValueError("msgpack: truncated data")
        out = self.b[self.i:self.i + n]
        self.i += n
        return bytes(out)

    def num(self, fmt: str) -> int:
        return struct.unpack(">" + fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self) -> Any:
        c = self.take(1)[0]
        if c <= 0x7F:
            return c
        if c >= 0xE0:
            return c - 0x100
        if 0x80 <= c <= 0x8F:
            return self.map(c & 0x0F)
        if 0x90 <= c <= 0x9F:
            return [self.obj() for _ in range(c & 0x0F)]
        if 0xA0 <= c <= 0xBF:
            return self.take(c & 0x1F).decode("utf-8")
        sized = {0xC4: ("B", "bin"), 0xC5: ("H", "bin"), 0xC6: ("I", "bin"),
                 0xD9: ("B", "str"), 0xDA: ("H", "str"), 0xDB: ("I", "str"),
                 0xDC: ("H", "array"), 0xDD: ("I", "array"),
                 0xDE: ("H", "map"), 0xDF: ("I", "map")}
        ints = {0xCC: "B", 0xCD: "H", 0xCE: "I", 0xCF: "Q",
                0xD0: "b", 0xD1: "h", 0xD2: "i", 0xD3: "q"}
        if c in ints:
            return self.num(ints[c])
        if c in sized:
            fmt, kind = sized[c]
            n = self.num(fmt)
            if kind == "bin":
                return self.take(n)
            if kind == "str":
                return self.take(n).decode("utf-8")
            if kind == "array":
                return [self.obj() for _ in range(n)]
            return self.map(n)
        raise ValueError(f"msgpack subset: unsupported type byte 0x{c:02x}")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out


def unpackb(blob: bytes) -> Any:
    r = _Reader(blob)
    out = r.obj()
    if r.i != len(r.b):
        raise ValueError("msgpack: trailing bytes")
    return out

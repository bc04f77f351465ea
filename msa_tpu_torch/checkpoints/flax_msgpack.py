"""Pure-Python reader for the msgpack subset that ``flax.serialization``
writes, so the port loads the shipped checkpoints without flax or msgpack.

The subset: maps, arrays, str, bin, nil, bools, ints and floats, plus three
ext types — 1: ndarray (msgpack of ``(shape, dtype name, C-order bytes)``),
2: complex (msgpack of ``(real, imag)``), 3: numpy scalar (an ndarray of
shape ``()``). Arrays flax split into chunks (``__msgpack_chunked_array__``)
are joined back, as ``flax.serialization.msgpack_restore`` does.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Any, Tuple

import numpy as np

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str) -> Any:
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {
            0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
            0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
            0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
            0xDE: ("map", ">H"), 0xDF: ("map", ">I"),
            0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I"),
        }
        if b in sized:
            kind, fmt = sized[b]
            n = self.unpack(fmt)
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "ext":
                return self.ext(n)
            return getattr(self, kind)(n)
        fixed = {
            0xCA: ">f", 0xCB: ">d",
            0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
            0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
        }
        if b in fixed:
            return self.unpack(fixed[b])
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext(fixext[b])
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def array(self, n: int) -> list:
        return [self.obj() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out

    def ext(self, n: int) -> Any:
        code = self.unpack(">b")
        payload = bytes(self.take(n))
        if code == _EXT_NDARRAY:
            return _ndarray(payload)
        if code == _EXT_NPSCALAR:
            return _ndarray(payload)[()]
        if code == _EXT_COMPLEX:
            re, im = _Reader(payload).obj()
            return complex(re, im)
        raise ValueError(f"unsupported msgpack ext type {code}")


def _ndarray(payload: bytes) -> np.ndarray:
    shape, dtype_name, buf = _Reader(payload).obj()
    if isinstance(dtype_name, bytes):
        dtype_name = dtype_name.decode()
    shape: Tuple[int, ...] = tuple(shape)
    if dtype_name == "bfloat16":
        # numpy has no bfloat16: widen the bit patterns to float32 exactly
        bits = np.frombuffer(buf, np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(dtype_name)).reshape(shape)


def _unchunk(tree: Any) -> Any:
    if not isinstance(tree, dict):
        return tree
    if "__msgpack_chunked_array__" in tree:
        chunks = tree["chunks"]
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        flat = np.concatenate([chunks[str(i)] for i in range(len(chunks))])
        return flat.reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def loads(data: bytes) -> Any:
    """Decode one flax-msgpack document into dicts/lists of numpy arrays."""
    r = _Reader(data)
    out = r.obj()
    if r.pos != len(r.data):
        raise ValueError("trailing bytes after the msgpack document")
    return _unchunk(out)


def load(path: "str | Path") -> Any:
    return loads(Path(path).read_bytes())

"""Pure-Python reader and writer for the msgpack subset that
``flax.serialization`` writes, so the port loads and saves checkpoints
without flax or msgpack.

The subset: maps, arrays, str, bin, nil, bools, ints and floats, plus three
ext types — 1: ndarray (msgpack of ``(shape, dtype name, C-order bytes)``),
2: complex (msgpack of ``(real, imag)``), 3: numpy scalar (an ndarray of
shape ``()``). Arrays flax split into chunks (``__msgpack_chunked_array__``)
are joined back, as ``flax.serialization.msgpack_restore`` does.

:func:`dumps` writes the bytes of ``flax.serialization.msgpack_serialize``:
``msgpack.packb(tree, strict_types=True)`` with flax's ext hook. Ints and
strings take their smallest encoding, Python floats are float64, numpy
arrays ext 1, numpy scalars ext 3, complex ext 2, and an array of more than
:data:`MAX_CHUNK_SIZE` bytes held in a dict is split into
``__msgpack_chunked_array__`` chunks, as flax splits it. ``msgpack_serialize``
copies the tree through ``jax.tree_util`` first, which sorts every dict's
keys; ``sort_keys=False`` keeps the tree's order instead, as
``msgpack_serialize(tree, in_place=True)`` and ``flax.serialization.to_bytes``
do.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Any, Tuple

import numpy as np

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
# flax's chunk limit in bytes (msgpack's hard limit is 2**31 - 1 a leaf)
MAX_CHUNK_SIZE = 2**30


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


# --- writer -----------------------------------------------------------------


def _header(n: int, fix: "int | None", fix_max: int, wide: Tuple[int, int, int]) -> bytes:
    """The header of a sized object: the fix form up to ``fix_max``, else
    the 8-, 16- or 32-bit length form (``wide``'s type bytes; 0 where the
    form does not exist)."""
    if fix is not None and n <= fix_max:
        return bytes([fix | n])
    for code, fmt, top in zip(wide, (">BB", ">BH", ">BI"), (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code and n <= top:
            return struct.pack(fmt, code, n)
    raise ValueError(f"object of size {n} is too large for msgpack")


def _int(v: int) -> bytes:
    if 0 <= v < 0x80 or -0x20 <= v < 0:
        return struct.pack("b" if v < 0 else "B", v)
    forms = ((0xCC, ">BB", 0, 0xFF), (0xCD, ">BH", 0, 0xFFFF), (0xCE, ">BI", 0, 0xFFFFFFFF),
             (0xCF, ">BQ", 0, 0xFFFFFFFFFFFFFFFF)) if v > 0 else (
            (0xD0, ">Bb", -0x80, 0), (0xD1, ">Bh", -0x8000, 0), (0xD2, ">Bi", -0x80000000, 0),
            (0xD3, ">Bq", -0x8000000000000000, 0))
    for code, fmt, lo, hi in forms:
        if lo <= v <= hi:
            return struct.pack(fmt, code, v)
    raise OverflowError("Integer value out of range")


def _ext(code: int, data: bytes) -> bytes:
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    head = bytes([fixext[len(data)]]) if len(data) in fixext else _header(len(data), None, 0, (0xC7, 0xC8, 0xC9))
    return head + struct.pack("b", code) + data


def _ndarray_bytes(arr: np.ndarray) -> bytes:
    """flax's ``_ndarray_to_bytes``: msgpack of ``(shape, dtype name,
    C-order bytes)``."""
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("Object and structured dtypes not supported for serialization of ndarrays.")
    out: list = []
    _pack(out, [list(arr.shape), arr.dtype.name, arr.tobytes("C")], strict=False)
    return b"".join(out)


def _pack(out: list, obj: Any, strict: bool = True) -> None:
    """Append ``obj``'s msgpack bytes to ``out``. ``strict`` is msgpack's
    ``strict_types``: a tuple is then not an array (flax refuses it)."""
    t = type(obj)
    if obj is None:
        out.append(b"\xc0")
    elif t is bool:
        out.append(b"\xc3" if obj else b"\xc2")
    elif t is int:
        out.append(_int(obj))
    elif t in (bytes, bytearray):
        out += [_header(len(obj), None, 0, (0xC4, 0xC5, 0xC6)), bytes(obj)]
    elif t is str:
        b = obj.encode("utf-8")
        out += [_header(len(b), 0xA0, 31, (0xD9, 0xDA, 0xDB)), b]
    elif t is float:
        out.append(struct.pack(">Bd", 0xCB, obj))
    elif t is list or (not strict and t is tuple):
        out.append(_header(len(obj), 0x90, 15, (0, 0xDC, 0xDD)))
        for v in obj:
            _pack(out, v, strict)
    elif t is dict:
        out.append(_header(len(obj), 0x80, 15, (0, 0xDE, 0xDF)))
        for k, v in obj.items():
            _pack(out, k, strict)
            _pack(out, v, strict)
    elif isinstance(obj, np.ndarray):
        out.append(_ext(_EXT_NDARRAY, _ndarray_bytes(obj)))
    elif isinstance(obj, np.generic):
        out.append(_ext(_EXT_NPSCALAR, _ndarray_bytes(np.asarray(obj))))
    elif t is complex:
        part: list = []
        _pack(part, [obj.real, obj.imag], strict=False)
        out.append(_ext(_EXT_COMPLEX, b"".join(part)))
    else:
        raise TypeError(f"Cannot serialize {obj!r}")


def _chunk(arr: np.ndarray) -> dict:
    """flax's ``_chunk``: the flat array in pieces of at most
    :data:`MAX_CHUNK_SIZE` bytes, the shape and the pieces keyed "0", "1", …"""
    size = max(1, int(MAX_CHUNK_SIZE / arr.dtype.itemsize))
    flat = arr.reshape(-1)
    chunks = [flat[i : i + size] for i in range(0, flat.size, size)]
    return {
        "__msgpack_chunked_array__": True,
        "shape": {str(i): n for i, n in enumerate(arr.shape)},
        "chunks": {str(i): c for i, c in enumerate(chunks)},
    }


def _prepare(tree: Any, sort_keys: bool) -> Any:
    """A copy of the tree as flax hands it to msgpack: dict keys sorted
    (``sort_keys``), and every array held in a dict (or the tree itself)
    above :data:`MAX_CHUNK_SIZE` bytes chunked."""

    def leaf(v):
        if isinstance(v, np.ndarray) and v.size * v.dtype.itemsize > MAX_CHUNK_SIZE:
            return _chunk(v)
        return v

    def walk(v, in_dict):
        if type(v) is dict:
            keys = sorted(v) if sort_keys else list(v)
            return {k: walk(v[k], True) for k in keys}
        if type(v) in (list, tuple):
            return type(v)(walk(x, False) for x in v)
        return leaf(v) if in_dict else v

    return walk(tree, False) if isinstance(tree, (dict, list, tuple)) else leaf(tree)


def dumps(tree: Any, sort_keys: bool = True) -> bytes:
    """``flax.serialization.msgpack_serialize(tree)`` without flax: dicts,
    lists, str, bytes, None, bools, ints, floats, complex, numpy arrays and
    scalars. ``sort_keys=False`` is ``msgpack_serialize(tree, in_place=True)``
    (``to_bytes``)."""
    out: list = []
    _pack(out, _prepare(tree, sort_keys))
    return b"".join(out)


def dump(path: "str | Path", tree: Any, sort_keys: bool = True) -> None:
    """Write :func:`dumps` of ``tree`` to ``path``, creating its directory."""
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_bytes(dumps(tree, sort_keys))

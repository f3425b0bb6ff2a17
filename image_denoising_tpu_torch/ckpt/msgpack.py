"""The msgpack form of the JAX package's ``.ckpt`` files, by hand.

``image_denoising_tpu/ckpt/io.py`` writes a params tree with flax's
``serialization.msgpack_serialize``: nested maps with ``str`` keys, in
sorted order (``jax.tree_util.tree_map`` rebuilds every dict with sorted
keys), whose leaves are numpy arrays packed as msgpack ext type 1. The
ext payload is itself msgpack: the array ``(shape, dtype.name,
arr.tobytes('C'))`` with ``use_bin_type=True``, so a 0-d array packs its
shape as an empty array.

``pack`` writes the bytes flax writes for such a tree; ``unpack`` reads
them back to nested dicts of numpy arrays. Only that subset is handled:
maps, arrays (inside the ext payload), ``str``, ``bin``, non-negative
integers and ext type 1, each header form chosen by size as msgpack does
(fixext only for payloads of exactly 1, 2, 4, 8 or 16 bytes). Anything
else raises ``ValueError``: flax's other ext types (2, complex; 3, numpy
scalars), its chunked form of arrays above 2³⁰ bytes, floats, booleans,
nil, negative integers and dtypes numpy does not name (bfloat16).
"""
from __future__ import annotations

import struct
from typing import Any, Dict

import numpy as np

__all__ = ["pack", "unpack"]

_EXT_NDARRAY = 1
# numpy's own dtypes; bfloat16 and the other ml_dtypes names are refused,
# whether or not a library has registered them with numpy
_DTYPES = {"bool", "int8", "int16", "int32", "int64", "uint8", "uint16", "uint32",
           "uint64", "float16", "float32", "float64"}
_MAX_CHUNK = 2 ** 30  # flax splits larger arrays into a chunked map
_FIXEXT = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}


def _uint(n: int) -> bytes:
    if n < 0:
        raise ValueError(f"negative integer {n} is outside the .ckpt subset")
    if n < 0x80:
        return bytes([n])
    if n < 0x100:
        return b"\xcc" + struct.pack(">B", n)
    if n < 0x10000:
        return b"\xcd" + struct.pack(">H", n)
    if n < 0x100000000:
        return b"\xce" + struct.pack(">I", n)
    return b"\xcf" + struct.pack(">Q", n)


def _str(s: str) -> bytes:
    raw = s.encode("utf-8")
    n = len(raw)
    if n < 32:
        head = bytes([0xA0 | n])
    elif n < 0x100:
        head = b"\xd9" + struct.pack(">B", n)
    elif n < 0x10000:
        head = b"\xda" + struct.pack(">H", n)
    else:
        head = b"\xdb" + struct.pack(">I", n)
    return head + raw


def _bin(raw: bytes) -> bytes:
    n = len(raw)
    if n < 0x100:
        head = b"\xc4" + struct.pack(">B", n)
    elif n < 0x10000:
        head = b"\xc5" + struct.pack(">H", n)
    else:
        head = b"\xc6" + struct.pack(">I", n)
    return head + raw


def _array_head(n: int) -> bytes:
    if n < 16:
        return bytes([0x90 | n])
    if n < 0x10000:
        return b"\xdc" + struct.pack(">H", n)
    return b"\xdd" + struct.pack(">I", n)


def _map_head(n: int) -> bytes:
    if n < 16:
        return bytes([0x80 | n])
    if n < 0x10000:
        return b"\xde" + struct.pack(">H", n)
    return b"\xdf" + struct.pack(">I", n)


def _ext(code: int, payload: bytes) -> bytes:
    n = len(payload)
    if n in _FIXEXT:
        head = bytes([_FIXEXT[n]])
    elif n < 0x100:
        head = b"\xc7" + struct.pack(">B", n)
    elif n < 0x10000:
        head = b"\xc8" + struct.pack(">H", n)
    else:
        head = b"\xc9" + struct.pack(">I", n)
    return head + struct.pack(">b", code) + payload


def _ndarray(arr: np.ndarray) -> bytes:
    if arr.dtype.name not in _DTYPES:
        raise ValueError(f"dtype {arr.dtype} is outside the .ckpt subset")
    if arr.nbytes > _MAX_CHUNK:
        raise ValueError(f"an array of {arr.nbytes} bytes would be written in "
                         "flax's chunked form, which the port does not write")
    payload = (_array_head(arr.ndim) + b"".join(_uint(int(s)) for s in arr.shape)
               + _str(arr.dtype.name) + _bin(arr.tobytes("C")))
    return _ext(_EXT_NDARRAY, _array_head(3) + payload)


def _pack(node: Any, out: list) -> None:
    if isinstance(node, dict):
        for k in node:
            if not isinstance(k, str):
                raise ValueError(f"map key {k!r} is not a str")
        out.append(_map_head(len(node)))
        for k in sorted(node):
            out.append(_str(k))
            _pack(node[k], out)
    elif isinstance(node, np.ndarray):
        out.append(_ndarray(node))
    else:
        raise ValueError(f"leaf of type {type(node).__name__} is outside the "
                         ".ckpt subset (numpy arrays in nested str-keyed dicts)")


def pack(tree: Dict[str, Any]) -> bytes:
    """A nested dict of numpy arrays → the bytes of flax's
    ``msgpack_serialize`` of it (keys sorted at every level)."""
    out: list = []
    _pack(tree, out)
    return b"".join(out)


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        view = self.data[self.pos : self.pos + n]
        self.pos += n
        return view

    def be(self, fmt: str) -> int:
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        t = self.take(1)[0]
        if t < 0x80:
            return t
        if 0x80 <= t <= 0x8F:
            return self.map(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return self.array(t & 0x0F)
        if 0xA0 <= t <= 0xBF:
            return self.string(t & 0x1F)
        simple = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q"}
        if t in simple:
            return self.be(simple[t])
        sizes = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
        if t in sizes:
            return bytes(self.take(self.be(sizes[t])))
        sizes = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if t in sizes:
            return self.string(self.be(sizes[t]))
        if t in (0xDC, 0xDD):
            return self.array(self.be(">H" if t == 0xDC else ">I"))
        if t in (0xDE, 0xDF):
            return self.map(self.be(">H" if t == 0xDE else ">I"))
        fixext = {v: k for k, v in _FIXEXT.items()}
        if t in fixext:
            return self.ext(fixext[t])
        sizes = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        if t in sizes:
            return self.ext(self.be(sizes[t]))
        raise ValueError(f"msgpack type byte 0x{t:02x} at offset {self.pos - 1} is "
                         "outside the .ckpt subset (maps, arrays, str, bin, "
                         "non-negative ints, ext 1)")

    def string(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            if not isinstance(k, str):
                raise ValueError(f"map key {k!r} is not a str")
            if k == "__msgpack_chunked_array__":
                raise ValueError("flax's chunked array form (arrays above 2^30 "
                                 "bytes) is outside the .ckpt subset")
            out[k] = self.value()
        return out

    def ext(self, n: int) -> np.ndarray:
        code = self.be(">b")
        payload = bytes(self.take(n))
        if code != _EXT_NDARRAY:
            raise ValueError(f"msgpack ext type {code} is outside the .ckpt "
                             "subset (only ext 1, ndarray)")
        inner = _Reader(payload)
        tpl = inner.value()
        if inner.pos != len(payload) or not (
                isinstance(tpl, list) and len(tpl) == 3
                and isinstance(tpl[0], list) and isinstance(tpl[1], str)
                and isinstance(tpl[2], bytes)):
            raise ValueError("malformed ndarray ext payload")
        shape, name, buf = tpl
        if name not in _DTYPES:
            raise ValueError(f"array dtype {name!r} is outside the .ckpt subset")
        return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape).copy()


def unpack(data: bytes) -> Dict[str, Any]:
    """The bytes of a ``.ckpt`` → nested dicts of numpy arrays."""
    r = _Reader(data)
    tree = r.value()
    if r.pos != len(r.data):
        raise ValueError(f"{len(r.data) - r.pos} trailing bytes after the tree")
    return tree

"""Checkpoint reading for serving: the speed-up decoder.

The JAX package writes ``decoder_chkpnt{N}.ckpt`` with flax's msgpack
serializer (``feature3dgs_tpu/train/checkpoints.py:save_decoder_checkpoint``).
Neither flax nor msgpack is needed here: ``msgpack_restore`` is a small
pure-Python reader of the subset flax writes — maps, arrays, strings,
integers, floats, nil, booleans, bin, and flax's ndarray extension (type 1,
holding a packed ``(shape, dtype name, bytes)`` triple; type 3 holds a
scalar the same way). Full training checkpoints come with training.
"""
from __future__ import annotations

import struct

import numpy as np
import torch

from feature3dgs_tpu_torch import default_device

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(">" + fmt, self.take(struct.calcsize(">" + fmt)))[0]

    def obj(self):
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
            return self.take(b & 0x1F).decode("utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {0xC4: ("B", "bin"), 0xC5: ("H", "bin"), 0xC6: ("I", "bin"),
                 0xD9: ("B", "str"), 0xDA: ("H", "str"), 0xDB: ("I", "str"),
                 0xDC: ("H", "array"), 0xDD: ("I", "array"),
                 0xDE: ("H", "map"), 0xDF: ("I", "map")}
        if b in sized:
            fmt, kind = sized[b]
            n = self.unpack(fmt)
            if kind == "bin":
                return self.take(n)
            if kind == "str":
                return self.take(n).decode("utf-8")
            return self.array(n) if kind == "array" else self.map(n)
        numbers = {0xCA: "f", 0xCB: "d", 0xCC: "B", 0xCD: "H", 0xCE: "I",
                   0xCF: "Q", 0xD0: "b", 0xD1: "h", 0xD2: "i", 0xD3: "q"}
        if b in numbers:
            return self.unpack(numbers[b])
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            code = self.unpack("b")
            return _ext(code, self.take(fixext[b]))
        if b in (0xC7, 0xC8, 0xC9):
            n = self.unpack({0xC7: "B", 0xC8: "H", 0xC9: "I"}[b])
            code = self.unpack("b")
            return _ext(code, self.take(n))
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def array(self, n: int) -> list:
        return [self.obj() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out


def _ext(code: int, payload: bytes):
    if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
        raise ValueError(f"unsupported msgpack extension type {code}")
    shape, dtype_name, buf = _Reader(payload).obj()
    if dtype_name == "bfloat16":
        raise ValueError("bfloat16 arrays are not supported")
    arr = np.frombuffer(buf, dtype=np.dtype(dtype_name)).reshape(shape)
    return arr[()] if code == _EXT_NPSCALAR else arr.copy()


def msgpack_restore(data: bytes):
    """Decode msgpack bytes written by flax's ``msgpack_serialize``."""
    r = _Reader(data)
    out = r.obj()
    if r.pos != len(data):
        raise ValueError("trailing bytes after the msgpack object")
    return out


def _unclean(tree):
    """Undo the JAX package's None sentinel ({"__none__": True})."""
    if isinstance(tree, dict):
        if tree.get("__none__") is True:
            return None
        if tree.get("__msgpack_chunked_array__") is True:
            raise ValueError("chunked (> 1 GiB) arrays are not supported")
        return {k: _unclean(v) for k, v in tree.items()}
    return tree


def load_decoder_checkpoint(path: str, device=None) -> dict:
    """``decoder_chkpnt{N}.ckpt`` -> {"w": [F_in, F_out], "b": [F_out]} on
    ``default_device(device)``."""
    device = default_device(device)
    with open(path, "rb") as f:
        raw = _unclean(msgpack_restore(f.read()))
    return {k: torch.from_numpy(np.asarray(v, np.float32)).to(device)
            for k, v in raw.items()}

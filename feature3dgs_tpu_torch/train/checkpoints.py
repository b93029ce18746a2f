"""Checkpoints: scene PLY snapshots, the full training state, the speed-up
decoder, ``cfg_args`` and ``cameras.json``.

Port of ``feature3dgs_tpu/train/checkpoints.py``, in the JAX package's own
file formats, so a checkpoint written by either package loads in the other:
  1. ``point_cloud/iteration_N/point_cloud.ply`` in the original schema;
  2. ``chkpnt{N}.ckpt``: parameters, Adam moments, densification statistics
     and the decoder with its Adam state, as flax's msgpack layout of a
     nested dict with ``{"__none__": True}`` standing for None, and
     ``chkpnt{N}.meta.json`` beside it holding the iteration;
  3. ``decoder_chkpnt{N}.ckpt``: the decoder alone.
Neither flax nor msgpack is needed here: ``msgpack_restore`` and
``msgpack_serialize`` are a small pure-Python reader and writer of the
subset flax uses: maps, arrays, strings, integers, floats, nil, booleans,
bin, and flax's ndarray extension (type 1, holding a packed ``(shape, dtype
name, bytes)`` triple; type 3 holds a numpy scalar the same way).
"""
from __future__ import annotations

import json
import os
import struct

import numpy as np
import torch

from feature3dgs_tpu_torch import default_device
from feature3dgs_tpu_torch.model import optim
from feature3dgs_tpu_torch.model.gaussians import GaussianParams, GaussianState
from feature3dgs_tpu_torch.model.ply_io import save_gaussians_ply

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


# flax splits arrays above this many bytes into chunks; this writer refuses
_MAX_ARRAY_BYTES = 2 ** 30


def _pack_head(n: int, fix: tuple | None, sized: tuple) -> bytes:
    """The header of a sized object: ``fix`` = (base byte, largest fix
    size) or None; ``sized`` = the type bytes of the 8/16/32-bit forms
    (None where the type has no 8-bit form)."""
    if fix is not None and n <= fix[1]:
        return bytes([fix[0] | n])
    for code, fmt, limit in zip(sized, ("B", "H", "I"),
                                (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= limit:
            return bytes([code]) + struct.pack(">" + fmt, n)
    raise ValueError(f"object of {n} elements is too large for msgpack")


def _pack_ext(code: int, payload: bytes) -> bytes:
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    n = len(payload)
    head = (bytes([fixext[n]]) if n in fixext
            else _pack_head(n, None, (0xC7, 0xC8, 0xC9)))
    return head + struct.pack("b", code) + payload


def _pack(obj, out: list):
    if obj is None:
        out.append(b"\xc0")
    elif isinstance(obj, bool):
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        if 0 <= obj <= 0x7F:
            out.append(bytes([obj]))
        elif -32 <= obj < 0:
            out.append(struct.pack("b", obj))
        elif obj >= 0:
            out.append(next(bytes([c]) + struct.pack(">" + f, obj)
                            for c, f, lim in ((0xCC, "B", 0xFF),
                                              (0xCD, "H", 0xFFFF),
                                              (0xCE, "I", 0xFFFFFFFF),
                                              (0xCF, "Q", 2 ** 64 - 1))
                            if obj <= lim))
        else:
            out.append(next(bytes([c]) + struct.pack(">" + f, obj)
                            for c, f, lim in ((0xD0, "b", -2 ** 7),
                                              (0xD1, "h", -2 ** 15),
                                              (0xD2, "i", -2 ** 31),
                                              (0xD3, "q", -2 ** 63))
                            if obj >= lim))
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        out.append(_pack_head(len(raw), (0xA0, 31), (0xD9, 0xDA, 0xDB)) + raw)
    elif isinstance(obj, bytes):
        out.append(_pack_head(len(obj), None, (0xC4, 0xC5, 0xC6)) + obj)
    elif isinstance(obj, (list, tuple)):
        out.append(_pack_head(len(obj), (0x90, 15), (None, 0xDC, 0xDD)))
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        out.append(_pack_head(len(obj), (0x80, 15), (None, 0xDE, 0xDF)))
        if not all(isinstance(key, str) for key in obj):
            raise TypeError(f"map keys {list(obj)!r} are not all strings")
        for key in sorted(obj):     # flax writes a map's keys in sorted order
            _pack(key, out)
            _pack(obj[key], out)
    elif isinstance(obj, (np.ndarray, np.generic)):
        arr = np.asarray(obj)
        if arr.nbytes > _MAX_ARRAY_BYTES:
            raise ValueError("arrays above 1 GiB (flax's chunked form) are "
                             "not supported")
        triple: list = []
        _pack((list(arr.shape), arr.dtype.name, arr.tobytes()), triple)
        out.append(_pack_ext(_EXT_NPSCALAR if isinstance(obj, np.generic)
                             else _EXT_NDARRAY, b"".join(triple)))
    else:
        raise TypeError(f"cannot pack {type(obj).__name__}")


def msgpack_serialize(tree) -> bytes:
    """Encode a tree of dicts, lists, Python scalars, strings, numpy arrays
    and numpy scalars as flax's ``msgpack_serialize`` does."""
    out: list = []
    _pack(tree, out)
    return b"".join(out)


def _clean(tree):
    """None has no encoding in the JAX package's files: a sentinel dict
    stands for it."""
    if tree is None:
        return {"__none__": True}
    if isinstance(tree, dict):
        return {k: _clean(v) for k, v in tree.items()}
    return tree


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
    """``decoder_chkpnt{N}.ckpt``, or a full ``chkpnt{N}.ckpt`` that holds a
    decoder -> {"w": [F_in, F_out], "b": [F_out]} on
    ``default_device(device)``."""
    device = default_device(device)
    with open(path, "rb") as f:
        raw = _unclean(msgpack_restore(f.read()))
    if "params" in raw and "decoder" in raw:     # a full training checkpoint
        raw = raw["decoder"]
        if raw is None:
            raise ValueError(f"{path} holds no decoder (trained without "
                             "--speedup)")
    return {k: torch.from_numpy(np.asarray(v, np.float32)).to(device)
            for k, v in raw.items()}


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().to("cpu").numpy()


def _fields_np(p: GaussianParams) -> dict:
    return {k: _np(getattr(p, k)) for k in GaussianParams.FIELDS}


def save_scene_ply(model_path: str, iteration: int, params: GaussianParams,
                   state: GaussianState) -> str:
    path = os.path.join(model_path, "point_cloud",
                        f"iteration_{iteration}", "point_cloud.ply")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    save_gaussians_ply(path, params, state)
    return path


def _state_dict(ts) -> dict:
    gs = ts.gstate
    return {
        "params": _fields_np(ts.params),
        "gstate": {
            "alive": _np(gs.alive),
            "max_radii2d": _np(gs.max_radii2d),
            "xyz_gradient_accum": _np(gs.xyz_gradient_accum),
            "denom": _np(gs.denom),
            "active_sh_degree": int(gs.active_sh_degree),
            "spatial_lr_scale": float(gs.spatial_lr_scale),
        },
        "adam": {"mu": _fields_np(ts.adam.mu), "nu": _fields_np(ts.adam.nu),
                 "step": _np(ts.adam.step)},
        "decoder": (None if ts.decoder is None
                    else {k: _np(v) for k, v in ts.decoder.items()}),
        "decoder_adam": None if ts.decoder_adam is None else {
            "mu": {k: _np(v) for k, v in ts.decoder_adam.mu.items()},
            "nu": {k: _np(v) for k, v in ts.decoder_adam.nu.items()},
            "step": _np(ts.decoder_adam.step)},
    }


def save_checkpoint(model_path: str, iteration: int, ts) -> str:
    """Write the full training state ``ts`` (a ``train.trainer.TrainState``)
    as ``chkpnt{iteration}.ckpt`` and its ``.meta.json``; returns the path."""
    payload = msgpack_serialize(_clean(_state_dict(ts)))
    os.makedirs(model_path, exist_ok=True)
    path = os.path.join(model_path, f"chkpnt{iteration}.ckpt")
    with open(path, "wb") as f:
        f.write(payload)
    with open(os.path.join(model_path, f"chkpnt{iteration}.meta.json"),
              "w") as f:
        json.dump({"iteration": iteration}, f)
    return path


def save_decoder_checkpoint(model_path: str, iteration: int,
                            decoder: dict) -> str:
    """The decoder alone (the original decoder_chkpnt{it}.pth,
    train.py:124-126), loadable without the training state."""
    payload = msgpack_serialize({k: _np(v) for k, v in decoder.items()})
    os.makedirs(model_path, exist_ok=True)
    path = os.path.join(model_path, f"decoder_chkpnt{iteration}.ckpt")
    with open(path, "wb") as f:
        f.write(payload)
    return path


def load_checkpoint(path: str, device=None):
    """``chkpnt{N}.ckpt`` -> (TrainState, iteration) on
    ``default_device(device)``; the iteration comes from the ``.meta.json``
    beside the file (0 when that is missing)."""
    from feature3dgs_tpu_torch.train.trainer import TrainState
    device = default_device(device)
    with open(path, "rb") as f:
        raw = _unclean(msgpack_restore(f.read()))

    def tensor(x, dtype=None):
        return torch.from_numpy(np.array(x, dtype=dtype)).to(device)

    def fields(d):
        return GaussianParams(**{k: tensor(d[k])
                                 for k in GaussianParams.FIELDS})

    def tensors(d):
        return {k: tensor(v) for k, v in d.items()}

    gs = raw["gstate"]
    gstate = GaussianState(
        alive=tensor(gs["alive"], bool), max_radii2d=tensor(gs["max_radii2d"]),
        xyz_gradient_accum=tensor(gs["xyz_gradient_accum"]),
        denom=tensor(gs["denom"]),
        active_sh_degree=int(gs["active_sh_degree"]),
        spatial_lr_scale=float(gs["spatial_lr_scale"]))
    ad = raw["adam"]
    adam = optim.AdamState(fields(ad["mu"]), fields(ad["nu"]),
                           tensor(ad["step"], np.int32))
    decoder = None if raw["decoder"] is None else tensors(raw["decoder"])
    da = raw["decoder_adam"]
    decoder_adam = None if da is None else optim.TensorAdamState(
        tensors(da["mu"]), tensors(da["nu"]), tensor(da["step"], np.int32))
    meta_path = path.replace(".ckpt", ".meta.json")
    iteration = 0
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            iteration = json.load(f).get("iteration", 0)
    return TrainState(params=fields(raw["params"]), gstate=gstate, adam=adam,
                      decoder=decoder, decoder_adam=decoder_adam), iteration


def save_cfg_args(model_path: str, cfg: dict):
    """The run's configuration as JSON under the original's file name."""
    os.makedirs(model_path, exist_ok=True)
    with open(os.path.join(model_path, "cfg_args"), "w") as f:
        json.dump(cfg, f, indent=1, default=str)


def load_cfg_args(model_path: str) -> dict:
    with open(os.path.join(model_path, "cfg_args")) as f:
        return json.load(f)


def save_cameras_json(model_path: str, cameras):
    with open(os.path.join(model_path, "cameras.json"), "w") as f:
        json.dump([c.to_json() for c in cameras], f)

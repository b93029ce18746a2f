"""The kernel libraries under the wrappers that launch them
(ops/cuda_raster.py, ops/cuda_adam.py, ops/cuda_preprocess.py,
ops/cuda_resize.py, ops/cuda_segment.py).

``build`` compiles each source of ``SOURCES`` not built yet with ``nvcc``
for ``sm_90a`` into its own shared library with a plain C interface, one
``nvcc`` a source, all started together, into ``build/kernels/`` at the
repository root, named by the hash of the source, every header of csrc/
and the flags. ``load`` builds at the first load of any library, opens
one through ``ctypes`` with its wrapper's signatures and cross-checks the
constants the wrapper mirrors. ``check``, ``check_aligned`` and
``raise_on`` are the argument checks and error report every wrapper uses.
A new kernel is one ``.cu`` file (exporting ``f3dgs_error_string`` and its
entry points ``extern "C"``), one row of ``SOURCES`` and one wrapper.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = {"raster_forward": _CSRC / "raster_forward.cu",
           "raster_backward": _CSRC / "raster_backward.cu",
           "adam": _CSRC / "adam.cu",
           "preprocess": _CSRC / "preprocess.cu",
           "resize": _CSRC / "resize.cu",
           "segment": _CSRC / "segment.cu"}
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
BUILD_LOG: str = ""

_libs: dict = {}
_lock = threading.Lock()


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and Path(cand, "bin", "nvcc").exists():
            return str(Path(cand, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _library_path(name: str) -> Path:
    """Where the library of source ``name`` lands: its tag hashes the
    source, every header of csrc/ and the flags, so editing a shared header
    rebuilds every kernel."""
    h = hashlib.sha256(SOURCES[name].read_bytes())
    for header in sorted(_CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}_{h.hexdigest()[:16]}.so"


def build() -> dict:
    """Compile every kernel library not built yet, one ``nvcc`` per source,
    all started together; returns {name: library path}. The ptxas reports
    (registers, spills) land in ``BUILD_LOG`` and beside each library."""
    global BUILD_LOG
    paths = {name: _library_path(name) for name in SOURCES}
    todo = [name for name, lib_path in paths.items() if not lib_path.exists()]
    procs = {}
    if todo:
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for name in todo:
        tmp = paths[name].with_name(f"{paths[name].stem}.{os.getpid()}.tmp.so")
        procs[name] = (tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {SOURCES[name]}:\n{log}")
            continue
        paths[name].with_suffix(".log").write_text(log)
        os.replace(tmp, paths[name])
    if failed:
        raise RuntimeError("\n".join(failed))
    BUILD_LOG = "".join(
        f"[{name}]\n" + (p.with_suffix(".log").read_text()
                         if p.with_suffix(".log").exists() else "")
        for name, p in paths.items())
    return paths


def load(name: str, signatures: dict, constants: dict):
    """The library of source ``name``, built (``build``) and opened once:
    each symbol of ``signatures`` ({symbol: (argtypes, restype)}) declared,
    and ``f3dgs_error_string`` beside them; each function of ``constants``
    ({symbol: expected value}, declared in ``signatures``) called and held
    to its value, so a wrapper's mirror of a constant of the source cannot
    drift from it. Later calls return the same handle."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build()[name]))
            for symbol, (argtypes, restype) in signatures.items():
                fn = getattr(lib, symbol)
                fn.argtypes, fn.restype = argtypes, restype
            lib.f3dgs_error_string.argtypes = [ctypes.c_int]
            lib.f3dgs_error_string.restype = ctypes.c_char_p
            for symbol, want in constants.items():
                got = getattr(lib, symbol)()
                if got != want:
                    raise RuntimeError(f"library {name}: {symbol}() returns "
                                       f"{got}, its wrapper expects {want}")
            _libs[name] = lib
    return lib


def check(name: str, x: torch.Tensor, dtype: torch.dtype, shape: tuple,
          device: torch.device):
    """Raise unless ``x`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``."""
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise ValueError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {shape}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_aligned(name: str, x: torch.Tensor):
    """Raise unless a non-empty ``x`` starts on a 16-byte boundary (the
    kernels read it as float4)."""
    if x.numel() and x.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary")


def raise_on(lib, name: str, err: int):
    """Raise with the library's message when a call of kernel ``name``
    returned a CUDA error code other than 0."""
    if err != 0:
        raise RuntimeError(f"{name} launch failed: "
                           + lib.f3dgs_error_string(err).decode())

"""ctypes loader of the native host helpers (``native/src/f3dgs_native.cc``).

Port of ``feature3dgs_tpu/native/loader.py``. The library is built at first
use with ``$CXX`` (default ``g++``) and the JAX package's Makefile flags into
``build/native/``, under a name that hashes the source, the compiler, the
flags, ``platform.machine()`` and the compiler's predefined macros under
those flags: ``-march=native`` code suits only the instruction set that built
it, and the macros name that set. Concurrent first users (test workers,
several ranks) take a file lock, so one of them compiles, into a temporary
file renamed into place. A failed build or load raises with the compiler's
log; there is no fallback route.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "src" / "f3dgs_native.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
# feature3dgs_tpu/native/Makefile's CXXFLAGS
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall")

_lib = None
_lock = threading.Lock()


def _compiler() -> str:
    return os.environ.get("CXX") or "g++"


def _run(cmd: list, what: str) -> str:
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              stdin=subprocess.DEVNULL, timeout=300)
    except OSError as e:
        raise RuntimeError(f"{what}: cannot run {cmd[0]!r}: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"{what} failed ({' '.join(cmd)}), exit "
                           f"{proc.returncode}:\n{proc.stdout}{proc.stderr}")
    return proc.stdout


def library_path() -> Path:
    """Where the library for this source, compiler, flags and CPU lands."""
    cxx = _compiler()
    macros = _run([cxx, *CXXFLAGS, "-x", "c++", "-E", "-dM", "-"],
                  "asking the C++ compiler for its target")
    h = hashlib.sha256(SOURCE.read_bytes())
    for part in (cxx, " ".join(CXXFLAGS), platform.machine(), macros):
        h.update(part.encode() + b"\0")
    return BUILD_DIR / f"libf3dgs_native_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless it exists; returns its path."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(path.with_suffix(".lock"), "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)      # released when the file closes
        if not path.exists():
            tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
            try:
                _run([_compiler(), *CXXFLAGS, "-shared", "-o", str(tmp),
                      str(SOURCE)], f"building {SOURCE.name}")
                os.replace(tmp, path)
            finally:
                tmp.unlink(missing_ok=True)
    return path


def load() -> ctypes.CDLL:
    """The loaded library, built first if needed (once a process)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            f32p = ctypes.POINTER(ctypes.c_float)
            f64p = ctypes.POINTER(ctypes.c_double)
            u8p = ctypes.POINTER(ctypes.c_uint8)
            lib.knn_mean_sq_dist.argtypes = [f32p, ctypes.c_int64, f32p]
            lib.knn_mean_sq_dist.restype = ctypes.c_int
            lib.colmap_scan_points3d.argtypes = [
                u8p, ctypes.c_int64, ctypes.c_int64, f64p, u8p, f64p]
            lib.colmap_scan_points3d.restype = ctypes.c_int
            _lib = lib
    return _lib


def knn_mean_sq_dist(points: np.ndarray) -> np.ndarray:
    """[N,3] -> [N] float32 mean squared distance to the 3 nearest
    neighbours (grid search; 1e-6 for a lone point)."""
    pts = np.ascontiguousarray(points, np.float32)
    if pts.ndim != 2 or pts.shape[1] != 3:
        raise ValueError(f"points must be [N, 3], got {pts.shape}")
    out = np.empty(pts.shape[0], np.float32)
    rc = load().knn_mean_sq_dist(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), pts.shape[0],
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if rc != 0:
        raise RuntimeError(f"native knn_mean_sq_dist returned {rc}")
    return out


def colmap_scan_points3d(data: bytes, n: int):
    """Fields of the ``n`` records of a points3D.bin's bytes ``data``
    (header included): (xyz [n,3] f64, rgb [n,3] u8, error [n] f64).
    Raises on a truncated file."""
    buf = np.frombuffer(data, np.uint8)
    if not 0 <= n <= (buf.size - 8) // 51:      # a record is >= 51 bytes
        raise RuntimeError(f"points3D.bin of {buf.size} bytes cannot hold "
                           f"the {n} records its header counts (truncated "
                           "file?)")
    xyz = np.empty((n, 3), np.float64)
    rgb = np.empty((n, 3), np.uint8)
    err = np.empty(n, np.float64)
    rc = load().colmap_scan_points3d(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), buf.size, n,
        xyz.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        err.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    if rc != 0:
        raise RuntimeError(f"points3D.bin holds fewer than the {n} records "
                           "its header counts (truncated file?)")
    return xyz, rgb, err

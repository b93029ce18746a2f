"""Forward compositing on the card: the wrapper of ops/csrc/raster_forward.cu.

The kernel replaces ``feature3dgs_tpu/ops/pallas_raster.py:_fwd_kernel``.
It is compiled with ``nvcc`` for ``sm_90a`` into a shared library with a
plain C interface at first use, from the sources in this package, into
``build/kernels/`` at the repository root (cached by source hash), and
called through ``ctypes`` on PyTorch's current stream.

``raster_forward_cuda`` launches the kernel on CUDA tensors and raises on
anything else; ``ops.rasterize`` runs the plain version
(``ops.composite.composite_plain``) for CPU tensors. ``FORWARD_LAUNCHES``
counts kernel launches.
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

from feature3dgs_tpu_torch.ops.binning import TileGrid
from feature3dgs_tpu_torch.ops.composite import CompositeOutput

# list entries the kernel stages per step (CHUNK in raster_forward.cu)
KERNEL_CHUNK = 32
# launches of the forward kernel since import (or since a caller reset it)
FORWARD_LAUNCHES = 0

_SRC = Path(__file__).resolve().parent / "csrc" / "raster_forward.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# the largest dynamic shared memory a Hopper block may use
MAX_SMEM_BYTES = 232448

_lib = None
_lib_lock = threading.Lock()
BUILD_LOG: str = ""


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and Path(cand, "bin", "nvcc").exists():
            return str(Path(cand, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def build() -> Path:
    """Compile the kernel library if this source has not been built yet;
    returns its path. The ptxas report (registers, spills) lands in
    ``BUILD_LOG`` and beside the library."""
    global BUILD_LOG
    src = _SRC.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib_path = BUILD_DIR / f"raster_forward_{tag}.so"
    log_path = lib_path.with_suffix(".log")
    if lib_path.exists():
        BUILD_LOG = log_path.read_text() if log_path.exists() else ""
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_name(f"{lib_path.stem}.{os.getpid()}.tmp.so")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_SRC)],
                          capture_output=True, text=True)
    BUILD_LOG = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {_SRC}:\n{BUILD_LOG}")
    log_path.write_text(BUILD_LOG)
    os.replace(tmp, lib_path)
    return lib_path


def _library():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.f3dgs_raster_forward.argtypes = [p] * 9 + [i] * 7 + [p] * 6
            lib.f3dgs_raster_forward.restype = i
            lib.f3dgs_raster_forward_chunk.argtypes = []
            lib.f3dgs_raster_forward_chunk.restype = i
            lib.f3dgs_raster_forward_smem_bytes.argtypes = [i, i]
            lib.f3dgs_raster_forward_smem_bytes.restype = ctypes.c_size_t
            lib.f3dgs_error_string.argtypes = [i]
            lib.f3dgs_error_string.restype = ctypes.c_char_p
            if lib.f3dgs_raster_forward_chunk() != KERNEL_CHUNK:
                raise RuntimeError("KERNEL_CHUNK disagrees with the kernel")
            _lib = lib
    return _lib


def _check(name: str, x: torch.Tensor, dtype: torch.dtype, shape: tuple,
           device: torch.device):
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise ValueError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {shape}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_tile_lists(gid_sorted: torch.Tensor, tile_starts: torch.Tensor,
                     tile_counts: torch.Tensor, n_gauss: int):
    """Raise unless every tile's list ``[start, start + count)`` lies in
    ``gid_sorted`` and every id in it names one of ``n_gauss`` Gaussians.
    The kernel trusts these ranges; one host sync reads the verdict."""
    n_inst = gid_sorted.shape[0]
    # start > n_inst - count, not start + count > n_inst: no int32 overflow
    bad = ((tile_starts < 0) | (tile_counts < 0)
           | (tile_starts > n_inst - tile_counts)).any()
    if n_inst:
        lo, hi = torch.aminmax(gid_sorted)
        bad = bad | (lo < 0) | (hi >= n_gauss)
    if bool(bad):
        raise ValueError(
            "tile lists out of range: each [tile_start, tile_start + "
            f"tile_count) must lie in the {gid_sorted.shape[0]} entries of "
            f"gid_sorted, and each id in [0, {n_gauss})")


def raster_forward_cuda(xy, conic, opacity, rgb, depth, feat, gid_sorted,
                        tile_starts, tile_counts, grid: TileGrid, *,
                        tile_base: int = 0) -> CompositeOutput:
    """Composite every tile with the forward kernel. Per-Gaussian inputs
    xy [N,2], conic [N,3], opacity [N], rgb [N,3], depth [N], feat [N,F]
    f32; gid_sorted [L], tile_starts/tile_counts [T] int32, all contiguous
    CUDA tensors (anything else raises). Outputs are in tile layout
    ([T, P, ...]); tile t is global tile ``tile_base + t``."""
    global FORWARD_LAUNCHES
    dev = xy.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {dev}")
    n = xy.shape[0]
    f_dim = feat.shape[-1] if feat.dim() == 2 else -1
    n_tiles = tile_starts.shape[0]
    f32, i32 = torch.float32, torch.int32
    _check("xy", xy, f32, (n, 2), dev)
    _check("conic", conic, f32, (n, 3), dev)
    _check("opacity", opacity, f32, (n,), dev)
    _check("rgb", rgb, f32, (n, 3), dev)
    _check("depth", depth, f32, (n,), dev)
    _check("feat", feat, f32, (n, f_dim), dev)
    _check("gid_sorted", gid_sorted, i32, (gid_sorted.shape[0],), dev)
    _check("tile_starts", tile_starts, i32, (n_tiles,), dev)
    _check("tile_counts", tile_counts, i32, (n_tiles,), dev)
    p = grid.pixels_per_tile
    if p > 1024 or p % 4:
        raise ValueError(f"tile of {p} pixels: the kernel needs a multiple "
                         "of 4 pixels, at most 1024")
    lib = _library()
    smem = lib.f3dgs_raster_forward_smem_bytes(p, f_dim)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"{f_dim} feature channels at {p}-pixel tiles need "
                         f"{smem} bytes of shared memory (> {MAX_SMEM_BYTES})")
    if max(n, gid_sorted.shape[0], n_tiles * p * max(f_dim, 3)) >= 2 ** 31:
        raise ValueError("sizes exceed the kernel's 32-bit indexing")
    check_tile_lists(gid_sorted, tile_starts, tile_counts, n)

    color = torch.empty((n_tiles, p, 3), dtype=f32, device=dev)
    feature = torch.empty((n_tiles, p, f_dim), dtype=f32, device=dev)
    depth_out = torch.empty((n_tiles, p), dtype=f32, device=dev)
    final_t = torch.empty((n_tiles, p), dtype=f32, device=dev)
    n_contrib = torch.empty((n_tiles, p), dtype=i32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.f3dgs_raster_forward(
            xy.data_ptr(), conic.data_ptr(), opacity.data_ptr(),
            rgb.data_ptr(), depth.data_ptr(), feat.data_ptr(),
            gid_sorted.data_ptr(), tile_starts.data_ptr(),
            tile_counts.data_ptr(), n_tiles, tile_base, grid.grid_x,
            grid.grid_y, grid.tile_w, grid.tile_h, f_dim, color.data_ptr(), feature.data_ptr(), depth_out.data_ptr(),
            final_t.data_ptr(), n_contrib.data_ptr(), stream)
    if err != 0:
        raise RuntimeError("raster_forward launch failed: "
                           + lib.f3dgs_error_string(err).decode())
    if n_tiles:
        FORWARD_LAUNCHES += 1
    return CompositeOutput(color, feature, depth_out, final_t, n_contrib)

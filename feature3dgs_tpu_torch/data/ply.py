"""Minimal binary-little-endian PLY codec (numpy structured arrays).

A copy of ``feature3dgs_tpu/data/ply.py`` (numpy only, no ``plyfile``
dependency): the subset of PLY needed for (a) Gaussian scene snapshots with
the exact field schema of the original code (scene/gaussian_model.py:192-229: x y z,
nx ny nz, f_dc_*, f_rest_*, opacity, scale_*, rot_*, semantic_*) so
checkpoints interoperate with reference tooling/viewers, and (b) COLMAP
points3D.ply-style inputs (positions + uchar colors).
"""
from __future__ import annotations

import io
import os
from typing import Mapping

import numpy as np

_PLY_TO_NP = {
    "float": "<f4", "float32": "<f4", "double": "<f8", "float64": "<f8",
    "int": "<i4", "int32": "<i4", "uint": "<u4", "uint32": "<u4",
    "short": "<i2", "int16": "<i2", "ushort": "<u2", "uint16": "<u2",
    "char": "i1", "int8": "i1", "uchar": "u1", "uint8": "u1",
}
_NP_TO_PLY = {
    np.dtype("<f4"): "float", np.dtype("<f8"): "double",
    np.dtype("<i4"): "int", np.dtype("<u4"): "uint",
    np.dtype("<i2"): "short", np.dtype("<u2"): "ushort",
    np.dtype("i1"): "char", np.dtype("u1"): "uchar",
}


def write_ply(path: str, fields: Mapping[str, np.ndarray], element: str = "vertex"):
    """Write named 1-D columns (all same length) as one PLY element."""
    names = list(fields)
    n = len(next(iter(fields.values())))
    dtype = np.dtype([(name, np.asarray(fields[name]).dtype.newbyteorder("<"))
                      for name in names])
    rec = np.empty(n, dtype=dtype)
    for name in names:
        col = np.asarray(fields[name])
        if col.shape != (n,):
            raise ValueError(f"field {name} must be 1-D of length {n}, got {col.shape}")
        rec[name] = col
    header = ["ply", "format binary_little_endian 1.0", f"element {element} {n}"]
    for name in names:
        header.append(f"property {_NP_TO_PLY[rec.dtype[name]]} {name}")
    header.append("end_header\n")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write("\n".join(header).encode("ascii"))
        f.write(rec.tobytes())


def read_ply(path: str, element: str = "vertex") -> dict[str, np.ndarray]:
    """Read one element of a binary/ascii PLY into a dict of 1-D arrays.

    List properties are not supported (not used by the Gaussian schema)."""
    with open(path, "rb") as f:
        data = f.read()
    header_end = data.find(b"end_header")
    if header_end < 0:
        raise ValueError(f"{path}: not a PLY file")
    header_end = data.find(b"\n", header_end) + 1
    lines = data[:header_end].decode("ascii", "replace").splitlines()
    fmt = None
    elements = []  # (name, count, [(prop_name, np_dtype)])
    for ln in lines:
        parts = ln.strip().split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append((parts[1], int(parts[2]), []))
        elif parts[0] == "property":
            if parts[1] == "list":
                raise ValueError(f"{path}: list properties unsupported")
            elements[-1][2].append((parts[2], _PLY_TO_NP[parts[1]]))

    offset = header_end
    for name, count, props in elements:
        if fmt == "ascii":
            body = data[header_end:].decode("ascii")
            table = np.loadtxt(io.StringIO(body), max_rows=count, ndmin=2)
            if name == element:
                return {p: table[:, i].astype(np.dtype(d))
                        for i, (p, d) in enumerate(props)}
            continue
        dt = np.dtype([(p, d) for p, d in props])
        if fmt == "binary_big_endian":
            dt = dt.newbyteorder(">")
        nbytes = dt.itemsize * count
        if name == element:
            rec = np.frombuffer(data, dtype=dt, count=count, offset=offset)
            return {p: np.ascontiguousarray(rec[p]) for p, _ in props}
        offset += nbytes
    raise KeyError(f"{path}: element {element!r} not found")

"""Bytes and operations the compositing kernels need, each input read once
and each output written once, frozen from ``chip_smoke.py:257-262`` (the
operation counts per pair) and ``chip_smoke.py:381-416`` (``forward_bound``,
``backward_bound``, ``bound_fields``).

``stats`` holds the work counted by the reference's own binning and blending
of the same inputs (``port_bench/reference/render.py:_count``): "tested"
(entry, pixel) pairs a pixel examines while live, "contributing" pairs,
"walked" pairs up to each pixel's last contributor, the list entries
"entries_tested" / "entries_walked" some pixel reaches, and [N] bool masks
"tested_gaussians", "walked_gaussians", "contributing_gaussians".
"""
from port_bench.yardstick.peaks import PEAK_BYTES, PEAK_F32_FLOPS

# operations per (list entry, pixel) pair: alpha and its tests (~15), and
# for a contributing pair T, the weight and RGB+depth (~16) plus 2F
OPS_TESTED, OPS_CONTRIB = 15, 16
# the backward: alpha and its tests per walked pair (~15); per counting
# pair T, u, dL/dalpha, the suffix and the ten row terms (~50) plus 2F
OPS_BWD_WALKED, OPS_BWD_CONTRIB = 15, 50


def forward_bound(stats, n_tiles, p, f_dim):
    """(bytes, operations) of the forward: x, y, conic, opacity of the
    Gaussians some pixel tests; rgb, depth, features of those that
    contribute; the list entries tested, the tiles' starts and counts;
    color, depth, final_T, n_contrib and the features of every pixel."""
    n_tested = int(stats["tested_gaussians"].sum())
    n_contributing = int(stats["contributing_gaussians"].sum())
    n_bytes = 4 * (6 * n_tested + (4 + f_dim) * n_contributing
                   + stats["entries_tested"] + 2 * n_tiles
                   + n_tiles * p * (f_dim + 6))
    ops = (OPS_TESTED * stats["tested"]
           + (OPS_CONTRIB + 2 * f_dim) * stats["contributing"])
    return n_bytes, ops


def backward_bound(stats, n_tiles, p, n_inst, f_dim):
    """The same for the backward: the pixel cotangents, final_T and
    n_contrib; x, y, conic, opacity of the Gaussians some walk reaches, rgb
    and depth of those that count; the walked list ids, the tiles' starts
    and counts; one row per entry."""
    n_walked = int(stats["walked_gaussians"].sum())
    n_contributing = int(stats["contributing_gaussians"].sum())
    n_bytes = 4 * (n_tiles * p * (f_dim + 7) + 6 * n_walked
                   + 4 * n_contributing + stats["entries_walked"]
                   + 2 * n_tiles + n_inst * (10 + f_dim))
    ops = (OPS_BWD_WALKED * stats["walked"]
           + (OPS_BWD_CONTRIB + 2 * f_dim) * stats["contributing"])
    return n_bytes, ops


def bound_seconds(n_bytes, ops) -> tuple:
    """(least seconds the card could take, "bytes" or "operations": which
    of the two bounds it)."""
    by_bytes, by_ops = n_bytes / PEAK_BYTES, ops / PEAK_F32_FLOPS
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations")

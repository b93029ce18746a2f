"""Instance expansion on the card: the per-Gaussian table gather and its
tile arithmetic in the script's six layouts, and the port's own expansion
with and without its blocking host read. The port of
``scripts/micro_expand.py``.

    python -m feature3dgs_tpu_torch.cli.micro_expand [--l 524288]
        [--n 100000] [--grid_x 76] [--iters 10] [--device cpu]

The inputs are the script's numpy draws in its order (``build_inputs``):
per-Gaussian rects of 1-12 tiles a side, the owner of each of ``l`` slots
(``gid``), and the [n, 5] and [n, 4] tables of instance offsets, widths,
corners and depths that the variants gather. ``v0_current`` to ``v5_gather2d`` are
the script's, with its float arithmetic from slot to tile (``tail_math``);
on the card most differ from ``v0_current`` only by a view (a reshape or a
transpose of the gathered rows), which eager PyTorch does not copy. They
must agree bit for bit, as in the script.

Two rows are the port's, from the same draws (rects ``(x0, y0)`` to
``(x0 + w, y0 + h)``, all valid, a grid ``grid_x`` wide and 48 tall,
capacity ``l``): ``port_expand`` is ``ops/binning.py:expand_instances`` as
it stands, whose ``repeat_interleave`` without ``output_size`` reads its
length on the host and blocks; ``port_expand_sized`` is a form with no host
read (``expand_sized``). The port drops a Gaussian whose instances do not
all fit, where the script cuts at slot ``l``: both rows must give the same
(row, tile) bit for bit on the slots the port keeps, and there the tile
must equal ``v0_current``'s tile key.

Each variant is timed as a CUDA-event span of a synchronised call, median
of ``--iters`` (``bench_utils.profiled_step_ms``). The first line names the
card and its power limit; then one line a variant, the script's (name, ms,
slots, platform) and its bytes bound: its inputs read once (the table rows
the slots use) and its outputs written once, at ``bench_utils.PEAK_BYTES``.
"""
from __future__ import annotations

import sys
from argparse import ArgumentParser
from typing import NamedTuple

import numpy as np
import torch

from feature3dgs_tpu_torch.ops.binning import TileGrid, expand_instances

GRID_Y = 48
NUM_TILES = 76 * 38     # the script's tile count of a sentinel key


def build_parser() -> ArgumentParser:
    ap = ArgumentParser(description="Instance-expansion gather layouts "
                        "(PyTorch port of scripts/micro_expand.py)")
    ap.add_argument("--l", type=int, default=524_288)
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--grid_x", type=int, default=76)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap


class ExpandInputs(NamedTuple):
    w: np.ndarray           # [n] rect widths in tiles
    h: np.ndarray           # [n] rect heights
    x0: np.ndarray          # [n] rect's first tile column
    y0: np.ndarray          # [n] rect's first tile row
    fit_total: int          # slots that hold an instance, at most l
    gid: np.ndarray         # [l] int32 owner of each slot
    table: np.ndarray       # [n, 5] float32 offset, width, x0, y0, depth
    table4: np.ndarray      # [n, 4] float32 offset, width, y0 * gx + x0, depth


def build_inputs(l: int, n: int, grid_x: int) -> ExpandInputs:
    """The script's arrays, drawn from RandomState(0) in its order
    (scripts/micro_expand.py:36-62)."""
    if l % 1024:
        raise ValueError(f"--l must be a multiple of 1024, got {l}")
    rng = np.random.RandomState(0)
    w = rng.randint(1, 13, size=n)
    h = rng.randint(1, 13, size=n)
    x0 = rng.randint(0, grid_x - 12, size=n)
    y0 = rng.randint(0, 36, size=n)
    areas = w * h
    offsets = np.cumsum(areas) - areas
    depth = (rng.rand(n) * 10 + 0.3).astype(np.float32)
    fit_total = int(min(l, offsets[-1] + areas[-1]))
    gid = np.maximum(np.minimum(
        np.searchsorted(offsets, np.arange(l), "right") - 1, n - 1), 0
    ).astype(np.int32)
    table = np.stack([
        offsets.astype(np.float32), np.maximum(w, 1).astype(np.float32),
        x0.astype(np.float32), y0.astype(np.float32), depth], axis=1)
    table4 = np.stack([
        offsets.astype(np.float32), np.maximum(w, 1).astype(np.float32),
        (y0 * grid_x + x0).astype(np.float32), depth], axis=1)
    return ExpandInputs(w, h, x0, y0, fit_total, gid, table, table4)


def script_variants(x: ExpandInputs, grid_x: int, device) -> dict:
    """name -> fn(gid) of the script's six layouts, each returning
    (tile_key [l] int32, depth_key [l] float32)."""
    gx = grid_x
    table = torch.from_numpy(x.table).to(device)
    table4 = torch.from_numpy(x.table4).to(device)
    l = x.gid.shape[0]
    slots = torch.arange(l, dtype=torch.int32, device=device)
    r_rows = l // 128
    slot_2d = slots.to(torch.float32).reshape(r_rows, 128)
    valid_2d = slots.reshape(r_rows, 128) < x.fit_total

    def tail_math(slot_f, off_f, w_f, base_f, d_f, valid):
        local = slot_f - off_f
        q = torch.floor(local * (1.0 / w_f))
        r = local - q * w_f
        q = q + torch.where(r >= w_f, 1.0, 0.0) - torch.where(r < 0.0, 1.0,
                                                              0.0)
        r = local - q * w_f
        tile = (base_f + q * gx + r).to(torch.int32)
        tile_key = torch.where(valid, tile, NUM_TILES)
        depth_key = torch.where(valid, d_f, float("inf"))
        return tile_key, depth_key

    def flat(tk, dk):
        return tk.reshape(-1), dk.reshape(-1)

    def v0_current(gid):
        g = table[gid]                              # [L,5]
        base = g[:, 3] * gx + g[:, 2]
        return tail_math(slots.to(torch.float32), g[:, 0], g[:, 1], base,
                         g[:, 4], slots < x.fit_total)

    def v1_reshape_cols(gid):
        g = table[gid]
        cols = [g[:, k].reshape(r_rows, 128) for k in range(5)]
        base = cols[3] * gx + cols[2]
        return flat(*tail_math(slot_2d, cols[0], cols[1], base, cols[4],
                               valid_2d))

    def v2_transpose(gid):
        g = table[gid].T                            # [5, L]
        cols = [g[k].reshape(r_rows, 128) for k in range(5)]
        base = cols[3] * gx + cols[2]
        return flat(*tail_math(slot_2d, cols[0], cols[1], base, cols[4],
                               valid_2d))

    def v3_reshape3d(gid):
        g = table[gid].reshape(r_rows, 128, 5)
        cols = [g[:, :, k] for k in range(5)]
        base = cols[3] * gx + cols[2]
        return flat(*tail_math(slot_2d, cols[0], cols[1], base, cols[4],
                               valid_2d))

    def v4_packed4(gid):
        g = table4[gid]
        cols = [g[:, k].reshape(r_rows, 128) for k in range(4)]
        return flat(*tail_math(slot_2d, cols[0], cols[1], cols[2], cols[3],
                               valid_2d))

    def v5_gather2d(gid):
        g = table[gid.reshape(r_rows, 128)]         # [R,128,5]
        cols = [g[:, :, k] for k in range(5)]
        base = cols[3] * gx + cols[2]
        return flat(*tail_math(slot_2d, cols[0], cols[1], base, cols[4],
                               valid_2d))

    return {f.__name__: f for f in (v0_current, v1_reshape_cols,
                                    v2_transpose, v3_reshape3d, v4_packed4,
                                    v5_gather2d)}


def port_rects(x: ExpandInputs, grid_x: int, device):
    """(rect_min [n,2], rect_max [n,2] int32, valid [n], TileGrid) of the
    script's rects on a grid ``grid_x`` x GRID_Y of 1-pixel tiles."""
    lo = np.stack([x.x0, x.y0], 1).astype(np.int32)
    hi = np.stack([x.x0 + x.w, x.y0 + x.h], 1).astype(np.int32)
    return (torch.from_numpy(lo).to(device), torch.from_numpy(hi).to(device),
            torch.ones(lo.shape[0], dtype=torch.bool, device=device),
            TileGrid(grid_x, GRID_Y, 1, 1))


def port_expand(rect_min, rect_max, valid, grid: TileGrid, capacity: int):
    """``ops/binning.py:expand_instances`` of one camera: (row, tile) of
    the kept instances, whose count the host reads."""
    row, tile, _, _ = expand_instances(rect_min[None], rect_max[None],
                                       valid[None], grid,
                                       instance_capacity=capacity)
    return row, tile


def expand_sized(rect_min, rect_max, valid, grid: TileGrid, capacity: int):
    """The same expansion with no host read: ``capacity`` slots, each of
    which finds its Gaussian by a search of the kept areas' inclusive sums
    (as the script builds ``gid``). A slot past the kept instances gets row
    n and tile ``grid.num_tiles``. Returns (row, tile) [capacity] int64."""
    n = valid.shape[0]
    widths = (rect_max[:, 0] - rect_min[:, 0]).long()
    heights = (rect_max[:, 1] - rect_min[:, 1]).long()
    areas = torch.where(valid, widths * heights, torch.zeros_like(widths))
    kept = torch.where(torch.cumsum(areas, 0) <= capacity, areas,
                       torch.zeros_like(areas))
    incl = torch.cumsum(kept, 0)
    slot = torch.arange(capacity, device=valid.device)
    row = torch.searchsorted(incl, slot, right=True)
    g = row.clamp_max(n - 1)
    local = slot - (incl - kept)[g]
    w_g = widths[g].clamp_min(1)
    tile = ((rect_min[g, 1].long() + local // w_g) * grid.grid_x
            + rect_min[g, 0].long() + local % w_g)
    return row, torch.where(row < n, tile, grid.num_tiles)


def check_agreement(outs: dict, n: int, num_tiles: int) -> None:
    """The script's check (every layout bit-equal to ``v0_current``) and
    the port's: both expansions equal on the slots the port keeps, the
    sized one's other slots empty (row n, tile ``num_tiles``), and the kept
    tiles ``v0_current``'s tile keys."""
    ref_tk, ref_dk = outs["v0_current"]
    for name, (tk, dk) in outs.items():
        if name.startswith("v"):
            np.testing.assert_array_equal(tk, ref_tk, err_msg=name)
            np.testing.assert_array_equal(dk, ref_dk, err_msg=name)
    row, tile = outs["port_expand"]
    row_s, tile_s = outs["port_expand_sized"]
    k = row.shape[0]
    np.testing.assert_array_equal(row_s[:k], row, err_msg="row")
    np.testing.assert_array_equal(tile_s[:k], tile, err_msg="tile")
    np.testing.assert_array_equal(row_s[k:], n, err_msg="empty rows")
    np.testing.assert_array_equal(tile_s[k:], num_tiles, err_msg="empty")
    np.testing.assert_array_equal(tile, ref_tk[:k], err_msg="tile vs v0")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from feature3dgs_tpu_torch import default_device
    from feature3dgs_tpu_torch.bench_utils import (bytes_bound_ms,
                                                   device_label, platform,
                                                   profiled_step_ms)
    dev = default_device(args.device)
    print(device_label(dev), flush=True)
    l, n, gx = args.l, args.n, args.grid_x
    x = build_inputs(l, n, gx)
    gid = torch.from_numpy(x.gid).to(dev)
    rects = port_rects(x, gx, dev)
    runs = {name: (fn, (gid,))
            for name, fn in script_variants(x, gx, dev).items()}
    runs["port_expand"] = (port_expand, rects + (l,))
    runs["port_expand_sized"] = (expand_sized, rects + (l,))
    outs = {name: tuple(t.cpu().numpy() for t in fn(*a))
            for name, (fn, a) in runs.items()}
    check_agreement(outs, n, rects[3].num_tiles)
    # bytes: gid and the table rows the slots use read, two [l] keys
    # written; the rects (two int32 pairs and a bool a Gaussian) read and
    # (row, tile) int64 written for each kept or each of l slots
    used = int(x.gid.max()) + 1
    n_bytes = {name: 4 * (3 * l + (4 if name == "v4_packed4" else 5) * used)
               for name in runs}
    n_bytes["port_expand"] = 17 * n + 16 * outs["port_expand"][0].shape[0]
    n_bytes["port_expand_sized"] = 17 * n + 16 * l
    for name, (fn, a) in runs.items():
        ms = profiled_step_ms(lambda: fn(*a), n=args.iters, device=dev)
        print(f"{name:18s} {ms:8.4f} ms   [{l} slots, {platform(dev)}]   "
              f"bound {bytes_bound_ms(n_bytes[name]):.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The segment-sum (``ops/segment.py:SegmentPlan``) on the CPU: the
kernel's wrapper refuses what it cannot take, its team plan follows the
row width and alignment, and CPU rows (with or without a rider) take the
plain path, counted.

The kernel itself runs on the card only (tests/test_torch_segment_cuda.py);
the plain path's agreement with a float64 sum is
``test_segment_sum_is_the_per_gaussian_sum_and_deterministic`` in
tests/test_torch_backward.py.
"""
import numpy as np
import pytest
import torch

from feature3dgs_tpu_torch import tracing
from feature3dgs_tpu_torch.ops import cuda_segment, segment
from feature3dgs_tpu_torch.ops.segment import SegmentPlan

L, N, C = 60, 9, 8


def _plan_inputs(seed=0, l=L, n=N, c=C):
    rng = np.random.RandomState(seed)
    gid = torch.from_numpy(rng.randint(0, n + 2, l).astype(np.int32))
    rows = torch.from_numpy(rng.randn(l, c).astype(np.float32))
    return gid, rows


def _args(kind):
    """(order, bounds, rows, rider) with one argument broken by ``kind``."""
    gid, rows = _plan_inputs()
    plan = SegmentPlan(gid, N)
    order, bounds, rider = plan.order, plan.bounds, rows[:, :3].clone()
    if kind == "rows_dtype":
        rows = rows.double()
    elif kind == "rows_rank":
        rows = rows.reshape(-1)
    elif kind == "rows_layout":
        rows = torch.zeros((C, L)).t()
    elif kind == "rider_length":
        rider = rider[1:]
    elif kind == "rider_dtype":
        rider = rider.double()
    elif kind == "rider_rank":
        rider = rider.reshape(-1)
    elif kind == "rider_layout":
        rider = torch.zeros((3, L)).t()
    elif kind == "rider_device":
        rider = rider.to("meta")
    elif kind == "order_dtype":
        order = order.int()
    elif kind == "order_length":
        order = order[:-1]
    elif kind == "order_layout":
        order = torch.stack([order, order], 1)[:, 0]
    elif kind == "bounds_dtype":
        bounds = bounds.int()
    elif kind == "bounds_rank":
        bounds = bounds[None]
    elif kind == "bounds_empty":
        bounds = bounds[:0]
    elif kind == "bounds_layout":
        bounds = torch.stack([bounds, bounds], 1)[:, 0]
    return order, bounds, rows, rider


@pytest.mark.parametrize("kind,match", [
    ("rows_dtype", "rows has dtype torch.float64"),
    ("rows_rank", r"rows must be \[L, C\]"),
    ("rows_layout", "rows must be contiguous"),
    ("rider_length", r"rider has shape \(59, 3\), expected \(60, 3\)"),
    ("rider_dtype", "rider has dtype torch.float64"),
    ("rider_rank", r"rider must be \[L, C\]"),
    ("rider_layout", "rider must be contiguous"),
    ("rider_device", "rider is on meta, expected cpu"),
    ("order_dtype", "order has dtype torch.int32"),
    ("order_length", "rows has shape"),
    ("order_layout", "order must be contiguous"),
    ("bounds_dtype", "bounds has dtype torch.int32"),
    ("bounds_rank", r"bounds must be \[N \+ 1\]"),
    ("bounds_empty", r"bounds must be \[N \+ 1\]"),
    ("bounds_layout", "bounds must be contiguous"),
    ("cpu", "needs CUDA tensors")])
def test_wrapper_refuses(kind, match):
    with pytest.raises(ValueError, match=match):
        cuda_segment.segment_sum_cuda(*_args(kind))


@pytest.mark.parametrize("channels,vec4,want", [
    (1, False, (1, 1)), (3, False, (4, 1)), (10, False, (16, 1)),
    (4, True, (1, 1)), (64, True, (16, 1)), (128, True, (32, 1)),
    (256, True, (32, 2)), (384, True, (32, 4)), (512, True, (32, 4)),
    (2048, True, (32, 4)), (128, False, (32, 4)), (40, False, (32, 2))])
def test_team_plan_follows_width_and_alignment(channels, vec4, want):
    plan = cuda_segment.team_plan(channels, vec4)
    assert (plan.vec4, (plan.lanes, plan.per_lane)) == (vec4, want)
    nvec = channels // 4 if vec4 else channels
    # a pass covers the row, or a full warp of 4 vectors a lane
    assert min(nvec, 128) <= plan.lanes * plan.per_lane
    assert plan.lanes == 32 or plan.lanes >= nvec


@pytest.mark.parametrize("channels", [0, 6])
def test_team_plan_refuses_what_float4_cannot_read(channels):
    with pytest.raises(ValueError, match="cannot be read as float4"):
        cuda_segment.team_plan(channels, True)


@pytest.mark.parametrize("c,dtype", [(C, torch.float32), (10, torch.float32),
                                     (3, torch.float64), (0, torch.float32)])
def test_cpu_takes_the_plain_path_and_counts_it(monkeypatch, c, dtype):
    """``segment_reduce`` over the rows gathered into plan order, bit for
    bit, zeros for Gaussians with no entry; no kernel wrapper is reached;
    one ``raster.segsum_plain`` a row array."""
    def refuse(*a, **k):
        raise AssertionError("CPU rows reached the kernel wrapper")

    monkeypatch.setattr(segment, "segment_sum_cuda", refuse)
    gid, rows = _plan_inputs(seed=c, c=c)
    rows = rows.to(dtype)
    with tracing.recording() as session:
        plan = SegmentPlan(gid, N)
        got = plan.sum(rows)
        again, narrow = plan.sums(rows, rows[:, :1])
        alone, none = plan.sums(rows)
    ids, order = torch.sort(gid.long(), stable=True)
    lengths = torch.stack([(ids == g).sum() for g in range(N)])
    ref = torch.segment_reduce(rows[order], "sum", lengths=lengths,
                               unsafe=True)
    assert got.dtype == dtype and torch.equal(got, ref)
    assert torch.equal(again, ref) and torch.equal(narrow, ref[:, :1])
    assert torch.equal(alone, ref) and none is None
    assert torch.equal(plan.bounds,
                       torch.cat([lengths.new_zeros(1), lengths.cumsum(0)]))
    empty = lengths == 0
    assert not got[empty].any()
    assert session.summary()["counters"] == {"raster.segsum_plain": 4}


@pytest.mark.parametrize("c,c_rider", [(128, 10), (512, 10), (64, 10),
                                       (16, 10), (10, 0), (0, 10),
                                       (3, 512)])
def test_cpu_sums_a_rider_as_its_own_rows(c, c_rider):
    """``sums(rows, rider)`` on the CPU, at the widths the card sums in one
    launch or two: each the plain sum of its own rows, bit for bit, and two
    ``raster.segsum_plain``."""
    gid, rows = _plan_inputs(seed=c + c_rider, c=c + c_rider)
    rows, rider = rows[:, :c], rows[:, c:]
    plan = SegmentPlan(gid, N)
    with tracing.recording() as session:
        got, got_rider = plan.sums(rows, rider)
    assert torch.equal(got, plan.sum(rows))
    assert torch.equal(got_rider, plan.sum(rider))
    assert got.shape == (N, c) and got_rider.shape == (N, c_rider)
    assert session.summary()["counters"] == {"raster.segsum_plain": 2}


def test_one_cpu_step_counts_two_plain_sums():
    """A CPU training step sums its geometric and feature rows on the plain
    path: two ``raster.segsum_plain`` a step, no fused sum."""
    from feature3dgs_tpu_torch.data.synthetic import synthetic_scene
    from feature3dgs_tpu_torch.ops.rasterize import RasterConfig
    from feature3dgs_tpu_torch.train.trainer import Trainer
    scene = synthetic_scene(n_cams=2, w=64, h=48, n_pts=100, f_dim=8)
    tr = Trainer(scene, rcfg=RasterConfig(tile_w=16, tile_h=16, chunk=16,
                                          instance_capacity=1 << 12),
                 device="cpu")
    tr.step(sync=False)
    with tracing.recording() as session:
        tr.step(sync=False)
        tr.step(sync=True)
    summary = session.summary()
    assert summary["counters"]["raster.segsum_plain"] == 4
    assert "raster.segsum_fused" not in summary["counters"]
    assert summary["spans"]["raster.segment_sum"]["count"] == 2

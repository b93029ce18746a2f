"""The segment-sum kernel (ops/csrc/segment.cu) on the card against the
plain path it replaces.

Needs an NVIDIA GPU with nvcc: marked ``cuda`` and skipped elsewhere. On
the card, run without the JAX-side conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_segment_cuda.py -q

``SegmentPlan.sum`` and ``sums`` on CUDA rows are held bit for bit to ``torch.segment_reduce(rows[order], "sum", lengths=...)`` on the
same tensors, which adds each group's rows to 0 in plan order, as the
kernel does: widths C = 1, 3, 10, 64, 128 and 512, the geometric rows
riding in the feature rows' launch, Gaussians with no entry, dropped ids
(>= N), one Gaussian holding thousands of entries, a ``camera_rows`` plan
over four cameras, and rows that start off a 16-byte boundary (read as
floats). CUDA rows of another dtype raise: the card has no plain path.
"""
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _gen(dev, seed):
    return torch.Generator(device=dev).manual_seed(seed)


def plain(plan, rows):
    return torch.segment_reduce(rows[plan.order], "sum",
                                lengths=plan.bounds.diff(), unsafe=True)


def held(name, got, ref):
    assert got.shape == ref.shape and got.is_contiguous(), name
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32)), name


def ids(dev, l, n, seed, spill=2):
    """[L] int32 ids in [0, n + spill): ids >= n are dropped entries."""
    return torch.randint(0, n + spill, (l,), generator=_gen(dev, seed),
                         device=dev, dtype=torch.int32)


@pytest.mark.parametrize("c", [1, 3, 10, 64, 128, 512])
def test_matches_the_plain_path(dev, c):
    from feature3dgs_tpu_torch.ops import cuda_segment
    from feature3dgs_tpu_torch.ops.segment import SegmentPlan
    n = 5000
    # ids from a range twice N wide: about half the Gaussians have no entry
    gid = ids(dev, 30_000, 2 * n, seed=c)
    rows = torch.randn((30_000, c), generator=_gen(dev, c + 1), device=dev)
    plan = SegmentPlan(gid, n)
    before = cuda_segment.SEGMENT_LAUNCHES
    got = plan.sum(rows)
    assert cuda_segment.SEGMENT_LAUNCHES == before + 1
    held(f"C={c}", got, plain(plan, rows))
    empty = plan.bounds.diff() == 0
    assert bool(empty.any()) and not bool(got[empty].any())


@pytest.mark.parametrize("f,launches", [(16, 2), (64, 1), (128, 1),
                                         (512, 1)])
def test_geometric_rows_ride_with_the_feature_rows(dev, f, launches):
    """``sums(feature, geom)`` as the backward calls it: one launch where the
    feature rows' team has 10 lanes or more, two below; each sum bit-equal
    to the plain path's."""
    from feature3dgs_tpu_torch.ops import cuda_segment
    from feature3dgs_tpu_torch.ops.segment import SegmentPlan
    n, l = 20_000, 110_000
    plan = SegmentPlan(ids(dev, l, n, seed=f), n)
    geom = torch.randn((l, 10), generator=_gen(dev, f + 1), device=dev)
    feat = torch.randn((l, f), generator=_gen(dev, f + 2), device=dev)
    before = cuda_segment.SEGMENT_LAUNCHES
    d_feat, dg = plan.sums(feat, geom)
    assert cuda_segment.SEGMENT_LAUNCHES - before == launches
    held(f"geom beside F={f}", dg, plain(plan, geom))
    held(f"F={f}", d_feat, plain(plan, feat))


@pytest.mark.parametrize("c", [10, 128])
def test_one_gaussian_with_thousands_of_entries(dev, c):
    from feature3dgs_tpu_torch.ops.segment import SegmentPlan
    n, l = 1000, 40_000
    gid = ids(dev, l, n, seed=7, spill=0)
    gid[torch.randperm(l, generator=_gen(dev, 8), device=dev)[:12_000]] = 3
    rows = torch.randn((l, c), generator=_gen(dev, 9), device=dev)
    plan = SegmentPlan(gid, n)
    assert int(plan.bounds[4] - plan.bounds[3]) >= 12_000
    held(f"long C={c}", plan.sum(rows), plain(plan, rows))


def test_camera_rows_plan(dev):
    """The batched backward's geometric plan: rows fold by (camera, id) into
    [B*N]; its feature plan by id into [N]."""
    from feature3dgs_tpu_torch.ops.segment import SegmentPlan, camera_rows
    n, b, tiles = 700, 4, 6
    counts = torch.randint(0, 900, (b * tiles,), generator=_gen(dev, 11),
                           device=dev, dtype=torch.int32)
    gid = ids(dev, int(counts.sum()), n, seed=12, spill=0)
    geom = torch.randn((gid.shape[0], 10), generator=_gen(dev, 13),
                       device=dev)
    feat = torch.randn((gid.shape[0], 128), generator=_gen(dev, 14),
                       device=dev)
    plan = SegmentPlan(camera_rows(gid, counts, n, tiles), b * n)
    held("camera rows", plan.sum(geom), plain(plan, geom))
    by_id = SegmentPlan(gid, n)
    held("camera ids", by_id.sum(feat), plain(by_id, feat))
    # the same rows as one launch takes them when the plans agree
    d_feat, dg = by_id.sums(feat, geom)
    held("camera ids, geom beside", dg, plain(by_id, geom))
    held("camera ids, features beside", d_feat, plain(by_id, feat))


@pytest.mark.parametrize("c", [128, 512])
def test_rows_off_a_16_byte_boundary(dev, c):
    """Rows that start one float past an aligned address take the float
    team (same bits); aligned rows of the same values, float4."""
    from feature3dgs_tpu_torch.ops import cuda_segment
    from feature3dgs_tpu_torch.ops.segment import SegmentPlan
    n, l = 3000, 20_000
    flat = torch.randn(l * c + 1, generator=_gen(dev, c), device=dev)
    rows = flat[1:].view(l, c)
    assert rows.is_contiguous() and rows.data_ptr() % 16 == 4
    plan = SegmentPlan(ids(dev, l, n, seed=c + 5), n)
    got = plan.sum(rows)
    held(f"unaligned C={c}", got, plain(plan, rows))
    held(f"aligned C={c}", plan.sum(rows.clone()), got)
    assert cuda_segment.team_plan(c, False).per_lane == 4


def test_empty_inputs(dev):
    from feature3dgs_tpu_torch.ops import cuda_segment
    from feature3dgs_tpu_torch.ops.segment import SegmentPlan
    gid = ids(dev, 0, 10, seed=0)
    before = cuda_segment.SEGMENT_LAUNCHES
    got = SegmentPlan(gid, 10).sum(torch.zeros((0, 16), device=dev))
    assert got.shape == (10, 16) and not bool(got.any())
    assert cuda_segment.SEGMENT_LAUNCHES == before + 1
    gid = ids(dev, 50, 10, seed=1)
    assert SegmentPlan(gid, 10).sum(torch.zeros((50, 0), device=dev)).shape \
        == (10, 0)
    assert SegmentPlan(gid, 0).sum(torch.ones((50, 4), device=dev)).shape \
        == (0, 4)
    empty, ones = SegmentPlan(gid, 10).sums(torch.zeros((50, 0), device=dev),
                                            torch.ones((50, 4), device=dev))
    assert empty.shape == (10, 0) and ones.shape == (10, 4)
    assert cuda_segment.SEGMENT_LAUNCHES == before + 2


def test_two_runs_bit_equal_and_launches_a_call(dev):
    from feature3dgs_tpu_torch.ops import cuda_segment
    from feature3dgs_tpu_torch.ops.segment import SegmentPlan
    gid = ids(dev, 200_000, 30_000, seed=21)
    rows = torch.randn((200_000, 128), generator=_gen(dev, 22), device=dev)
    geom = torch.randn((200_000, 10), generator=_gen(dev, 23), device=dev)
    runs = []
    for _ in range(2):
        before = cuda_segment.SEGMENT_LAUNCHES
        plan = SegmentPlan(gid, 30_000)
        runs.append((plan.sum(rows), plan.sum(geom), *plan.sums(rows, geom)))
        assert cuda_segment.SEGMENT_LAUNCHES - before == 3
    for a, b in zip(*runs):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert torch.equal(runs[0][2], runs[0][0])
    assert torch.equal(runs[0][3], runs[0][1])
    direct, none = cuda_segment.segment_sum_cuda(plan.order, plan.bounds,
                                                 rows)
    assert torch.equal(direct, runs[0][0]) and none is None


@pytest.mark.parametrize("which", ["rows", "rider"])
def test_other_dtypes_raise_on_the_card(dev, which):
    """CUDA rows go to the kernel whatever their dtype, and its wrapper
    refuses float64: no plain path on the card."""
    from feature3dgs_tpu_torch.ops import cuda_segment
    from feature3dgs_tpu_torch.ops.segment import SegmentPlan
    plan = SegmentPlan(ids(dev, 500, 100, seed=31), 100)
    rows = torch.randn((500, 16), generator=_gen(dev, 32), device=dev)
    rider = rows[:, :4].clone()
    bad = dict(rows=rows, rider=rider)
    bad[which] = bad[which].double()
    before = cuda_segment.SEGMENT_LAUNCHES
    with pytest.raises(ValueError, match=f"{which} has dtype torch.float64"):
        plan.sums(bad["rows"], bad["rider"])
    assert cuda_segment.SEGMENT_LAUNCHES == before


def test_kernel_attributes(dev):
    from feature3dgs_tpu_torch.ops import cuda_segment
    for vec4 in (False, True):
        for per_lane in (1, 2, 4):
            attrs = cuda_segment.kernel_attributes(vec4, per_lane)
            assert attrs["local_bytes"] == 0, (vec4, per_lane, attrs)
            assert attrs["blocks_per_sm"] >= 1 and attrs["registers"] > 0


def test_train_step_counts_fused_sums(dev):
    """A training step on the card at F = 128 sums both row arrays through
    the kernel: two ``raster.segsum_fused`` a step, no plain sum, one
    launch for both."""
    from feature3dgs_tpu_torch import tracing
    from feature3dgs_tpu_torch.data.synthetic import synthetic_scene
    from feature3dgs_tpu_torch.ops import cuda_segment
    from feature3dgs_tpu_torch.ops.rasterize import RasterConfig
    from feature3dgs_tpu_torch.train.trainer import Trainer
    scene = synthetic_scene(n_cams=2, w=64, h=48, n_pts=100, f_dim=128)
    tr = Trainer(scene, rcfg=RasterConfig(tile_w=16, tile_h=16, chunk=16,
                                          instance_capacity=1 << 12),
                 device="cuda")
    tr.step(sync=False)
    before = cuda_segment.SEGMENT_LAUNCHES
    with tracing.recording() as session:
        tr.step(sync=False)
        tr.step(sync=True)
    summary = session.summary()
    assert summary["counters"]["raster.segsum_fused"] == 4
    assert "raster.segsum_plain" not in summary["counters"]
    assert summary["spans"]["raster.segment_sum"]["count"] == 2
    assert cuda_segment.SEGMENT_LAUNCHES - before == 2

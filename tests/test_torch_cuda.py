"""The compositing kernels on the card against their plain versions.

Needs an NVIDIA GPU with nvcc: marked ``cuda`` and skipped elsewhere. On
the card, run without the JAX-side conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Bars as tests/test_pallas.py: forward 1e-5 absolute on color, features and
final_T, 1e-4 on depth, n_contrib exactly; backward 5e-6 on every gradient
group (per-entry rows and per-Gaussian sums) after dividing by the group's
largest magnitude. The alpha_matmul mode has its own, looser contract
(stated at its test), and a densify round on the card equals the same round
on the CPU.
"""
import math

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _inputs(dev, f_dim, tile_w, tile_h, boost, width=64, height=48, seed=1):
    from feature3dgs_tpu_torch.convert import camera_from_numpy
    from feature3dgs_tpu_torch.core import transforms
    from feature3dgs_tpu_torch.ops.rasterize import (RasterConfig,
                                                     composite_inputs)
    rng = np.random.RandomState(seed)
    n = 300
    q = rng.randn(n, 4)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    g = {"means3d": rng.uniform(-1.5, 1.5, (n, 3)),
         "scales": np.exp(rng.uniform(-3.5, -1.5, (n, 3))), "rotations": q,
         "opacities": np.minimum(rng.uniform(0.2, 0.95, n) * boost, 0.999),
         "shs": rng.randn(n, 9, 3) * 0.3, "feat": rng.randn(n, f_dim)}
    g = {k: torch.tensor(v.astype(np.float32), device=dev) for k, v in g.items()}
    view = transforms.world_to_view(np.eye(3), np.array([0.0, 0.0, 4.0]))
    proj = transforms.projection_matrix(0.01, 100.0, 1.0, 0.8) @ view
    cam = camera_from_numpy(view, proj, transforms.camera_center_from_view(
        view).astype(np.float32), math.tan(0.5), math.tan(0.4), width, height,
        dev)
    return composite_inputs(
        g["means3d"], g["opacities"], g["feat"], cam, scales=g["scales"],
        rotations=g["rotations"], shs=g["shs"], sh_degree=2,
        config=RasterConfig(tile_w=tile_w, tile_h=tile_h))


def _check(got, ref):
    for k, tol in (("color", 1e-5), ("feature", 1e-5), ("final_T", 1e-5),
                   ("depth", 1e-4)):
        err = float((getattr(got, k) - getattr(ref, k)).abs().max()) \
            if getattr(got, k).numel() else 0.0
        assert err <= tol, (k, err)
    assert torch.equal(got.n_contrib, ref.n_contrib)


@pytest.mark.parametrize("f_dim,tile_w,tile_h,boost", [
    (4, 16, 16, 3.0), (128, 16, 16, 3.0), (128, 32, 16, 1.0),
    (5, 8, 8, 3.0), (0, 16, 16, 1.0), (512, 32, 16, 3.0),
    (0, 32, 16, 3.0), (3, 16, 16, 3.0), (3, 32, 16, 1.0), (4, 32, 16, 3.0),
    (16, 16, 16, 1.0), (16, 32, 16, 3.0), (128, 32, 16, 3.0),
    (256, 16, 16, 3.0), (256, 32, 16, 1.0), (24, 32, 32, 3.0)])
def test_kernel_matches_plain(dev, f_dim, tile_w, tile_h, boost):
    from feature3dgs_tpu_torch.ops import cuda_raster
    from feature3dgs_tpu_torch.ops.composite import composite_plain
    ci = _inputs(dev, f_dim, tile_w, tile_h, boost)
    before = cuda_raster.FORWARD_LAUNCHES
    got = cuda_raster.raster_forward_cuda(*ci.args)
    assert cuda_raster.FORWARD_LAUNCHES == before + 1
    ref = composite_plain(*ci.args, chunk=16)
    torch.cuda.synchronize()
    _check(got, ref)
    again = cuda_raster.raster_forward_cuda(*ci.args)
    assert torch.equal(again.feature, got.feature)   # deterministic


@pytest.mark.parametrize("f_dim,tile_w", [(8, 16), (128, 32)])
def test_kernel_tile_base_row_wrap(dev, f_dim, tile_w):
    """A slice of tiles offset by tile_base, and a second stacked image
    (tile_base = T), composite image-local pixels like the plain version."""
    from feature3dgs_tpu_torch.ops import cuda_raster
    from feature3dgs_tpu_torch.ops.composite import composite_plain
    ci = _inputs(dev, f_dim, tile_w, 16, 3.0)
    for base in (3, ci.grid.num_tiles):
        got = cuda_raster.raster_forward_cuda(*ci.args, tile_base=base)
        ref = composite_plain(*ci.args, chunk=16, tile_base=base)
        _check(got, ref)
    full = cuda_raster.raster_forward_cuda(*ci.args)
    wrapped = cuda_raster.raster_forward_cuda(*ci.args,
                                              tile_base=ci.grid.num_tiles)
    _check(wrapped, full)


def test_kernel_wrapper_rejects_bad_inputs(dev):
    from feature3dgs_tpu_torch.ops import cuda_raster
    ci = _inputs(dev, 4, 16, 16, 1.0)
    args = list(ci.args)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_raster.raster_forward_cuda(*[a.cpu() if torch.is_tensor(a) else a
                                          for a in args])
    bad = list(args)
    bad[3] = args[3].double()
    with pytest.raises(ValueError, match="dtype"):
        cuda_raster.raster_forward_cuda(*bad)
    bad = list(args)
    bad[5] = torch.randn(args[5].shape[1], args[5].shape[0], device=dev).t()
    with pytest.raises(ValueError, match="contiguous"):
        cuda_raster.raster_forward_cuda(*bad)
    bad = list(args)
    bad[8] = args[8].clone()
    bad[8][-1] = args[6].numel() + 1      # the last tile's list leaves gid_sorted
    with pytest.raises(ValueError, match="tile lists out of range"):
        cuda_raster.raster_forward_cuda(*bad)
    # batched: the rows must be whole cameras, and the tiles in their grids
    n = args[0].shape[0]
    for kw in (dict(n_per_camera=n - 1),
               dict(n_per_camera=n, tile_base=ci.grid.num_tiles)):
        with pytest.raises(ValueError, match="do not cover"):
            cuda_raster.raster_forward_cuda(*args, **kw)


# gradient groups of the backward's rows: (name, first column, end column)
GROUPS = (("xy", 0, 2), ("conic", 2, 5), ("opacity", 5, 6), ("rgb", 6, 9),
          ("depth", 9, 10))


def _norm_err(got, ref):
    s = max(float(ref.abs().max()), 1e-9)
    return float((got - ref).abs().max()) / s


def _backward_inputs(dev, f_dim, seed=0, tile_w=16):
    from feature3dgs_tpu_torch.ops import cuda_raster
    ci = _inputs(dev, f_dim, tile_w, 16, 3.0)
    fwd = cuda_raster.raster_forward_cuda(*ci.args)
    gen = torch.Generator(device="cpu").manual_seed(seed)
    cts = [torch.randn(x.shape, generator=gen).to(dev)
           for x in (fwd.color, fwd.feature, fwd.depth, fwd.final_T)]
    return ci, (*cts, fwd.final_T, fwd.n_contrib)


@pytest.mark.parametrize("f_dim,fag,tile_w", [
    (4, False, 16), (4, True, 16), (128, False, 16), (128, True, 16),
    (512, False, 16), (512, True, 16), (0, False, 16), (0, False, 32),
    (3, False, 16), (3, True, 32), (16, True, 32), (128, False, 32),
    (128, True, 32), (256, False, 16), (256, False, 32)])
def test_backward_kernel_matches_plain(dev, f_dim, fag, tile_w):
    """Per-entry rows and per-Gaussian gradients against the plain version;
    rows first filled with NaN all get written; two runs are bit-equal."""
    from feature3dgs_tpu_torch.ops import cuda_raster
    from feature3dgs_tpu_torch.ops.composite import (BackwardRows,
                                                     composite_plain_backward)
    from feature3dgs_tpu_torch.ops.segment import SegmentPlan
    ci, rest = _backward_inputs(dev, f_dim, tile_w=tile_w)
    n_inst = ci.bins.gid_sorted.shape[0]
    poisoned = BackwardRows(
        torch.full((n_inst, 10), float("nan"), device=dev),
        torch.full((n_inst, f_dim), float("nan"), device=dev))
    before = cuda_raster.BACKWARD_LAUNCHES
    got = cuda_raster.raster_backward_cuda(*ci.args, *rest,
                                           feature_alpha_grad=fag,
                                           out=poisoned)
    assert cuda_raster.BACKWARD_LAUNCHES == before + 1
    ref = composite_plain_backward(*ci.args, *rest, chunk=16,
                                   feature_alpha_grad=fag)
    torch.cuda.synchronize()
    assert not got.geom.isnan().any() and not got.feature.isnan().any()
    plan = SegmentPlan(ci.bins.gid_sorted, ci.args[0].shape[0])
    for name, a, b in GROUPS:
        assert _norm_err(got.geom[:, a:b], ref.geom[:, a:b]) <= 5e-6, name
        assert _norm_err(plan.sum(got.geom[:, a:b]),
                         plan.sum(ref.geom[:, a:b])) <= 5e-6, name
    if f_dim:
        assert _norm_err(got.feature, ref.feature) <= 5e-6
        assert _norm_err(plan.sum(got.feature), plan.sum(ref.feature)) <= 5e-6
    again = cuda_raster.raster_backward_cuda(*ci.args, *rest,
                                             feature_alpha_grad=fag)
    assert torch.equal(again.geom, got.geom)
    assert torch.equal(again.feature, got.feature)
    assert torch.equal(SegmentPlan(ci.bins.gid_sorted, ci.args[0].shape[0])
                       .sum(again.feature), plan.sum(got.feature))


def _screen_lists(dev, f_dim, tile_w, tile_h, lengths, seed=0,
                  saturating=()):
    """One row of tiles with per-tile lists of the given lengths, splats
    straight in screen space inside their tile. Tiles in ``saturating`` get
    broad splats of opacity 0.9 that end every pixel within a few entries
    (not 0.99: at the alpha clamp 1 / (1 - alpha) = 100 multiplies the f32
    rounding of the two summation orders past the 5e-6 bar)."""
    from feature3dgs_tpu_torch.ops.binning import TileGrid
    rng = np.random.RandomState(seed)
    n_tiles = len(lengths)
    grid = TileGrid(width=tile_w * n_tiles, height=tile_h, tile_w=tile_w,
                    tile_h=tile_h)
    xy, conic, opacity = [], [], []
    for t, n in enumerate(lengths):
        sat = t in saturating
        xy.append(np.stack([rng.uniform(t * tile_w, (t + 1) * tile_w, n),
                            rng.uniform(0, tile_h, n)], 1))
        s2 = rng.uniform(200.0, 400.0, n) if sat else rng.uniform(4.0, 40.0, n)
        conic.append(np.stack([1.0 / s2, rng.uniform(-0.2, 0.2, n) / s2,
                               1.0 / rng.permutation(s2)], 1))
        opacity.append(np.full(n, 0.9) if sat else rng.uniform(0.05, 0.9, n))
    total = int(sum(lengths))
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)
    counts = torch.tensor(lengths, dtype=torch.int32, device=dev)
    starts = (torch.cumsum(counts, 0) - counts).to(torch.int32)
    return (f32(np.concatenate(xy)), f32(np.concatenate(conic)),
            f32(np.concatenate(opacity)), f32(rng.rand(total, 3)),
            f32(rng.uniform(1, 5, total)), f32(rng.randn(total, f_dim)),
            torch.randperm(total, generator=torch.Generator().manual_seed(
                seed)).to(torch.int32).to(dev), starts, counts, grid)


def _check_both_kernels(dev, args, alpha_matmul, fag=False, tile_base=0):
    """Forward and backward kernels against the plain versions on ``args``
    (exact mode at the exact bars, alpha_matmul at its own), every poisoned
    row written, two launches bit-equal. Returns the forward output."""
    from feature3dgs_tpu_torch.ops import cuda_raster
    from feature3dgs_tpu_torch.ops.composite import (BackwardRows,
                                                     composite_plain,
                                                     composite_plain_backward)
    f_dim, n_inst = args[5].shape[1], args[6].shape[0]
    got = cuda_raster.raster_forward_cuda(*args, tile_base=tile_base,
                                          alpha_matmul=alpha_matmul)
    ref = composite_plain(*args, chunk=32, tile_base=tile_base,
                          alpha_matmul=alpha_matmul)
    if alpha_matmul:
        for k, tol in (("color", 1e-4), ("feature", 1e-4), ("final_T", 1e-4),
                       ("depth", 5e-4)):
            if getattr(got, k).numel():
                assert float((getattr(got, k) - getattr(ref, k)).abs().max()) \
                    <= tol, k
        diff = (got.n_contrib - ref.n_contrib).abs()
        assert float((diff > 0).float().mean()) < 0.01 and int(diff.max()) <= 1
    else:
        _check(got, ref)
    again = cuda_raster.raster_forward_cuda(*args, tile_base=tile_base,
                                            alpha_matmul=alpha_matmul)
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    if tile_base:
        return got
    gen = torch.Generator(device="cpu").manual_seed(1)
    rest = (*[torch.randn(x.shape, generator=gen).to(dev)
              for x in (got.color, got.feature, got.depth, got.final_T)],
            got.final_T, got.n_contrib)
    poisoned = BackwardRows(
        torch.full((n_inst, 10), float("nan"), device=dev),
        torch.full((n_inst, f_dim), float("nan"), device=dev))
    rows = cuda_raster.raster_backward_cuda(
        *args, *rest, feature_alpha_grad=fag, alpha_matmul=alpha_matmul,
        out=poisoned)
    want = composite_plain_backward(*args, *rest, chunk=32,
                                    feature_alpha_grad=fag,
                                    alpha_matmul=alpha_matmul)
    torch.cuda.synchronize()
    assert not rows.geom.isnan().any() and not rows.feature.isnan().any()
    tol = 1e-4 if alpha_matmul else 5e-6
    if alpha_matmul and args[9].tile_w > 16:
        tol *= (args[9].tile_w / 16) ** 2
    for name, a, b in GROUPS:
        if float(want.geom[:, a:b].abs().max()) > 0:
            assert _norm_err(rows.geom[:, a:b], want.geom[:, a:b]) <= tol, name
    if f_dim and float(want.feature.abs().max()) > 0:
        assert _norm_err(rows.feature, want.feature) <= tol
    rows2 = cuda_raster.raster_backward_cuda(
        *args, *rest, feature_alpha_grad=fag, alpha_matmul=alpha_matmul)
    assert torch.equal(rows2.geom, rows.geom)
    assert torch.equal(rows2.feature, rows.feature)
    return got


@pytest.mark.parametrize("alpha_matmul", [False, True])
@pytest.mark.parametrize("f_dim,tile_w", [(0, 16), (3, 32), (4, 16),
                                          (16, 32), (128, 16), (128, 32),
                                          (256, 32)])
def test_list_lengths_around_the_chunk(dev, f_dim, tile_w, alpha_matmul):
    """Lists of 0, 1, 31, 32, 33, 64, 65 and 230 entries (the kernels walk
    32 at a time and the backward stages 64), side by side."""
    args = _screen_lists(dev, f_dim, tile_w, 16,
                         [0, 1, 31, 32, 33, 64, 65, 230], seed=f_dim + tile_w)
    got = _check_both_kernels(dev, args, alpha_matmul)
    assert int(got.n_contrib[0].max()) == 0 and int(got.n_contrib[-1].max()) > 64


@pytest.mark.parametrize("alpha_matmul", [False, True])
@pytest.mark.parametrize("f_dim,tile_w,fag", [(4, 16, False), (128, 32, False),
                                              (16, 32, True)])
def test_saturated_tile_beside_an_empty_one(dev, f_dim, tile_w, fag,
                                            alpha_matmul):
    """A tile whose pixels all end within the first chunk of a three-chunk
    list (the block leaves early; the backward walks one chunk and zero-
    fills the rest), an empty tile, and an ordinary one."""
    args = _screen_lists(dev, f_dim, tile_w, 16, [90, 0, 70], seed=7,
                         saturating=(0,))
    got = _check_both_kernels(dev, args, alpha_matmul, fag=fag)
    assert 0 < int(got.n_contrib[0].max()) <= 32
    assert float(got.final_T[0].max()) < 1e-3
    assert int(got.n_contrib[1].max()) == 0
    assert float(got.final_T[1].min()) == 1.0


@pytest.mark.parametrize("f_dim,tile_w", [(16, 16), (128, 32)])
def test_tile_base_on_long_lists(dev, f_dim, tile_w):
    """tile_base > 0 on lists that span several chunks: the slice starts in
    the middle of a row and wraps into the next image."""
    args = _screen_lists(dev, f_dim, tile_w, 16, [40, 100, 33, 5], seed=3)
    for base in (2, 4, 7):
        _check_both_kernels(dev, args, False, tile_base=base)


@pytest.mark.parametrize("name", ["raster_forward", "raster_backward"])
@pytest.mark.parametrize("p,f_dim", [(256, 4), (512, 128), (512, 256),
                                     (1024, 16)])
def test_plans_agree_with_the_libraries(dev, name, p, f_dim):
    """The Python launch plan's shared memory is the library's own, and the
    instantiation it picks fits the card."""
    from feature3dgs_tpu_torch.ops import cuda_raster, kernel_lib
    for mm in (False, True):
        attrs = cuda_raster.kernel_attributes(name, p, f_dim, mm)
        lib = kernel_lib.load(name, *cuda_raster.LIBRARIES[name])
        if name == "raster_forward":
            shape = (attrs["threads"], attrs["channel_tiles"],
                     attrs["halves"], int(mm))
        else:
            shape = (p, f_dim, int(mm), attrs["entries"], attrs["ring_rows"])
        assert getattr(lib, f"f3dgs_{name}_smem_bytes")(*shape) \
            == attrs["smem_bytes"]
        assert attrs["blocks_per_sm"] >= 1 and attrs["registers"] <= 255


def test_rasterize_backward_on_the_card(dev):
    """One forward and one backward launch per differentiable render, with
    gradients equal to the plain backend's."""
    from feature3dgs_tpu_torch.ops import cuda_raster
    from feature3dgs_tpu_torch.ops.rasterize import RasterConfig, rasterize
    rng = np.random.RandomState(2)
    n = 300
    q = rng.randn(n, 4)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    base = {"means3d": rng.uniform(-1.5, 1.5, (n, 3)),
            "scales": np.exp(rng.uniform(-3.5, -1.5, (n, 3))), "rotations": q,
            "opacities": rng.uniform(0.2, 0.95, n),
            "shs": rng.randn(n, 9, 3) * 0.3, "feat": rng.randn(n, 32)}
    from feature3dgs_tpu_torch.convert import camera_from_numpy
    from feature3dgs_tpu_torch.core import transforms
    view = transforms.world_to_view(np.eye(3), np.array([0.0, 0.0, 4.0]))
    proj = transforms.projection_matrix(0.01, 100.0, 1.0, 0.8) @ view
    cam = camera_from_numpy(view, proj, transforms.camera_center_from_view(
        view).astype(np.float32), math.tan(0.5), math.tan(0.4), 96, 64, dev)
    grads = {}
    for backend in ("cuda", "plain"):
        leaves = {k: torch.tensor(v.astype(np.float32), device=dev,
                                  requires_grad=True) for k, v in base.items()}
        f0, b0 = cuda_raster.FORWARD_LAUNCHES, cuda_raster.BACKWARD_LAUNCHES
        out = rasterize(leaves["means3d"], leaves["opacities"], leaves["feat"],
                        cam, scales=leaves["scales"],
                        rotations=leaves["rotations"], shs=leaves["shs"],
                        sh_degree=2, bg=torch.tensor([0.2, 0.5, 0.1],
                                                     device=dev),
                        config=RasterConfig(backend=backend))
        (out.color.square().mean() + out.feature.abs().mean()
         + out.depth.mean()).backward()
        launches = (cuda_raster.FORWARD_LAUNCHES - f0,
                    cuda_raster.BACKWARD_LAUNCHES - b0)
        assert launches == ((1, 1) if backend == "cuda" else (0, 0))
        grads[backend] = {k: v.grad for k, v in leaves.items()}
    for k in base:
        assert _norm_err(grads["cuda"][k], grads["plain"][k]) <= 5e-6, k


@pytest.mark.parametrize("f_dim,tile_w", [(4, 16), (128, 16), (128, 32)])
def test_alpha_matmul_kernels_match_plain(dev, f_dim, tile_w):
    """Both kernels in the alpha_matmul mode against the plain versions in
    the same mode, to the mode's contract (tests/test_pallas.py:413-446):
    1e-4 on color, features and final_T, 5e-4 on depth, n_contrib differing
    on fewer than 1% of the pixels by at most 1, gradient rows at 1e-4
    max-normalised (4x that at 32-wide tiles, whose tile-local terms are 4x
    as large); every row written; the mode's own launch counts."""
    from feature3dgs_tpu_torch.ops import cuda_raster
    from feature3dgs_tpu_torch.ops.composite import (BackwardRows,
                                                     composite_plain,
                                                     composite_plain_backward)
    from feature3dgs_tpu_torch.ops.segment import SegmentPlan
    widen = (tile_w / 16) ** 2
    ci = _inputs(dev, f_dim, tile_w, 16, 3.0)
    counts = (cuda_raster.FORWARD_LAUNCHES, cuda_raster.BACKWARD_LAUNCHES,
              cuda_raster.FORWARD_MM_LAUNCHES, cuda_raster.BACKWARD_MM_LAUNCHES)
    fwd = cuda_raster.raster_forward_cuda(*ci.args, alpha_matmul=True)
    ref = composite_plain(*ci.args, chunk=16, alpha_matmul=True)
    for k, tol in (("color", 1e-4), ("feature", 1e-4), ("final_T", 1e-4),
                   ("depth", 5e-4)):
        assert float((getattr(fwd, k) - getattr(ref, k)).abs().max()) \
            <= tol * widen, k
    diff = (fwd.n_contrib - ref.n_contrib).abs()
    assert float((diff > 0).float().mean()) < 0.01 and int(diff.max()) <= 1

    gen = torch.Generator(device="cpu").manual_seed(0)
    rest = (*[torch.randn(x.shape, generator=gen).to(dev)
              for x in (fwd.color, fwd.feature, fwd.depth, fwd.final_T)],
            fwd.final_T, fwd.n_contrib)
    n_inst = ci.bins.gid_sorted.shape[0]
    got = cuda_raster.raster_backward_cuda(
        *ci.args, *rest, alpha_matmul=True, out=BackwardRows(
            torch.full((n_inst, 10), float("nan"), device=dev),
            torch.full((n_inst, f_dim), float("nan"), device=dev)))
    rows = composite_plain_backward(*ci.args, *rest, chunk=16,
                                    alpha_matmul=True)
    torch.cuda.synchronize()
    assert (cuda_raster.FORWARD_LAUNCHES, cuda_raster.BACKWARD_LAUNCHES,
            cuda_raster.FORWARD_MM_LAUNCHES,
            cuda_raster.BACKWARD_MM_LAUNCHES) == (
        counts[0], counts[1], counts[2] + 1, counts[3] + 1)
    assert not got.geom.isnan().any() and not got.feature.isnan().any()
    plan = SegmentPlan(ci.bins.gid_sorted, ci.args[0].shape[0])
    for name, a, b in GROUPS:
        assert _norm_err(got.geom[:, a:b], rows.geom[:, a:b]) \
            <= 1e-4 * widen, name
        assert _norm_err(plan.sum(got.geom[:, a:b]),
                         plan.sum(rows.geom[:, a:b])) <= 1e-4 * widen, name
    assert _norm_err(got.feature, rows.feature) <= 1e-4 * widen
    again = cuda_raster.raster_backward_cuda(*ci.args, *rest,
                                             alpha_matmul=True)
    assert torch.equal(again.geom, got.geom)            # deterministic


def test_exact_mode_is_unchanged_by_the_flag(dev):
    """alpha_matmul=False gives the bits of a call without the argument,
    forward and backward."""
    from feature3dgs_tpu_torch.ops import cuda_raster
    ci, rest = _backward_inputs(dev, 128)
    absent = cuda_raster.raster_forward_cuda(*ci.args)
    off = cuda_raster.raster_forward_cuda(*ci.args, alpha_matmul=False)
    for a, b in zip(absent, off):
        assert torch.equal(a, b)
    rows_absent = cuda_raster.raster_backward_cuda(*ci.args, *rest)
    rows_off = cuda_raster.raster_backward_cuda(*ci.args, *rest,
                                                alpha_matmul=False)
    assert torch.equal(rows_absent.geom, rows_off.geom)
    assert torch.equal(rows_absent.feature, rows_off.feature)
    on = cuda_raster.raster_forward_cuda(*ci.args, alpha_matmul=True)
    assert not torch.equal(on.color, absent.color)      # the mode does differ


def test_rasterize_alpha_matmul_on_the_card(dev):
    """RasterConfig(alpha_matmul=True) launches the alpha-mode kernels,
    forward and backward, through rasterize."""
    from feature3dgs_tpu_torch.ops import cuda_raster
    from feature3dgs_tpu_torch.ops.rasterize import RasterConfig, composite
    ci = _inputs(dev, 16, 16, 16, 3.0)
    leaves = [x.clone().requires_grad_() for x in ci.args[:6]]
    before = (cuda_raster.FORWARD_MM_LAUNCHES, cuda_raster.BACKWARD_MM_LAUNCHES,
              cuda_raster.FORWARD_LAUNCHES, cuda_raster.BACKWARD_LAUNCHES)
    out = composite((*leaves, *ci.args[6:]),
                    RasterConfig(tile_w=16, tile_h=16, alpha_matmul=True))
    (out.color.square().mean() + out.feature.abs().mean()).backward()
    assert (cuda_raster.FORWARD_MM_LAUNCHES, cuda_raster.BACKWARD_MM_LAUNCHES,
            cuda_raster.FORWARD_LAUNCHES, cuda_raster.BACKWARD_LAUNCHES) == (
        before[0] + 1, before[1] + 1, before[2], before[3])
    assert all(bool(torch.isfinite(x.grad).all()) for x in leaves)


@pytest.mark.parametrize("use_screen_size_prune", [False, True])
def test_densify_round_on_the_card_equals_the_cpu(dev, use_screen_size_prune):
    """The same round from the same state and noise on CUDA and on the CPU:
    alive, the report and every verbatim copy exactly, children's positions
    and scales at 1e-6."""
    from feature3dgs_tpu_torch.model import density
    from feature3dgs_tpu_torch.model import gaussians as G
    from feature3dgs_tpu_torch.model import optim
    rng = np.random.RandomState(3)
    cap, f32 = 4096, np.float32
    shapes = {"xyz": (3,), "features_dc": (1, 3), "features_rest": (15, 3),
              "scaling": (3,), "rotation": (4,), "opacity": (1,),
              "semantic_feature": (1, 16)}
    params = {k: rng.randn(cap, *s).astype(f32) for k, s in shapes.items()}
    params["scaling"] = np.log(rng.uniform(0.005, 0.09, (cap, 1))
                               * rng.uniform(0.7, 1.0, (cap, 3))).astype(f32)
    params["scaling"][::7] = np.log(0.5)
    params["opacity"] = rng.uniform(-7.0, 2.0, (cap, 1)).astype(f32)
    moments = {k: rng.rand(cap, *s).astype(f32) for k, s in shapes.items()}
    alive = rng.rand(cap) > 0.4
    denom = rng.randint(0, 4, cap).astype(f32)
    accum = (rng.uniform(0, 5e-4, cap) * np.maximum(denom, 1)).astype(f32)
    noise = rng.randn(2, cap, 3).astype(f32)

    def state_on(device):
        to = lambda x: torch.from_numpy(x.copy()).to(device)
        p = G.GaussianParams(**{k: to(v) for k, v in params.items()})
        gs = G.GaussianState(alive=to(alive), max_radii2d=to(denom),
                             xyz_gradient_accum=to(accum), denom=to(denom))
        adam = optim.AdamState(
            G.GaussianParams(**{k: to(v) for k, v in moments.items()}),
            G.GaussianParams(**{k: to(v) for k, v in moments.items()}),
            torch.tensor(3, dtype=torch.int32, device=device))
        return p, gs, adam, to(noise), torch.tensor(4.0, device=device)

    def run(p, gs, adam, noise_t, extent):
        return density.densify_and_prune(
            p, gs, adam, noise_t, max_grad=2e-4, min_opacity=0.005,
            extent=extent, percent_dense=0.01,
            use_screen_size_prune=use_screen_size_prune)

    card_state = state_on(dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")     # the round reads nothing back
    try:
        on_card = run(*card_state)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    on_cpu = run(*state_on("cpu"))
    for name in on_cpu[3]._fields:
        assert int(getattr(on_card[3], name)) == int(getattr(on_cpu[3], name))
    assert int(on_cpu[3].num_cloned) > 0 and int(on_cpu[3].num_split) > 0
    assert int(on_cpu[3].num_pruned) > 0
    assert torch.equal(on_card[1].alive.cpu(), on_cpu[1].alive)
    for k in shapes:
        a, b = getattr(on_card[0], k).cpu(), getattr(on_cpu[0], k)
        if k in ("xyz", "scaling"):
            assert float((a - b).abs().max()) <= 1e-6 * max(
                1.0, float(b.abs().max())), k
        else:
            assert torch.equal(a, b), k
        assert torch.equal(getattr(on_card[2].mu, k).cpu(),
                           getattr(on_cpu[2].mu, k)), k


def _batch_views(dev, width=64, height=48):
    """Three same-size cameras on the z axis (tests/test_rasterize.py's)."""
    from feature3dgs_tpu_torch.convert import camera_from_numpy
    from feature3dgs_tpu_torch.core import transforms
    views = []
    for cam_z, fovx in ((-4.0, 1.0), (-3.0, 1.1), (-5.5, 0.9)):
        view = transforms.world_to_view(np.eye(3), np.array([0.0, 0.0, -cam_z]))
        proj = transforms.projection_matrix(0.01, 100.0, fovx, 0.8) @ view
        views.append(camera_from_numpy(
            view, proj, transforms.camera_center_from_view(view).astype(
                np.float32), math.tan(fovx / 2), math.tan(0.4), width, height,
            dev))
    return views


@pytest.mark.parametrize("alpha_matmul", [False, True])
@pytest.mark.parametrize("f_dim,tile_w", [(8, 16), (128, 32)])
def test_batched_kernel_equals_per_view_launches(dev, f_dim, tile_w,
                                                 alpha_matmul):
    """One launch over three cameras' stacked grids (n_per_camera) gives
    each camera's per-view launch bit for bit, and matches the batched plain
    version at the mode's bars; the feature table is passed once."""
    from feature3dgs_tpu_torch.ops import cuda_raster
    from feature3dgs_tpu_torch.ops.composite import composite_plain
    from feature3dgs_tpu_torch.ops.rasterize import (RasterConfig,
                                                     composite_inputs,
                                                     composite_inputs_batch)
    rng = np.random.RandomState(3)
    n = 300
    q = rng.randn(n, 4)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    g = {"means3d": rng.uniform(-1.5, 1.5, (n, 3)),
         "scales": np.exp(rng.uniform(-3.5, -1.5, (n, 3))), "rotations": q,
         "opacities": np.minimum(rng.uniform(0.2, 0.95, n) * 3.0, 0.999),
         "shs": rng.randn(n, 9, 3) * 0.3, "feat": rng.randn(n, f_dim)}
    g = {k: torch.tensor(v.astype(np.float32), device=dev) for k, v in g.items()}
    kw = dict(scales=g["scales"], rotations=g["rotations"], shs=g["shs"],
              sh_degree=2, config=RasterConfig(tile_w=tile_w, tile_h=16))
    views = _batch_views(dev)
    ci = composite_inputs_batch(g["means3d"], g["opacities"], g["feat"],
                                views, **kw)
    assert ci.args[5].data_ptr() == g["feat"].data_ptr()   # not copied
    before = (cuda_raster.FORWARD_LAUNCHES, cuda_raster.FORWARD_MM_LAUNCHES)
    got = cuda_raster.raster_forward_cuda(*ci.args, n_per_camera=n,
                                          alpha_matmul=alpha_matmul)
    after = (cuda_raster.FORWARD_LAUNCHES, cuda_raster.FORWARD_MM_LAUNCHES)
    assert after[int(alpha_matmul)] == before[int(alpha_matmul)] + 1
    t = ci.grid.num_tiles
    for b, view in enumerate(views):
        one = composite_inputs(g["means3d"], g["opacities"], g["feat"], view,
                               **kw)
        ref = cuda_raster.raster_forward_cuda(*one.args,
                                              alpha_matmul=alpha_matmul)
        for name in ref._fields:
            assert torch.equal(getattr(got, name)[b * t:(b + 1) * t],
                               getattr(ref, name)), (b, name)
    plain = composite_plain(*ci.args, chunk=32, n_per_camera=n,
                            alpha_matmul=alpha_matmul)
    torch.cuda.synchronize()
    if alpha_matmul:
        for k, tol in (("color", 1e-4), ("feature", 1e-4), ("final_T", 1e-4),
                       ("depth", 5e-4)):
            assert float((getattr(got, k) - getattr(plain, k)).abs().max()) \
                <= tol, k
        diff = (got.n_contrib - plain.n_contrib).abs()
        assert float((diff > 0).float().mean()) < 0.01 and int(diff.max()) <= 1
    else:
        _check(got, plain)


def test_render_batch_on_the_card_equals_render(dev):
    """renderer.render_batch launches the forward kernel once for the batch
    and equals renderer.render view by view, bit for bit."""
    from feature3dgs_tpu_torch import convert
    from feature3dgs_tpu_torch.ops import cuda_raster
    from feature3dgs_tpu_torch.ops.rasterize import RasterConfig
    from feature3dgs_tpu_torch.render import renderer
    rng = np.random.RandomState(5)
    n = 240
    fields = {
        "xyz": rng.uniform(-1.5, 1.5, (n, 3)),
        "features_dc": rng.randn(n, 1, 3) * 0.5,
        "features_rest": rng.randn(n, 15, 3) * 0.2,
        "scaling": rng.uniform(-3.5, -1.5, (n, 3)),
        "rotation": rng.randn(n, 4), "opacity": rng.uniform(-1, 3, (n, 1)),
        "semantic_feature": rng.randn(n, 1, 16)}
    fields = {k: v.astype(np.float32) for k, v in fields.items()}
    alive = np.ones(n, bool)
    alive[::7] = False
    params, state = convert.gaussians_from_numpy(fields, alive, 3, dev)
    views = _batch_views(dev)
    cfg = RasterConfig(tile_w=16, tile_h=16, instance_capacity=1 << 12)
    with torch.inference_mode():
        before = cuda_raster.FORWARD_LAUNCHES
        batch = renderer.render_batch(params, state, views, config=cfg)
        assert cuda_raster.FORWARD_LAUNCHES == before + 1
        for b, view in enumerate(views):
            one = renderer.render(params, state, view, config=cfg)
            for name in one._fields:
                assert torch.equal(getattr(batch, name)[b],
                                   getattr(one, name)), (b, name)
    with pytest.raises(ValueError, match="forward-only"):
        renderer.render_batch(
            params, state, views, config=cfg,
            override_opacity=torch.ones(n, device=dev, requires_grad=True))


def _views_on(dev, f_dim, tile_w, n_cams, width=64, height=64, seed=3):
    """n_cams cameras on one scene: each view's inputs alone, and all of
    them binned in one sort (``composite_inputs_batch``)."""
    from feature3dgs_tpu_torch.convert import camera_from_numpy
    from feature3dgs_tpu_torch.core import transforms
    from feature3dgs_tpu_torch.ops.rasterize import (RasterConfig,
                                                     composite_inputs,
                                                     composite_inputs_batch)
    rng = np.random.RandomState(seed)
    n = 300
    q = rng.randn(n, 4)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    g = {"means3d": rng.uniform(-1.5, 1.5, (n, 3)),
         "scales": np.exp(rng.uniform(-3.5, -1.5, (n, 3))), "rotations": q,
         "opacities": np.minimum(rng.uniform(0.2, 0.95, n) * 3.0, 0.999),
         "shs": rng.randn(n, 9, 3) * 0.3, "feat": rng.randn(n, f_dim)}
    g = {k: torch.tensor(v.astype(np.float32), device=dev) for k, v in g.items()}
    cams = []
    for i in range(n_cams):
        view = transforms.world_to_view(np.eye(3),
                                        np.array([0.1 * i, 0.0, 4.0 + 0.3 * i]))
        proj = transforms.projection_matrix(0.01, 100.0, 1.0, 0.8) @ view
        cams.append(camera_from_numpy(
            view, proj, transforms.camera_center_from_view(view).astype(
                np.float32), math.tan(0.5), math.tan(0.4), width, height, dev))
    kw = dict(scales=g["scales"], rotations=g["rotations"], shs=g["shs"],
              sh_degree=2, config=RasterConfig(tile_w=tile_w, tile_h=16))
    singles = [composite_inputs(g["means3d"], g["opacities"], g["feat"], c,
                                **kw) for c in cams]
    return singles, composite_inputs_batch(g["means3d"], g["opacities"],
                                           g["feat"], cams, **kw)


def _rows_match_plain(got, ref, tol=5e-6):
    for name, a, b in GROUPS:
        if float(ref.geom[:, a:b].abs().max()) > 0:
            assert _norm_err(got.geom[:, a:b], ref.geom[:, a:b]) <= tol, name
    if got.feature.numel() and float(ref.feature.abs().max()) > 0:
        assert _norm_err(got.feature, ref.feature) <= tol


@pytest.mark.parametrize("f_dim,tile_w", [(4, 16), (128, 32), (128, 16)])
def test_backward_kernel_tile_slices_and_batches(dev, f_dim, tile_w):
    """``tile_base``: the backward over 2 and 4 slices of tile rows (each
    with its own sub-range of gid_sorted and rebased starts) writes the
    full launch's rows bit for bit; ``n_per_camera``: one launch over 3
    cameras writes each camera's own launch's rows bit for bit. Both within
    5e-6 of the plain version (max-normalised)."""
    from feature3dgs_tpu_torch.ops import cuda_raster
    from feature3dgs_tpu_torch.ops.binning import tile_slices
    from feature3dgs_tpu_torch.ops.composite import composite_plain_backward
    singles, batch = _views_on(dev, f_dim, tile_w, 3)
    ci, grid = singles[0], singles[0].grid
    fwd = cuda_raster.raster_forward_cuda(*ci.args)
    gen = torch.Generator(device="cpu").manual_seed(f_dim)
    state = (*[torch.randn(x.shape, generator=gen).to(dev)
               for x in (fwd.color, fwd.feature, fwd.depth, fwd.final_T)],
             fwd.final_T, fwd.n_contrib)
    full = cuda_raster.raster_backward_cuda(*ci.args, *state)
    for n_tile in (2, 4):
        rows_loc = -(-grid.grid_y // n_tile)
        ranges = [(min(r * rows_loc, grid.grid_y) * grid.grid_x,
                   min((r + 1) * rows_loc, grid.grid_y) * grid.grid_x)
                  for r in range(n_tile)]
        offset = 0
        for (t0, t1), lists in zip(ranges, tile_slices(*ci.args[6:9],
                                                       ranges)):
            args = (*ci.args[:6], *lists, grid, *(x[t0:t1] for x in state))
            before = cuda_raster.BACKWARD_LAUNCHES
            rows = cuda_raster.raster_backward_cuda(*args, tile_base=t0)
            assert cuda_raster.BACKWARD_LAUNCHES == before + (t1 > t0)
            k = lists[0].shape[0]
            assert torch.equal(rows.geom, full.geom[offset:offset + k])
            assert torch.equal(rows.feature, full.feature[offset:offset + k])
            _rows_match_plain(rows, composite_plain_backward(
                *args, chunk=32, tile_base=t0))
            offset += k
        assert offset == ci.bins.gid_sorted.shape[0]

    n = ci.args[0].shape[0]
    bfwd = cuda_raster.raster_forward_cuda(*batch.args, n_per_camera=n)
    t_n = grid.num_tiles
    bstate = (*[torch.cat([torch.randn((t_n,) + x.shape[1:],
                                       generator=gen).to(dev)
                           for _ in singles])
                for x in (fwd.color, fwd.feature, fwd.depth, fwd.final_T)],
              bfwd.final_T, bfwd.n_contrib)
    before = cuda_raster.BACKWARD_LAUNCHES
    brows = cuda_raster.raster_backward_cuda(*batch.args, *bstate,
                                             n_per_camera=n)
    assert cuda_raster.BACKWARD_LAUNCHES == before + 1
    _rows_match_plain(brows, composite_plain_backward(
        *batch.args, *bstate, chunk=32, n_per_camera=n))
    offset = 0
    for b, one in enumerate(singles):
        ofwd = cuda_raster.raster_forward_cuda(*one.args)
        assert torch.equal(ofwd.n_contrib, bfwd.n_contrib[b * t_n:(b + 1) * t_n])
        rows = cuda_raster.raster_backward_cuda(
            *one.args, *(x[b * t_n:(b + 1) * t_n] for x in bstate))
        k = one.bins.gid_sorted.shape[0]
        assert torch.equal(brows.geom[offset:offset + k], rows.geom)
        assert torch.equal(brows.feature[offset:offset + k], rows.feature)
        offset += k


def test_batched_train_step_launches_once_each_way(dev):
    """A DistributedTrainer step of 4 cameras on a 1 x 1 mesh makes one
    forward and one backward launch, and its loss is the mean of the 4
    cameras' single-step losses from the same state (2e-5 relative)."""
    import copy

    from feature3dgs_tpu_torch.data.synthetic import synthetic_scene
    from feature3dgs_tpu_torch.ops import cuda_raster
    from feature3dgs_tpu_torch.ops.rasterize import RasterConfig
    from feature3dgs_tpu_torch.parallel import DistributedTrainer, make_mesh
    from feature3dgs_tpu_torch.train.trainer import (OptimizationConfig,
                                                     train_step)
    scene = synthetic_scene(n_cams=4, w=96, h=64, n_pts=400, f_dim=8, seed=0)
    rcfg = RasterConfig(instance_capacity=1 << 16)
    tr = DistributedTrainer(scene, mesh=make_mesh((1, 1)), cameras_per_step=4,
                            ocfg=OptimizationConfig(iterations=8), rcfg=rcfg,
                            max_sh_degree=2, device=dev)
    start = copy.deepcopy(tr.ts)
    cams = scene.train_cameras
    cuda_raster.FORWARD_LAUNCHES = cuda_raster.BACKWARD_LAUNCHES = 0
    m = tr.step(cameras=cams)
    assert (cuda_raster.FORWARD_LAUNCHES,
            cuda_raster.BACKWARD_LAUNCHES) == (1, 1)
    losses = []
    for c in cams:
        ts = copy.deepcopy(start)
        losses.append(float(train_step(
            ts, c.to_view(dev), tr._device_cache(c, "image"),
            tr._device_cache(c, "feature"), tr.bg, 1, ocfg=tr.ocfg,
            rcfg=rcfg, speedup=False)["loss"]))
    assert m["finite"] == 1.0
    assert abs(m["loss"] - np.mean(losses)) <= 2e-5 * abs(np.mean(losses))


def _shard_step_inputs(dev):
    """4 cameras of a small synthetic scene and a fresh TrainState of its
    points, on ``dev``."""
    from feature3dgs_tpu_torch.data.synthetic import synthetic_scene
    from feature3dgs_tpu_torch.model import gaussians as G
    from feature3dgs_tpu_torch.train.trainer import TrainState
    scene = synthetic_scene(n_cams=4, w=96, h=64, n_pts=400, f_dim=8, seed=2)
    params, gstate = G.create_from_pcd(scene.points, scene.colors,
                                       max_sh_degree=2, feature_dim=8,
                                       capacity=512, device=dev)
    params.semantic_feature = torch.from_numpy(np.random.RandomState(2).randn(
        512, 1, 8).astype(np.float32) * 0.1).to(dev)
    gstate.active_sh_degree = 2
    return TrainState.create(params, gstate, device=dev), scene.train_cameras


def _batch_on(cams, device):
    """Views, images and teacher maps of ``cams`` on ``device``."""
    return ([c.to_view(device) for c in cams],
            [torch.from_numpy(c.image).to(device) for c in cams],
            [torch.from_numpy(c.semantic_feature).to(device) for c in cams])


@pytest.mark.parametrize("mode", ["shard_gaussians", "shard_instances"])
def test_row_sharded_steps_on_the_card(dev, mode):
    """On a 1 x 1 mesh, a ``shard_gaussians`` step and an instance-exchange
    step match the replicated step from the same state at the mesh step's
    bars (loss 2e-5 relative, parameters 5e-5, xyz_gradient_accum 2e-5,
    denom exact, max_radii2d exact for the exchange), and the exchange
    step on the card matches the same step on the CPU (the plain versions)
    at those bars. The exchange composites each camera alone: one forward
    and one backward launch a camera."""
    import copy

    from feature3dgs_tpu_torch.model.gaussians import GaussianParams
    from feature3dgs_tpu_torch.ops import cuda_raster
    from feature3dgs_tpu_torch.ops.rasterize import RasterConfig
    from feature3dgs_tpu_torch.parallel import make_mesh, sharded_train_step
    from feature3dgs_tpu_torch.parallel.sharded import shard_state
    from feature3dgs_tpu_torch.train.trainer import OptimizationConfig
    flags = dict(shard_gaussians=True,
                 shard_instances=mode == "shard_instances")

    def step(ts, device, **kw):
        return sharded_train_step(
            ts, *_batch_on(cams, device), torch.zeros(3, device=device),
            np.arange(1, 5), mesh=make_mesh((1, 1)),
            ocfg=OptimizationConfig(), rcfg=RasterConfig(
                tile_w=16, tile_h=16, instance_capacity=1 << 16), **kw)

    start, cams = _shard_step_inputs(dev)
    ref = copy.deepcopy(start)
    rm = step(ref, dev)
    got = shard_state(copy.deepcopy(start), make_mesh((1, 1)))
    cuda_raster.FORWARD_LAUNCHES = cuda_raster.BACKWARD_LAUNCHES = 0
    m = step(got, dev, **flags)
    n = 4 if flags["shard_instances"] else 1
    assert (cuda_raster.FORWARD_LAUNCHES,
            cuda_raster.BACKWARD_LAUNCHES) == (n, n)
    cpu = torch.device("cpu")
    on_cpu = copy.deepcopy(start)
    for obj in (on_cpu.params, on_cpu.adam.mu, on_cpu.adam.nu):
        for k in GaussianParams.FIELDS:
            setattr(obj, k, getattr(obj, k).cpu())
    for k in ("alive", "max_radii2d", "xyz_gradient_accum", "denom"):
        setattr(on_cpu.gstate, k, getattr(on_cpu.gstate, k).cpu())
    on_cpu.adam.step = on_cpu.adam.step.cpu()
    cm = step(on_cpu, cpu, **flags)
    for other, om in ((ref, rm), (on_cpu, cm)):
        assert abs(float(m["loss"]) - float(om["loss"])) <= 2e-5 * abs(
            float(om["loss"]))
        assert int(m["num_instances"]) == int(om["num_instances"])
        for k in GaussianParams.FIELDS:
            err = (getattr(got.params, k).cpu() - getattr(other.params, k)
                   .cpu()).abs().max()
            assert float(err) <= 5e-5, k
        g, o = got.gstate, other.gstate
        assert float((g.xyz_gradient_accum.cpu()
                      - o.xyz_gradient_accum.cpu()).abs().max()) <= 2e-5
        assert torch.equal(g.denom.cpu(), o.denom.cpu())
        radii = (g.max_radii2d.cpu() - o.max_radii2d.cpu()).abs().max()
        assert float(radii) <= (0.0 if flags["shard_instances"] else 1e-4)


def test_row_sharded_trainer_on_the_card(dev):
    """``DistributedTrainer(shard_gaussians=True, shard_instances=True)``
    on a 1 x 1 mesh trains 6 steps of 2 cameras over a densify round and
    an opacity reset: finite losses, the round applied, a whole state as
    big as the shard at world size 1."""
    from feature3dgs_tpu_torch.data.synthetic import synthetic_scene
    from feature3dgs_tpu_torch.ops.rasterize import RasterConfig
    from feature3dgs_tpu_torch.parallel import DistributedTrainer, make_mesh
    from feature3dgs_tpu_torch.train.trainer import OptimizationConfig
    scene = synthetic_scene(n_cams=4, w=96, h=64, n_pts=400, f_dim=8, seed=0)
    tr = DistributedTrainer(
        scene, mesh=make_mesh((1, 1)), cameras_per_step=2,
        shard_gaussians=True, shard_instances=True,
        ocfg=OptimizationConfig(iterations=12, densify_from_iter=2,
                                densification_interval=6,
                                opacity_reset_interval=8,
                                densify_grad_threshold=1e-6),
        rcfg=RasterConfig(tile_w=16, tile_h=16, instance_capacity=1 << 16),
        max_sh_degree=2, device=dev)
    history = tr.train(iterations=12, log_every=4)
    tr.flush_maintenance(drain=True)
    assert all(h["finite"] == 1.0 for h in history)
    assert [r["iteration"] for r in tr.densify_log] == [6, 12]
    assert tr.full_state().params.capacity == tr.capacity
    assert tr.full_state().params.xyz.device.type == dev.type


def test_viewer_channels_on_the_card_match_the_cpu(dev):
    """net_image of each render mode on the card against the same render
    package on the CPU: RGB, Normal and Feature Map (the float64 PCA with
    the fit's R factor through numpy) within 1e-5; the colormapped modes
    differ on fewer than 1% of the pixels (a float move at a table bin
    edge)."""
    from feature3dgs_tpu_torch.core import transforms
    from feature3dgs_tpu_torch.render.modes import RENDER_ITEMS, net_image
    rng = np.random.RandomState(0)
    yy, xx = np.mgrid[0:48, 0:64]
    pkg = {"color": rng.rand(48, 64, 3), "feature": rng.randn(48, 64, 16),
           "depth": 3 + 0.5 * np.sin(xx / 5) + 0.3 * np.cos(yy / 4)}
    pkg = {k: torch.from_numpy(v.astype(np.float32)) for k, v in pkg.items()}
    view = transforms.world_to_view(np.eye(3), np.array([0.0, 0.0, 4.0]))
    proj = torch.from_numpy((transforms.projection_matrix(
        0.01, 100.0, 1.0, 0.8) @ view).astype(np.float32))
    for mode, item in enumerate(RENDER_ITEMS):
        cpu = net_image(pkg, RENDER_ITEMS, mode, proj)
        card = net_image({k: v.to(dev) for k, v in pkg.items()},
                         RENDER_ITEMS, mode, proj.to(dev))
        assert card.device.type == dev.type and card.shape == (48, 64, 3)
        diff = (card.cpu() - cpu).abs().amax(-1)
        diff[-1, -1] = 0        # the corner normal: rounding noise
        if item in ("Depth", "Edge", "Curvature"):
            assert float((diff > 0).float().mean()) < 0.01, item
        else:
            assert float(diff.max()) <= 1e-5, item


def test_box_nms_and_mask_boxes_on_the_card(dev):
    """The AMG's device helpers on the card decide as on the CPU."""
    from feature3dgs_tpu_torch.encoders import sam_decode as sd
    rng = np.random.RandomState(1)
    xy = rng.uniform(0, 80, (300, 2))
    boxes = torch.from_numpy(np.concatenate(
        [xy, xy + rng.uniform(2, 30, (300, 2))], 1))
    scores = rng.choice([0.2, 0.5, 0.9], 300)
    for thresh in (0.2, 0.5, 0.8):
        assert torch.equal(sd.box_nms(boxes.to(dev), scores, thresh).cpu(),
                           sd.box_nms(boxes, scores, thresh))
    masks = torch.from_numpy(rng.rand(20, 40, 50) > 0.98)
    assert torch.equal(sd.batched_mask_to_box(masks.to(dev)).cpu(),
                       sd.batched_mask_to_box(masks))

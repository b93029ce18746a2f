"""Several cameras a step, on one card or a mesh of cards, over
``torch.distributed``.

Port of ``feature3dgs_tpu/parallel/sharded.py`` (its replicated path):

  mesh axis   what shards                   collectives
  ---------   ---------------------------   ---------------------------------
  "data"      the camera batch              sum of loss and gradients
  "tile"      the tile grid of each image   all_gather of colour and depth
                                            tiles (SSIM needs the whole
                                            frame); sum of each rank's share
                                            of the resized feature map

Per-Gaussian preprocessing and binning are cheap and run on every rank of
a data row (the same result, no communication); compositing, which holds
the time and the memory, is sharded over tile rows: each rank composites
its own rows of every camera of its data row, through the kernels'
``tile_base``, padded to whole tile rows a rank. A rank's cameras are
preprocessed one by one and binned in one sort, and all the tiles it
composites go through one forward and one backward launch when they are
contiguous in the stacked grids (a tile axis of 1): on one card a step of
B cameras makes one sort, one forward and one backward launch.

Gradients follow the JAX package's transposes: the tile gather's backward
gives each rank the sum of every rank's cotangent of its own slice, the
feature-map sum's backward sums the cotangents the same way, and the
per-Gaussian gradients are summed over the whole mesh. The loss each rank
computes for its cameras is normalised by 1 / (B * n_tile), so the world
sum is the mean over the B cameras.

A mesh over a world of one process holds no process group, and every
collective here is then the identity: the one-card path runs none.
``shard_gaussians`` (row-sharded parameters and optimizer state) and
``shard_instances`` (the tile-owner instance exchange) are not ported.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist

from feature3dgs_tpu_torch.core.projection import CameraView
from feature3dgs_tpu_torch.model import density, optim
from feature3dgs_tpu_torch.model import gaussians as G
from feature3dgs_tpu_torch.model.decoder import apply_decoder
from feature3dgs_tpu_torch.ops.binning import tile_slices
from feature3dgs_tpu_torch.ops.rasterize import (RasterConfig, _views,
                                                 composite,
                                                 composite_inputs_batch,
                                                 tiles_to_image)
from feature3dgs_tpu_torch.train import losses as L

NOT_PORTED = ("{} is not ported to feature3dgs_tpu_torch yet (row-sharded "
              "Gaussians and the instance exchange: feature3dgs_tpu/parallel/"
              "sharded.py)")


class Mesh:
    """A ("data", "tile") mesh over the ``torch.distributed`` world: rank r
    sits at (r // n_tile, r % n_tile), as the JAX package reshapes its
    device list. ``shape`` maps each axis name to its size. The ranks of
    one data row share a tile-axis process group; at world size 1 there is
    no process group at all."""

    def __init__(self, shape: Sequence[int]):
        if len(shape) != 2:
            raise ValueError(f"a mesh has the axes ('data', 'tile'), got a "
                             f"shape of {len(shape)}: {tuple(shape)}")
        n_data, n_tile = (int(x) for x in shape)
        world = dist.get_world_size() if dist.is_initialized() else 1
        if n_data < 1 or n_tile < 1 or n_data * n_tile != world:
            raise ValueError(f"mesh shape ({n_data}, {n_tile}) needs a world "
                             f"size of {n_data * n_tile}, this one has {world}")
        self.shape = {"data": n_data, "tile": n_tile}
        self.size = world
        self.rank = dist.get_rank() if world > 1 else 0
        self.data_index, self.tile_index = divmod(self.rank, n_tile)
        self.tile_group = None
        if world > 1:
            # every rank creates every group, in the same order
            for d in range(n_data):
                group = dist.new_group(list(range(d * n_tile,
                                                  (d + 1) * n_tile)))
                if d == self.data_index:
                    self.tile_group = group

    def __repr__(self):
        return (f"Mesh(data={self.shape['data']}, tile={self.shape['tile']}, "
                f"rank={self.rank})")


def make_mesh(shape: Sequence[int] | None = None) -> Mesh:
    """A ("data", "tile") mesh over the current world (default shape: every
    rank on the data axis). Call ``parallel.distributed.initialize`` first
    when the world has more than one process."""
    if shape is None:
        shape = (dist.get_world_size() if dist.is_initialized() else 1, 1)
    return Mesh(shape)


class _GatherTiles(torch.autograd.Function):
    """all_gather over the tile axis, concatenated along dim 0. Backward:
    the sum over the ranks of their cotangents, of which each keeps its own
    slice (a reduce-scatter). ``anchor`` (a tensor that needs grad) records
    the node on every rank, so every rank joins the backward's collective
    even where its own slice is constant."""

    @staticmethod
    def forward(ctx, x, anchor, mesh):
        ctx.mesh, ctx.rows = mesh, x.shape[0]
        parts = [torch.empty_like(x) for _ in range(mesh.shape["tile"])]
        dist.all_gather(parts, x.contiguous(), group=mesh.tile_group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.mesh.tile_group)
        r0 = ctx.mesh.tile_index * ctx.rows
        return g[r0:r0 + ctx.rows], None, None


class _SumTiles(torch.autograd.Function):
    """Sum over the tile axis; its backward sums the cotangents the same
    way. ``anchor`` as in ``_GatherTiles``."""

    @staticmethod
    def forward(ctx, x, anchor, mesh):
        ctx.mesh = mesh
        x = x.contiguous().clone()
        dist.all_reduce(x, group=mesh.tile_group)
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.mesh.tile_group)
        return g, None, None


def _gather_tiles(x, anchor, mesh: Mesh):
    if mesh.shape["tile"] == 1:
        return x
    return _GatherTiles.apply(x, anchor, mesh)


def _sum_tiles(x, anchor, mesh: Mesh):
    if mesh.shape["tile"] == 1:
        return x
    return _SumTiles.apply(x, anchor, mesh)


def _world_reduce_(tensors: list, mesh: Mesh, op=dist.ReduceOp.SUM):
    """Reduce same-dtype tensors over the whole mesh, in place, as one
    flat buffer (nothing at world size 1)."""
    if mesh.size == 1 or not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, op=op)
    for t, part in zip(tensors, torch.split(flat, [t.numel()
                                                   for t in tensors])):
        t.copy_(part.view_as(t))


def _local_composite(params: G.GaussianParams, alive, sh_degree: int,
                     views: list, bg, config: RasterConfig, mesh: Mesh,
                     ndc_offset=None):
    """Per rank: preprocess ``views`` one by one and bin them in one sort,
    composite this rank's tile rows of each (the grid padded to whole tile
    rows a rank), and gather colour and depth over the tile axis. Returns
    (colors [H,W,3] and depths [H,W] a view, the local feature tiles
    [t_loc,P,F] a view, aux, meta); aux holds the union of visibility, the
    largest radii, the largest per-camera instance count and tile list."""
    grid = config.grid(views[0].width, views[0].height)
    n_tile, ti = mesh.shape["tile"], mesh.tile_index
    n, n_cams, n_tiles = params.xyz.shape[0], len(views), grid.num_tiles
    opacity = torch.where(alive, G.get_opacity(params),
                          torch.zeros((), device=params.xyz.device))
    ci = composite_inputs_batch(
        params.xyz, opacity, G.get_semantic(params), views,
        scales=G.get_scaling(params), rotations=G.get_rotation(params),
        shs=G.get_features(params), sh_degree=sh_degree,
        ndc_offset=ndc_offset, active_mask=alive, config=config)
    rows_loc = -(-grid.grid_y // n_tile)
    t_loc = rows_loc * grid.grid_x
    r0 = min(ti * rows_loc, grid.grid_y)
    r1 = min(r0 + rows_loc, grid.grid_y)
    mine = (r1 - r0) * grid.grid_x          # real tiles of this rank a view
    # this rank's tiles of each camera in the stacked grids; neighbours
    # merge, so a tile axis of 1 composites every camera in one launch
    ranges = []
    for c in range(n_cams * bool(mine)):
        lo = c * n_tiles + r0 * grid.grid_x
        if ranges and ranges[-1][1] == lo:
            ranges[-1] = (ranges[-1][0], lo + mine)
        else:
            ranges.append((lo, lo + mine))
    lists = ci.args[6:9]
    if ranges == [(0, lists[1].shape[0])]:
        parts = [lists]                     # the whole lists: no host read
    else:
        parts = tile_slices(*lists, ranges)
    outs = [composite((*ci.args[:6], *part, grid), config, tile_base=t0,
                      n_per_camera=n)
            for (t0, _), part in zip(ranges, parts)]

    anchor = ci.args[0]
    p, f_dim = grid.pixels_per_tile, ci.args[5].shape[-1]

    def local_tiles(c, k, shape, fill):
        """Camera c's tiles of field k on this rank, padded to t_loc with
        empty tiles (which composite nothing: T stays 1)."""
        got = []
        if mine:
            lo = c * n_tiles + r0 * grid.grid_x
            (t0, _), out = next((r, o) for r, o in zip(ranges, outs)
                                if r[0] <= lo < r[1])
            got.append(getattr(out, k)[lo - t0:lo - t0 + mine])
        got.append(torch.full((t_loc - mine, p) + shape, fill,
                              dtype=torch.float32, device=anchor.device))
        return torch.cat(got)

    colors, depths, features = [], [], []
    for c in range(n_cams):
        color_l = (local_tiles(c, "color", (3,), 0.0)
                   + local_tiles(c, "final_T", (), 1.0)[..., None] * bg)
        depth_l = local_tiles(c, "depth", (), 0.0)
        colors.append(tiles_to_image(
            _gather_tiles(color_l, anchor, mesh)[:n_tiles], grid))
        depths.append(tiles_to_image(
            _gather_tiles(depth_l, anchor, mesh)[:n_tiles], grid))
        features.append(local_tiles(c, "feature", (f_dim,), 0.0))

    valid = ci.valid
    radii = torch.where(valid, ci.pre.radius, torch.zeros_like(ci.pre.radius))
    counts = ci.bins.tile_counts
    aux = {"radii": radii.amax(0), "visibility": (radii > 0).any(0),
           "total_instances": ci.bins.total.amax(),
           "max_tile_count": (counts.amax() if counts.numel() else
                              torch.zeros((), dtype=torch.int32,
                                          device=anchor.device))}
    meta = {"row0": ti * rows_loc, "rows_loc": rows_loc,
            "gy_pad": n_tile * rows_loc, "grid": grid, "anchor": anchor}
    return colors, features, depths, aux, meta


def rasterize_tile_sharded(params: G.GaussianParams, state: G.GaussianState,
                           cam: CameraView, *, bg, config: RasterConfig,
                           mesh: Mesh) -> dict:
    """One camera rendered with its tile grid sharded over the mesh's tile
    axis (and computed alike on every data row): {"color" [H,W,3],
    "feature" [H,W,F], "depth" [H,W]} on every rank. Differentiable."""
    colors, features, depths, _, meta = _local_composite(
        params, state.alive, state.active_sh_degree, [cam], bg, config, mesh)
    grid = meta["grid"]
    feature = _gather_tiles(features[0], meta["anchor"],
                            mesh)[:grid.num_tiles]
    return {"color": colors[0], "feature": tiles_to_image(feature, grid),
            "depth": depths[0]}


def stack_cameras(cams: Sequence[CameraView]) -> CameraView:
    """Same-resolution CameraViews as one CameraView whose tensors carry a
    leading [B] (what ``sharded_train_step`` and ``rasterize_batch``
    take)."""
    stack = lambda xs: torch.stack([torch.as_tensor(x) for x in xs])
    return CameraView(view=stack([c.view for c in cams]),
                      proj=stack([c.proj for c in cams]),
                      campos=stack([c.campos for c in cams]),
                      tan_fovx=stack([c.tan_fovx for c in cams]),
                      tan_fovy=stack([c.tan_fovy for c in cams]),
                      width=cams[0].width, height=cams[0].height)


def sharded_train_step(ts, cams, gt_images, gt_features, bg, iteration, *,
                       mesh: Mesh, ocfg, rcfg: RasterConfig,
                       speedup: bool = False, shard_gaussians: bool = False,
                       shard_instances: bool = False) -> dict:
    """One data x tile training step over a batch of B cameras: the mesh
    counterpart of ``train.trainer.train_step``, with its contract (``ts``
    updated in place, a dict of scalar tensors back, no host sync on one
    card).

    ``cams``: B same-resolution CameraViews (a list or ``stack_cameras``);
    ``gt_images`` [B,H,W,3] and ``gt_features`` [B,h,w,F] (or sequences of
    B maps; fp16 teacher maps are upcast); ``iteration``: the span of B
    1-based iterations the step counts as (a scalar for B = 1), over which
    ``group_lrs`` sums each learning rate. Every rank passes the whole
    batch; data row d trains cameras [d * B/D, (d + 1) * B/D).

    The loss is the mean over the B cameras of the reference's
    per-iteration loss; gradients are summed over the mesh and Adam runs
    once. Densification statistics take the union of visibility, the
    largest radii and the summed NDC gradients of the batch. A non-finite
    loss discards the whole update on the device."""
    for flag, on in (("shard_gaussians", shard_gaussians),
                     ("shard_instances", shard_instances)):
        if on:
            raise NotImplementedError(NOT_PORTED.format(flag))
    views = _views(cams)
    b, n_data, n_tile = len(views), mesh.shape["data"], mesh.shape["tile"]
    if b % n_data:
        raise ValueError(f"camera batch {b} not divisible by the data axis "
                         f"{n_data}")
    b_loc = b // n_data
    mine = range(mesh.data_index * b_loc, (mesh.data_index + 1) * b_loc)
    params, gstate = ts.params, ts.gstate
    leaves = G.GaussianParams(**{k: getattr(params, k).detach().requires_grad_()
                                 for k in G.GaussianParams.FIELDS})
    ndc_offset = torch.zeros((params.capacity, 2), dtype=torch.float32,
                             device=params.xyz.device, requires_grad=True)
    dec = None
    if speedup:
        dec = {k: v.detach().requires_grad_() for k, v in ts.decoder.items()}

    colors, features, _, aux, meta = _local_composite(
        leaves, gstate.alive, gstate.active_sh_degree,
        [views[i] for i in mine], bg, rcfg, mesh, ndc_offset)
    total = 0.0
    sums = []
    for color, feature, i in zip(colors, features, mine):
        gt_feature = gt_features[i]
        rgb_term, ll1 = L.rgb_loss(color, gt_images[i], ocfg.lambda_dssim)
        # this rank's share of the resized map, summed over the tile axis:
        # the small resized map crosses ranks, not the feature tiles
        fmap = _sum_tiles(L.resize_bilinear_from_tile_rows(
            feature, meta["grid"], gt_feature.shape[0], gt_feature.shape[1],
            meta["row0"], meta["rows_loc"], meta["gy_pad"]),
            meta["anchor"], mesh)
        if speedup:
            fmap = apply_decoder(dec, fmap)
        ll1_feat = L.l1_loss(fmap, gt_feature.to(torch.float32))
        total = total + rgb_term + ocfg.feature_loss_weight * ll1_feat
        with torch.no_grad():
            sums.append(torch.stack([
                ll1, ll1_feat, L.psnr(torch.clamp(color, 0, 1),
                                      torch.clamp(gt_images[i], 0, 1))]))
    # the tile axis computes each camera's loss n_tile times: the world sum
    # of these is the mean over the batch, and each slice's cotangent sums
    # back to exactly one share
    norm = 1.0 / (b * n_tile)
    local = total * norm
    inputs = [getattr(leaves, k) for k in G.GaussianParams.FIELDS] + [ndc_offset]
    if speedup:
        inputs += [dec["w"], dec["b"]]
    grads = torch.autograd.grad(local, inputs, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for x, g in zip(inputs, grads)]
    scalars = torch.cat([local.detach()[None], torch.stack(sums).sum(0) * norm])
    return _apply_step_tail(ts, grads, scalars, aux, iteration, mesh=mesh,
                            ocfg=ocfg, speedup=speedup)


@torch.no_grad()
def _apply_step_tail(ts, grads: list, scalars, aux: dict, iteration, *,
                     mesh: Mesh, ocfg, speedup: bool) -> dict:
    """The step's tail: world sums of the gradients and of [loss, l1,
    l1_feature, psnr], the densification statistics' maxima, one Adam
    update over the iteration span, the statistics fold and the metrics;
    every update gated on a finite loss."""
    params, gstate = ts.params, ts.gstate
    _world_reduce_(grads + [scalars], mesh)
    vis_rad = torch.stack([aux["visibility"].to(torch.float32), aux["radii"]])
    counts = torch.stack([aux["total_instances"].long(),
                          aux["max_tile_count"].long()])
    _world_reduce_([vis_rad], mesh, dist.ReduceOp.MAX)
    _world_reduce_([counts], mesh, dist.ReduceOp.MAX)
    n_fields = len(G.GaussianParams.FIELDS)
    g_params = G.GaussianParams(*grads[:n_fields])
    loss = scalars[0]
    finite = torch.isfinite(loss)
    optim.adam_update(params, g_params, ts.adam,
                      optim.group_lrs(ocfg.lr, iteration,
                                      gstate.spatial_lr_scale),
                      keep=finite)
    if speedup:
        optim.tensor_adam_update(ts.decoder, dict(w=grads[-2], b=grads[-1]),
                                 ts.decoder_adam, lr=1e-4, keep=finite)
    density.add_densification_stats(gstate, grads[n_fields], vis_rad[0] > 0,
                                    vis_rad[1], keep=finite)
    return {"finite": finite, "loss": loss, "l1": scalars[1],
            "l1_feature": scalars[2], "psnr": scalars[3],
            "num_instances": counts[0], "max_tile_count": counts[1],
            "num_active": gstate.alive.sum()}

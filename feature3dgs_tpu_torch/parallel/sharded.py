"""Several cameras a step, on one card or a mesh of cards, over
``torch.distributed``.

Port of ``feature3dgs_tpu/parallel/sharded.py``:

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

Two options spread the Gaussians themselves (port of the JAX package's
``shard_gaussians`` and ``shard_instances``):
  * ``shard_gaussians``: each rank holds 1/D of the rows of the
    parameters, Adam moments and densification statistics
    (``shard_state`` / ``gather_state``). The render all-gathers the rows
    over the whole world (``_GatherRows``) and the backward reduce-scatters
    the gradients, so Adam and the statistics run on the rank's rows;
  * ``shard_instances``: the tile-owner instance exchange
    (``_exchange_losses``): each rank preprocesses and expands only its
    rows, one ``all_to_all_single`` hands every (tile, depth, id) instance
    to the rank that composites its tile, and that rank sorts what it
    received and composites only its tiles, through both kernels.

A mesh over a world of one process holds no process group, and every
collective here is then the identity: the one-card path runs none.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.distributed as dist

from feature3dgs_tpu_torch.core.projection import CameraView
from feature3dgs_tpu_torch.model import optim
from feature3dgs_tpu_torch.model import gaussians as G
from feature3dgs_tpu_torch.model.decoder import apply_decoder
from feature3dgs_tpu_torch.ops.binning import (expand_instances,
                                               sort_instances, tile_slices)
from feature3dgs_tpu_torch.ops.rasterize import (RasterConfig, _prep_view,
                                                 _views, composite,
                                                 composite_inputs_batch,
                                                 tiles_to_image)
from feature3dgs_tpu_torch.train import losses as L
from feature3dgs_tpu_torch.train.trainer import (TrainState, step_grads,
                                                 step_leaves, step_update)


class Mesh:
    """A ("data", "tile") mesh over the ``torch.distributed`` world, or over
    the ranks ``ranks`` of it (in mesh order; the JAX package's ``devices``
    argument): mesh rank r sits at (r // n_tile, r % n_tile), as the JAX
    package reshapes its device list. ``shape`` maps each axis name to its
    size. The ranks of one data row share a tile-axis process group, and a
    mesh over part of the world has a group of its own (``group``; None is
    the whole world). Building one is a collective: every rank of the world
    builds it, with the same arguments, members or not (``member``). A
    mesh of one rank holds no process group at all.

    A process group orders its members by global rank, whatever order
    ``ranks`` has, and so do the blocks of its collectives. ``order`` and
    ``tile_order`` hold the group position of each mesh rank of ``group``
    and of this rank's ``tile_group`` (None where the two orders agree, as
    for ascending ``ranks``); the collectives here put blocks back into
    mesh order with them, so blocks come out in mesh order as the JAX
    package's do."""

    def __init__(self, shape: Sequence[int],
                 ranks: Sequence[int] | None = None):
        if len(shape) != 2:
            raise ValueError(f"a mesh has the axes ('data', 'tile'), got a "
                             f"shape of {len(shape)}: {tuple(shape)}")
        n_data, n_tile = (int(x) for x in shape)
        world = dist.get_world_size() if dist.is_initialized() else 1
        if ranks is None:
            ranks = list(range(world))
            if n_data < 1 or n_tile < 1 or n_data * n_tile != world:
                raise ValueError(f"mesh shape ({n_data}, {n_tile}) needs a "
                                 f"world size of {n_data * n_tile}, this one "
                                 f"has {world}")
        ranks = [int(r) for r in ranks]
        if (n_data < 1 or n_tile < 1 or n_data * n_tile != len(ranks)
                or len(set(ranks)) != len(ranks)
                or not all(0 <= r < world for r in ranks)):
            raise ValueError(f"mesh shape ({n_data}, {n_tile}) needs "
                             f"{n_data * n_tile} distinct ranks of a world of "
                             f"{world}, got {ranks}")
        self.shape = {"data": n_data, "tile": n_tile}
        self.size = len(ranks)
        me = dist.get_rank() if world > 1 else 0
        self.member = me in ranks
        self.rank = ranks.index(me) if self.member else -1
        self.data_index, self.tile_index = divmod(max(self.rank, 0), n_tile)
        self.group = self.tile_group = None
        self.order = self.tile_order = None
        if self.size > 1:
            self.order = _group_positions(ranks)
            # every rank of the world creates every group, in the same order
            if self.size < world:
                self.group = dist.new_group(ranks)
            for d in range(n_data):
                row = ranks[d * n_tile:(d + 1) * n_tile]
                group = dist.new_group(row)
                if self.member and d == self.data_index:
                    self.tile_group = group
                    self.tile_order = _group_positions(row)

    def __repr__(self):
        return (f"Mesh(data={self.shape['data']}, tile={self.shape['tile']}, "
                f"rank={self.rank})")


def _group_positions(members: list) -> list | None:
    """Each member's position in a process group of ``members`` (which
    sorts them), or None where that is their own order."""
    pos = [sorted(members).index(r) for r in members]
    return None if pos == sorted(pos) else pos


def _mesh_blocks(x, order):
    """The equal blocks of ``x`` along dim 0, as a group's collective
    delivers them (by group position), in mesh order."""
    if order is None:
        return x
    parts = x.tensor_split(len(order))
    return torch.cat([parts[i] for i in order])


def _group_blocks(x, order):
    """The inverse of ``_mesh_blocks``: mesh-ordered blocks put into group
    order, as a split collective hands them out."""
    if order is None:
        return x
    parts = x.tensor_split(len(order))
    return torch.cat([parts[m] for m in sorted(range(len(order)),
                                               key=order.__getitem__)])


def make_mesh(shape: Sequence[int] | None = None,
              ranks: Sequence[int] | None = None) -> Mesh:
    """A ("data", "tile") mesh over the current world, or over its ``ranks``
    (default shape: every rank on the data axis). Call
    ``parallel.distributed.initialize`` first when the world has more than
    one process."""
    if shape is None:
        shape = (len(ranks) if ranks is not None else
                 dist.get_world_size() if dist.is_initialized() else 1, 1)
    return Mesh(shape, ranks)


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
        order = mesh.tile_order or range(len(parts))
        return torch.cat([parts[i] for i in order])

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


class _GatherRows(torch.autograd.Function):
    """all_gather over the mesh, in mesh-rank order (the JAX package's
    flat index data_index * n_tile + tile_index), concatenated along dim 0.
    Backward: a reduce-scatter with a sum, so each rank gets the sum of
    every rank's cotangent of its own rows: the transpose of the gather."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        x = x.contiguous()
        out = x.new_empty((mesh.size * x.shape[0],) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x, group=mesh.group)
        return _mesh_blocks(out, mesh.order)

    @staticmethod
    def backward(ctx, g):
        g = _group_blocks(g.contiguous(), ctx.mesh.order)
        out = g.new_empty((g.shape[0] // ctx.mesh.size,) + tuple(g.shape[1:]))
        dist.reduce_scatter_tensor(out, g, group=ctx.mesh.group)
        return out, None


def _gather_rows(x, mesh: Mesh):
    if mesh.size == 1:
        return x
    return _GatherRows.apply(x, mesh)


def _gather_params(leaves: G.GaussianParams, alive, ndc_offset, mesh: Mesh):
    """Every rank's rows of the parameters, ``alive`` and ``ndc_offset``,
    in one ``_GatherRows`` of their columns side by side: the gradients of
    the parameters and of the NDC offset (the densification statistics'
    input) come back to this rank's rows from its backward."""
    if mesh.size == 1:
        return leaves, alive, ndc_offset
    n_loc = alive.shape[0]
    parts = [getattr(leaves, k).reshape(n_loc, -1)
             for k in G.GaussianParams.FIELDS]
    parts += [ndc_offset, alive.to(torch.float32)[:, None]]
    full = torch.split(_gather_rows(torch.cat(parts, 1), mesh),
                       [x.shape[1] for x in parts], 1)
    cap = full[0].shape[0]
    params = G.GaussianParams(**{
        k: x.reshape((cap,) + tuple(getattr(leaves, k).shape[1:]))
        for k, x in zip(G.GaussianParams.FIELDS, full)})
    return params, full[-1][:, 0] > 0.5, full[-2]


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
    dist.all_reduce(flat, op=op, group=mesh.group)
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
    batch of cameras; data row d trains cameras [d * B/D, (d + 1) * B/D),
    and only those entries of the ground truth are read (the others may be
    None).

    The loss is the mean over the B cameras of the reference's
    per-iteration loss; gradients are summed over the mesh and Adam runs
    once. Densification statistics take the union of visibility, the
    largest radii and the summed NDC gradients of the batch. A non-finite
    loss discards the whole update on the device.

    ``shard_gaussians``: ``ts`` holds this rank's row shard
    (``shard_state``): every rank of the world its own equal block of the
    parameters, Adam moments and densification statistics, in rank order.
    The render all-gathers the rows (``_GatherRows``, whose backward
    reduce-scatters the gradients back to their rows), and Adam and the
    statistics run on the shard. ``shard_instances`` (needs
    ``shard_gaussians``): the tile-owner instance exchange of
    ``_exchange_losses`` in place of the gathered render."""
    views = _views(cams)
    b, n_data, n_tile = len(views), mesh.shape["data"], mesh.shape["tile"]
    if b % n_data:
        raise ValueError(f"camera batch {b} not divisible by the data axis "
                         f"{n_data}")
    if shard_instances and not shard_gaussians:
        raise ValueError(
            "shard_instances requires shard_gaussians: the instance "
            "exchange only makes sense when Gaussian rows are "
            "row-sharded over the mesh")
    b_loc = b // n_data
    mine = range(mesh.data_index * b_loc, (mesh.data_index + 1) * b_loc)
    gstate = ts.gstate
    leaves, ndc_offset, dec = step_leaves(ts, speedup)

    if shard_instances:
        total, sums, aux = _exchange_losses(
            leaves, gstate.alive, gstate.active_sh_degree, ndc_offset, views,
            gt_images, gt_features, bg, mesh, ocfg, rcfg, dec)
    else:
        full, alive, offset = leaves, gstate.alive, ndc_offset
        if shard_gaussians:
            full, alive, offset = _gather_params(leaves, alive, ndc_offset,
                                                 mesh)
        colors, features, _, aux, meta = _local_composite(
            full, alive, gstate.active_sh_degree, [views[i] for i in mine],
            bg, rcfg, mesh, offset)
        total, sums = 0.0, []
        for color, feature, i in zip(colors, features, mine):
            term, s = _camera_loss(color, feature, gt_images[i],
                                   gt_features[i], meta, mesh, ocfg, dec)
            total = total + term
            sums.append(s)
    # the tile axis computes each camera's loss n_tile times: the world sum
    # of these is the mean over the batch, and each slice's cotangent sums
    # back to exactly one share
    norm = 1.0 / (b * n_tile)
    local = total * norm
    grads = step_grads(local, leaves, ndc_offset, dec)
    scalars = torch.cat([local.detach()[None], torch.stack(sums).sum(0) * norm])
    return _apply_step_tail(ts, grads, scalars, aux, iteration, mesh=mesh,
                            ocfg=ocfg, speedup=speedup,
                            shard_gaussians=shard_gaussians)


def _camera_loss(color, feature_local, gt_image, gt_feature, meta: dict,
                 mesh: Mesh, ocfg, dec):
    """One camera's reference loss from its gathered colour and this rank's
    feature tiles, and its [l1, l1_feature, psnr] (no grad)."""
    rgb_term, ll1 = L.rgb_loss(color, gt_image, ocfg.lambda_dssim)
    # this rank's share of the resized map, summed over the tile axis: the
    # small resized map crosses ranks, not the feature tiles
    fmap = _sum_tiles(L.resize_bilinear_from_tile_rows(
        feature_local, meta["grid"], gt_feature.shape[0], gt_feature.shape[1],
        meta["row0"], meta["rows_loc"], meta["gy_pad"]), meta["anchor"], mesh)
    if dec is not None:
        fmap = apply_decoder(dec, fmap)
    ll1_feat = L.l1_loss(fmap, gt_feature.to(torch.float32))
    with torch.no_grad():
        s = torch.stack([ll1, ll1_feat, L.psnr(torch.clamp(color, 0, 1),
                                               torch.clamp(gt_image, 0, 1))])
    return rgb_term + ocfg.feature_loss_weight * ll1_feat, s


def _route(dest, tile, depth, gid, cap_pair: int, mesh: Mesh):
    """Send each instance to rank ``dest``: a stable sort by destination
    keeps each (source, destination) pair's instances in expansion order,
    the first ``cap_pair`` of each pair go into its slots of a [D *
    cap_pair, 3] int32 buffer (global tile, the depth's float bits, global
    id; unused slots carry id -1), and one ``all_to_all_single`` delivers
    every source's slots to their owner. Returns (received [D * cap_pair,
    3], the largest number of instances a pair dropped)."""
    d_tot = mesh.size
    dest_s, order = torch.sort(dest, stable=True)
    cnt = torch.bincount(dest, minlength=d_tot)
    j = (torch.arange(dest.shape[0], device=dest.device)
         - (torch.cumsum(cnt, 0) - cnt)[dest_s])
    take = j < cap_pair
    order = order[take]
    stage = torch.tensor([0, _INF_BITS, -1], dtype=torch.int32,
                         device=dest.device).repeat(d_tot * cap_pair, 1)
    stage[(dest_s * cap_pair + j)[take]] = torch.stack([
        tile[order].to(torch.int32),
        depth[order].to(torch.float32).contiguous().view(torch.int32),
        gid[order].to(torch.int32)], 1)
    recv = stage
    if d_tot > 1:
        recv = torch.empty_like(stage)
        dist.all_to_all_single(recv, _group_blocks(stage, mesh.order),
                               group=mesh.group)
        recv = _mesh_blocks(recv, mesh.order)
    return recv, (cnt - cap_pair).clamp_min(0).amax()


# float bits of +inf: the depth of an unused exchange slot
_INF_BITS = 0x7F800000


# the exchange's slots over the instance capacity (the JAX package's slack)
EXCHANGE_SLACK = 2.0


def exchange_capacities(instance_capacity: int,
                        mesh: Mesh) -> tuple[int, int]:
    """The instance exchange's slots, as the JAX package sizes them: (a
    source rank's expansion slots a camera, a multiple of 128; slots a
    (source, destination) pair, a multiple of 8)."""
    d_tot, n_tile = mesh.size, mesh.shape["tile"]
    need = int(EXCHANGE_SLACK * instance_capacity)
    return (-(-need // (128 * d_tot)) * 128,
            -(-need // (8 * n_tile * d_tot)) * 8)


def _exchange_losses(leaves: G.GaussianParams, alive, sh_degree: int,
                     ndc_offset, views: list, gt_images, gt_features, bg,
                     mesh: Mesh, ocfg, rcfg: RasterConfig, dec):
    """The tile-owner instance exchange (port of
    ``feature3dgs_tpu/parallel/sharded.py:_make_exchange_loss_fn``): per
    rank, which holds 1/D of the Gaussian rows, and per batch position i,

      1. preprocess only its own rows for the camera of position i of every
         data row (the preprocess work spreads over all D ranks);
      2. gather the per-camera table [cap, n_data, 10] (xy, conic,
         opacity, rgb, depth) and the features [cap, F] with
         ``_GatherRows`` (their backward reduce-scatters the gradients, so
         they come back to their rows);
      3. expand its rows into (tile, depth, id) instances, at most
         ``l_src`` a camera;
      4. route each instance to the rank that owns its tile rows of its
         camera, data row r and tile rank tile // t_loc, at most
         ``cap_pair`` a (source, destination) pair, with one
         ``all_to_all_single``;
      5. sort what it received (``ops.binning.sort_instances``) and
         composite its real tiles with ``composite(..., tile_base)``.

    Instances arrive in rank order and, from one rank, in expansion order,
    so the stable sort gives each tile the list of the single sort. A drop
    at the source expansion or in a pair forces ``num_instances`` up to
    the instance capacity, so the trainer's growth logic fires. The three
    fields travel as int32 (the depth as its float bits), so ids need no
    float-exact range. Returns (the loss sum of this rank's cameras, their
    [l1, l1_feature, psnr] rows, aux with this rank's rows of visibility
    and radii)."""
    n_data, n_tile = mesh.shape["data"], mesh.shape["tile"]
    di, ti = mesh.data_index, mesh.tile_index
    b_loc = len(views) // n_data
    grid = rcfg.grid(views[0].width, views[0].height)
    t_true = grid.num_tiles
    rows_loc = -(-grid.grid_y // n_tile)
    t_loc = rows_loc * grid.grid_x
    r0 = min(ti * rows_loc, grid.grid_y)
    mine = (min(r0 + rows_loc, grid.grid_y) - r0) * grid.grid_x
    i_cap = rcfg.instance_capacity_or_default
    l_src, cap_pair = exchange_capacities(i_cap, mesh)
    n_loc = alive.shape[0]
    row0 = mesh.rank * n_loc
    dev = alive.device
    p, f_dim = grid.pixels_per_tile, leaves.semantic_feature.shape[-1]

    feat_full = _gather_rows(G.get_semantic(leaves), mesh)
    opacity = torch.where(alive, G.get_opacity(leaves),
                          torch.zeros((), device=dev))
    scales, rots, shs = (G.get_scaling(leaves), G.get_rotation(leaves),
                         G.get_features(leaves))
    vis = torch.zeros(n_loc, dtype=torch.bool, device=dev)
    rad = torch.zeros(n_loc, dtype=torch.float32, device=dev)
    dropped = torch.zeros((), dtype=torch.long, device=dev)
    mtc = torch.zeros((), dtype=torch.long, device=dev)
    totals, total, sums = [], 0.0, []
    for i in range(b_loc):
        preps = [_prep_view(
            leaves.xyz, opacity, views[r * b_loc + i], grid, scales=scales,
            rotations=rots, cov3d_precomp=None, shs=shs, sh_degree=sh_degree,
            colors_precomp=None, scale_modifier=1.0, ndc_offset=ndc_offset,
            active_mask=alive, config=rcfg) for r in range(n_data)]
        misc = _gather_rows(torch.stack([torch.cat(
            [xy, pre.conic, pre.opacity[:, None], pre.rgb, pre.depth[:, None]],
            1) for pre, xy, _, _, _ in preps], 1), mesh)  # [cap, n_data, 10]
        valid = torch.stack([v for *_, v in preps])
        radius = torch.stack([pre.radius for pre, *_ in preps])
        with torch.no_grad():
            row, tile, _, tot = expand_instances(
                torch.stack([q[2] for q in preps]),
                torch.stack([q[3] for q in preps]), valid, grid,
                instance_capacity=l_src)
            cam = row // max(n_loc, 1)
            tile = tile - cam * t_true
            depth = torch.stack([pre.depth for pre, *_ in preps]).reshape(-1)
            recv, drop = _route(cam * n_tile + tile // t_loc, tile, depth[row],
                                row - cam * n_loc + row0, cap_pair, mesh)
            ok = recv[:, 2] >= 0
            gid_sorted, starts, counts = sort_instances(
                torch.where(ok, recv[:, 0] - ti * t_loc, t_loc),
                recv[:, 1].contiguous().view(torch.float32), recv[:, 2],
                t_loc)
            totals.append(tot)
            dropped = torch.maximum(dropped, torch.maximum(
                drop, (tot - l_src).clamp_min(0).amax()))
            mtc = torch.maximum(mtc, counts.amax().long())
            vis = vis | ((radius > 0) & valid).any(0)
            rad = torch.maximum(rad, torch.where(
                valid, radius, torch.zeros_like(radius)).amax(0))
        xy, conic, opac, rgb, z = (x.contiguous() for x in torch.split(
            misc[:, di], [2, 3, 1, 3, 1], 1))
        args = (xy, conic, opac[:, 0], rgb, z[:, 0], feat_full.contiguous(),
                gid_sorted, starts[:mine], counts[:mine], grid)
        # only the rank's real tiles are composited (its last tile rows may
        # lie past the image); the rest are empty tiles, T = 1
        out = composite(args, rcfg, tile_base=ti * t_loc)

        def local(x, shape, fill):
            return torch.cat([x, torch.full((t_loc - mine, p) + shape, fill,
                                            dtype=torch.float32, device=dev)])

        color_l = (local(out.color, (3,), 0.0)
                   + local(out.final_T, (), 1.0)[..., None] * bg)
        color = tiles_to_image(_gather_tiles(color_l, xy, mesh)[:t_true],
                               grid)
        meta = {"row0": ti * rows_loc, "rows_loc": rows_loc,
                "gy_pad": n_tile * rows_loc, "grid": grid, "anchor": xy}
        k = di * b_loc + i
        term, s = _camera_loss(color, local(out.feature, (f_dim,), 0.0),
                               gt_images[k], gt_features[k], meta, mesh, ocfg,
                               dec)
        total = total + term
        sums.append(s)
    # every camera's true total is the sum of its sources' totals
    totals = torch.stack(totals)
    maxima = torch.stack([dropped, mtc])
    _world_reduce_([totals], mesh)
    _world_reduce_([maxima], mesh, dist.ReduceOp.MAX)
    n_inst = totals.amax()
    n_inst = torch.where(maxima[0] > 0, torch.clamp_min(n_inst, i_cap), n_inst)
    aux = {"radii": rad, "visibility": vis, "rows_local": True,
           "total_instances": n_inst, "max_tile_count": maxima[1]}
    return total, sums, aux


@torch.no_grad()
def _apply_step_tail(ts, grads: list, scalars, aux: dict, iteration, *,
                     mesh: Mesh, ocfg, speedup: bool,
                     shard_gaussians: bool = False) -> dict:
    """The step's tail: world sums of the gradients and of [loss, l1,
    l1_feature, psnr] and the densification statistics' maxima, then
    ``step_update`` over the iteration span gated on a finite loss, and
    the metrics. Under ``shard_gaussians`` the gradients of the rows came
    back summed from the gather's reduce-scatter, and the statistics are
    cut to this rank's rows."""
    n_fields = len(G.GaussianParams.FIELDS)
    _world_reduce_((grads[n_fields + 1:] if shard_gaussians else grads)
                   + [scalars], mesh)
    vis_rad = torch.stack([aux["visibility"].to(torch.float32), aux["radii"]])
    if not aux.get("rows_local"):
        _world_reduce_([vis_rad], mesh, dist.ReduceOp.MAX)
        n_loc = ts.params.capacity
        vis_rad = vis_rad[:, mesh.rank * n_loc:(mesh.rank + 1) * n_loc] \
            if shard_gaussians else vis_rad
    counts = torch.stack([aux["total_instances"].long(),
                          aux["max_tile_count"].long()])
    _world_reduce_([counts], mesh, dist.ReduceOp.MAX)
    loss = scalars[0]
    finite = torch.isfinite(loss)
    step_update(ts, grads, vis_rad[0] > 0, vis_rad[1], finite, iteration,
                ocfg=ocfg, speedup=speedup)
    active = ts.gstate.alive.sum()
    if shard_gaussians:
        active = active.reshape(1)
        _world_reduce_([active], mesh)
        active = active[0]
    return {"finite": finite, "loss": loss, "l1": scalars[1],
            "l1_feature": scalars[2], "psnr": scalars[3],
            "num_instances": counts[0], "max_tile_count": counts[1],
            "num_active": active}


# the row-leading tensors of a GaussianState
_STATE_ROWS = ("alive", "max_radii2d", "xyz_gradient_accum", "denom")


def _map_rows(ts, fn):
    """A TrainState whose row-leading tensors (parameters, Adam moments,
    the state's rows) are ``fn`` of ``ts``'s; the rest is shared."""
    rows = lambda p: G.GaussianParams(**{k: fn(getattr(p, k))
                                         for k in G.GaussianParams.FIELDS})
    adam = optim.AdamState(rows(ts.adam.mu), rows(ts.adam.nu), ts.adam.step)
    gstate = dataclasses.replace(ts.gstate, **{k: fn(getattr(ts.gstate, k))
                                               for k in _STATE_ROWS})
    return TrainState(params=rows(ts.params), gstate=gstate, adam=adam,
                      decoder=ts.decoder, decoder_adam=ts.decoder_adam)


def shard_state(ts, mesh: Mesh):
    """This rank's block of rows of a whole TrainState (every rank holds
    the same whole state): rows [rank * C/D, (rank + 1) * C/D) of the
    parameters, Adam moments and the state's rows, copied; the decoder, its
    Adam state and the Adam step are shared with ``ts`` (steps update them
    in place). The capacity C must be a multiple of the world size D."""
    cap, d = ts.params.capacity, mesh.size
    if cap % d:
        raise ValueError(f"capacity {cap} is not a multiple of the world "
                         f"size {d}: every rank holds an equal row shard "
                         "(round it up, as DistributedTrainer does)")
    lo, hi = mesh.rank * (cap // d), (mesh.rank + 1) * (cap // d)
    return _map_rows(ts, lambda x: x[lo:hi].clone())


def gather_state(ts, mesh: Mesh):
    """The whole TrainState from every rank's row shard, in rank order (a
    collective: every rank must call it)."""
    return _map_rows(ts, lambda x: _all_rows(x, mesh))


def _all_rows(x, mesh: Mesh):
    """Every rank's rows of ``x`` in mesh-rank order, without autograd (bool
    tensors travel as uint8)."""
    if mesh.size == 1:
        return x
    src = x.to(torch.uint8) if x.dtype == torch.bool else x.contiguous()
    out = src.new_empty((mesh.size * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, src, group=mesh.group)
    out = _mesh_blocks(out, mesh.order)
    return out.to(torch.bool) if x.dtype == torch.bool else out


"""The port's collectives keep mesh order when a mesh's ranks are not
ascending, as the JAX package's ``make_mesh(devices=...)`` keeps the order
of its devices (``feature3dgs_tpu/parallel/sharded.py:49-61``).

A process group sorts its members by global rank, so without the mesh's
permutations the blocks of every gather, reduce-scatter and all-to-all
over ``Mesh(..., ranks=[1, 0])`` came out in global-rank order. One spawn
of 2 gloo ranks on the CPU (``tests/torch_parallel_worker.py
mesh_order``) builds each mesh over ranks [0, 1] and over [1, 0]; every
case holds both to what mesh order means, so the ascending mesh is the
unchanged control."""
import os

import numpy as np
import pytest

from tests.test_torch_parallel_gloo import spawn_ranks
from tests.torch_parallel_worker import cotangent

ORDERS = {"up_": [0, 1], "down_": [1, 0]}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """What each of the 2 global ranks wrote, by global rank."""
    tmp = tmp_path_factory.mktemp("mesh_order")
    spawn_ranks(["mesh_order", str(tmp)], world=2)
    return [dict(np.load(os.path.join(tmp, f"order{r}.npz")))
            for r in range(2)]


def _by_mesh_rank(ranks, key, field="mesh_rank"):
    """(global rank of mesh rank m, its record) for m = 0, 1."""
    return sorted(((int(z[key + field]), g, z) for g, z in enumerate(ranks)),
                  key=lambda t: t[0])


def _summed_cotangent(shape):
    return sum(cotangent(g, shape).numpy() for g in range(2))


@pytest.mark.parametrize("key", sorted(ORDERS))
def test_row_shards_gather_back_in_mesh_order(ranks, key):
    """shard_state gives mesh rank m rows [2m, 2m + 2); gather_state
    (``_all_rows``) rebuilds rows 0-3 in order on every rank, bool rows
    included."""
    xyz = np.arange(12, dtype=np.float32).reshape(4, 3)
    for m, g, z in _by_mesh_rank(ranks, key):
        assert ORDERS[key][m] == g
        np.testing.assert_array_equal(z[key + "shard"], xyz[2 * m:2 * m + 2])
        np.testing.assert_array_equal(z[key + "gathered"], xyz)
        np.testing.assert_array_equal(z[key + "alive"],
                                      [True, False, True, True])


@pytest.mark.parametrize("key", sorted(ORDERS))
def test_gather_rows_and_its_reduce_scatter_follow_mesh_order(ranks, key):
    """``_GatherRows`` forward is every shard in mesh order; its backward,
    the reduce-scatter, gives mesh rank m the sum over both ranks of their
    cotangents' rows [2m, 2m + 2): the transpose of the gather."""
    xyz = np.arange(12, dtype=np.float32).reshape(4, 3)
    total = _summed_cotangent((4, 3))
    for m, _, z in _by_mesh_rank(ranks, key):
        np.testing.assert_array_equal(z[key + "gather_rows"], xyz)
        np.testing.assert_array_equal(z[key + "scatter_rows"],
                                      total[2 * m:2 * m + 2])


@pytest.mark.parametrize("key", sorted(ORDERS))
def test_exchange_route_follows_mesh_order(ranks, key):
    """``_route``'s all_to_all_single delivers to mesh rank d, in mesh
    order of the sources, the instance each source addressed to d (tile 10
    * source + d, id = source) and one unused slot a pair (id -1)."""
    for d, _, z in _by_mesh_rank(ranks, key):
        recv = z[key + "route"]
        assert recv.shape == (4, 3)
        np.testing.assert_array_equal(recv[:, 2], [0, -1, 1, -1])
        np.testing.assert_array_equal(recv[[0, 2], 0], [d, 10 + d])
        assert int(z[key + "route_dropped"]) == 0


@pytest.mark.parametrize("key", sorted(ORDERS))
def test_gather_tiles_follows_tile_order(ranks, key):
    """On a 1 x 2 mesh, ``_GatherTiles`` stacks tile rank 0's block then
    tile rank 1's on every rank, and its backward gives tile rank t the
    summed cotangents' rows [3t, 3t + 3)."""
    block = np.arange(6, dtype=np.float32).reshape(3, 2)
    want = np.concatenate([block, block + 100.0])
    total = _summed_cotangent((6, 2))
    for t, _, z in _by_mesh_rank(ranks, key, "tile_index"):
        np.testing.assert_array_equal(z[key + "gather_tiles"], want)
        np.testing.assert_array_equal(z[key + "scatter_tiles"],
                                      total[3 * t:3 * t + 3])

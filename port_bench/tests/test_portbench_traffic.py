"""The traffic generator: the same seed gives the same pool, every seed
the same sizes in another order, and the surface points lie on the
room's surfaces."""

import torch

from port_bench.lib import harness
from port_bench.tests._tiny import shrink
from port_bench.traffic import rooms

CPU = torch.device("cpu")


def _pool(workload, seed):
    cell = shrink(harness.Cell.load(workload, seed, 1.0, False, CPU))
    mode = "test" if cell.workload["mode"] == "test" else "train"
    return rooms.make_pool(cell.mix, cell.config, mode, seed, CPU, pin=False)


def _leaves(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        return [t for k in sorted(x) for t in _leaves(x[k])]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _leaves(v)]
    return [torch.tensor(x, dtype=torch.float64)]


def test_pool_is_the_seeds():
    for workload in ("scannet.train.room", "fcaf3d.train.room"):
        a, b = _pool(workload, 2 ** 31 + 11), _pool(workload, 2 ** 31 + 11)
        la, lb = _leaves(a), _leaves(b)
        assert len(la) == len(lb)
        assert all(torch.equal(x, y) for x, y in zip(la, lb))
        c = _leaves(_pool(workload, 12))
        assert not all(torch.equal(x, y) for x, y in zip(la, c)
                       if x.shape == y.shape)


def test_every_seed_gets_the_same_sizes():
    sizes = []
    for seed in (1, 2 ** 31 + 5, 3 * 10 ** 9):
        pool = _pool("scannet.test.room", seed)
        sizes.append(sorted((tuple(round(e, 6) for e in s["extent"]),
                             s["n_boxes"]) for s in pool))
    assert sizes[0] == sizes[1] == sizes[2]


def test_surface_points_lie_on_the_room():
    g = torch.Generator().manual_seed(3)
    extent = (5.0, 6.0, 2.7)
    boxes, _ = rooms._boxes(extent, 6, 18, g)
    pts = rooms.room_surface_points(extent, boxes, 4000, g)
    sdf = rooms.room_sdf(pts[:, 0], pts[:, 1], pts[:, 2], extent, boxes)
    # a point on a box face that lies inside another box is not on the
    # union's surface: most points are
    on = sdf.abs() < 1e-4
    assert float(on.float().mean()) > 0.9
    assert float(sdf.max()) < 1e-4


def test_planted_tsdf_has_a_surface_and_rises_into_it():
    extent = (4.0, 4.0, 2.4)
    boxes = torch.tensor([[2.0, 2.0, 0.5, 1.0, 1.0, 0.9, 0.0]])
    tsdf = rooms.room_tsdf((20, 20, 12), 0.2, extent, boxes, CPU)
    assert float(tsdf.min()) == -1.0 and float(tsdf.max()) == 1.0
    # the box's centre is inside (negative), the room's middle above it
    # is free space (positive)
    assert float(tsdf[10, 10, 2]) < 0 < float(tsdf[10, 10, 8])

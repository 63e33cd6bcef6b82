"""The yardstick's arithmetic on cases worked by hand: the kernels' bytes
and operations, the least time, the model FLOPs and the readers."""

import math
from types import SimpleNamespace

import pytest
import torch

from port_bench.lib import device as dv
from port_bench.lib import readers, work
from port_bench.reference.models.layers import Conv

# a view that sees voxel (x, y, z) at pixel (x, y), depth 1
EYE = torch.tensor([[1.0, 0, 0, 0], [0, 1.0, 0, 0], [0, 0, 0, 1.0]])
# a view that sees every voxel at pixel (0, 0)
ORIGIN = torch.tensor([[0.0, 0, 0, 0], [0, 0.0, 0, 0], [0, 0, 0, 1.0]])


def test_volume_work_one_view():
    # grid 2x1x1 at 1 m: voxel 0 -> pixel 0, voxel 1 -> pixel 1
    proj, vv = EYE[None], torch.ones(1, dtype=torch.bool)
    nbytes, ops = work.volume_work(proj, vv, (2, 1, 1), 1.0, (0, 0, 0), 1,
                                   2)
    # rows 2 x 32 x 4, projection 12 x 4, a view flag, volume 2 x 32 x 4,
    # count 2 x 4, mask 2
    assert nbytes == 256 + 48 + 1 + 256 + 8 + 2
    # 6 x 2 voxels, 21 x 2 voxel-views, 33 x 2 pairs, 32 x 2 observed
    assert ops == 12 + 42 + 66 + 64


def test_volume_work_counts_distinct_rows_and_pairs():
    proj = torch.stack([EYE, ORIGIN])
    vv = torch.ones(2, dtype=torch.bool)
    nbytes, ops = work.volume_work(proj, vv, (2, 1, 1), 1.0, (0, 0, 0), 1,
                                   2)
    # rows: 2 of view 0, 1 of view 1; both voxels seen twice
    assert nbytes == 3 * 128 + 96 + 2 + 256 + 8 + 2
    assert ops == 12 + 21 * 2 * 2 + 33 * 4 + 32 * 2
    # a view flagged invalid reads nothing and counts nothing
    vv[1] = False
    nbytes1, ops1 = work.volume_work(proj, vv, (2, 1, 1), 1.0, (0, 0, 0),
                                     1, 2)
    assert ops1 == 12 + 42 + 66 + 64
    assert nbytes1 == 256 + 96 + 2 + 256 + 8 + 2


def test_volume_bwd_work():
    proj, vv = EYE[None], torch.ones(1, dtype=torch.bool)
    nbytes, ops = work.volume_bwd_work(proj, vv, (2, 1, 1), 1.0, (0, 0, 0),
                                       1, 2)
    # cotangent 2 x 32 x 4, count 2 x 4, projection 48, flag 1, the
    # features' gradient 1 x 1 x 2 x 32 x 4
    assert nbytes == 256 + 8 + 48 + 1 + 256
    assert ops == 12 + 42 + 64 + 64


def test_ray_work_of_rays_that_hit_nothing():
    # an empty scene: every ray takes every coarse step and no fine one
    tsdf = -torch.ones(16, 16, 16)
    proj = torch.tensor([[[10.0, 0, 2, 0], [0, 10.0, 2, 0], [0, 0, 1, 1]]])
    vv = torch.ones(1, dtype=torch.bool)
    nbytes, ops = work.ray_work(proj, vv, tsdf, 0.1, (0, 0, 0), 4, 4,
                                n_samples=64, threshold=0.05, skip_factor=8,
                                window=16, coarse_step=8)
    n_coarse = 8
    assert ops == 15.0 * n_coarse * 16
    k_max = min(16, math.ceil(1 / 0.05))
    occ_bytes = 4        # a 2x2x2 occupancy grid packs into one 32-bit word
    assert nbytes == 12 + 16 * 12 + 1 + occ_bytes + 16 * (8 * k_max + 5)


def test_least_time_takes_the_larger_bound():
    assert dv.bound_s(3.35e12, 0.0) == pytest.approx(1.0)
    assert dv.bound_s(0.0, 67e12) == pytest.approx(1.0)
    assert dv.bound_s(3.35e12, 2 * 67e12) == pytest.approx(2.0)


class _Net(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.a = Conv(2, 4, 3)
        self.b = Conv(4, 8, 1)

    def forward(self, x):
        return self.b(self.a(x))


def test_dense_flops_forward_and_step():
    net, x = _Net(), torch.randn(1, 2, 5, 5)
    fwd_a, fwd_b = 2.0 * (4 * 25) * 2 * 9, 2.0 * (8 * 25) * 4
    c = work.FlopCounter()
    with c.counting(net):
        net(x)
    assert c.total == fwd_a + fwd_b
    # a step: a's weight gradient (its input is the data), b's weight and
    # input gradients
    c = work.FlopCounter(backward=True)
    with c.counting(net):
        net(x)
    assert c.total == 2 * fwd_a + 3 * fwd_b
    # a frozen: a forward only, b's input gradient not needed either
    c = work.FlopCounter(backward=True, frozen=("a.",))
    with c.counting(net):
        net(x)
    assert c.total == fwd_a + 2 * fwd_b


def test_sparse_flops_count_the_found_pairs():
    from port_bench.reference.ops import sparse as sp
    feats = torch.randn(5, 3)
    weights = torch.randn(2, 3, 4)
    idx = torch.zeros(2, 5, dtype=torch.long)
    found = torch.tensor([[1, 1, 0, 0, 0], [1, 0, 0, 0, 1]], dtype=torch.bool)
    c = work.FlopCounter()
    with c.counting(torch.nn.Module()):
        sp.apply_sparse_conv(feats, weights, idx, found)
    assert c.total == 2.0 * 3 * 4 * 4


def _run(**kw):
    base = dict(n=4, window_s=2.0, marks={}, trace=None, work={},
                item_times=[])
    base.update(kw)
    return SimpleNamespace(**base)


class _Trace:
    def __init__(self, device, window_s):
        self.device, self.window_s = device, window_s

    busy_s = dv.Trace.busy_s
    kernel_s = dv.Trace.kernel_s


def test_busy_is_the_union_of_the_intervals():
    # microseconds: [0, 10], [5, 20] overlap; [30, 40] alone
    t = _Trace([(0.0, 10.0, "a"), (5.0, 20.0, "b"), (30.0, 40.0, "c")], 1.0)
    assert t.busy_s() == pytest.approx(30e-6)
    assert readers.idle_pct(_run(trace=_Trace(t.device, 60e-6))) == \
        pytest.approx(50.0)


def test_roofline_is_least_time_over_device_time():
    # 4 items whose least times sum to 1 ms, a launch an item; the trace
    # holds two launches of 1 ms each: 0.5 ms least over 2 ms taken
    t = _Trace([(0.0, 1000.0, "void volume_accum_kernel<float>(float*)"),
                (2000.0, 3000.0, "void volume_accum_kernel<float>(float*)"),
                (4000.0, 9000.0, "void volume_accum_bwd_kernel<float>()")],
               1.0)
    run = _run(trace=t, work={"volume_accum_kernel": 4 * 0.25e-3})
    assert readers.roofline_pct(run, "volume_accum_kernel") == \
        pytest.approx(25.0)
    # a kernel that did not run gives no number, never 0
    assert readers.roofline_pct(run, "ray_march_kernel") is None


def test_mfu_stage_and_percentile():
    run = _run(work={"flops": 67e12}, marks={"tower": 40.0},
               item_times=[0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9,
                           1.0])
    assert readers.mfu_pct(run) == pytest.approx(50.0)
    assert readers.stage_ms(run, "tower") == pytest.approx(10.0)
    assert readers.stage_ms(run, "detector") is None
    assert readers.p80_ms(run) == pytest.approx(1e3 * 0.88, rel=1e-9)

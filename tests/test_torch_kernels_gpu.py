"""The CUDA kernels of cnrma_torch against their plain torch versions, on
the card (``python -m pytest --noconftest -m gpu
tests/test_torch_kernels_gpu.py`` on a machine with an NVIDIA GPU and
nvcc).  Skipped where there is no CUDA device.

The two main-path kernels are built with ``--fmad=false`` and sum in the
same order as their plain versions, so ids, masks and counts must be equal;
volumes agree to fp32 rounding (1e-6 absolute on features in [0, 1]) and,
in bf16, to one bf16 ulp of the mean.  The probe kernels copy, gather or
multiply small integers, so they must equal their plain versions exactly.
"""

import math

import numpy as np
import pytest
import torch

from cnrma_torch.ops import backproject as bp
from cnrma_torch.ops import ray_marching as rm
from cnrma_torch.synthetic import ring_projections, sphere_tsdf
from cnrma_torch.tools import bp_probe, feature_probe, gather_probe

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("views,h,w,dim", [(3, 24, 32, (16, 16, 8)),
                                           (7, 60, 80, (48, 40, 24))])
def test_volume_kernel_matches_plain(cuda, dtype, views, h, w, dim):
    rng = np.random.RandomState(0)
    vs = 0.3          # the volume reaches past the frustums
    proj = ring_projections(views, 4 * h, 4 * w, dim, vs)
    proj[:, :2, :] /= 4
    feats = torch.from_numpy(rng.rand(views, h, w, 32).astype(np.float32))
    valid = torch.ones(views, dtype=torch.bool)
    valid[1] = False
    args = (torch.from_numpy(proj).to(cuda), feats.to(cuda, dtype),
            valid.to(cuda), dim, vs, (0.0, 0.0, 0.0))
    vol, cnt, ok = bp.volume_accum_cuda(*args)
    pvol, pcnt, pok = bp.volume_accum_plain(*args)
    torch.cuda.synchronize()
    assert ok.any() and not ok.all()
    assert torch.equal(ok, pok)
    assert torch.equal(cnt, pcnt)
    # fp32: rounding of the mean; bf16: one bf16 ulp of the mean
    tol = (1e-6 if dtype == torch.float32
           else 2.0 ** -7 * pvol.float().abs() + 1e-30)
    assert bool(((vol.float() - pvol.float()).abs() <= tol).all())


@pytest.mark.parametrize("views,h,w,dim,step", [(2, 24, 32, (64, 64, 32), 4),
                                                (3, 60, 80, (128, 96, 48), 8)])
def test_coarse_march_kernel_matches_plain(cuda, views, h, w, dim, step):
    vs = 0.04
    tsdf = sphere_tsdf(dim, vs, radius=0.3 * min(dim) * vs,
                       trunc=3 * vs).to(cuda)
    occ = rm.build_occupancy(tsdf, 8)
    proj = ring_projections(views, 4 * h, 4 * w, dim, vs)
    proj[:, :2, :] /= 4
    n_samples = 300
    t_one = math.sqrt(sum(n * n for n in dim)) * vs / n_samples
    n_coarse = (n_samples + step - 1) // step
    origin = torch.zeros(3, device=cuda)
    hits = 0
    for p in torch.from_numpy(proj).to(cuda):
        o, d = rm.get_ray_parameters(p, h, w)
        got = rm.coarse_march_cuda(o, d, occ, origin, t_one, step, n_coarse,
                                   8 * vs)
        want = rm.coarse_march_plain(o, d, occ, origin, t_one, step,
                                     n_coarse, 8 * vs)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0])
        assert torch.equal(got[1], want[1])
        hits += int(got[1].sum())
    assert 0 < hits < views * h * w


@pytest.mark.parametrize("xalign", [bp_probe.XALIGN, 1])
def test_rect_gather_kernel_matches_plain(cuda, xalign):
    s = dict(bp_probe.CHECK_SHAPE, K1=37, t3=200)
    featq, ryq0, rx0, code = bp_probe.synth(np.random.RandomState(0), **s,
                                            xalign=xalign)
    code[0, :3] = [-1, -(2 ** 31), 2 ** 30]        # invalid codes give 0
    args = (*bp_probe.to_device(cuda, featq, ryq0, rx0, code), s["Rhq"],
            s["Rw"])
    got = bp_probe.rect_gather_cuda(*args)
    want = bp_probe.rect_gather_plain(*args)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    assert got.abs().sum() > 0


def test_probe_kernels_refuse_wide_indices(cuda):
    """An int64 index above 2**31 is refused, not narrowed: narrowed, it
    would wrap into the table, where the plain version gives 0."""
    table = torch.zeros(4, 128, device=cuda)
    wide = torch.full((1, 128), 2 ** 31 + 5, dtype=torch.int64, device=cuda)
    assert not gather_probe.lane_gather_plain(table + 1, wide).any()
    with pytest.raises(TypeError, match="must be int32"):
        gather_probe.lane_gather_cuda(table, wide)
    with pytest.raises(TypeError, match="must be int32"):
        gather_probe.flat_gather_cuda(table, wide[0])


def test_gather_probe_kernels_match_plain(cuda):
    rows = 96
    rng = np.random.RandomState(0)
    flat, table2d, idx = gather_probe.tables(rng, cuda, rows, 1000 + 3)
    idx[:3] = torch.tensor([-1, rows * 128, 2 ** 31 - 1])    # out of range
    idx2d = gather_probe.lane_indices(rng, cuda, rows)[:77].clone()
    idx2d[0, :2] = torch.tensor([-5, rows])
    got = gather_probe.lane_gather_cuda(table2d, idx2d)
    assert torch.equal(got, gather_probe.lane_gather_plain(table2d, idx2d))
    got = gather_probe.flat_gather_cuda(flat, idx)
    assert torch.equal(got, gather_probe.flat_gather_plain(flat, idx))
    assert not got[:3].any()


@pytest.mark.parametrize("name", feature_probe.NAMES)
def test_feature_probe_kernel_matches_plain(cuda, name):
    args_k, want = feature_probe.probe_inputs(name, cuda)
    args_p, _ = feature_probe.probe_inputs(name, cuda)
    got, ref = feature_probe.KERNELS[name][0](*args_k), \
        feature_probe.KERNELS[name][1](*args_p)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    assert np.array_equal(got.cpu().numpy(), want)
    if name == "alias":
        assert got.data_ptr() == args_k[0].data_ptr()


def test_feature_probe_kernels_off_the_probe_shapes(cuda):
    """dot on integer matrices of other shapes (exact in fp32), onehot with
    indices outside the table and a table above 64 KB, dyn_slice with a
    start past the end (clamped), prefetch with a skipped id."""
    rng = np.random.RandomState(1)
    a = torch.from_numpy(rng.randint(-4, 5, (48, 64))).to(cuda, torch.bfloat16)
    b = torch.from_numpy(rng.randint(-4, 5, (64, 32))).to(cuda, torch.bfloat16)
    assert torch.equal(feature_probe.dot_cuda(a, b),
                       feature_probe.dot_plain(a, b))
    tab = torch.from_numpy(rng.randn(400, 128)).to(cuda, torch.bfloat16)
    idx = torch.from_numpy(rng.randint(-3, 403, 70).astype(np.int32)).to(cuda)
    assert torch.equal(feature_probe.onehot_cuda(idx, tab),
                       feature_probe.onehot_plain(idx, tab))
    x = torch.from_numpy(rng.randn(20, 64).astype(np.float32)).to(cuda)
    start = torch.tensor([17], dtype=torch.int32, device=cuda)
    assert torch.equal(feature_probe.dyn_slice_cuda(start, x, 8),
                       x[12:20])
    xb = x.reshape(5, 4, 64)
    tids = torch.tensor([4, 0, 7, 1, 2], dtype=torch.int32, device=cuda)
    assert torch.equal(feature_probe.prefetch_cuda(tids, xb),
                       feature_probe.prefetch_plain(tids, xb))
    assert torch.equal(feature_probe.dma_cuda(x, 3, 12), 2 * x[3:15])

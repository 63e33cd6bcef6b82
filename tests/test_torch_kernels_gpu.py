"""The two CUDA kernels of cnrma_torch against their plain torch versions,
on the card (``python -m pytest --noconftest -m gpu
tests/test_torch_kernels_gpu.py`` on a machine with an NVIDIA GPU and
nvcc).  Skipped where there is no CUDA device.

Both kernels are built with ``--fmad=false`` and sum in the same order as
their plain versions, so ids, masks and counts must be equal; volumes agree
to fp32 rounding (1e-6 absolute on features in [0, 1]) and, in bf16, to
one bf16 ulp of the mean.
"""

import math

import numpy as np
import pytest
import torch

from cnrma_torch.ops import backproject as bp
from cnrma_torch.ops import ray_marching as rm
from cnrma_torch.synthetic import ring_projections, sphere_tsdf

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

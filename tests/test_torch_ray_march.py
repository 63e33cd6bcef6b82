"""Parity of the port's NeuS ray marcher (``cnrma_torch/ops/
ray_marching.py``) with the JAX package, on the CPU.

The coarse pass is held against the JAX coarse pass with its Pallas lookup
kernel K2 in interpret mode; the scene-level march (all views at once, the
path whose CUDA kernel is ``csrc/ray_march.cu``) against the JAX
``ray_march_neus`` run per view.  Rays and samples are computed in fp32 by
both packages with ulp-level differences (a 4x4 inverse and a matmul), so
the comparisons mask what those ulps may flip (ROADMAP F6): rays with a
sample within 1e-4 of a voxel-rounding boundary, and kept samples whose
weight is within 1e-6 of the 0.05 threshold.  Everything else is exact
(ids, masks, kept sets) or within 1e-5 (weights, positions).
"""

import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnrma_torch.ops import ray_marching as trm
from cnrma_torch.synthetic import sphere_tsdf
from cnrma_tpu.ops import ray_marching as jrm
from _torch_threads import _few_threads  # noqa: F401

DIM, VS, H, W = (64, 64, 32), 0.04, 24, 32


def _camera(seed):
    """A view of the volume from outside its -y face."""
    rng = np.random.RandomState(seed)
    K = np.array([[20.0, 0, W / 2], [0, 20.0, H / 2], [0, 0, 1]], np.float32)
    E = np.eye(4, dtype=np.float32)          # camera-to-world, looking +y
    E[:3, 0] = [1, 0, 0]
    E[:3, 1] = [0, 0, -1]
    E[:3, 2] = [0, 1, 0]
    E[:3, 3] = [1.28 + rng.randn() * 0.1, -0.6, 0.64 + rng.randn() * 0.1]
    return (K @ np.linalg.inv(E)[:3]).astype(np.float32)


def _tsdf(seed, radius=0.7):
    rng = np.random.RandomState(seed)
    t = -sphere_tsdf(DIM, VS, radius=radius, trunc=3 * VS).numpy()
    return np.clip(t + rng.randn(*DIM).astype(np.float32) * 0.002, -1, 1)


def _near_boundary(o, d, ts, cell, tol=1e-4):
    """[HW] rays with a sample within ``tol`` of a .5 rounding boundary."""
    p = (o[None, None, :].astype(np.float64)
         + d[:, None, :].astype(np.float64) * ts[None, :, None]) / cell
    return (np.abs(np.abs(p - np.floor(p)) - 0.5) < tol).any(axis=(1, 2))


def test_ray_parameters():
    proj = _camera(0)
    jo, jd = jrm.get_ray_parameters(jnp.asarray(proj), H, W)
    to, td = trm.get_ray_parameters(torch.from_numpy(proj), H, W)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-5)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_build_occupancy_equal(seed):
    t = _tsdf(seed)
    want = np.asarray(jrm.build_occupancy(jnp.asarray(t), 8))
    got = trm.build_occupancy(torch.from_numpy(t), 8).numpy()
    assert 0 < want.mean() < 1
    np.testing.assert_array_equal(got, want)


def test_neus_weights():
    t = np.random.RandomState(0).uniform(-1, 1, (50, 48)).astype(np.float32)
    t = np.sort(t, axis=1)                 # rising TSDF: rays with weight
    want = np.asarray(jrm.neus_weights(jnp.asarray(t)))
    got = trm.neus_weights(torch.from_numpy(t)).numpy()
    assert (want > 0.05).any()
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("capacity", [64, 7])
def test_select_topk_slot_order(capacity):
    """Compact branch (all positives fit, index order) and ranked branch
    (over capacity, descending with ties to the lower index): equal."""
    w = np.zeros(40, np.float32)
    w[[3, 5, 9, 11, 17, 20, 21, 30, 33]] = [.2, .5, .2, .9, .5, .1, .5, .3,
                                           .2]
    want = np.asarray(jrm._select_topk(jnp.asarray(w), capacity))
    got = trm._select_topk(torch.from_numpy(w), capacity).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed,step", [(0, 8), (1, 4)])
def test_coarse_pass_matches_pallas_interpret(monkeypatch, seed, step):
    """The coarse march (the plain version the CUDA kernel equals) against
    the JAX coarse pass through the Pallas one-hot lookup in interpret
    mode; same rays in, so j0/has_hit are equal except on rays with a
    sample within 1e-4 of a coarse cell's rounding boundary."""
    monkeypatch.setenv("CNRMA_RAY_PALLAS", "interpret")
    occ = jrm.build_occupancy(jnp.asarray(_tsdf(seed, radius=0.3)), 8)
    o, d = jrm.get_ray_parameters(jnp.asarray(_camera(seed)), H, W)
    n_samples = 300
    t_one = math.sqrt(sum(n * n for n in DIM)) * VS / n_samples
    n_coarse = (n_samples + step - 1) // step
    cell = VS * 8
    n_rows = (occ.size + 127) // 128
    assert jrm._ray_pallas_decision(n_rows, H * W * n_coarse) == (True, True)
    tc = (jnp.arange(n_coarse, dtype=jnp.float32) * step + step * 0.5) * t_one
    places = o[None, None, :] + d[:, None, :] * tc[None, :, None]
    vals = jrm._sample_occupancy(occ, places.reshape(-1, 3),
                                 jnp.zeros(3, jnp.float32), cell)
    hit = np.asarray(vals).reshape(H * W, n_coarse) > 0.5
    j0, has_hit = trm.coarse_march_plain(
        torch.from_numpy(np.array(o)), torch.from_numpy(np.array(d)),
        torch.from_numpy(np.array(occ)), torch.zeros(3), t_one, step,
        n_coarse, cell)
    keep = ~_near_boundary(np.asarray(o), np.asarray(d), np.asarray(tc), cell)
    assert keep.mean() > 0.9 and 0 < hit.any(1).mean() < 1
    np.testing.assert_array_equal(has_hit.numpy()[keep], hit.any(1)[keep])
    np.testing.assert_array_equal(j0.numpy()[keep], hit.argmax(1)[keep])


def _points(pts, o, t_one):
    """{(u, v, sample): (weight, xyz)} of a RayMarchPoints buffer."""
    w = np.asarray(pts.weight)
    uv = np.asarray(pts.uv)
    xyz = np.asarray(pts.xyz)
    out = {}
    for i in np.nonzero(w > 0)[0]:
        s = int(round(np.linalg.norm(xyz[i] - o) / t_one))
        out[(int(uv[i, 0]), int(uv[i, 1]), s)] = (w[i], xyz[i])
    return out


@functools.lru_cache(maxsize=None)
def _jax_march(cam: int, skip: bool, capacity: int):
    """The JAX marcher on view ``_camera(cam)`` of ``_tsdf(2)`` (coarse pass
    through K2 in interpret mode when skipping), as view 3; kept across
    tests, since the interpreted kernel dominates their time."""
    proj, tsdf = _camera(cam), _tsdf(2)
    occ = jrm.build_occupancy(jnp.asarray(tsdf), 8) if skip else None
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CNRMA_RAY_PALLAS", "interpret")
        return jrm.ray_march_neus(jnp.asarray(proj), jnp.asarray(tsdf), DIM,
                                  VS, jnp.zeros(3, jnp.float32), H, W,
                                  occupancy=occ, **_march_kw(capacity),
                                  view_index=3)


def _march_kw(capacity):
    return dict(n_samples=64, capacity=capacity, skip_factor=8,
                skip_window=48, coarse_step=8)


def _assert_same_points(want, got, proj):
    """Kept point sets, weights and positions of one view equal, masked as
    the module docstring says."""
    n_samples, step = 64, 8
    o, d = (np.asarray(a) for a in jrm.get_ray_parameters(
        jnp.asarray(proj), H, W))
    t_one = math.sqrt(sum(n * n for n in DIM)) * VS / n_samples
    near = _near_boundary(o, d, np.arange(n_samples) * t_one, VS)
    near |= _near_boundary(o, d, (np.arange(n_samples // step) * step
                                  + step * 0.5) * t_one, VS * 8)
    jp, tp = _points(want, o, t_one), _points(got, o, t_one)

    def comparable(pts):
        return {k for k, (w, _) in pts.items()
                if not near[k[1] * W + k[0]] and abs(w - 0.05) >= 1e-6}
    keys = comparable(jp)
    assert len(keys) > 100 and len(keys) >= 0.8 * len(jp)
    assert keys == comparable(tp)
    for k in keys:
        np.testing.assert_allclose(tp[k][0], jp[k][0], atol=1e-5)
        np.testing.assert_allclose(tp[k][1], jp[k][1], atol=1e-5)


@pytest.mark.parametrize("skip,capacity", [(False, 4096), (True, 4096),
                                           (True, 150)])
def test_ray_march_neus_kept_points(skip, capacity):
    """Kept point sets, weights and positions against the JAX marcher
    (coarse pass through K2 in interpret mode when skipping); capacity 150
    overflows and takes the weight-ranked branch."""
    proj, tsdf = _camera(2), _tsdf(2)
    want = _jax_march(2, skip, capacity)
    occ = trm.build_occupancy(torch.from_numpy(tsdf), 8) if skip else None
    got = trm.ray_march_neus(
        torch.from_numpy(proj), torch.from_numpy(tsdf), DIM, VS,
        (0.0, 0.0, 0.0), H, W, occupancy=occ, view_index=3,
        **_march_kw(capacity))
    _assert_same_points(want, got, proj)
    assert set(np.asarray(got.view)[np.asarray(got.weight) > 0]) == {3}
    if capacity == 150:
        assert (np.asarray(want.weight) > 0).sum() == 150


@pytest.mark.parametrize("capacity", [4096, 150])
def test_ray_march_scene_matches_jax_per_view(capacity):
    """The scene-level march of three views (the middle one invalid)
    against the JAX marcher run view by view, skipping on: per valid view
    the same kept set, weights and positions (masked as above); the invalid
    view emits nothing.  Capacity 150 takes the ranked branch."""
    cams = (2, 4, 3)
    projs = np.stack([_camera(c) for c in cams])
    tsdf = torch.from_numpy(_tsdf(2))
    got = trm.ray_march_scene(
        torch.from_numpy(projs), tsdf, torch.tensor([True, False, True]),
        DIM, VS, (0.0, 0.0, 0.0), H, W,
        occupancy=trm.build_occupancy(tsdf, 8), **_march_kw(capacity))
    assert got.weight.shape == (3, capacity)
    assert not got.weight[1].any() and (got.view[1] == -1).all()
    for j in (0, 2):
        view = trm.RayMarchPoints(*(f[j] for f in got))
        _assert_same_points(_jax_march(cams[j], True, capacity), view,
                            projs[j])
        assert set(np.asarray(view.view)[np.asarray(view.weight) > 0]) \
            == {j}
    if capacity == 150:
        assert ((got.weight > 0).sum(1) == torch.tensor([150, 0, 150])).all()


def test_select_topk_batched_rows():
    """``_select_topk`` on [V, n]: each row equals the JAX selection of
    that row, slot for slot, with one row under capacity (compact branch)
    and one over it (ranked branch) in the same batch."""
    rng = np.random.RandomState(0)
    w = np.zeros((3, 60), np.float32)
    w[0, rng.choice(60, 5, replace=False)] = rng.rand(5)
    w[1, rng.choice(60, 30, replace=False)] = rng.randint(1, 6, 30) / 10
    w[2, :] = 0                                  # a view that keeps nothing
    got = trm._select_topk(torch.from_numpy(w), 12).numpy()
    assert got.shape == (3, 12)
    for row in range(3):
        want = np.asarray(jrm._select_topk(jnp.asarray(w[row]), 12))
        np.testing.assert_array_equal(got[row], want)
    assert (got[0] >= 0).sum() == 5 and (got[1] >= 0).all()


def test_march_rays_plain_views_and_coarse():
    """The plain scene march: an invalid view emits nothing; a valid
    view's j0/has_hit are those of ``coarse_march_plain``, its kept samples
    lie in its fine window, and its weights are in descending order."""
    projs = torch.from_numpy(np.stack([_camera(0), _camera(1)]))
    tsdf = torch.from_numpy(_tsdf(0))
    occ = trm.build_occupancy(tsdf, 8)
    o, d = trm.get_ray_parameters(projs, H, W)
    n_samples, step = 64, 8
    w, smp, j0, hit = trm.march_rays_plain(
        o, d, torch.tensor([False, True]), tsdf, occ, (0.0, 0.0, 0.0), VS,
        n_samples, 0.05, 8, 48, step)
    assert w.shape == smp.shape == (2, H * W, 20)
    assert not w[0].any() and not smp[0].any() and not j0[0].any() \
        and not hit[0].any()
    t_one = math.sqrt(sum(n * n for n in DIM)) * VS / n_samples
    cj0, chit = trm.coarse_march_plain(o[1], d[1], occ, torch.zeros(3),
                                       t_one, step, n_samples // step,
                                       VS * 8)
    assert torch.equal(j0[1], cj0) and torch.equal(hit[1], chit)
    start = (cj0 * step - step).clamp(0, n_samples - 48)[:, None]
    kept = w[1] > 0
    assert kept.any() and (w[1][:, :-1] >= w[1][:, 1:]).all()
    assert ((smp[1] >= start) & (smp[1] < start + 48))[kept].all()
    assert hit[1][kept.any(1)].all()


def test_cpu_wrapper_counts_no_launch():
    o, d = trm.get_ray_parameters(torch.from_numpy(_camera(0))[None], H, W)
    tsdf = torch.from_numpy(_tsdf(0))
    occ = trm.build_occupancy(tsdf, 8)
    args = (o, d, torch.ones(1, dtype=torch.bool), tsdf, occ,
            (0.0, 0.0, 0.0), VS, 64, 0.05, 8, 48, 8)
    before = trm.RAY_MARCH.launches
    got = trm.march_rays(*args)
    want = trm.march_rays_plain(*args)
    assert trm.RAY_MARCH.launches == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("scene", [True, False])
def test_ray_march_refuses_tsdf_off_voxel_dim(scene):
    """The march spaces samples by the TSDF's shape and the payload places
    points by ``voxel_dim``: a TSDF of another shape is refused."""
    tsdf = torch.from_numpy(_tsdf(0))[:, :, :-8]
    proj = torch.from_numpy(_camera(0))
    with pytest.raises(ValueError, match="is not voxel_dim"):
        if scene:
            trm.ray_march_scene(proj[None], tsdf, torch.ones(1, dtype=bool),
                                DIM, VS, (0.0, 0.0, 0.0), H, W)
        else:
            trm.ray_march_neus(proj, tsdf, DIM, VS, (0.0, 0.0, 0.0), H, W,
                               view_index=0)

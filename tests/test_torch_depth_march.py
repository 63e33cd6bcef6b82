"""The depth ray march of the port (``ray_march_depth``,
``ray_marching_type='depth'``) against the JAX package, fp32 on the CPU.

Per view on a planted ball TSDF, for ``depth_points`` 2 and 0, under and
over the view's capacity: the kept points as sets (ROADMAP F6: the two
selection branches order their slots differently, so sets are compared,
not slots), pixels and weights exactly, positions within 1e-5.  Then the
tiny ``CNRMA`` with ``ray_marching_type='depth'``, its whole test forward
against JAX's ``model.apply(train=False)`` with the same parameters and
subsample draw: the point cloud (1e-5 on positions, 1e-4 of the scale on
features) and the boxes and scores as sets (1e-4 of their scale).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnrma_torch.core.builder import cnrma_kwargs
from cnrma_torch.core.config import Config
from cnrma_torch.ops import ray_marching as trm
from cnrma_tpu.models import cn_rma as jcn
from cnrma_tpu.ops import ray_marching as jrm
from test_pipeline import tiny_model
from test_torch_bridge import tiny_torch_cnrma
from test_torch_stages import _flax_tree, _randomize_norms
from _torch_threads import _few_threads  # noqa: F401

DIMS, VOXEL, ORIGIN = (16, 16, 16), 0.1, (0.0, 0.0, 0.0)
H, W = 16, 24


def _ball_tsdf():
    """A ball of radius 0.45 m in the 16^3 grid at 10 cm, truncated at
    three voxels."""
    ii = np.stack(np.meshgrid(*[np.arange(n) for n in DIMS],
                              indexing="ij"), -1).astype(np.float32) * VOXEL
    d = np.linalg.norm(ii - np.array([0.8, 0.75, 0.85]), axis=-1) - 0.45
    return np.clip(d / (3 * VOXEL), -1, 1).astype(np.float32)


def _projection():
    """A [24 x 16] feature-map camera outside the grid, looking in."""
    intr = np.array([[16.0, 0, W / 2], [0, 16.0, H / 2], [0, 0, 1]],
                    np.float32)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [0.75, 0.7, -0.6]
    return (intr @ np.linalg.inv(pose)[:3]).astype(np.float32)


def _kept(points, o, d):
    """The kept points of a view as arrays ordered by (row, column,
    distance along the pixel's ray): (uv, weight, xyz)."""
    w = np.asarray(points.weight)
    keep = w > 0
    uv = np.asarray(points.uv)[keep]
    xyz = np.asarray(points.xyz)[keep]
    pix = uv[:, 1] * W + uv[:, 0]
    t = ((xyz - o) * d[pix]).sum(-1)
    order = np.lexsort((t, uv[:, 0], uv[:, 1]))
    assert (np.asarray(points.view)[keep] == 3).all()
    return uv[order], w[keep][order], xyz[order]


@pytest.mark.parametrize("capacity", [4096, 60], ids=["fits", "over"])
@pytest.mark.parametrize("depth_points", [2, 0])
def test_view_keeps_jax_points(depth_points, capacity):
    """One view's kept set equals JAX's: the same pixels and weights
    exactly, positions within 1e-5; over capacity the same highest
    weights (ties to the lower index) survive."""
    tsdf, proj = _ball_tsdf(), _projection()
    kw = dict(n_samples=300, depth_points=depth_points, capacity=capacity)
    want = jax.device_get(jax.jit(lambda t, p: jrm.ray_march_depth(
        p, t, DIMS, VOXEL, jnp.asarray(ORIGIN, jnp.float32), H, W,
        view_index=3, **kw))(tsdf, proj))
    tsdf_t, proj_t = torch.from_numpy(tsdf), torch.from_numpy(proj)
    got = trm.ray_march_depth(proj_t, tsdf_t, DIMS, VOXEL, ORIGIN, H, W,
                              view_index=3, **kw)
    assert got.weight.shape == (capacity,)
    full = trm.ray_march_depth(proj_t, tsdf_t, DIMS, VOXEL, ORIGIN, H, W,
                               view_index=3, n_samples=300,
                               depth_points=depth_points, capacity=4096)
    n_full = int((full.weight > 0).sum())
    n_rays = len(torch.unique(full.uv[full.weight > 0], dim=0))
    o, d = (x.numpy() for x in trm.get_ray_parameters(proj_t, H, W))
    wuv, ww, wxyz = _kept(want, o, d)
    guv, gw, gxyz = _kept(got, o, d)
    print(f"depth_points {depth_points}, capacity {capacity}: {len(ww)} of "
          f"{n_full} points on {n_rays} rays")
    assert n_rays > 50 and n_full <= max(1, 2 * depth_points) * n_rays
    assert (n_full > capacity) == (capacity == 60)
    assert len(ww) == min(capacity, n_full)
    np.testing.assert_array_equal(guv, wuv)
    np.testing.assert_array_equal(gw, ww)
    np.testing.assert_allclose(gxyz, wxyz, atol=1e-5)


def test_scene_march_marks_invalid_views():
    """``ray_march_depth_scene`` marches view by view: each view is
    ``ray_march_depth``'s, and an invalid view keeps no point."""
    tsdf = torch.from_numpy(_ball_tsdf())
    proj = torch.from_numpy(np.stack([_projection()] * 3))
    valid = torch.tensor([True, False, True])
    pts = trm.ray_march_depth_scene(proj, tsdf, valid, DIMS, VOXEL, ORIGIN,
                                    H, W, capacity=2048)
    one = trm.ray_march_depth(proj[2], tsdf, DIMS, VOXEL, ORIGIN, H, W,
                              view_index=2, capacity=2048)
    assert pts.weight.shape == (3, 2048)
    for a, b in zip(pts, one):
        torch.testing.assert_close(a[2], b, rtol=0, atol=0)
    assert not bool((pts.weight[1] > 0).any()) and bool(
        (pts.view[1] == -1).all())
    assert int((pts.weight[0] > 0).sum()) > 100


def test_builder_reads_depth_points():
    """A config's ``depth_points`` None (the shipped configs) or 0 gives 2,
    as the JAX builder reads it; only a direct construction asks for 0."""
    cfg = Config.fromfile("configs/ray_marching_scannet.py")
    cfg.merge_from_options({"model.ray_marching_type": "depth"})
    assert cnrma_kwargs(cfg)["depth_points"] == 2
    cfg.merge_from_options({"model.depth_points": 0})
    assert cnrma_kwargs(cfg)["depth_points"] == 2
    cfg.merge_from_options({"model.depth_points": 3})
    assert cnrma_kwargs(cfg)["depth_points"] == 3
    with pytest.raises(ValueError, match="ray_marching_type"):
        tiny_torch_cnrma(ray_marching_type="sdf")


@pytest.mark.parametrize("depth_points", [2, 0])
def test_tiny_depth_forward_matches_jax(depth_points):
    """The whole tiny test forward with depth marching: the TSDFs, the
    point cloud and the boxes against JAX's with the same parameters (the
    port's initialisation, seed 0, random norms) and subsample draw."""
    model, batch = tiny_model()
    model = model.clone(ray_marching_type="depth", depth_points=depth_points,
                        ray_samples=300)
    torch.manual_seed(0)
    port = tiny_torch_cnrma(ray_marching_type="depth",
                            depth_points=depth_points,
                            ray_samples=300).eval()
    _randomize_norms(port, 12)
    variables = _flax_tree(port.state_dict())
    draws = []
    orig = jcn._normalize_subsample

    def spy(flat, rng_b, max_points):
        r = jax.random.uniform(rng_b, (flat.weight.shape[0],))
        jax.debug.callback(lambda x: draws.append(np.asarray(x)), r)
        return orig(flat, rng_b, max_points)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcn, "_normalize_subsample", spy)
        want = jax.device_get(jax.jit(lambda v, b: model.apply(
            v, b, train=False, rngs={"sample": jax.random.PRNGKey(0)}))(
                variables, batch))
    tb = {k: torch.from_numpy(np.array(batch[k]))
          for k in ("imgs", "projection", "view_valid", "offset")}
    got = port(tb, uniform=torch.from_numpy(np.array(draws[0]))[None])
    for k, w in want["tsdf"].items():
        np.testing.assert_allclose(got["tsdf"][k].numpy(), np.asarray(w),
                                   atol=1e-4, err_msg=k)
    wv = np.asarray(want["points"].valid)
    print(f"depth_points {depth_points}: {int(wv.sum())} points kept")
    assert wv.sum() > 50
    np.testing.assert_array_equal(got["points"].valid.numpy(), wv)
    np.testing.assert_allclose(got["points"].xyz.numpy()[wv],
                               np.asarray(want["points"].xyz)[wv], atol=1e-5)
    wf = np.asarray(want["points"].feats)[wv]
    np.testing.assert_allclose(got["points"].feats.numpy()[wv], wf,
                               atol=1e-4 * np.abs(wf).max())

    def ordered(b, s, v):
        b, s, v = np.asarray(b[0]), np.asarray(s[0]), np.asarray(v[0])
        o = np.argsort(-s[v].max(1), kind="stable")
        return b[v][o], s[v][o]
    wb, ws = ordered(want["bboxes"], want["scores"], want["bbox_valid"])
    gb, gs = ordered(got["bboxes"], got["scores"], got["bbox_valid"])
    assert len(wb) == len(gb) > 0
    np.testing.assert_allclose(gs, ws, atol=1e-4 * np.abs(ws).max())
    np.testing.assert_allclose(gb, wb, atol=1e-4 * np.abs(wb).max())

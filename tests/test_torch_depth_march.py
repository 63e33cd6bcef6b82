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
Last, the depth branch of the TRAINING forward (JAX ``CNRMA.ray_march``:
the march on a given fine TSDF under ``stop_gradient``, the weight
normalisation and subsample with JAX's uniform draw passed in, the
pixel-feature gather and the weight multiply) against the port's
``_march`` -> ``_point_cloud``: a scalar loss on the weighted features,
its value and its gradient with respect to the feature maps, and the
point sets (F6: sets, not slots).  And two depth training steps of the
train CLI at cut sizes (no JAX in them): finite losses, a non-zero
gradient in every trainable group (the 2D tower's too: the depth points
carry gathered features) and a checkpoint that reloads.
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


# --- the depth branch of the training forward --------------------------------

TRAIN_FEATS = 8             # feature-map channels of the training case
TRAIN_POINTS = 150          # max_points: fewer than the kept samples
NEAR_TIE = 1e-6             # |TSDF product| this close to the sign test


def _train_case():
    """Two views of 16x24 feature maps (the stride-4 maps of 64x96
    images; the second camera moved and turned), random features and the
    loss's weights (seed 3), and the ball TSDF."""
    rng = np.random.RandomState(3)
    p0 = _projection()
    intr = np.array([[16.0, 0, W / 2], [0, 16.0, H / 2], [0, 0, 1]],
                    np.float32)
    c, s = np.cos(0.3), np.sin(0.3)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
    pose[:3, 3] = [0.3, 0.75, -0.5]
    p1 = (intr @ np.linalg.inv(pose)[:3]).astype(np.float32)
    proj = np.stack([p0, p1])
    proj[:, :2] *= 4                       # full-resolution projections
    feats = rng.randn(1, 2, H, W, TRAIN_FEATS).astype(np.float32)
    coef = rng.randn(TRAIN_FEATS).astype(np.float32)
    axis = (rng.randn(3) * 0.3).astype(np.float32)
    return feats, proj[None], _ball_tsdf()[None], coef, axis


def _near_tie_pixels(proj, tsdf, view_index, n_samples):
    """The pixels (flat ``v * H * W + row * W + col``) of one view whose
    ray has a TSDF product within ``NEAR_TIE`` of 0: the sign test there
    may round either way."""
    o, d = jrm.get_ray_parameters(jnp.asarray(proj[:, :] / np.array(
        [[4.0], [4.0], [1.0]], np.float32)), H, W)
    t_max = np.sqrt(sum(n * n for n in DIMS)) * VOXEL
    ts = np.arange(n_samples, dtype=np.float32) * np.float32(t_max
                                                             / n_samples)
    places = np.asarray(o)[None, None] + np.asarray(d)[:, None] \
        * ts[None, :, None]
    vals, _ = jrm._sample_tsdf(jnp.asarray(tsdf), jnp.asarray(
        places.reshape(-1, 3)), jnp.asarray(ORIGIN, jnp.float32), VOXEL)
    tv = np.asarray(vals).reshape(H * W, n_samples)
    prod = tv[:, :-1] * tv[:, 1:]
    near = (np.abs(prod) <= NEAR_TIE).any(axis=1)
    return view_index * H * W + np.flatnonzero(near)


@pytest.mark.parametrize("depth_points", [2, 0])
def test_depth_training_branch_matches_jax(depth_points):
    """The training forward's depth branch, JAX's ``CNRMA.ray_march``
    (jitted once with its gradient) against the port's ``ray_march``
    (``_march`` -> ``_point_cloud``), on the same feature maps, ball TSDF
    and subsample draw: the kept points as sets (positions 1e-5, weighted
    features 1e-5 of their scale), the loss ``sum((feats @ c) * (1 +
    xyz @ a))`` within 1e-5 relative and its gradient with respect to the
    feature maps within 1e-5 of its scale; pixels whose ray has a TSDF
    product within ``NEAR_TIE`` of the sign test are left out."""
    feats, proj, tsdf, coef, axis = _train_case()
    kw = dict(ray_marching_type="depth", depth_points=depth_points,
              ray_samples=300, rays_per_view_cap=4096,
              max_points=TRAIN_POINTS)
    model = tiny_model()[0].clone(**kw)
    draws = []
    orig = jcn._normalize_subsample

    def spy(flat, rng_b, max_points):
        r = jax.random.uniform(rng_b, (flat.weight.shape[0],))
        jax.debug.callback(lambda x: draws.append(np.asarray(x)), r)
        return orig(flat, rng_b, max_points)

    def loss(f, t):
        pts = model.apply({}, f, jnp.asarray(proj), jnp.ones((1, 2), bool),
                          t, jnp.zeros((1, 3)), jax.random.PRNGKey(5),
                          method=jcn.CNRMA.ray_march)
        value = jnp.sum((pts.feats @ coef) * (1 + pts.xyz @ axis))
        return value, (pts.xyz, pts.feats, pts.valid)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcn, "_normalize_subsample", spy)
        (want, (wxyz, wpf, wv)), wgrad = jax.device_get(jax.jit(
            jax.value_and_grad(loss, has_aux=True))(feats, tsdf))
    port = tiny_torch_cnrma(**kw)
    f_t = torch.from_numpy(feats).requires_grad_(True)
    pts = port.ray_march(f_t, torch.from_numpy(proj),
                         torch.ones(1, 2, dtype=torch.bool),
                         torch.from_numpy(tsdf),
                         uniform=torch.from_numpy(draws[0])[None])
    got = torch.sum((pts.feats @ torch.from_numpy(coef))
                    * (1 + pts.xyz @ torch.from_numpy(axis)))
    got.backward()
    ggrad = f_t.grad.numpy()

    ties = np.concatenate([_near_tie_pixels(proj[0, v], tsdf[0], v, 300)
                           for v in range(2)])
    keep = np.ones(2 * H * W, bool)
    keep[ties] = False
    n_kept = int(wv.sum())
    print(f"depth_points {depth_points}: {n_kept} of {TRAIN_POINTS} points "
          f"kept; {len(ties)} pixels near the sign test")
    assert n_kept == TRAIN_POINTS and len(ties) < 0.05 * 2 * H * W

    def rows(xyz, pf, v):
        a = np.concatenate([xyz[0][v[0]], pf[0][v[0]]], 1)
        return a[np.lexsort(a[:, 2::-1].T)]
    gv = pts.valid.numpy()
    a = rows(pts.xyz.detach().numpy(), pts.feats.detach().numpy(), gv)
    b = rows(wxyz, wpf, wv)
    assert a.shape == b.shape
    np.testing.assert_allclose(a[:, :3], b[:, :3], atol=1e-5)
    np.testing.assert_allclose(a[:, 3:], b[:, 3:],
                               atol=1e-5 * np.abs(b[:, 3:]).max())
    rel = abs(float(got) / float(want) - 1)
    g = ggrad.reshape(2 * H * W, -1)[keep]
    w = np.asarray(wgrad).reshape(2 * H * W, -1)[keep]
    err = float(np.abs(g - w).max() / np.abs(w).max())
    print(f"loss {float(want):.6g}, relative error {rel:.3g}; feature "
          f"gradient error {err:.3g} of its scale, "
          f"{int((np.abs(w) > 0).any(1).sum())} pixels carry it")
    assert rel < 1e-5 and err < 1e-5


# every trainable group of CNRMA, each of which a depth step must reach
TRAIN_GROUPS = ("tower2d.resnet.", "tower2d.fpn.", "tower2d.fuse.",
                "backbone3d.", "tsdf_head.", "detector.backbone.",
                "detector.head.")


def test_depth_training_steps_through_the_cli(tmp_path, monkeypatch):
    """``python -m cnrma_torch.tools.train configs/ray_marching_scannet.py
    --device cpu --max-steps 2 --cfg-options model.ray_marching_type=depth
    model.depth_points=2`` at cut sizes: two steps with finite losses and
    positives, each step's gradient non-zero in every trainable group, and
    the checkpoint loads into the test model."""
    import os
    import shutil
    from cnrma_torch.synthetic import write_scannet
    from cnrma_torch.tools import test as test_cli
    from cnrma_torch.tools import train as train_cli
    from cnrma_torch.train.optim import Optimizer
    data = str(tmp_path / "data")
    ann = write_scannet(data, n_scenes=1, n_frames=3, tsdf_dim=(32, 32, 16),
                        image_size=(128, 96))
    train = os.path.join(data, "scannet_infos_train.pkl")
    shutil.copy(ann, train)
    norms = []
    step = Optimizer.step

    def spy(self, grads):
        norms.append({g: float(sum(float(t.float().square().sum())
                                   for n, t in grads.items()
                                   if n.startswith(g) and t is not None))
                      for g in TRAIN_GROUPS})
        return step(self, grads)
    monkeypatch.setattr(Optimizer, "step", spy)
    cfg = "configs/ray_marching_scannet.py"
    records, ckpt = train_cli.main([
        cfg, "--device", "cpu", "--max-steps", "2", "--work-dir",
        str(tmp_path / "wd"), "--cfg-options", f"data.train.data_root={data}",
        f"data.train.ann_file={train}", "data.train.num_frames=2",
        "data.train.image_size=(64,32)", "model.voxel_dim_train=(16,16,16)",
        "data.train.voxel_dim=(16,16,16)", "model.ray_samples=32",
        "model.rays_per_view_cap=64", "model.max_points=128",
        "model.ray_marching_type=depth", "model.depth_points=2",
        "model.capacities={'voxelize':256,'stride2':128,'stride4':64,"
        "'levels':(32,16,8,8),'neck':(64,32,16)}"])
    assert len(records) == 2 and len(norms) == 2
    for r, n in zip(records, norms):
        print(f"depth step {r['step']}: {r['log_vars']}; squared gradient "
              f"norms {n}")
        assert all(np.isfinite(v) for v in r["log_vars"].values())
        assert r["log_vars"]["loss_bbox"] > 0
        assert all(v > 0 for v in n.values()), n
    cfg_t = Config.fromfile(cfg)
    cfg_t.merge_from_options({"model.ray_marching_type": "depth"})
    from cnrma_torch.core.builder import build_model
    model = build_model(cfg_t, mode="test")
    assert test_cli.load_parameters(model, ckpt, 0) == 0
    os.remove(ckpt)

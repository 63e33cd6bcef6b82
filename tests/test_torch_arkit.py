"""The ARKitScenes yaw path of the port against the JAX package, fp32 on the
CPU: the ARKit reader in both layouts, its pose helpers, the builder on
the four ARKit configs, the yaw augmentation, the assigner's targets on
yaw boxes, the detector's 7-DoF loss and its gradient, the yaw decoding's
guard, the converter at the ARKit head's widths, and the whole slice: a tiny synthetic ARKit scene through the test CLI
against JAX ``model.apply``.

Tolerances: exact for the readers' arrays, the pose helpers, labels and
the converter's tensors (the same numpy operations on both sides); 1e-6
where both sides run the same fp32 operations (augmentation, assigner
targets, decoding and its gradient); the detector loss 1e-5 relative and
its gradient 1e-4 of each leaf's largest magnitude (the rotated IoU's
polygon clip in another order of operations); the whole slice's boxes and
scores 1e-4 of their scale, with the same kept points.
"""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnrma_torch.models import fcaf3d as tdet
from cnrma_torch.synthetic import write_arkit
from cnrma_tpu.models import fcaf3d as jdet
from _torch_threads import _few_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARKIT_CONFIGS = ("ray_marching_arkit.py", "arkit_middle.py",
                 "atlas_recon_arkit.py", "fcaf3d_middle_arkit.py")
T = torch.from_numpy


@pytest.fixture(scope="module")
def arkit_scene(tmp_path_factory):
    """One tiny synthetic ARKit scene (12 frames of 128x96) in the raw
    layout: (data root, infos path)."""
    root = str(tmp_path_factory.mktemp("arkit"))
    ann = write_arkit(root, n_scenes=1, n_frames=12, tsdf_dim=(24, 24, 16),
                      image_size=(128, 96))
    return root, ann


# --- the pose helpers and the reader ------------------------------------------

def test_rodrigues_and_traj_line():
    from cnrma_torch.data import arkit as tark
    from cnrma_torch.synthetic import axis_angle
    from cnrma_tpu.data import arkit as jark
    rng = np.random.RandomState(3)
    vecs = [np.zeros(3), np.array([0, 0, np.pi - 1e-9])] + [
        rng.randn(3) * s for s in (1e-8, 0.3, 1.0, 3.0)]
    for v in vecs:
        np.testing.assert_array_equal(tark.rodrigues(v), jark.rodrigues(v))
        R = tark.rodrigues(v)
        np.testing.assert_allclose(tark.rodrigues(axis_angle(R)), R,
                                   atol=1e-9)
        line = f"5037.41149 {v[0]:.9f} {v[1]:.9f} {v[2]:.9f} 0.5 -1.25 2.0"
        ts, m = tark.parse_traj_line(line)
        jts, jm = jark.parse_traj_line(line)
        assert ts == jts == "5037.41149"
        np.testing.assert_array_equal(m, jm)


def _inline(root, ann, path):
    """The scene of ``ann`` rewritten in the inline layout (image paths,
    intrinsics and extrinsics in the infos, frame ids their indices), the
    poses read by the raw reader's own helpers."""
    from cnrma_torch.data.arkit import load_pincam, parse_traj_line
    with open(ann, "rb") as f:
        info = pickle.load(f)[0]
    scene = info["scene"]
    frames = os.path.join(info["split"], scene, f"{scene}_frames")
    with open(os.path.join(root, frames, "lowres_wide.traj")) as f:
        poses = [parse_traj_line(ln) for ln in f]
    ids = info["total_image_ids"]
    intr_dir = os.path.join(root, frames, "lowres_wide_intrinsics")
    pincams = sorted(os.listdir(intr_dir))
    inline = dict(info, total_image_ids=list(range(len(ids))),
                  image_paths=[os.path.join(frames, "lowres_wide",
                                            f"{scene}_{t}.png") for t in ids],
                  intrinsics=[load_pincam(os.path.join(intr_dir, p))
                              for p in pincams],
                  extrinsics=[min(poses, key=lambda p: abs(
                      float(p[0]) - float(t)))[1] for t in ids])
    with open(path, "wb") as f:
        pickle.dump([inline], f)
    return path


@pytest.mark.parametrize("layout", ["raw", "inline"])
def test_reader_matches_jax(arkit_scene, layout, tmp_path, monkeypatch):
    """Both readers on the same scene and seed give the same arrays (max
    error 0), in the test split's and the training split's ``middle``
    space.  The raw scene has a third of its poses 3 ms off their frame
    (the ±5 ms fallback, with one pose in each window) and half of its
    ``.pincam`` names 1 ms off.  The JAX package's optional native TSDF
    resampler is held off: it rounds otherwise (ROADMAP F10)."""
    from cnrma_torch.data.arkit import AtlasARKitDataset as TReader
    from cnrma_tpu.data.arkit import AtlasARKitDataset as JReader
    from cnrma_tpu.utils import native
    monkeypatch.setattr(native, "available", lambda: False)
    root, ann = arkit_scene
    if layout == "inline":
        ann = _inline(root, ann, str(tmp_path / "inline.pkl"))
    else:
        with open(ann, "rb") as f:
            info = pickle.load(f)[0]
        scene = info["scene"]
        with open(os.path.join(root, info["split"], scene, f"{scene}_frames",
                               "lowres_wide.traj")) as f:
            stamps = [float(ln.split()[0]) for ln in f]
        keys = {f"{round(t, 3):.3f}" for t in stamps}
        late = [t for t in info["total_image_ids"] if t not in keys]
        assert late and all(
            sum(abs(float(t) - s) < 0.005 for s in stamps) == 1
            for t in info["total_image_ids"])
    for test_mode in (True, False):
        kw = dict(data_root=root, ann_file=ann, num_frames=6, seed=3,
                  voxel_dim=(16, 16, 16), image_size=(96, 64),
                  test_mode=test_mode, space_mode="middle")
        got, want = TReader(**kw)[0], JReader(**kw)[0]
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]),
                                          np.asarray(want[k]), err_msg=k)
        assert got["gt_valid"].sum() == 5 and got["gt_boxes"][:5, 6].any()
        assert np.isfinite(got["projection"]).all()


# --- the builder ------------------------------------------------------------

@pytest.mark.parametrize("config", ARKIT_CONFIGS)
def test_builder_builds_the_arkit_configs(config, arkit_scene, monkeypatch):
    """Every knob the torch builder reads for an ARKit config equals the JAX
    builder's (flax dataclasses, built without init), the yaw detector has
    8 regression outputs and 17 classes, the joint configs' grids are
    192x192x80, and the config's reader builds."""
    from cnrma_torch.core import builder as t_builder
    from cnrma_torch.core.config import Config as TConfig
    from cnrma_torch.models.fcaf3d_only import FCAF3DOnly
    from cnrma_tpu.core import builder as j_builder
    from cnrma_tpu.core.config import Config as JConfig
    from cnrma_tpu.ops import sparse as j_sparse
    monkeypatch.setattr(j_sparse, "LUT_CELL_BUDGET", j_sparse.LUT_CELL_BUDGET)
    path = os.path.join(REPO, "configs", config)
    root, ann = arkit_scene
    tcfg = TConfig.fromfile(path)
    for mode in ("train", "test"):
        jm = j_builder.build_model(JConfig.fromfile(path), mode=mode)
        model = t_builder.build_model(tcfg, mode=mode)
        assert type(model).__name__ == type(jm).__name__
        kw = (t_builder.fcaf3d_only_kwargs(tcfg)
              if isinstance(model, FCAF3DOnly)
              else t_builder.cnrma_kwargs(tcfg, mode))
        for name, value in kw.items():
            want = getattr(jm, name)
            if name == "compute_dtype":
                assert value == getattr(torch, jnp.dtype(want).name), name
            elif name == "capacities":
                assert tuple(value) == tuple(want), name
            else:
                assert value == want, (name, value, want)
    if hasattr(model, "detector"):
        det = model.detector
        assert model.with_yaw and det.with_yaw and det.n_classes == 17
        assert det.head.reg_conv.shape[-1] == 8
    if type(model).__name__ == "CNRMA":
        assert model.voxel_dim == (192, 192, 80)
    reader = t_builder.build_dataset(tcfg, "train", data_root=root,
                                     ann_file=ann)
    assert reader.with_yaw


# --- augmentation, assigner -------------------------------------------------

def test_yaw_augmentation_matches_jax():
    """``augment_scenes`` with yaw (the path of ``CNRMA`` and ``FCAF3DOnly``
    with ``with_yaw``) against JAX's ``feature_transform_aug`` with its
    draws injected, every combination of the two flips: the horizontal
    flip maps yaw to pi - yaw, the vertical one to -yaw."""
    from cnrma_torch.models import cn_rma as tcn
    from cnrma_tpu.models import cn_rma as jcn
    rng = np.random.RandomState(4)
    pts = rng.randn(2, 100, 3).astype(np.float32)
    boxes = np.concatenate([rng.randn(2, 5, 3), rng.rand(2, 5, 3) + 0.2,
                            rng.uniform(-np.pi, np.pi, (2, 5, 1))],
                           -1).astype(np.float32)
    cfg = tcn.FEATURE_TRANSFORM
    flips = set()
    for key in range(8):
        keys = [jax.random.PRNGKey(key), jax.random.PRNGKey(key + 100)]
        draws, want = [], []
        for b, k in enumerate(keys):
            kf, kv, kr, ks, kt = jax.random.split(k, 5)
            draws.append({
                "flip_h": torch.tensor(bool(jax.random.uniform(kf) < 0.5)),
                "flip_v": torch.tensor(bool(jax.random.uniform(kv) < 0.5)),
                "angle": torch.tensor(float(jax.random.uniform(
                    kr, minval=cfg["rot_range"][0],
                    maxval=cfg["rot_range"][1]))),
                "scale": torch.tensor(float(jax.random.uniform(
                    ks, minval=0.9, maxval=1.1))),
                "trans": T(np.array(jax.random.normal(kt, (3,))
                                      * jnp.asarray([0.1, 0.1, 0.1])))})
            flips.add((bool(draws[-1]["flip_h"]), bool(draws[-1]["flip_v"])))
            want.append(jcn.feature_transform_aug(
                k, jnp.asarray(pts[b]), jnp.asarray(boxes[b]), True))
        gp, gb = tcn.augment_scenes(T(pts), T(boxes), cfg, True,
                                    aug_draws=draws)
        for b, (wp, wb) in enumerate(want):
            np.testing.assert_allclose(gp[b].numpy(), np.asarray(wp),
                                       atol=1e-6)
            np.testing.assert_allclose(gb[b].numpy(), np.asarray(wb),
                                       atol=1e-6)
    assert len(flips) == 4


def _yaw_boxes():
    """Six yaw boxes [6, 7] (gravity-center z) at +-pi/4, next to +-pi/2,
    at pi/2 and at 0: non-square, in a 3 m room."""
    return np.array([[0.8, 0.8, 0.5, 1.0, 0.4, 0.6, np.pi / 4],
                     [2.2, 0.8, 0.5, 0.9, 0.3, 0.8, -np.pi / 4],
                     [0.8, 2.2, 0.4, 1.2, 0.5, 0.5, np.pi / 2 - 1e-3],
                     [2.2, 2.2, 0.6, 0.7, 0.3, 0.9, -np.pi / 2 + 1e-3],
                     [1.5, 1.5, 0.3, 0.6, 0.2, 0.4, np.pi / 2],
                     [1.5, 0.4, 0.3, 0.5, 0.3, 0.4, 0.0]], np.float32)


def _level_points(seed, sizes=(400, 200, 100, 50)):
    """Points of four pyramid levels over the 3 m room: [P, 3], scale ids,
    validity."""
    rng = np.random.RandomState(seed)
    p = sum(sizes)
    points = np.concatenate([rng.rand(p, 2) * 3, rng.rand(p, 1) * 1.2],
                            1).astype(np.float32)
    scale_ids = np.repeat(np.arange(4), sizes).astype(np.int32)
    return points, scale_ids, rng.rand(p) > 0.1


def test_assigner_targets_on_yaw_boxes():
    """Labels exact, centerness and box targets (the 7th column the GT's
    yaw) within 1e-6, on boxes at +-pi/4 and near +-pi/2, where the
    de-rotation's sign (mmdet3d 0.15's transposed rotation) decides which
    points are inside."""
    from cnrma_torch.models import assigner as tas
    from cnrma_tpu.models import assigner as jas
    points, scale_ids, valid = _level_points(1)
    boxes = _yaw_boxes()
    labels = np.arange(6, dtype=np.int32)
    gt_valid = np.ones(6, bool)
    args = (points, scale_ids, valid, boxes, labels, gt_valid)
    want = jas.fcaf3d_assign(*map(jnp.asarray, args), n_scales=4, limit=2,
                             topk=6)
    got = tas.fcaf3d_assign(*map(T, args), n_scales=4, limit=2, topk=6)
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    assert set(got.labels.numpy().tolist()) == {-1, 0, 1, 2, 3, 4, 5}
    np.testing.assert_allclose(got.centerness_targets.numpy(),
                               np.asarray(want.centerness_targets), atol=1e-6)
    np.testing.assert_allclose(got.bbox_targets.numpy(),
                               np.asarray(want.bbox_targets), atol=1e-6)


# --- the 7-DoF loss and its gradient ----------------------------------------

def _loss_case(seed):
    """Head outputs of four levels for one scene over ``_yaw_boxes``: raw
    face distances and yaw terms, the (sin, cos) pair exactly (0, 0) in
    every seventh row and in every other positive row (the assigner's);
    numpy arrays."""
    from cnrma_torch.models import assigner as tas
    rng = np.random.RandomState(seed)
    points, scale_ids, valid = _level_points(seed)
    p = len(points)
    bbox = np.concatenate([np.exp(rng.randn(p, 6) * 0.3) * 0.3,
                           rng.randn(p, 2)], 1).astype(np.float32)
    c = dict(points=points, scale_ids=scale_ids, valid=valid,
             centerness=rng.randn(p).astype(np.float32), bbox_pred=bbox,
             cls=(rng.randn(p, 17) * 2).astype(np.float32),
             gt_boxes=_yaw_boxes(),
             gt_labels=np.array([14, 13, 16, 0, 12, 4], np.int32),
             gt_valid=np.ones(6, bool))
    a = tas.fcaf3d_assign(*map(T, (points, scale_ids, valid, c["gt_boxes"],
                                   c["gt_labels"], c["gt_valid"])),
                          n_scales=4, limit=2, topk=6)
    c["positive"] = (a.labels >= 0).numpy() & valid
    bbox[::7, 6:] = 0.0
    bbox[np.nonzero(c["positive"])[0][::2], 6:] = 0.0
    return c


def _levels(c, lib):
    """The case's rows split into its four levels' ``LevelOut``s, each
    with a batch axis, as the detector gives them."""
    out = []
    for s in range(4):
        m = c["scale_ids"] == s
        fields = [c["centerness"][m], c["bbox_pred"][m], c["cls"][m],
                  c["points"][m], c["valid"][m]]
        out.append(lib.LevelOut(*(x[None] for x in fields)))
    return out


@pytest.mark.parametrize("yaw_parametrization", ["fcaf3d", "sin-cos"])
def test_yaw_loss_and_gradient_match_jax(yaw_parametrization):
    """``FCAF3DDetector.loss`` with ``with_yaw``: the three losses within
    1e-5 relative of JAX's, and their sum's gradient by the centerness,
    box and class outputs within 1e-4 of each one's largest magnitude of
    ``jax.grad``'s, finite everywhere, rows at (sin, cos) = (0, 0) among
    the positives included (their gradient is not zero)."""
    c = _loss_case(5)
    kw = dict(n_classes=17, n_reg_outs=8, assigner_limit=2,
              assigner_topk=6, yaw_parametrization=yaw_parametrization,
              with_yaw=True)
    jm = jdet.FCAF3DDetector(**kw)
    with torch.device("meta"):
        tm = tdet.FCAF3DDetector(**kw)
    gt = [c["gt_boxes"][None], c["gt_labels"][None], c["gt_valid"][None]]

    def jloss(ctr, bbox, cls):
        outs = [o._replace(centerness=ctr[i], bbox_pred=bbox[i],
                           cls_scores=cls[i])
                for i, o in enumerate(_levels(c, jdet))]
        losses = jm.loss(outs, *map(jnp.asarray, gt))
        return sum(losses.values()), losses
    base = _levels(c, jdet)
    leaves = ([jnp.asarray(o.centerness) for o in base],
              [jnp.asarray(o.bbox_pred) for o in base],
              [jnp.asarray(o.cls_scores) for o in base])
    (_, want), jgrads = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True))(*leaves)

    touts = [tdet.LevelOut(*(T(np.array(x)) for x in o))
             for o in _levels(c, tdet)]
    for o in touts:
        for t in o[:3]:
            t.requires_grad_(True)
    got = tm.loss(touts, *map(T, gt))
    sum(got.values()).backward()
    for k, w in want.items():
        np.testing.assert_allclose(got[k].item(), float(w), rtol=1e-5,
                                   err_msg=k)
    for i, name in enumerate(("centerness", "bbox_pred", "cls_scores")):
        g = np.concatenate([getattr(o, name).grad.numpy().reshape(-1)
                            for o in touts])
        w = np.concatenate([np.asarray(x).reshape(-1) for x in jgrads[i]])
        assert np.isfinite(g).all(), name
        np.testing.assert_allclose(g, w, atol=1e-4 * np.abs(w).max(),
                                   err_msg=name)
    # the levels' rows are the case's rows in order (its scale ids sorted)
    hit = c["positive"] & (c["bbox_pred"][:, 6:] == 0).all(1)
    g_bbox = np.concatenate([o.bbox_pred.grad.numpy()[0] for o in touts])
    assert hit.sum() >= 5 and (np.abs(g_bbox[hit]).max(1) > 0).all()


@pytest.mark.parametrize("mode", ["fcaf3d", "sin-cos"])
def test_decode_guard_gradient_is_finite(mode):
    """The guard at (sin, cos) = (0, 0) in ``decode_bbox`` gives finite
    gradients in torch (``torch.where`` does not stop a NaN from the
    branch it drops, so the square root takes a safe input first, as
    JAX's ``sq_safe``), equal to ``jax.grad``'s within 1e-6."""
    rng = np.random.RandomState(9)
    pts = rng.randn(20, 3).astype(np.float32)
    pred = np.abs(rng.randn(20, 8)).astype(np.float32)
    pred[:6, 6:] = 0.0
    r = rng.randn(20, 7).astype(np.float32)
    want = jax.grad(lambda p: jnp.sum(jdet.decode_bbox(
        jnp.asarray(pts), p, mode) * r))(jnp.asarray(pred))
    x = T(pred.copy()).requires_grad_(True)
    (tdet.decode_bbox(T(pts), x, mode) * T(r)).sum().backward()
    assert np.isfinite(x.grad.numpy()).all()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want), atol=1e-6)


# --- parameters ---------------------------------------------------------------

def test_arkit_head_crosses_the_converter():
    """The reference converter maps the ARKit head's tensors (the
    8-output regression, 17-class and centerness convs, the class bias) at
    their full widths exactly as the JAX package's does.  (A JAX ARKit
    parameter tree crossing the bridge whole: ``test_whole_slice``.)"""
    import importlib.util
    from cnrma_torch import convert
    from cnrma_torch.bridge import from_flax
    from test_torch_stages import _reference_state
    torch.manual_seed(0)
    net = tdet.FCAF3DHeadNet(17, n_reg_outs=8)
    spec = importlib.util.spec_from_file_location(
        "convert_checkpoint", os.path.join(REPO, "tools",
                                           "convert_checkpoint.py"))
    jconv = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jconv)
    head = {"detector.head." + k: v for k, v in net.state_dict().items()
            if k in ("reg_conv", "cls_conv", "centerness_conv", "cls_bias")}
    assert head["detector.head.reg_conv"].shape == (1, 128, 8)
    assert head["detector.head.cls_conv"].shape == (1, 128, 17)
    sd = _reference_state(head)
    params, stats = jconv.convert_state_dict(sd)
    want = from_flax({"params": params, "batch_stats": stats})
    got = convert.reference_state_dict(sd)
    assert set(got) == set(want) == set(head)
    for k in head:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy())
        np.testing.assert_array_equal(got[k].numpy(), head[k].numpy())


# --- the whole slice ----------------------------------------------------------

def test_whole_slice_matches_jax(tmp_path, monkeypatch):
    """A synthetic ARKit scene through the torch test CLI (parameters from
    an ``.npz`` of flax leaves) against JAX ``model.apply`` on the JAX
    reader's sample with the same parameters: ``configs/
    ray_marching_arkit.py`` cut to a 16^3 grid, 4 views of 96x64, the tiny
    detector capacities, fp32 (the JAX bf16 volume sum and tiled volume
    held off, ROADMAP F6), ``space_mode='middle'``; the JAX ARKit tree
    fills the port's model with no missing or extra key.  ``max_points`` covers
    every kept point, so both keep the same set (held against the CLI's
    middle dump); the 7-column boxes and 17 scores within 1e-4 of their
    scale.  JAX compiles at XLA's lowest
    optimisation level (half the compile time; the same function).
    Parameters: the port's default initialisation (seed 1)."""
    from cnrma_tpu.core.builder import build_dataset as j_dataset
    from cnrma_tpu.core.builder import build_model as j_model
    from cnrma_tpu.core.config import Config as JConfig
    from cnrma_tpu.data.loader import collate_scenes
    from cnrma_tpu.ops import sparse as j_sparse
    from cnrma_tpu.train.loop import device_batch
    from cnrma_torch.bridge import from_flax
    from cnrma_torch.core.builder import build_model
    from cnrma_torch.core.config import Config
    from cnrma_torch.tools import test as test_cli
    from test_torch_test_cli import TINY_CAPS, _flax_tree_from_torch
    monkeypatch.setattr(j_sparse, "LUT_CELL_BUDGET", j_sparse.LUT_CELL_BUDGET)
    monkeypatch.setenv("CNRMA_RAY_PALLAS", "interpret")
    data = str(tmp_path / "data")
    ann = write_arkit(data, n_scenes=1, n_frames=6, tsdf_dim=(24, 24, 16),
                      image_size=(128, 96))
    config = os.path.join(REPO, "configs", "ray_marching_arkit.py")
    options = [f"data.test.data_root={data}", f"data.test.ann_file={ann}",
               "data.test.num_frames=4", "data.test.image_size=(96,64)",
               "model.voxel_dim_test=(16,16,16)",
               "data.test.voxel_dim=(16,16,16)", "model.ray_samples=64",
               "model.rays_per_view_cap=2048", "model.max_points=8192",
               "model.detection_head.pts_threshold=500",
               "model.detection_head.test_cfg.nms_pre=16",
               "model.bp_accum_dtype='float32'", "model.bp_tile=0",
               f"model.capacities={TINY_CAPS}"]
    opts = dict(kv.split("=", 1) for kv in options)
    jcfg, tcfg = JConfig.fromfile(config), Config.fromfile(config)
    jcfg.merge_from_options(opts)
    tcfg.merge_from_options(opts)
    jmodel = j_model(jcfg, mode="test")
    assert jmodel.with_yaw and jmodel.n_reg_outs == 8
    sample = device_batch(collate_scenes([j_dataset(jcfg, "test",
                                                    seed=0)[0]]))
    rng = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": rng, "sample": rng}, sample, train=False))
    torch.manual_seed(1)
    torch_model = build_model(tcfg)
    variables = _flax_tree_from_torch(torch_model.state_dict(), shapes)
    # the JAX ARKit tree fills the port's model: no missing or extra key,
    # no other shape (the 8-output regression, the 17 classes)
    from_flax(variables, torch_model)
    ckpt = str(tmp_path / "params.npz")
    np.savez(ckpt, **{"/".join(str(getattr(p, "key", p)) for p in path): v
                      for path, v in
                      jax.tree_util.tree_leaves_with_path(variables)})
    apply = jax.jit(lambda v, b: jmodel.apply(
        v, b, train=False, rngs={"sample": rng})).lower(
            variables, sample).compile(
                compiler_options={"xla_backend_optimization_level": 0})
    out = jax.device_get(apply(variables, sample))
    save, mid = str(tmp_path / "res"), str(tmp_path / "mid")
    test_cli.main([config, ckpt, "--device", "cpu", "--save-path", save,
                   "--middle-save-path", mid, "--cfg-options", *options])
    with open(ann, "rb") as f:
        scene = pickle.load(f)[0]["scene"]

    # the same kept points (the subsample orders them by each side's own
    # draw), in the same 1 cm detector voxels: a point within fp32
    # rounding of a voxel boundary could land in either, and the boxes
    # would no longer compare
    valid = np.asarray(out["points"].valid)[0]
    assert 50 < valid.sum() < int(opts["model.max_points"])

    from scipy.spatial import cKDTree
    want = np.asarray(out["points"].xyz)[0][valid]
    got = np.load(os.path.join(mid, scene + "_vert.npy"))[:, :3]
    assert got.shape == want.shape
    # each point of either side has one of the other within 1e-5 (some
    # points come twice, so the match is not one to one)
    assert cKDTree(got).query(want)[0].max() <= 1e-5 * np.sqrt(3)
    want = want[cKDTree(want).query(got)[1]]
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_array_equal(np.floor(got / 0.01), np.floor(want / 0.01))
    with np.load(os.path.join(save, scene, scene + "_bbox_raw.npz")) as z:
        gb, gs = z["bboxes"], z["scores"]

    def ordered(b, s):
        o = np.argsort(-s.max(1), kind="stable")
        return b[o], s[o]
    v = np.asarray(out["bbox_valid"][0])
    wb, ws = ordered(np.asarray(out["bboxes"][0])[v],
                     np.asarray(out["scores"][0])[v])
    gb, gs = ordered(gb, gs)
    assert len(gb) == len(wb) > 0 and gb.shape[1] == 7 and gs.shape[1] == 17
    np.testing.assert_allclose(gs, ws, atol=1e-4 * np.abs(ws).max())
    np.testing.assert_allclose(gb, wb, atol=1e-4 * np.abs(wb).max())

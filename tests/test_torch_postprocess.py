"""The port's post-processing against the JAX package on the CPU: box IoU,
NMS, the mAP scorer, the config builder, marching cubes, the TSDF
container, PLY writing and the capacity report.

Tolerances: IoU matrices 1e-5 (fp32, the same clip on both sides); NMS keep
masks and outputs equal; mAP 1e-6 against ``indoor_eval`` and the
hand-computed values of ``tests/test_eval_ap.py`` at their own tolerances;
builder knobs equal; marching-cubes faces equal and vertices and normals
within 1e-5; TSDF resample equal to the numpy path; capacity lines equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnrma_tpu.eval.indoor_eval import indoor_eval as j_indoor_eval
from cnrma_tpu.ops import iou3d as j_iou
from cnrma_tpu.ops import nms as j_nms
from cnrma_torch.eval.indoor_eval import indoor_eval as t_indoor_eval
from cnrma_torch.ops import iou3d as t_iou
from cnrma_torch.ops import nms as t_nms

CONFIG = "configs/ray_marching_scannet.py"


def random_boxes(n, seed, yaw=True):
    """n random gravity-center boxes, then the edge cases: touching in x,
    nested, identical, zero-volume (dz 0) and zero-area (dx 0)."""
    rng = np.random.RandomState(seed)
    b = np.concatenate([rng.uniform(-2, 2, (n, 3)),
                        rng.uniform(0.2, 1.5, (n, 3)),
                        rng.uniform(-np.pi, np.pi, (n, 1)) if yaw
                        else np.zeros((n, 1))], axis=1)
    edge = np.array([[0, 0, 0, 1, 1, 1, 0], [1, 0, 0, 1, 1, 1, 0],
                     [0, 0, 0, 0.5, 0.5, 0.5, 0], [0, 0, 0, 1, 1, 1, 0],
                     [0, 0, 0, 1, 1, 0, 0], [0, 0, 0, 0, 1, 1, 0]])
    return np.concatenate([b, edge]).astype(np.float32)


@pytest.mark.parametrize("rotated", [False, True])
@pytest.mark.parametrize("kind", ["bev", "3d"])
def test_iou_matrices(rotated, kind):
    a, b = random_boxes(64, 0, rotated), random_boxes(64, 1, rotated)
    j = {"bev": j_iou.iou_bev_matrix, "3d": j_iou.iou_3d_matrix}[kind]
    t = {"bev": t_iou.iou_bev_matrix, "3d": t_iou.iou_3d_matrix}[kind]
    want = np.asarray(j(jnp.asarray(a), jnp.asarray(b), rotated=rotated))
    got = t(torch.from_numpy(a), torch.from_numpy(b), rotated=rotated)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    assert (want > 0.99).sum() >= 2 and (want == 0).any()


def test_iou_elementwise():
    a, b = random_boxes(64, 2), random_boxes(64, 3)
    b[::2] = a[::2] + np.float32(0.1)
    for jf, tf in ((j_iou.aligned_iou_3d, t_iou.aligned_iou_3d),
                   (j_iou.rotated_iou_3d, t_iou.rotated_iou_3d)):
        want = np.asarray(jf(jnp.asarray(a), jnp.asarray(b)))
        got = tf(torch.from_numpy(a), torch.from_numpy(b)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("rotated", [False, True])
def test_nms_keep_masks(rotated):
    rng = np.random.RandomState(4)
    boxes = random_boxes(60, 5, rotated)
    boxes[:, :2] *= 0.4                     # crowd them so NMS bites
    scores = rng.rand(len(boxes)).astype(np.float32)
    scores[10:20] = scores[0]               # ties break by index
    scores[-3:] = -np.inf                   # never kept
    want = np.asarray(j_nms.nms_bev(jnp.asarray(boxes), jnp.asarray(scores),
                                    0.3, rotated=rotated))
    got = t_nms.nms_bev(torch.from_numpy(boxes), torch.from_numpy(scores),
                        0.3, rotated=rotated).numpy()
    np.testing.assert_array_equal(got, want)
    assert 5 < got.sum() < len(boxes) - 3


@pytest.mark.parametrize("yaw", [False, True])
def test_multiclass_nms(yaw):
    rng = np.random.RandomState(6)
    boxes = random_boxes(80, 7, yaw)[:80]
    boxes[:, :2] *= 0.5
    if not yaw:
        boxes = boxes[:, :6]
    scores = (rng.rand(80, 5) ** 3).astype(np.float32)
    scores[5:9] = scores[4]
    want = j_nms.multiclass_nms_np(boxes, scores)
    got = t_nms.multiclass_nms_np(boxes, scores)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


# --- mAP: the hand-computed cases of tests/test_eval_ap.py ---------------

def _box(x, y, z, dx=1.0, dy=1.0, dz=1.0):
    return [x, y, z, dx, dy, dz]


def _scene(gt_boxes, gt_labels):
    return {"gt_boxes": np.asarray(gt_boxes, np.float32).reshape(-1, 6),
            "labels": np.asarray(gt_labels, np.int64)}


def _preds(boxes, scores, labels):
    return {"boxes": np.asarray(boxes, np.float32).reshape(-1, 6),
            "scores": np.asarray(scores, np.float32),
            "labels": np.asarray(labels, np.int64)}


AP_CASES = {
    "duplicate_detection_is_fp": (
        [_scene([_box(0, 0, 0)], [0])],
        [_preds([_box(0, 0, 0), _box(0.05, 0, 0)], [0.9, 0.8], [0, 0])],
        (0.25,), {"mAP_0.25": 1.0, "mAR_0.25": 1.0}),
    "fp_between_tps": (
        [_scene([_box(0, 0, 0), _box(5, 5, 0)], [0, 0])],
        [_preds([_box(0, 0, 0), _box(10, 10, 0), _box(5, 5, 0)],
                [0.9, 0.8, 0.7], [0, 0, 0])],
        (0.25,), {"mAP_0.25": 5.0 / 6.0}),
    "exact_threshold_iou_is_fp": (
        [_scene([_box(0, 0, 0)], [0])],
        [_preds([_box(1.0 / 3.0, 0, 0)], [0.9], [0])],
        (0.25, 0.5), {"mAP_0.25": 1.0, "mAP_0.50": 0.0}),
    "multi_scene_global_score_sort": (
        [_scene([_box(0, 0, 0)], [0]), _scene([_box(5, 5, 0)], [0])],
        [_preds([_box(0, 0, 0)], [0.9], [0]),
         _preds([_box(20, 20, 0), _box(5, 5, 0)], [0.85, 0.8], [0, 0])],
        (0.25,), {"mAP_0.25": 5.0 / 6.0}),
    "match_is_scene_local": (
        [_scene([_box(0, 0, 0)], [0]), _scene([_box(5, 5, 0)], [0])],
        [_preds(np.zeros((0, 6)), [], []),
         _preds([_box(0, 0, 0)], [0.9], [0])],
        (0.25,), {"mAP_0.25": 0.0}),
    "greedy_takes_best_iou_gt": (
        [_scene([_box(0, 0, 0), _box(0.8, 0, 0)], [0, 0])],
        [_preds([_box(0.1, 0, 0)], [0.9], [0])],
        (0.25,), {"mAR_0.25": 0.5}),
    "class_bookkeeping": (
        [_scene([_box(0, 0, 0), _box(5, 5, 0)], [0, 1])],
        [_preds([_box(0, 0, 0), _box(9, 9, 0)], [0.9, 0.9], [0, 2])],
        (0.25,), {"a_AP_0.25": 1.0, "b_AP_0.25": 0.0, "mAP_0.25": 0.5}),
    "duplicate_before_other_tp": (
        [_scene([_box(0, 0, 0), _box(5, 5, 0)], [0, 0])],
        [_preds([_box(0, 0, 0), _box(0.02, 0, 0), _box(5, 5, 0)],
                [0.9, 0.85, 0.8], [0, 0, 0])],
        (0.25,), {"mAP_0.25": 5.0 / 6.0}),
}


@pytest.mark.parametrize("case", sorted(AP_CASES))
def test_map_hand_computed(case):
    gts, preds, thrs, expect = AP_CASES[case]
    m = t_indoor_eval(gts, preds, iou_thrs=thrs,
                      label2cat={0: "a", 1: "b", 2: "c"}, logger=None)
    for key, value in expect.items():
        np.testing.assert_allclose(m[key], value, rtol=1e-6, err_msg=key)
    if case == "class_bookkeeping":
        assert "c_AP_0.25" not in m


@pytest.mark.parametrize("rotated", [False, True])
def test_map_matches_indoor_eval(rotated):
    """Random predictions over 3 scenes: every metric within 1e-6."""
    rng = np.random.RandomState(8)
    gts, preds = [], []
    for s in range(3):
        g = random_boxes(12, 10 + s, rotated)[:12]
        g[:, 2] = rng.uniform(0, 1, 12)
        p = np.concatenate([g + rng.normal(0, 0.15, g.shape).astype(
            np.float32), random_boxes(8, 20 + s, rotated)[:8]])
        p[:, 3:6] = np.abs(p[:, 3:6])
        # two classes, the same counts in every scene: the JAX IoU
        # compiles once per shape
        gts.append({"gt_boxes": g, "labels": np.arange(12) % 2})
        preds.append({"boxes": p, "scores": rng.rand(20).astype(np.float32),
                      "labels": np.arange(20) % 2})
    want = j_indoor_eval(gts, preds, rotated=rotated, logger=None)
    got = t_indoor_eval(gts, preds, rotated=rotated, logger=None)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-6, err_msg=k)
    assert 0.1 < want["mAP_0.25"] < 1.0


# --- config builder ---------------------------------------------------------

@pytest.mark.parametrize("options", [{}, {
    "model.voxel_dim_test": "(48,48,32)", "model.ray_samples": "64",
    "model.rays_per_view_cap": "1024", "model.max_points": "4096",
    "model.neus_threshold": "0.1", "model.compute_dtype": "bfloat16",
    "model.detection_head.n_classes": "5",
    "model.detection_head.test_cfg.nms_pre": "16",
    "model.detection_head.pts_threshold": "300",
    "model.capacities": "{'voxelize':256,'stride2':128,'stride4':64,"
                        "'levels':(32,16,8,8),'neck':(64,32,16)}",
    "model.pixel_mean": "[1.0,2.0,3.0]", "model.ray_skip_factor": "0",
}], ids=["config", "cfg_options"])
def test_builder_knobs(options, monkeypatch):
    """Every knob of the torch build_model equals the JAX build_model's
    (a flax dataclass, built without init)."""
    from cnrma_tpu.core import builder as j_builder
    from cnrma_tpu.core.config import Config as JConfig
    from cnrma_tpu.ops import sparse as j_sparse
    from cnrma_torch.core import builder as t_builder
    from cnrma_torch.core.config import Config as TConfig
    # the JAX builder sets this module global; keep it for later tests
    monkeypatch.setattr(j_sparse, "LUT_CELL_BUDGET", j_sparse.LUT_CELL_BUDGET)
    jcfg, tcfg = JConfig.fromfile(CONFIG), TConfig.fromfile(CONFIG)
    jcfg.merge_from_options(dict(options))
    tcfg.merge_from_options(dict(options))
    jm = j_builder.build_model(jcfg, mode="test")
    kw = t_builder.cnrma_kwargs(tcfg)
    for name, value in kw.items():
        want = getattr(jm, name)
        if name == "compute_dtype":
            assert value == getattr(torch, jnp.dtype(want).name), name
        elif name == "capacities":
            assert tuple(value) == tuple(want), name
        else:
            assert value == want, (name, value, want)
    model = t_builder.build_model(tcfg)
    assert model.voxel_dim == jm.voxel_dim
    assert model.detector.nms_pre == jm.nms_pre
    assert not model.training


def test_builder_refuses_later_items():
    """The ARKit yaw detector and reader are refused, naming their ROADMAP
    item; the stage-1 and stage-2 models build (they were refused until
    they were ported)."""
    from cnrma_torch.core import builder as t_builder
    from cnrma_torch.core.config import Config as TConfig
    from cnrma_torch.models.cn_rma import Atlas
    from cnrma_torch.models.fcaf3d_only import FCAF3DOnly
    with pytest.raises(NotImplementedError, match="item 9"):
        t_builder.build_model(TConfig.fromfile("configs/ray_marching_arkit.py"))
    for cfg, cls in (("configs/atlas_recon_scannet.py", Atlas),
                     ("configs/fcaf3d_middle_scannet.py", FCAF3DOnly)):
        assert type(t_builder.build_model(TConfig.fromfile(cfg))) is cls
    train = t_builder.build_model(TConfig.fromfile(CONFIG), mode="train")
    assert train.training and train.voxel_dim == (192, 192, 80)
    with pytest.raises(NotImplementedError, match="item 9"):
        t_builder.build_dataset(TConfig.fromfile(
            "configs/ray_marching_arkit.py"), "test")


# --- marching cubes, TSDF, PLY ---------------------------------------------

def _sphere(shape, center, radius):
    g = np.stack(np.meshgrid(*[np.arange(n) for n in shape], indexing="ij"))
    c = np.asarray(center)[:, None, None, None]
    return ((np.sqrt(((g - c) ** 2).sum(0)) - radius) / 3).astype(np.float32)


@pytest.mark.parametrize("kind", ["sphere", "noise"])
def test_marching_cubes(kind):
    from cnrma_tpu.utils.marching_cubes import marching_cubes as j_mc
    from cnrma_torch.utils.marching_cubes import marching_cubes as t_mc
    if kind == "sphere":
        vol = _sphere((20, 18, 16), (9.5, 8.2, 7.7), 6.3)
    else:
        vol = (np.random.RandomState(9).rand(12, 10, 9) * 2 - 1).astype(
            np.float32)
    want = j_mc(vol, 0.0)
    got = [t.numpy() for t in t_mc(torch.from_numpy(vol), 0.0)]
    assert len(want[1]) > 1000
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], atol=1e-5)
    np.testing.assert_allclose(got[2], want[2], atol=1e-5)


def test_tsdf_mesh_resample_and_ply(tmp_path, monkeypatch):
    """``TSDF.transform`` equals the JAX numpy path (its C++ resample off)
    under a translation and a rotation; ``get_mesh`` equals the numpy mesh;
    the PLY bytes and the npz keys equal the JAX package's."""
    from cnrma_tpu.geometry import tsdf as j_tsdf
    from cnrma_tpu.utils import native
    from cnrma_tpu.utils.ply import write_ply_mesh as j_ply
    from cnrma_torch.geometry.tsdf import TSDF
    from cnrma_torch.utils.ply import write_ply_mesh as t_ply
    monkeypatch.setattr(native, "available", lambda: False)
    rng = np.random.RandomState(10)
    vol = np.clip(_sphere((40, 36, 24), (20, 17, 11), 8.0)
                  + rng.normal(0, 0.05, (40, 36, 24)), -1, 1).astype(
                      np.float32)
    org = np.array([[0.3, -0.2, 0.1]], np.float32)
    rot = np.eye(4, dtype=np.float32)
    a = 0.3
    rot[:2, :2] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
    rot[:3, 3] = [0.5, -0.3, 0.1]
    shift = np.eye(4, dtype=np.float32)
    shift[:3, 3] = [-0.48, 0.12, -0.2]
    for T in (shift, rot):
        want = j_tsdf.TSDF(0.04, org, vol).transform(T, [32, 28, 20],
                                                     (0, 0, 0))
        got = TSDF(0.04, org, vol).transform(T, [32, 28, 20], (0, 0, 0))
        np.testing.assert_array_equal(got.tsdf_vol, want.tsdf_vol)
    jm = j_tsdf.TSDF(0.04, org, vol).get_mesh()
    tm = TSDF(0.04, org, vol).get_mesh()
    np.testing.assert_array_equal(tm[1], jm[1])
    np.testing.assert_allclose(tm[0], jm[0], atol=1e-5)
    j_ply(str(tmp_path / "j.ply"), *jm[:2], vertex_normals=jm[2])
    t_ply(str(tmp_path / "t.ply"), *jm[:2], vertex_normals=jm[2])
    assert (tmp_path / "j.ply").read_bytes() == \
        (tmp_path / "t.ply").read_bytes()
    TSDF(0.04, org, vol).save(str(tmp_path / "t.npz"))
    back = j_tsdf.TSDF.load(str(tmp_path / "t.npz"))
    np.testing.assert_array_equal(back.tsdf_vol, vol)
    np.testing.assert_array_equal(back.origin, org)


# --- capacity report --------------------------------------------------------

def _jax_capacity_lines(capfd):
    from cnrma_tpu.ops import sparse as js
    pts = jnp.asarray(np.random.RandomState(0).rand(64, 3).astype(
        np.float32))
    feats = jnp.ones((64, 2), jnp.float32)

    @jax.jit
    def f(p):
        st = js.voxelize_points(p, feats, jnp.ones((64,), bool), 0.05,
                                capacity=16)
        ks, _, _ = js.downsample_coords(st, 2, capacity=8)
        ks4, _, _ = js.downsample_coords(st, 8, capacity=64)
        return ks, ks4
    jax.block_until_ready(f(pts))
    return [ln for ln in capfd.readouterr().out.splitlines()
            if ln.startswith("[capacity]")]


def _torch_capacity_lines(capsys):
    from cnrma_torch.ops import sparse as ts
    pts = torch.from_numpy(np.random.RandomState(0).rand(64, 3).astype(
        np.float32))
    st = ts.voxelize_points(pts, torch.ones(64, 2), torch.ones(64,
                                                               dtype=bool),
                            0.05, capacity=16)
    ts.downsample_coords(st, 2, capacity=8)
    ts.downsample_coords(st, 8, capacity=64)
    return [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("[capacity]")]


def test_capacity_report_matches_jax(capfd, monkeypatch):
    """64 random points at 5 cm into 16 slots (the planted saturation),
    then two dedups, one saturated and one not: the JAX lines (its sort
    path) and the port's are the same."""
    from cnrma_tpu.ops import sparse as js
    monkeypatch.setattr(js, "LUT_CELL_BUDGET", 0)
    monkeypatch.setenv("CNRMA_CAPACITY_DEBUG", "1")
    want = _jax_capacity_lines(capfd)
    got = _torch_capacity_lines(capfd)
    assert got == want
    assert len(got) == 3 and "saturated=1" in got[0] \
        and got[2].endswith("saturated=0"), got
    assert got[0].startswith("[capacity] voxelize(stride 1): ")


def test_capacity_report_silent_off(capsys, monkeypatch):
    monkeypatch.delenv("CNRMA_CAPACITY_DEBUG", raising=False)
    assert _torch_capacity_lines(capsys) == []
    monkeypatch.setenv("CNRMA_CAPACITY_DEBUG", "0")
    assert _torch_capacity_lines(capsys) == []


def test_ray_march_and_subsample_reports(capsys, monkeypatch):
    """The per-view kept-sample line where the capacity is below a view's
    samples, and the scene-points line, with the fills counted from the
    same weights."""
    from cnrma_torch.models.cn_rma import _normalize_subsample
    from cnrma_torch.ops.ray_marching import RayMarchPoints, _points
    monkeypatch.setenv("CNRMA_CAPACITY_DEBUG", "1")
    g = torch.Generator().manual_seed(0)
    weight = torch.rand(3, 16, 4, generator=g)
    weight[weight < 0.6] = 0
    weight[2] = 0                        # an empty view
    pts = _points(weight, torch.zeros(3, 16, 4, dtype=torch.int32),
                  torch.zeros(3, 3), torch.ones(3, 16, 3), torch.arange(3),
                  0.1, 4, 10)
    flat = RayMarchPoints(*(f.flatten(0, 1) for f in pts))
    _normalize_subsample(flat, 12, g)
    counts = (weight > 0).reshape(3, -1).sum(1).tolist()
    kept = sum(min(c, 10) for c in counts)
    want = [f"[capacity] ray-march kept samples/view: {c}/10 "
            f"saturated={int(c >= 10)}" for c in counts]
    want.append(f"[capacity] scene points before max_points subsample: "
                f"{kept}/12 saturated={int(kept >= 12)}")
    assert capsys.readouterr().out.splitlines() == want
    assert counts[0] > 10 and counts[2] == 0

"""The port's test CLI slice against the JAX package on the CPU: the ScanNet
reader, the CLI's files, the whole slice from a dataset scene to boxes, the
offline NMS + mAP chain, and the capacity report of a forward.

Tolerances: the reader's images, projections, masks and offsets equal; its
GT TSDFs within 1e-6 of the JAX reader's (which takes its C++ resample
where built; the port runs the numpy path's arithmetic in torch); boxes and
scores of the whole slice within 1e-4 of their scale (fp32; the points
meet the detector in another order); files of a scene run alone equal to
those of the same scene inside a run; NMS files equal.
"""

import os
import shutil
import sys

import jax
import numpy as np
import pytest
import torch

from test_data import make_synthetic_scannet
from test_tools_contract import _write_scene
from _torch_spawn import CHILD_ENV
from _torch_threads import _few_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "ray_marching_scannet.py")
# the synthetic cameras' ring looks at the 16^3 grid, which 'origin' mode
# places from 0.48 m before the TSDF's origin; off the 1 cm lattice, so that
# no ray sample sits on a voxel boundary of the detector
TARGET = (-0.1633, -0.1571, -0.1612)
TINY_CAPS = ("{'voxelize':2048,'stride2':1024,'stride4':512,"
             "'levels':(256,128,64,32),'neck':(512,256,128)}")


def tiny_options(data, ann, frames=4):
    """--cfg-options that cut configs/ray_marching_scannet.py to a 16^3
    grid, ``frames`` views of 64x96 and the tiny detector capacities, in
    fp32 everywhere (the JAX bf16 volume sum and its tiled volume path
    are held off, ROADMAP F6)."""
    return [f"data.test.data_root={data}", f"data.test.ann_file={ann}",
            f"data.test.num_frames={frames}", "data.test.image_size=(96,64)",
            "model.voxel_dim_test=(16,16,16)", "data.test.voxel_dim=(16,16,16)",
            "model.ray_samples=64", "model.rays_per_view_cap=512",
            f"model.max_points={frames * 512}",
            "model.detection_head.pts_threshold=500",
            "model.detection_head.test_cfg.nms_pre=16",
            "model.bp_accum_dtype='float32'", "model.bp_tile=0",
            f"model.capacities={TINY_CAPS}"]


def _load_all(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


# --- reader -----------------------------------------------------------------

def test_reader_matches_jax(tmp_path):
    from cnrma_tpu.data.scannet import AtlasScanNetDataset as JReader
    from cnrma_torch.data.scannet import AtlasScanNetDataset as TReader
    ann = make_synthetic_scannet(str(tmp_path), n_scenes=2, n_frames=6)
    kw = dict(data_root=str(tmp_path), ann_file=ann, test_mode=True,
              num_frames=4, voxel_dim=(48, 48, 32), space_mode="origin",
              seed=0)
    jr, tr = JReader(**kw), TReader(**kw)
    for i in range(2):                  # in order: one seeded RandomState
        want, got = jr[i], tr[i]
        assert set(got) == set(want)
        assert got["scene"] == want["scene"]
        assert list(got["image_ids"]) == list(want["image_ids"])
        for k, w in want.items():
            if k in ("scene", "image_ids"):
                continue
            if k.startswith("tsdf_gt"):
                np.testing.assert_allclose(got[k], w, atol=1e-6, err_msg=k)
            else:
                assert got[k].dtype == w.dtype, k
                np.testing.assert_array_equal(got[k], w, err_msg=k)
    assert len(set(map(tuple, (jr[0]["image_ids"], jr[1]["image_ids"])))) \
        == 2


# --- the CLI's files --------------------------------------------------------

@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """3 tiny synthetic scenes (cameras aimed at the 16^3 grid, as in
    ``test_whole_slice_matches_jax``), default-initialised parameters saved
    as a ``.pt``; the CLI run with --max-scenes 2 and again with 1."""
    from cnrma_torch.core.builder import build_model
    from cnrma_torch.core.config import Config
    from cnrma_torch.synthetic import write_scannet
    from cnrma_torch.tools import test as test_cli
    root = tmp_path_factory.mktemp("cli")
    data = str(root / "data")
    ann = write_scannet(data, n_scenes=3, n_frames=5, tsdf_dim=(32, 32, 16),
                        target=TARGET, radius=1.0)
    options = tiny_options(data, ann)
    cfg = Config.fromfile(CONFIG)
    cfg.merge_from_options(dict(kv.split("=", 1) for kv in options))
    torch.manual_seed(0)
    ckpt = str(root / "init.pt")
    torch.save(build_model(cfg).state_dict(), ckpt)
    runs = {}
    for n in (2, 1):
        save, mid = str(root / f"res{n}"), str(root / f"mid{n}")
        records = test_cli.main([CONFIG, ckpt, "--device", "cpu",
                                 "--max-scenes", str(n), "--save-path", save,
                                 "--middle-save-path", mid,
                                 "--cfg-options", *options])
        runs[n] = (save, mid, records)
    return cfg, ckpt, runs, options


def test_cli_writes_exactly_n_scenes(cli_run):
    _, _, runs, _ = cli_run
    save, mid, records = runs[2]
    scenes = sorted(os.listdir(save))
    assert scenes == ["scene0000_00", "scene0001_00"] and len(records) == 2
    for s in scenes:
        assert sorted(os.listdir(os.path.join(save, s))) == sorted(
            [s + ".npz", s + ".ply", s + "_bbox_raw.npz"])
        tsdf = _load_all(os.path.join(save, s, s + ".npz"))
        assert tsdf["tsdf"].shape == (16, 16, 16)
        assert float(tsdf["voxel_size"]) == pytest.approx(0.04)
        assert tsdf["origin"].shape == (1, 3)
        vert = np.load(os.path.join(mid, s + "_vert.npy"))
        assert vert.dtype == np.float32 and vert.shape[1] == 35
    assert sorted(os.listdir(mid)) == [s + "_vert.npy" for s in scenes]


def test_cli_raw_boxes_are_the_models_valid_rows(cli_run):
    """Each scene's ``_bbox_raw.npz`` holds the valid rows of the model's
    forward on the reader's sample, with the subsample drawn from a
    generator seeded by the scene's index."""
    from cnrma_torch.core.builder import build_dataset, build_model
    cfg, ckpt, runs, _ = cli_run
    save = runs[2][0]
    model = build_model(cfg)
    model.load_state_dict(torch.load(ckpt, weights_only=True))
    dataset = build_dataset(cfg, "test", seed=0)
    n_boxes = 0
    for index in range(2):
        sample = dataset[index]
        batch = {k: torch.from_numpy(np.asarray(sample[k])[None])
                 for k in ("imgs", "projection", "view_valid", "offset")}
        out = model(batch, generator=torch.Generator().manual_seed(index))
        v = out["bbox_valid"][0]
        scene = sample["scene"]
        raw = _load_all(os.path.join(save, scene, scene + "_bbox_raw.npz"))
        np.testing.assert_array_equal(raw["bboxes"],
                                      out["bboxes"][0][v].numpy())
        np.testing.assert_array_equal(raw["scores"],
                                      out["scores"][0][v].numpy())
        assert raw["bboxes"].dtype == np.float32
        n_boxes += len(raw["bboxes"])
    assert n_boxes > 0


def test_cli_scene_alone_equals_scene_in_run(cli_run):
    _, _, runs, _ = cli_run
    (save2, mid2, _), (save1, mid1, _) = runs[2], runs[1]
    assert os.listdir(save1) == ["scene0000_00"]
    s = "scene0000_00"
    for f in (s + ".npz", s + "_bbox_raw.npz"):
        a = _load_all(os.path.join(save1, s, f))
        b = _load_all(os.path.join(save2, s, f))
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f + ":" + k)
    with open(os.path.join(save1, s, s + ".ply"), "rb") as f1, \
            open(os.path.join(save2, s, s + ".ply"), "rb") as f2:
        assert f1.read() == f2.read()
    np.testing.assert_array_equal(np.load(os.path.join(mid1, s + "_vert.npy")),
                                  np.load(os.path.join(mid2, s + "_vert.npy")))


@pytest.fixture(scope="module")
def sharded_run(cli_run, tmp_path_factory):
    """The CLI over two CPU processes (``--n-devices 2``) with
    ``--max-scenes 3``: rank 0 writes scenes 0 and 2, rank 1 scene 1; the
    processes' OpenMP threads passive (``_torch_spawn.CHILD_ENV``)."""
    from cnrma_torch.tools import test as test_cli
    _, ckpt, _, options = cli_run
    root = tmp_path_factory.mktemp("sharded")
    save, mid = str(root / "res"), str(root / "mid")
    with pytest.MonkeyPatch.context() as mp_:
        for k, v in CHILD_ENV.items():
            mp_.setenv(k, v)
        records = test_cli.main([CONFIG, ckpt, "--device", "cpu",
                                 "--n-devices", "2", "--max-scenes", "3",
                                 "--save-path", save, "--middle-save-path",
                                 mid, "--cfg-options", *options])
    return save, mid, records


def test_cli_n_devices_writes_the_one_process_files(cli_run, sharded_run):
    """Each scene's files from its rank equal the one-process run's: the
    subsample is seeded by the scene's global index and the frame draws
    are made in scene order on every rank."""
    _, _, runs, _ = cli_run
    save1, mid1, _ = runs[2]
    save, mid, records = sharded_run
    assert [(r["index"], r["rank"]) for r in records] == [(0, 0), (1, 1),
                                                          (2, 0)]
    for s in ("scene0000_00", "scene0001_00"):
        for f in (s + ".npz", s + "_bbox_raw.npz"):
            a = _load_all(os.path.join(save1, s, f))
            b = _load_all(os.path.join(save, s, f))
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k],
                                              err_msg=f + ":" + k)
        with open(os.path.join(save1, s, s + ".ply"), "rb") as f1, \
                open(os.path.join(save, s, s + ".ply"), "rb") as f2:
            assert f1.read() == f2.read()
        np.testing.assert_array_equal(
            np.load(os.path.join(mid1, s + "_vert.npy")),
            np.load(os.path.join(mid, s + "_vert.npy")))


def test_cli_n_devices_writes_exactly_max_scenes(sharded_run):
    save, mid, records = sharded_run
    scenes = ["scene0000_00", "scene0001_00", "scene0002_00"]
    assert sorted(os.listdir(save)) == scenes and len(records) == 3
    assert sorted(os.listdir(mid)) == [s + "_vert.npy" for s in scenes]
    for s in scenes:
        assert sorted(os.listdir(os.path.join(save, s))) == sorted(
            [s + ".npz", s + ".ply", s + "_bbox_raw.npz"])


def test_cli_reads_at_most_one_scene_ahead(cli_run, tmp_path, monkeypatch):
    """However fast the reader is against the forward, the CLI with one
    reader thread holds at most two samples at once: the scene it runs
    and the next one."""
    import weakref
    from cnrma_torch.tools import test as test_cli
    _, ckpt, _, options = cli_run
    alive, peak = [0], [0]

    class _Token:
        pass

    def _gone():
        alive[0] -= 1

    class Counted:
        def __init__(self, dataset):
            self.dataset = dataset

        def __len__(self):
            return len(self.dataset)

        def __getitem__(self, i):
            sample = self.dataset[i]
            sample["token"] = token = _Token()
            weakref.finalize(token, _gone)
            alive[0] += 1
            peak[0] = max(peak[0], alive[0])
            return sample

    build = test_cli.build_dataset
    monkeypatch.setattr(test_cli, "build_dataset",
                        lambda *a, **k: Counted(build(*a, **k)))
    records = test_cli.main([CONFIG, ckpt, "--device", "cpu",
                             "--save-path", str(tmp_path / "res"),
                             "--cfg-options", *options,
                             "data.workers_per_gpu=0"])
    assert len(records) == 3
    assert peak[0] == 2 and alive[0] == 0


# --- the whole slice against JAX ---------------------------------------------

def _flax_tree_from_torch(state, shapes):
    """The flax variable tree (``shapes``' structure) holding a torch state
    dict: the inverse of ``cnrma_torch.bridge.from_flax``."""
    from cnrma_torch.bridge import _convert

    def leaf(path, s):
        names = [str(getattr(p, "key", p)) for p in path]
        key, _ = _convert(names[0], names[1:], np.zeros(s.shape, np.float32))
        w = state[key].numpy()
        if names[-1] == "kernel" and w.ndim in (4, 5):
            w = np.transpose(w, tuple(range(2, w.ndim)) + (1, 0))
        assert w.shape == s.shape, key
        return w
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def test_whole_slice_matches_jax(tmp_path, monkeypatch, capfd):
    """A dataset scene through the torch CLI (parameters from an ``.npz``
    of flax leaves) against JAX ``model.apply`` on the JAX reader's sample
    with the same parameters; both with the capacity report on, whose
    lines must agree too.  ``max_points`` covers every kept point, so the
    two subsample draws keep the same set.  Parameters: the port's default
    initialisation (seed 1), bridged to flax leaves."""
    from cnrma_tpu.core.builder import build_dataset as j_dataset
    from cnrma_tpu.core.builder import build_model as j_model
    from cnrma_tpu.core.config import Config as JConfig
    from cnrma_tpu.data.loader import collate_scenes
    from cnrma_tpu.ops import sparse as j_sparse
    from cnrma_tpu.train.loop import device_batch
    from cnrma_torch.core.builder import build_model
    from cnrma_torch.core.config import Config
    from cnrma_torch.synthetic import write_scannet
    from cnrma_torch.tools import test as test_cli
    monkeypatch.setattr(j_sparse, "LUT_CELL_BUDGET", j_sparse.LUT_CELL_BUDGET)
    monkeypatch.setenv("CNRMA_RAY_PALLAS", "interpret")
    monkeypatch.setenv("CNRMA_CAPACITY_DEBUG", "1")
    data = str(tmp_path / "data")
    ann = write_scannet(data, n_scenes=1, n_frames=6, tsdf_dim=(32, 32, 16),
                        target=TARGET, radius=1.0)
    options = tiny_options(data, ann)
    opts = dict(kv.split("=", 1) for kv in options)
    jcfg, tcfg = JConfig.fromfile(CONFIG), Config.fromfile(CONFIG)
    jcfg.merge_from_options(opts)
    tcfg.merge_from_options(opts)

    jmodel = j_model(jcfg, mode="test")
    sample = device_batch(collate_scenes([j_dataset(jcfg, "test",
                                                    seed=0)[0]]))
    rng = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": rng, "sample": rng}, sample, train=False))
    torch.manual_seed(1)
    variables = _flax_tree_from_torch(build_model(tcfg).state_dict(), shapes)
    ckpt = str(tmp_path / "params.npz")
    np.savez(ckpt, **{"/".join(str(getattr(p, "key", p)) for p in path): v
                      for path, v in
                      jax.tree_util.tree_leaves_with_path(variables)})

    capfd.readouterr()
    out = jax.device_get(jax.jit(lambda v, b: jmodel.apply(
        v, b, train=False, rngs={"sample": rng}))(variables, sample))
    j_lines = [ln for ln in capfd.readouterr().out.splitlines()
               if ln.startswith("[capacity]")]
    save = str(tmp_path / "res")
    test_cli.main([CONFIG, ckpt, "--device", "cpu", "--save-path", save,
                   "--cfg-options", *options])
    t_lines = [ln for ln in capfd.readouterr().out.splitlines()
               if ln.startswith("[capacity]")]

    sites = ("voxelize(", "dedup(", "ray-march kept samples/view",
             "scene points before max_points subsample")
    j_lines = [ln for ln in j_lines if any(s in ln for s in sites)]
    assert sorted(t_lines) == sorted(j_lines)
    assert any("ray-march" in ln for ln in t_lines)

    valid = np.asarray(out["points"].valid)
    assert 50 < valid.sum() < int(opts["model.max_points"])
    # the detector floors positions to 1 cm voxels: a point within fp32
    # rounding of a boundary could land in either voxel, so the comparison
    # holds only for data with none there (this scene's nearest: 9e-4)
    cells = np.asarray(out["points"].xyz)[valid] / 0.01
    assert np.abs(cells - np.round(cells)).min() > 1e-4
    scene = "scene0000_00"
    raw = _load_all(os.path.join(save, scene, scene + "_bbox_raw.npz"))

    def ordered(b, s):
        o = np.argsort(-s.max(1), kind="stable")
        return b[o], s[o]
    v = np.asarray(out["bbox_valid"][0])
    wb, ws = ordered(np.asarray(out["bboxes"][0])[v],
                     np.asarray(out["scores"][0])[v])
    gb, gs = ordered(raw["bboxes"], raw["scores"])
    assert len(gb) == len(wb) > 0
    np.testing.assert_allclose(gs, ws, atol=1e-4 * np.abs(ws).max())
    np.testing.assert_allclose(gb, wb, atol=1e-4 * np.abs(wb).max())


# --- the offline chain -----------------------------------------------------

def test_offline_chain_through_torch_tools(tmp_path, monkeypatch):
    """``tests/test_tools_contract.py``'s z-convention chain through the
    torch nms_bbox and evaluate_bbox: perfect predictions score 1.0, the
    NMS files equal those of ``tools/nms_bbox.py``, and predictions lifted
    by dz/2 score 0 at IoU 0.5."""
    from cnrma_torch.tools import evaluate_bbox, nms_bbox
    sys.path.insert(0, REPO)
    from tools import nms_bbox as j_nms_bbox
    boxes = np.array([[1.0, 1.0, 0.8, 0.8, 0.6, 1.6],
                      [3.5, 1.0, 0.4, 1.6, 2.0, 0.8],
                      [1.0, 4.0, 1.2, 2.0, 0.9, 2.4]], np.float32)
    labels = np.array([2, 1, 7])
    data = str(tmp_path / "data")
    gt_dir = os.path.join(data, "scannet_instance_data")
    scene = "scene0000_00"
    metrics = {}
    for case, z in (("exact", 0.0), ("lifted", 0.5)):
        res = str(tmp_path / case)
        lifted = boxes.copy()
        lifted[:, 2] += z * boxes[:, 5]
        _write_scene(res, gt_dir, scene, lifted, labels)
        np.save(os.path.join(gt_dir, scene + "_aligned_bbox.npy"),
                np.concatenate([boxes, np.array(
                    [[5.0], [4.0], [10.0]], np.float32)], axis=1))
        nms_bbox.main(["--result_path", res, "--device", "cpu"])
        metrics[case] = evaluate_bbox.main(["--data_path", data,
                                            "--result_path", res,
                                            "--device", "cpu"])
        jres = str(tmp_path / (case + "_jax"))
        shutil.copytree(res, jres)
        monkeypatch.setattr(sys, "argv", ["nms_bbox.py", "--result_path",
                                          jres])
        j_nms_bbox.main()
        f = os.path.join(scene, scene + "_atlas_bbox.npz")
        got, want = _load_all(os.path.join(res, f)), _load_all(
            os.path.join(jres, f))
        for k in ("boxes", "scores", "labels"):
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        if case == "exact":
            np.testing.assert_array_equal(np.sort(got["boxes"], axis=0),
                                          np.sort(boxes, axis=0))
    assert metrics["exact"]["mAP_0.25"] == 1.0
    assert metrics["exact"]["mAP_0.50"] == 1.0
    assert metrics["lifted"]["mAP_0.50"] == 0.0


def test_evaluate_arkit_matches_jax(tmp_path, monkeypatch):
    """``evaluate_bbox --dataset arkit`` (rotated boxes, yaw in the GT and
    the results): every metric within 1e-6 of ``tools/evaluate_bbox.py``."""
    from cnrma_torch.tools import evaluate_bbox
    sys.path.insert(0, REPO)
    from tools import evaluate_bbox as j_evaluate_bbox
    rng = np.random.RandomState(11)
    data, res = str(tmp_path / "data"), str(tmp_path / "res")
    gt_dir = os.path.join(data, "arkit_instance_data")
    os.makedirs(gt_dir)
    for s in range(2):
        scene = f"scene{s:04d}_00"
        gt = np.concatenate([rng.uniform(0, 4, (6, 3)),
                             rng.uniform(0.3, 1.5, (6, 3)),
                             rng.uniform(-np.pi, np.pi, (6, 1)),
                             (np.arange(6) % 3)[:, None]], axis=1)
        np.save(os.path.join(gt_dir, scene + "_aligned_bbox.npy"),
                gt.astype(np.float32))
        boxes = np.concatenate([gt[:, :7], gt[:, :7]]).astype(np.float32)
        boxes[6:, :2] += rng.normal(0, 0.2, (6, 2))
        boxes[6:, 6] += rng.normal(0, 0.3, 6)
        os.makedirs(os.path.join(res, scene))
        np.savez(os.path.join(res, scene, scene + "_atlas_bbox.npz"),
                 boxes=boxes, scores=rng.rand(12).astype(np.float32),
                 labels=np.concatenate([gt[:, 7], gt[:, 7]]).astype(
                     np.int64))
    argv = ["--dataset", "arkit", "--data_path", data, "--result_path", res]
    got = evaluate_bbox.main(argv + ["--device", "cpu"])
    monkeypatch.setattr(sys, "argv", ["evaluate_bbox.py"] + argv)
    want = j_evaluate_bbox.main()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-6, err_msg=k)
    assert 0.2 < want["mAP_0.50"] < 1.0

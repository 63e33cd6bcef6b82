"""The port's data preparation against the JAX package's, on the CPU: the
TSDF fusion (``cnrma_torch.geometry.tsdf_fusion``) and each script of
``cnrma_torch/tools/data_prepare/`` and ``cnrma_torch/tools/
visualize_results.py`` against ``cnrma_tpu.geometry.tsdf_fusion`` and the
JAX package's ``tools/``, on the same tiny synthetic inputs made from a
seed; and ROADMAP F17 on a synthetic ``.sens`` with ScanNet's two camera
sizes.

Tolerances (``tsdf_fusion.PARITY_ATOL``, ``PARITY_MAX_SHARE``,
``near_ties``): the fused TSDF within 1e-5 absolute (XLA may contract the
projection's multiply-adds into FMAs: the fp32 values differ by about one
ulp of the running sum) and the weights exactly, except at near ties
(``tsdf_fusion.near_ties``: a voxel whose projected pixel lies within 1e-3
of a half-integer, or whose signed distance lies within 1e-4 of the
truncation's -1 or 1, in some frame), where one ulp takes the other pixel
or the other branch; at most 1% of the voxels may differ there.
Everything else is exact: the bounds, the scripts' arrays and pickles,
and every written file byte for byte.
"""

import argparse
import filecmp
import os
import shutil
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from cnrma_torch import synthetic  # noqa: E402
from cnrma_torch.geometry import tsdf_fusion as tfus  # noqa: E402
from cnrma_tpu.geometry import tsdf_fusion as jfus  # noqa: E402
from _torch_threads import _few_threads  # noqa: F401

SCENE = "scene0000_00"


def _jax_argv(monkeypatch, module, argv):
    """Run a JAX-side tool's ``main()``, which reads ``sys.argv``."""
    monkeypatch.setattr(sys, "argv", [module.__file__, *argv])
    module.main()


def _same_tree(a: str, b: str) -> None:
    """Every file under ``a`` and ``b``: the same names, the same bytes."""
    cmp = filecmp.dircmp(a, b)
    assert not cmp.left_only and not cmp.right_only, (cmp.left_only,
                                                      cmp.right_only)
    _, mismatch, errors = filecmp.cmpfiles(a, b, cmp.common_files,
                                           shallow=False)
    assert not mismatch and not errors, (mismatch, errors)
    for sub in cmp.common_dirs:
        _same_tree(os.path.join(a, sub), os.path.join(b, sub))


# --- the fusion -----------------------------------------------------------

def _close_fusion(got, want, depths, projections, origin, voxel_size):
    """The port's (tsdf, weight) against JAX's (``fusion_mismatch``): every
    voxel that differs must be a near tie, and at most
    ``PARITY_MAX_SHARE`` of them may differ; returns the share that
    differs."""
    share, unexplained = tfus.fusion_mismatch(got, want, depths, projections,
                                              origin, voxel_size)
    assert not len(unexplained), unexplained[:5]
    assert share <= tfus.PARITY_MAX_SHARE, share
    return share


def test_fuse_two_frame_golden_column():
    """The golden column of ``tests/test_geometry.py``: two 1x1 depth maps
    down one voxel column, against JAX and the hand-computed volume."""
    proj = np.array([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 0]], np.float32)
    projections = np.stack([proj, proj])
    depths = np.array([[[0.65]], [[0.45]]], np.float32)
    ok = np.ones(2, bool)
    args = ((1, 1, 9), 0.1)
    jt, jw = jfus.fuse_tsdf(jnp.asarray(depths), jnp.asarray(projections),
                            jnp.asarray(ok), jnp.zeros(3, jnp.float32), *args)
    t, w = tfus.fuse_tsdf(depths, projections, ok, np.zeros(3, np.float32),
                          *args)
    np.testing.assert_allclose(t.numpy(), np.asarray(jt),
                               atol=tfus.PARITY_ATOL, rtol=0)
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
    np.testing.assert_allclose(
        t.numpy().ravel(),
        [1.0, -1.0, -0.833333, -0.5, -0.5, -0.166667, 0.166667, 0.5, 0.5],
        atol=1e-5)
    np.testing.assert_array_equal(w.numpy().ravel(),
                                  [0, 0, 1, 1, 2, 2, 2, 2, 1])


def _tiny_room():
    """Six 48x64 depth maps of the planted room (3.84 x 3.84 x 1.92 m) on
    the ring of poses, and their projections."""
    extent = np.array([48, 48, 24]) * 0.08
    poses = synthetic.ring_poses(extent, 6)
    k = synthetic.scannet_intrinsic(64, 48)[:3, :3]
    depths = synthetic.render_room_depth(poses, k, (64, 48), extent,
                                         synthetic.room_boxes(extent))
    projections = np.stack([k @ np.linalg.inv(p)[:3]
                            for p in poses]).astype(np.float32)
    return depths, projections


def test_fuse_rendered_room_matches_jax():
    """24x24x12 voxels of 16 cm over six rendered frames, the third one
    invalid, against JAX: fed as one array, as a list of frames and as a
    CPU tensor, in chunks of 1, 4 and 32 frames, each result identical;
    the invalid frame changes the volume."""
    depths, projections = _tiny_room()
    ok = np.ones(6, bool)
    ok[2] = False
    origin = np.array([-0.3, -0.2, -0.1], np.float32)
    args = ((24, 24, 12), 0.16)
    want = jfus.fuse_tsdf(jnp.asarray(depths), jnp.asarray(projections),
                          jnp.asarray(ok), jnp.asarray(origin), *args)
    runs = [tfus.fuse_tsdf(depths, projections, ok, origin, *args, chunk=4),
            tfus.fuse_tsdf(list(depths), projections, ok, origin, *args,
                           chunk=1),
            tfus.fuse_tsdf(torch.from_numpy(depths), projections, ok, origin,
                           *args, chunk=32)]
    share = _close_fusion(runs[0], want, depths[ok], projections[ok], origin,
                          args[1])
    for t, w in runs[1:]:
        assert torch.equal(t, runs[0][0]) and torch.equal(w, runs[0][1])
    assert (np.asarray(want[1]) > 0).mean() > 0.05 and share < 0.01
    every = tfus.fuse_tsdf(depths, projections, np.ones(6, bool), origin,
                           *args)
    assert not torch.equal(every[1], runs[0][1])


def test_bounds_equal_jax():
    """``depth_to_world_points`` and ``volume_bounds_from_depths`` are the
    JAX module's numpy, equal bit for bit."""
    depths, _ = _tiny_room()
    k = synthetic.scannet_intrinsic(64, 48)[:3, :3]
    pose = synthetic.ring_poses(np.array([3.84, 3.84, 1.92]), 6)[1]
    got = tfus.depth_to_world_points(depths[1], k, pose, 3.0)
    want = jfus.depth_to_world_points(depths[1], k, pose, 3.0)
    np.testing.assert_array_equal(got, want)
    for vs in (0.04, 0.16):
        o, d = tfus.volume_bounds_from_depths(got, vs, 1.5)
        jo, jd = jfus.volume_bounds_from_depths(want, vs, 1.5)
        np.testing.assert_array_equal(o, jo)
        assert d == jd


# --- the scripts ----------------------------------------------------------

def _gen_args(data: str, save: str, vs: float) -> argparse.Namespace:
    from cnrma_torch.tools.data_prepare import generate_tsdf
    return generate_tsdf.parse_args(["--data_path", data, "--save_path",
                                     save, "--voxel_size", str(vs),
                                     "--device", "cpu"])


def _compare_tsdf_dirs(got: str, want: str, data: str) -> float:
    """Two ``atlas_tsdf/{scene}`` outputs: ``info.json`` byte for byte, each
    npz's origin and voxel size equal and its TSDF within the fusion's
    tolerance but at near ties (from the scene's frames); returns the
    largest share of voxels that differ."""
    from cnrma_torch.tools.data_prepare import generate_tsdf
    assert filecmp.cmp(os.path.join(got, "info.json"),
                       os.path.join(want, "info.json"), shallow=False)
    names = sorted(os.listdir(want))
    assert sorted(os.listdir(got)) == names and len(names) == 4
    args = _gen_args(data, "", 0.0)
    intr, depths, _, projs, _ = generate_tsdf.read_scene(args, SCENE)
    worst = 0.0
    for name in names:
        if not name.endswith(".npz"):
            continue
        g, w = np.load(os.path.join(got, name)), np.load(os.path.join(
            want, name))
        assert sorted(g.files) == sorted(w.files) == ["origin", "tsdf",
                                                      "voxel_size"]
        np.testing.assert_array_equal(g["origin"], w["origin"])
        assert g["origin"].shape == (1, 3)
        assert float(g["voxel_size"]) == float(w["voxel_size"])
        vs = float(w["voxel_size"])
        # the npz keeps no weights: compare the TSDFs alone
        zero = np.zeros_like(w["tsdf"])
        worst = max(worst, _close_fusion(
            (g["tsdf"], zero), (w["tsdf"], zero), depths,
            np.stack(projs).astype(np.float32), w["origin"][0], vs))
    return worst


@pytest.fixture(scope="module")
def posed_scene(tmp_path_factory):
    """``write_scannet``'s posed_images route with depth PNGs whose
    intrinsic is the images' (4 frames of 64x48)."""
    root = str(tmp_path_factory.mktemp("posed"))
    synthetic.write_scannet(root, n_scenes=1, n_frames=4,
                            tsdf_dim=(48, 48, 24), voxel_size=0.08,
                            image_size=(64, 48), depth_png=True)
    return root


def test_generate_tsdf_matches_jax(posed_scene, tmp_path):
    """``process_scene`` on the consistent route at 16/32/64 cm: the same
    three npz files and ``info.json``; the fused room agrees in sign with
    the planted one; a scene without depth PNGs is skipped as JAX skips
    it."""
    from cnrma_torch.tools.data_prepare import generate_tsdf as tgen
    from tools.data_prepare import generate_tsdf as jgen
    want, got = str(tmp_path / "jax"), str(tmp_path / "port")
    jgen.process_scene(_gen_args(posed_scene, want, 0.16), SCENE)
    tgen.process_scene(_gen_args(posed_scene, got, 0.16), SCENE)
    _compare_tsdf_dirs(os.path.join(got, "atlas_tsdf", SCENE),
                       os.path.join(want, "atlas_tsdf", SCENE), posed_scene)
    z = np.load(os.path.join(got, "atlas_tsdf", SCENE, "tsdf_16.npz"))
    extent = np.array([48, 48, 24]) * 0.08
    share, n = synthetic.fused_sign_agreement(
        z["tsdf"], z["origin"][0], 0.16, extent, synthetic.room_boxes(extent))
    assert n > 300 and share > 0.9, (share, n)

    bare = tmp_path / "bare" / "posed_images" / SCENE
    shutil.copytree(os.path.join(posed_scene, "posed_images", SCENE), bare,
                    ignore=shutil.ignore_patterns("*.png"))
    tgen.process_scene(_gen_args(str(tmp_path / "bare"), got, 0.16), SCENE)


@pytest.fixture(scope="module")
def raw_scene(tmp_path_factory):
    """``write_scannet_raw``: a .sens of 3 frames with ScanNet's two
    cameras (1296x968 JPEG colour, 640x480 depth), the scan of the same
    room with an axis alignment that turns it, the label map; then the
    JAX tool's ``extract_posed_images`` into ``scannet/posed_images``."""
    from tools.data_prepare import extract_posed_images as jext
    root = str(tmp_path_factory.mktemp("raw"))
    turn = np.eye(4)
    turn[:2, :2] = [[0.0, -1.0], [1.0, 0.0]]
    turn[:3, 3] = [3.84, -0.5, 0.25]
    cams = synthetic.write_scannet_raw(root, n_frames=3,
                                       tsdf_dim=(48, 48, 24),
                                       voxel_size=0.08, axis_align=turn)
    posed = os.path.join(root, "scannet", "posed_images")
    jext.extract(os.path.join(root, "scans", SCENE, SCENE + ".sens"),
                 os.path.join(posed, SCENE))
    return root, cams


def test_extract_posed_images_bytes(raw_scene, tmp_path):
    """The port's ``extract_posed_images`` writes every file of the JAX
    tool's, byte for byte: the JPEGs, the depth PNGs at 640x480, the poses
    and the colour intrinsic (F17)."""
    from PIL import Image

    from cnrma_torch.tools.data_prepare import extract_posed_images as text
    root, cams = raw_scene
    out = str(tmp_path / "posed")
    text.main(["--scans_path", os.path.join(root, "scans"), "--output_path",
               out])
    want = os.path.join(root, "scannet", "posed_images", SCENE)
    _same_tree(os.path.join(out, SCENE), want)
    assert len(os.listdir(want)) == 3 * 3 + 1
    assert Image.open(os.path.join(want, "00000.png")).size == (640, 480)
    assert Image.open(os.path.join(want, "00000.jpg")).size == (1296, 968)
    np.testing.assert_allclose(np.loadtxt(os.path.join(want,
                                                       "intrinsic.txt")),
                               cams["intrinsic_color"], atol=1e-6)


def test_f17_depth_fused_through_the_colour_intrinsic(raw_scene, tmp_path):
    """ROADMAP F17: ``extract_posed_images`` writes the colour intrinsic
    beside 640x480 depth maps, and ``generate_tsdf`` projects them through
    it.  JAX and the port agree on that route (the fusion's tolerance),
    and both miss the planted room: at 16 cm the share of observed voxels
    whose sign agrees with the room is at least 0.25 under the consistent
    route's (the same PNGs through the depth camera's own intrinsic), and
    they observe under half as many voxels."""
    from cnrma_torch.tools.data_prepare import generate_tsdf as tgen
    from tools.data_prepare import generate_tsdf as jgen
    root, cams = raw_scene
    data = os.path.join(root, "scannet")
    want, got = str(tmp_path / "jax"), str(tmp_path / "port")
    jgen.process_scene(_gen_args(data, want, 0.16), SCENE)
    tgen.process_scene(_gen_args(data, got, 0.16), SCENE)
    _compare_tsdf_dirs(os.path.join(got, "atlas_tsdf", SCENE),
                       os.path.join(want, "atlas_tsdf", SCENE), data)

    consistent = tmp_path / "consistent"
    shutil.copytree(os.path.join(data, "posed_images"),
                    consistent / "posed_images")
    np.savetxt(consistent / "posed_images" / SCENE / "intrinsic.txt",
               cams["intrinsic_depth"], fmt="%.6f")
    tgen.process_scene(_gen_args(str(consistent), str(consistent), 0.16),
                       SCENE)
    extent = np.array([48, 48, 24]) * 0.08
    boxes = synthetic.room_boxes(extent)
    shares = {}
    for name, base in (("f17", got), ("consistent", str(consistent))):
        z = np.load(os.path.join(base, "atlas_tsdf", SCENE, "tsdf_16.npz"))
        shares[name] = synthetic.fused_sign_agreement(
            z["tsdf"], z["origin"][0], 0.16, extent, boxes)
    (f17, n17), (good, n_good) = shares["f17"], shares["consistent"]
    assert good > 0.9 and f17 < good - 0.25, shares
    assert n17 < n_good / 2, shares


def test_batch_load_scannet_data_matches_jax(raw_scene, tmp_path):
    """``batch_load_scannet_data`` on the synthetic scan (a turned axis
    alignment): the six arrays equal the JAX tool's, dtype included, and
    the aligned boxes are the planted ones turned."""
    from cnrma_torch.tools.data_prepare import batch_load_scannet_data as tb
    from tools.data_prepare import batch_load_scannet_data as jb
    root, _ = raw_scene
    scans = os.path.join(root, "scans")
    tsv = os.path.join(root, "meta_data", "scannetv2-labels.combined.tsv")
    want, got = tmp_path / "jax", tmp_path / "port"
    want.mkdir()
    jb.process_scene(scans, SCENE, jb.read_label_map(tsv), str(want))
    tb.main(["--scans_path", scans, "--label_map", tsv, "--output_path",
             str(got)])
    names = sorted(os.listdir(want))
    assert sorted(os.listdir(got)) == names and len(names) == 6
    for name in names:
        a, b = np.load(got / name), np.load(want / name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    verts = np.load(got / f"{SCENE}_vert.npy")
    np.testing.assert_array_equal(tb.read_mesh_with_color(os.path.join(
        scans, SCENE, SCENE + "_vh_clean_2.ply")), jb.read_mesh_with_color(
        os.path.join(scans, SCENE, SCENE + "_vh_clean_2.ply")))
    assert verts.shape[1] == 6 and verts[:, 3:].max() > 0
    planted = synthetic.room_boxes(np.array([48, 48, 24]) * 0.08)
    unaligned = np.load(got / f"{SCENE}_unaligned_bbox.npy")
    np.testing.assert_allclose(unaligned, planted, atol=1e-5)
    aligned = np.load(got / f"{SCENE}_aligned_bbox.npy")
    np.testing.assert_allclose(aligned[:, 0], 3.84 - planted[:, 1],
                               atol=1e-5)
    np.testing.assert_allclose(aligned[:, 3:5], planted[:, [4, 3]],
                               atol=1e-5)


def test_aggregate_data_pickles_equal(raw_scene, tmp_path, monkeypatch):
    """``aggregate_data`` for ScanNet (train and val, the scene list) and
    ARKit (a splits map): the port's pickle equals the JAX tool's byte for
    byte."""
    from cnrma_torch.tools.data_prepare import aggregate_data as tagg
    from cnrma_torch.tools.data_prepare import batch_load_scannet_data as tb
    from tools.data_prepare import aggregate_data as jagg
    root, _ = raw_scene
    data = tmp_path / "scannet"
    shutil.copytree(os.path.join(root, "scannet", "posed_images"),
                    data / "posed_images")
    tb.main(["--scans_path", os.path.join(root, "scans"), "--label_map",
             os.path.join(root, "meta_data",
                          "scannetv2-labels.combined.tsv"),
             "--output_path", str(data / "scannet_instance_data")])
    (data / "atlas_tsdf" / "scene0001_00").mkdir(parents=True)   # no frames
    for split in ("train", "val"):
        argv = ["--dataset", "scannet", "--data_path", str(data), "--split",
                split, "--scene_list", os.path.join(
                    root, "meta_data", f"scannetv2_{split}.txt")]
        _jax_argv(monkeypatch, jagg, argv)
        want = (data / f"scannet_infos_{split}.pkl").read_bytes()
        out = tagg.main(argv)
        assert open(out, "rb").read() == want
    infos = np.load(out, allow_pickle=True)
    assert [i["scene"] for i in infos] == [SCENE]
    assert list(infos[0]["annos"]["class"]) == [4, 2, 1, 0]

    ark = tmp_path / "arkit"
    inst = ark / "arkit_instance_data"
    inst.mkdir(parents=True)
    rng = np.random.RandomState(3)
    for scene in ("41254900", "41254917"):
        (ark / "atlas_tsdf" / scene).mkdir(parents=True)
        (ark / "atlas_tsdf" / scene / "info.json").write_text(
            '{"images": [{"id": "1.000"}, {"id": "1.100"}]}')
        np.save(inst / f"{scene}_aligned_bbox.npy", rng.rand(3, 8))
    (ark / "splits.json").write_text('{"41254917": "Validation"}')
    argv = ["--dataset", "arkit", "--data_path", str(ark), "--split", "val",
            "--splits_map", str(ark / "splits.json")]
    _jax_argv(monkeypatch, jagg, argv)
    want = (ark / "arkit_infos_val.pkl").read_bytes()
    assert open(tagg.main(argv), "rb").read() == want


def test_load_arkit_data_matches_jax(tmp_path, monkeypatch):
    """``load_arkit_data`` on scans written by ``tests/test_arkit_prep.py``'s
    helper: a binary mesh subsampled by ``--max_num_point`` (the ``rng``'s
    draws), an annotation-only scan and a skipped one; the six files of
    each scan equal the JAX tool's.  ``box3d_iou`` equals JAX's within
    1e-6."""
    from test_arkit_prep import _write_annotation

    from cnrma_torch.tools.data_prepare import arkit_boxes as tbox
    from cnrma_torch.tools.data_prepare import load_arkit_data as tload
    from cnrma_torch.utils.ply import write_ply_mesh
    from tools.data_prepare import arkit_boxes as jbox
    from tools.data_prepare import load_arkit_data as jload
    rng = np.random.RandomState(5)
    base = tmp_path / "3dod" / "Training"
    items = [("chair", (1, 2, 0.5), (0.5, 0.6, 1.0), 0.2),
             ("tv monitor", (3, 3, 1), (1.2, 0.2, 0.7), -0.4),
             ("wild thing", (0, 0, 0), (1, 1, 1), 0.0)]
    for scene, mesh in (("41069021", True), ("41069042", False),
                        ("41069063", True)):
        scan = base / scene
        scan.mkdir(parents=True)
        _write_annotation(str(scan / f"{scene}_3dod_annotation.json"),
                          items if scene != "41069063" else items[2:])
        if mesh:
            write_ply_mesh(str(scan / f"{scene}_3dod_mesh.ply"),
                           rng.rand(50, 3), np.zeros((0, 3)),
                           vertex_colors=rng.randint(0, 256, (50, 3)))
    argv = ["--data_path", str(tmp_path), "--max_num_point", "20",
            "--seed", "7"]
    _jax_argv(monkeypatch, jload, argv + ["--output_path",
                                          str(tmp_path / "jax")])
    tload.main(argv + ["--output_path", str(tmp_path / "port")])
    _same_tree(str(tmp_path / "port"), str(tmp_path / "jax"))
    assert len(os.listdir(tmp_path / "port")) == 6 + 2 + 6
    assert np.load(tmp_path / "port" / "41069021_vert.npy").shape == (20, 6)

    boxes = np.array([[1, 2, 0.5, 0.5, 0.6, 1.0, 0.2],
                      [1.1, 2.1, 0.4, 0.6, 0.5, 0.8, -0.3],
                      [3, 3, 1, 1.2, 0.2, 0.7, 1.1]])
    corners = tbox.boxes_to_corners_3d(boxes)
    for i, j in ((0, 1), (0, 2), (1, 1)):
        assert tbox.box3d_iou(corners[i], corners[j]) == pytest.approx(
            jbox.box3d_iou(corners[i], corners[j]), abs=1e-6)


def test_process_reconstruction_matches_jax(tmp_path, monkeypatch):
    """``process_reconstruction``: each predicted mesh's xyz and vertex
    normals equal the JAX tool's; an empty mesh is skipped."""
    from cnrma_torch.tools.data_prepare import process_reconstruction as tp
    from cnrma_torch.utils.ply import write_ply_mesh
    from tools.data_prepare import process_reconstruction as jp
    rng = np.random.RandomState(2)
    res = tmp_path / "res"
    for scene, n in (("scene0000_00", 40), ("scene0001_00", 0)):
        (res / scene).mkdir(parents=True)
        write_ply_mesh(str(res / scene / f"{scene}.ply"), rng.rand(n, 3),
                       rng.randint(0, max(n, 1), (2 * n, 3)))
    _jax_argv(monkeypatch, jp, ["--result_path", str(res), "--output_path",
                                str(tmp_path / "jax")])
    tp.main(["--result_path", str(res), "--output_path",
             str(tmp_path / "port")])
    _same_tree(str(tmp_path / "port"), str(tmp_path / "jax"))
    assert os.listdir(tmp_path / "port") == ["scene0000_00_vert.npy"]


def test_visualize_results_matches_jax(tmp_path, monkeypatch):
    """``visualize_results`` on a ScanNet scene (6-column boxes and a
    mesh) and an ARKit-style one (7-column yaw boxes, no mesh), then with
    ``--generate_gt``: every ``.ply`` and ``.npz`` equal the JAX tool's
    byte for byte; the ribbons of boxes under the threshold are left
    out; ScanNet's GT is drawn turned by its class id (F20); without a
    card the default ``--device cuda:0`` raises."""
    from cnrma_torch.tools import visualize_results as tvis
    from cnrma_torch.utils.ply import read_ply, write_ply_mesh
    from tools import visualize_results as jvis
    rng = np.random.RandomState(4)
    res, gt = tmp_path / "res", tmp_path / "gt"
    gt.mkdir()
    for scene, cols in (("scene0000_00", 6), ("41254900", 7)):
        (res / scene).mkdir(parents=True)
        boxes = rng.rand(5, cols).astype(np.float32) * 3
        if cols == 7:
            boxes[:, 6] = rng.uniform(-np.pi, np.pi, 5)
            boxes[1, 6] = 0.0
        else:
            write_ply_mesh(str(res / scene / f"{scene}.ply"), rng.rand(30, 3),
                           rng.randint(0, 30, (20, 3)))
        np.savez(res / scene / f"{scene}_atlas_bbox.npz", boxes=boxes,
                 scores=np.array([0.9, 0.1, 0.5, 0.8, 0.3], np.float32),
                 labels=np.array([0, 3, 17, 20, 5]))
        # ScanNet's GT rows: a box and the NYU40 id; ARKit's: a yaw box
        # and the class
        np.save(gt / f"{scene}_aligned_bbox.npy",
                np.concatenate([rng.rand(3, cols) * 2,
                                np.array([[3], [7], [39]])], 1))
    for argv in ([], ["--generate_gt", "--gt_path", str(gt), "--postfix",
                      "_gt"]):
        shutil.rmtree(tmp_path / "jax", ignore_errors=True)
        shutil.copytree(res, tmp_path / "jax")
        _jax_argv(monkeypatch, jvis, ["--result_path", str(tmp_path / "jax"),
                                      *argv])
        tvis.main(["--result_path", str(res), "--device", "cpu", *argv])
        _same_tree(str(res), str(tmp_path / "jax"))
    verts, faces = read_ply(str(res / "scene0000_00" /
                                "scene0000_00_atlas_bbox.ply"))
    assert len(verts) == 30 + 4 * 12 * 4 and len(faces) == 20 + 4 * 12 * 2
    # ROADMAP F20: --generate_gt keeps the first seven columns of ScanNet's
    # [K, 7] GT rows, so the NYU40 id becomes the yaw the boxes are drawn at
    gen = np.load(res / "scene0000_00" / "scene0000_00_gt.npz")
    np.testing.assert_array_equal(gen["boxes"][:, 6], [3, 7, 39])
    if not torch.cuda.is_available():       # the default device is the card
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tvis.main(["--result_path", str(res)])

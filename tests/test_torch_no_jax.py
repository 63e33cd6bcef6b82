"""The PyTorch port imports and runs with JAX, flax and the JAX package
unavailable, as on a GPU machine that has none of them: a tiny forward,
then the test CLI, ``nms_bbox`` and ``evaluate_bbox`` on one tiny synthetic
scene, and one step of the train CLI on it, whose checkpoint the test CLI
loads, and two steps of the detector-only learning check; the three-stage
recipe on such a scene, one step a stage, stage 3 with depth marching;
the ARKit yaw path on a tiny synthetic ARKitScenes scene, stage 1 first;
and ScanNet's data preparation from a tiny synthetic ``.sens`` and
scan."""

import os
import subprocess
import sys

from _torch_spawn import run_script

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = """
import sys
for name in ("jax", "jaxlib", "flax", "optax", "cnrma_tpu"):
    sys.modules[name] = None          # any import of them raises
sys.path.insert(0, REPO)
import numpy as np, torch
import cnrma_torch.bridge, cnrma_torch.synthetic
import cnrma_torch.ops._build, cnrma_torch.ops.backproject
import cnrma_torch.ops.ray_marching, cnrma_torch.ops.sparse
import cnrma_torch.timing
import cnrma_torch.tools.bp_probe, cnrma_torch.tools.feature_probe
import cnrma_torch.tools.gather_probe, cnrma_torch.tools.trace_check
import cnrma_torch.tools.stage_times
import cnrma_torch.capacity, cnrma_torch.core.builder, cnrma_torch.core.config
import cnrma_torch.core.registry, cnrma_torch.data.arkit
import cnrma_torch.data.scannet, cnrma_torch.data.transforms
import cnrma_torch.eval.indoor_eval, cnrma_torch.geometry.boxes
import cnrma_torch.geometry.tsdf, cnrma_torch.ops.iou3d, cnrma_torch.ops.nms
import cnrma_torch.utils.marching_cubes, cnrma_torch.utils.ply
import cnrma_torch.tools.test, cnrma_torch.tools.nms_bbox
import cnrma_torch.tools.evaluate_bbox, cnrma_torch.tools.train
import cnrma_torch.train.loop, cnrma_torch.train.optim, cnrma_torch.train.state
import cnrma_torch.data.loader, cnrma_torch.models.assigner
import cnrma_torch.ops.losses
import cnrma_torch.convert, cnrma_torch.data.points_dataset
import cnrma_torch.eval.mesh_eval, cnrma_torch.models.fcaf3d_only
import cnrma_torch.tools.combine_models, cnrma_torch.tools.evaluate_mesh
import cnrma_torch.tools.overflow_survey, cnrma_torch.tools.overfit_full
import cnrma_torch.tools.overfit_check
import cnrma_torch.geometry.tsdf_fusion, cnrma_torch.tools.visualize_results
import cnrma_torch.tools.data_prepare.extract_posed_images
import cnrma_torch.tools.data_prepare.generate_tsdf
import cnrma_torch.tools.data_prepare.batch_load_scannet_data
import cnrma_torch.tools.data_prepare.arkit_boxes
import cnrma_torch.tools.data_prepare.load_arkit_data
import cnrma_torch.tools.data_prepare.aggregate_data
import cnrma_torch.tools.data_prepare.process_reconstruction
import cnrma_torch.parallel.dist, cnrma_torch.parallel.shard
import chip_smoke
from cnrma_torch.models.cn_rma import CNRMA
from cnrma_torch.models.fcaf3d import DetectionCapacities
torch.manual_seed(0)
model = CNRMA(voxel_dim=(16, 16, 16), voxel_size=0.1, n_classes=3,
              ray_samples=64, rays_per_view_cap=256, max_points=512,
              pts_threshold=500, nms_pre=16, voxel_size_fcaf3d=0.05,
              capacities=DetectionCapacities.tiny()).eval()
rng = np.random.RandomState(0)
proj = np.array([[30.0, 0, 16, -36], [0, 30.0, 16, -36], [0, 0, 1, 0.4]],
                np.float32)
batch = {"imgs": torch.from_numpy(rng.rand(1, 2, 32, 32, 3).astype(np.float32)
                                  * 255),
         "projection": torch.from_numpy(np.stack([proj, proj])[None]),
         "view_valid": torch.ones(1, 2, dtype=torch.bool),
         "offset": torch.zeros(1, 3)}
out = model(batch, generator=torch.Generator().manual_seed(0))
assert out["tsdf"]["scene_tsdf_010"].shape == (1, 16, 16, 16)
assert out["bboxes"].shape == (1, 4 * 16, 6)
assert bool(torch.isfinite(out["bboxes"]).all())

# the user's loop on one tiny synthetic scene: test CLI, NMS, mAP
import atexit, os, shutil, tempfile
from cnrma_torch.synthetic import write_scannet
from cnrma_torch.tools import evaluate_bbox, nms_bbox, test as test_cli
root = tempfile.mkdtemp()
atexit.register(shutil.rmtree, root, ignore_errors=True)
data, res = os.path.join(root, "data"), os.path.join(root, "res")
ann = write_scannet(data, n_scenes=1, n_frames=2, tsdf_dim=(32, 32, 16))
records = test_cli.main([
    os.path.join(REPO, "configs", "ray_marching_scannet.py"), "--device",
    "cpu", "--save-path", res, "--cfg-options", f"data.test.data_root={data}",
    f"data.test.ann_file={ann}", "data.test.num_frames=2",
    "data.test.image_size=(64,32)", "model.voxel_dim_test=(16,16,16)",
    "data.test.voxel_dim=(16,16,16)", "model.ray_samples=32",
    "model.rays_per_view_cap=64", "model.max_points=128",
    "model.detection_head.test_cfg.nms_pre=8",
    "model.capacities={'voxelize':256,'stride2':128,'stride4':64,"
    "'levels':(32,16,8,8),'neck':(64,32,16)}"])
assert [r["scene"] for r in records] == ["scene0000_00"]
nms_bbox.main(["--result_path", res, "--device", "cpu"])
m = evaluate_bbox.main(["--data_path", data, "--result_path", res,
                        "--device", "cpu"])
assert os.path.isfile(os.path.join(res, "scene0000_00",
                                   "scene0000_00_atlas_bbox.npz"))
assert "mAP_0.25" in m

# one step of the train CLI on the same scene, read as a training split
from cnrma_torch.tools import train as train_cli
shutil.copy(ann, os.path.join(data, "scannet_infos_train.pkl"))
small = ["model.ray_samples=32", "model.rays_per_view_cap=64",
         "model.max_points=128",
         "model.capacities={'voxelize':256,'stride2':128,'stride4':64,"
         "'levels':(32,16,8,8),'neck':(64,32,16)}"]
records, ckpt = train_cli.main([
    os.path.join(REPO, "configs", "ray_marching_scannet.py"), "--device",
    "cpu", "--max-steps", "1", "--work-dir", os.path.join(root, "wd"),
    "--cfg-options", f"data.train.data_root={data}",
    f"data.train.ann_file={os.path.join(data, 'scannet_infos_train.pkl')}",
    "data.train.num_frames=2", "data.train.image_size=(64,32)",
    "model.voxel_dim_train=(16,16,16)", "data.train.voxel_dim=(16,16,16)",
    *small])
assert len(records) == 1 and os.path.isfile(ckpt)
assert all(np.isfinite(v) for v in records[0]["log_vars"].values())
test_cli.main([
    os.path.join(REPO, "configs", "ray_marching_scannet.py"), ckpt,
    "--device", "cpu", "--save-path", os.path.join(root, "res2"),
    "--cfg-options", f"data.test.data_root={data}",
    f"data.test.ann_file={ann}", "data.test.num_frames=2",
    "data.test.image_size=(64,32)", "model.voxel_dim_test=(16,16,16)",
    "data.test.voxel_dim=(16,16,16)", *small])

# the detector-only learning check, two steps
from cnrma_torch.tools import overfit_check
out = overfit_check.run(["--steps", "2", "--device", "cpu"])
assert out["steps"] == 2 and np.isfinite([out["first"], out["final"]]).all()
loaded = [m for m in ("jax", "flax", "cnrma_tpu") if sys.modules.get(m)]
assert not loaded, loaded
print("NO_JAX_OK")
"""


TIME_LIMIT = 300            # seconds a script may take


def _run(name: str, script: str) -> subprocess.CompletedProcess:
    """``script`` in a fresh interpreter from the repository's root, its
    threads capped (``_torch_spawn.run_script``), within ``TIME_LIMIT``."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return run_script(name, [sys.executable, "-c",
                             script.replace("REPO", repr(REPO))],
                      TIME_LIMIT, env=env, cwd=REPO)


def test_port_runs_without_jax():
    proc = _run("no_jax", _SCRIPT)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "NO_JAX_OK" in proc.stdout


_RECIPE = """
import sys
for name in ("jax", "jaxlib", "flax", "optax", "cnrma_tpu"):
    sys.modules[name] = None          # any import of them raises
sys.path.insert(0, REPO)
import atexit, os, shutil, tempfile
import numpy as np
from cnrma_torch.geometry.tsdf import TSDF
from cnrma_torch.synthetic import write_point_dumps, write_scannet
from cnrma_torch.tools import combine_models, evaluate_mesh
from cnrma_torch.tools import test as test_cli, train as train_cli
from cnrma_torch.utils.ply import write_ply_mesh
cfg = lambda name: os.path.join(REPO, "configs", name)
root = tempfile.mkdtemp()
atexit.register(shutil.rmtree, root, ignore_errors=True)
data = os.path.join(root, "data")
ann = write_scannet(data, n_scenes=1, n_frames=3, tsdf_dim=(32, 32, 16),
                    image_size=(128, 96), ann_name="scannet_infos_train.pkl")
views = ["num_frames=2", "image_size=(64,32)", "voxel_dim=(16,16,16)",
         f"data_root={data}", f"ann_file={ann}"]
train = [f"data.train.{o}" for o in views] + [
    "model.voxel_dim_train=(16,16,16)"]
test = [f"data.test.{o}" for o in views] + ["model.voxel_dim_test=(16,16,16)"]
small = ["model.ray_samples=32", "model.rays_per_view_cap=64",
         "model.max_points=128",
         "model.capacities={'voxelize':256,'stride2':128,'stride4':64,"
         "'levels':(32,16,8,8),'neck':(64,32,16)}"]
run = lambda *a: ["--device", "cpu", "--max-steps", "1", "--work-dir",
                  os.path.join(root, *a), "--cfg-options"]

# stage 1: Atlas (bf16, Adam), then its TSDF, mesh and mesh metrics
rec, s1 = train_cli.main([cfg("atlas_recon_scannet.py"), *run("s1"), *train])
assert set(rec[0]["log_vars"]) >= {"tsdf_loss_004", "grad_norm"}
res1 = os.path.join(root, "res1")
test_cli.main([cfg("atlas_recon_scannet.py"), s1, "--device", "cpu",
               "--save-path", res1, "--cfg-options", *test])
assert sorted(os.listdir(os.path.join(res1, "scene0000_00"))) == [
    "scene0000_00.npz", "scene0000_00.ply"]
gt = TSDF.load(os.path.join(data, "atlas_tsdf", "scene0000_00",
                            "tsdf_04.npz")).get_mesh("cpu")
os.makedirs(os.path.join(root, "gt"))
write_ply_mesh(os.path.join(root, "gt", "scene0000_00.ply"), *gt[:2])
evaluate_mesh.main(["--data_path", data, "--result_path", res1,
                    "--gt_path", os.path.join(root, "gt")])
assert os.path.isfile(os.path.join(res1, "scene0000_00", "metrics.json"))

# stage 2.1: the dump of CNRMA from the stage-1 checkpoint
mid = os.path.join(root, "mid")
test_cli.main([cfg("scannet_middle.py"), s1, "--device", "cpu",
               "--save-path", os.path.join(root, "res21"),
               "--middle-save-path", mid, "--cfg-options", *test, *small])
assert os.path.isfile(os.path.join(mid, "scene0000_00_vert.npy"))

# stage 2: FCAF3DOnly on dumped points (synthetic, on the room's surface)
syn = os.path.join(data, "middle_points")
write_point_dumps(data, syn, n_points=3000)
rec, s2 = train_cli.main([
    cfg("fcaf3d_middle_scannet.py"), *run("s2"), f"data.train.data_root={data}",
    f"data.train.ann_file={ann}", f"data.train.points_dir={syn}",
    "data.train.num_points=2000",
    "model.capacities={'voxelize':2048,'stride2':1024,'stride4':512,"
    "'levels':(256,128,64,32),'neck':(512,256,128)}"])
assert set(rec[0]["log_vars"]) >= {"loss_cls", "grad_norm"}

# the merge, one stage-3 step from it (depth marching), and the test CLI
# on its checkpoint
merged = os.path.join(root, "merged.pt")
combine_models.main(["--recon", s1, "--detector", s2, "--output", merged])
rec, s3 = train_cli.main([cfg("ray_marching_scannet.py"), "--load-from",
                          merged, *run("s3"), *train, *small,
                          "model.ray_marching_type=depth",
                          "model.depth_points=2"])
assert all(np.isfinite(v) for v in rec[0]["log_vars"].values())
test_cli.main([cfg("ray_marching_scannet.py"), s3, "--device", "cpu",
               "--save-path", os.path.join(root, "res3"), "--cfg-options",
               *test, *small])
loaded = [m for m in ("jax", "flax", "cnrma_tpu") if sys.modules.get(m)]
assert not loaded, loaded
print("RECIPE_OK")
"""


def test_three_stage_recipe_runs_without_jax():
    """Stage 1 (``configs/atlas_recon_scannet.py``: one step, its test CLI
    run, ``evaluate_mesh``), the stage-2.1 dump (``configs/
    scannet_middle.py`` from the stage-1 checkpoint), stage 2
    (``configs/fcaf3d_middle_scannet.py`` on synthetic dumps), the merge,
    one stage-3 step from it with depth marching and the test CLI on its
    checkpoint, at cut sizes on the CPU with JAX, flax and the JAX package
    blocked."""
    proc = _run("recipe", _RECIPE)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "RECIPE_OK" in proc.stdout


_ARKIT = """
import sys
for name in ("jax", "jaxlib", "flax", "optax", "cnrma_tpu"):
    sys.modules[name] = None          # any import of them raises
sys.path.insert(0, REPO)
import atexit, os, shutil, tempfile
import numpy as np
from cnrma_torch.synthetic import write_arkit
from cnrma_torch.tools import evaluate_bbox, nms_bbox
from cnrma_torch.tools import test as test_cli, train as train_cli
cfg = lambda name: os.path.join(REPO, "configs", name)
root = tempfile.mkdtemp()
atexit.register(shutil.rmtree, root, ignore_errors=True)
data = os.path.join(root, "data")
val = write_arkit(data, n_scenes=1, n_frames=3, tsdf_dim=(48, 40, 32),
                  image_size=(128, 96))
train = os.path.join(data, "arkit_infos_train.pkl")
shutil.copy(val, train)
views = ["num_frames=2", "image_size=(64,64)", "voxel_dim=(32,32,16)",
         f"data_root={data}"]
small = ["model.ray_samples=32", "model.rays_per_view_cap=256",
         "model.max_points=512",
         "model.capacities={'voxelize':2048,'stride2':1024,'stride4':512,"
         "'levels':(256,128,64,32),'neck':(512,256,128)}"]
test = [f"data.test.{o}" for o in views] + [
    "model.voxel_dim_test=(32,32,16)",
    "model.detection_head.test_cfg.nms_pre=16"]
scene = "41254900"

# the test CLI -> rotated NMS -> rotated mAP
res = os.path.join(root, "res")
test_cli.main([cfg("ray_marching_arkit.py"), "--device", "cpu", "--save-path",
               res, "--cfg-options", *test, f"data.test.ann_file={val}",
               *small])
raw = np.load(os.path.join(res, scene, scene + "_bbox_raw.npz"))
assert raw["bboxes"].shape[1] == 7 and raw["scores"].shape[1] == 17
assert len(raw["bboxes"]) > 0 and np.isfinite(raw["bboxes"]).all()
nms_bbox.main(["--result_path", res, "--device", "cpu"])
kept = np.load(os.path.join(res, scene, scene + "_atlas_bbox.npz"))
assert kept["boxes"].shape[1] == 7
m = evaluate_bbox.main(["--dataset", "arkit", "--data_path", data,
                        "--result_path", res, "--device", "cpu"])
assert {"mAP_0.25", "mAP_0.50", "table_AP_0.25"} <= set(m)

# stage 1 (Atlas, bf16, Adam) for two steps; its checkpoint's stage-2.1
# dump feeds one stage-2 step, then one stage-3 step
run = lambda *a: ["--device", "cpu", "--max-steps", "1", "--work-dir",
                  os.path.join(root, *a), "--cfg-options"]
rec, s1 = train_cli.main([
    cfg("atlas_recon_arkit.py"), "--device", "cpu", "--max-steps", "2",
    "--work-dir", os.path.join(root, "s1"), "--cfg-options",
    *[f"data.train.{o}" for o in views],
    f"data.train.ann_file={train}", "model.voxel_dim_train=(32,32,16)"])
assert len(rec) == 2 and "tsdf_loss_004" in rec[0]["log_vars"]
assert all(np.isfinite(v) for r in rec for v in r["log_vars"].values())
mid = os.path.join(root, "mid")
test_cli.main([cfg("arkit_middle.py"), s1, "--device", "cpu", "--save-path",
               os.path.join(root, "res21"), "--middle-save-path", mid,
               "--cfg-options", *test, f"data.test.ann_file={train}", *small])
assert len(np.load(os.path.join(mid, scene + "_vert.npy"))) > 0
rec, _ = train_cli.main([
    cfg("fcaf3d_middle_arkit.py"), *run("s2"), f"data.train.data_root={data}",
    f"data.train.ann_file={train}", f"data.train.points_dir={mid}",
    "data.train.num_points=400", *small[-1:]])
assert all(np.isfinite(v) for v in rec[0]["log_vars"].values())
rec, _ = train_cli.main([
    cfg("ray_marching_arkit.py"), *run("s3"),
    *[f"data.train.{o}" for o in views], f"data.train.ann_file={train}",
    "model.voxel_dim_train=(32,32,16)", *small])
assert {"loss_bbox", "loss_cls", "tsdf_loss_004"} <= set(rec[0]["log_vars"])
assert all(np.isfinite(v) for v in rec[0]["log_vars"].values())
loaded = [m for m in ("jax", "flax", "cnrma_tpu") if sys.modules.get(m)]
assert not loaded, loaded
print("ARKIT_OK")
"""


def test_arkit_path_runs_without_jax():
    """The ARKit yaw path at cut sizes on the CPU with JAX, flax and the JAX
    package blocked: the test CLI on ``configs/ray_marching_arkit.py`` (7-column
    raw boxes, 17 classes), ``nms_bbox`` and ``evaluate_bbox --dataset
    arkit``; two stage-1 steps (``configs/atlas_recon_arkit.py``), the
    stage-2.1 dump of ``configs/arkit_middle.py`` from their checkpoint
    and one stage-2 step on it (``configs/fcaf3d_middle_arkit.py``); one stage-3
    step (finite losses, ``loss_bbox`` the rotated IoU's)."""
    proc = _run("arkit", _ARKIT)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "ARKIT_OK" in proc.stdout


_PREP = """
import sys
for name in ("jax", "jaxlib", "flax", "optax", "cnrma_tpu"):
    sys.modules[name] = None          # any import of them raises
sys.path.insert(0, REPO)
import atexit, os, pickle, shutil, tempfile
import numpy as np
from cnrma_torch.synthetic import write_scannet_raw
from cnrma_torch.tools.data_prepare import (
    aggregate_data, batch_load_scannet_data, extract_posed_images,
    generate_tsdf)
root = tempfile.mkdtemp()
atexit.register(shutil.rmtree, root, ignore_errors=True)
write_scannet_raw(root, n_frames=3, tsdf_dim=(48, 48, 24), voxel_size=0.08,
                  color_size=(128, 96), depth_size=(64, 48))
data = os.path.join(root, "scannet")
meta = os.path.join(root, "meta_data")
scene = "scene0000_00"
extract_posed_images.main(["--scans_path", os.path.join(root, "scans"),
                           "--output_path", os.path.join(data,
                                                         "posed_images")])
generate_tsdf.main(["--data_path", data, "--save_path", data,
                    "--voxel_size", "0.16", "--device", "cpu"])
batch_load_scannet_data.main([
    "--scans_path", os.path.join(root, "scans"), "--label_map",
    os.path.join(meta, "scannetv2-labels.combined.tsv"), "--output_path",
    os.path.join(data, "scannet_instance_data")])
for split in ("train", "val"):
    aggregate_data.main(["--dataset", "scannet", "--data_path", data,
                         "--split", split, "--scene_list",
                         os.path.join(meta, f"scannetv2_{split}.txt")])
tsdf = os.path.join(data, "atlas_tsdf", scene)
assert sorted(os.listdir(tsdf)) == ["info.json", "tsdf_16.npz",
                                    "tsdf_32.npz", "tsdf_64.npz"]
with np.load(os.path.join(tsdf, "tsdf_16.npz")) as z:
    assert z["origin"].shape == (1, 3) and np.isfinite(z["tsdf"]).all()
    assert (np.abs(z["tsdf"]) < 1).any()
with open(os.path.join(data, "scannet_infos_val.pkl"), "rb") as f:
    infos = pickle.load(f)
assert [i["scene"] for i in infos] == [scene]
assert infos[0]["total_image_ids"] == ["00000", "00001", "00002"]
assert infos[0]["annos"]["gt_num"] == 4
try:
    generate_tsdf.main(["--data_path", data, "--save_path", data])
    raise AssertionError("generate_tsdf ran without a card")
except RuntimeError as e:
    assert "no CUDA device" in str(e)
loaded = [m for m in ("jax", "flax", "cnrma_tpu") if sys.modules.get(m)]
assert not loaded, loaded
print("PREP_OK")
"""


def test_scannet_preparation_runs_without_jax():
    """ScanNet's data preparation at a tiny size on the CPU with JAX, flax
    and the JAX package blocked: ``extract_posed_images`` from a synthetic
    ``.sens``, ``generate_tsdf --device cpu`` (and its default ``cuda:0``
    refusing without a card), ``batch_load_scannet_data`` and
    ``aggregate_data`` for train and val."""
    proc = _run("prep", _PREP)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "PREP_OK" in proc.stdout

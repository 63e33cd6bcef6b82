"""The PyTorch port imports and runs with JAX, flax and the JAX package
unavailable, as on a GPU machine that has none of them: a tiny forward,
then the test CLI, ``nms_bbox`` and ``evaluate_bbox`` on one tiny synthetic
scene, and one step of the train CLI on it, whose checkpoint the test CLI
loads; and the three-stage recipe on such a scene, one step a stage."""

import os
import subprocess
import sys

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
import cnrma_torch.core.registry
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
loaded = [m for m in ("jax", "flax", "cnrma_tpu") if sys.modules.get(m)]
assert not loaded, loaded
print("NO_JAX_OK")
"""


def test_port_runs_without_jax():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run(
        [sys.executable, "-c", _SCRIPT.replace("REPO", repr(REPO))],
        capture_output=True, text=True, timeout=300, env=env, cwd=REPO)
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

# the merge, one stage-3 step from it, and the test CLI on its checkpoint
merged = os.path.join(root, "merged.pt")
combine_models.main(["--recon", s1, "--detector", s2, "--output", merged])
rec, s3 = train_cli.main([cfg("ray_marching_scannet.py"), "--load-from",
                          merged, *run("s3"), *train, *small])
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
    one stage-3 step from it and the test CLI on its checkpoint, at cut
    sizes on the CPU with JAX, flax and the JAX package blocked."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run(
        [sys.executable, "-c", _RECIPE.replace("REPO", repr(REPO))],
        capture_output=True, text=True, timeout=300, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "RECIPE_OK" in proc.stdout

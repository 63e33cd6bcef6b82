"""The PyTorch port imports and runs with JAX, flax and the JAX package
unavailable, as on a GPU machine that has none of them: a tiny forward,
then the test CLI, ``nms_bbox`` and ``evaluate_bbox`` on one tiny synthetic
scene."""

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
import cnrma_torch.tools.evaluate_bbox
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
import os, tempfile
from cnrma_torch.synthetic import write_scannet
from cnrma_torch.tools import evaluate_bbox, nms_bbox, test as test_cli
root = tempfile.mkdtemp()
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

"""The PyTorch port imports and runs with JAX, flax and the JAX package
unavailable, as on a GPU machine that has none of them."""

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

"""``stage_ms.unet_head.test``: the 3D U-Net and TSDF head (models/unet3d.py, models/tsdf_head.py) a scene."""

from port_bench.lib import readers

UNIT = "ms"
MOVES = "test_scenes_per_s"
WORKLOADS = ["scannet.test.room"]


def read(run):
    return readers.stage_ms(run, "unet_head")

"""``stage_ms.unet_head.train``: the 3D U-Net and TSDF head's forward a step."""

from port_bench.lib import readers

UNIT = "ms"
MOVES = "train_scenes_per_s"
WORKLOADS = ["scannet.train.room"]


def read(run):
    return readers.stage_ms(run, "unet_head")

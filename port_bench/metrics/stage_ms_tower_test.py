"""``stage_ms.tower.test``: the 2D tower (models/resnet_fpn.py) a scene: the program's tower mark."""

from port_bench.lib import readers

UNIT = "ms"
MOVES = "test_scenes_per_s"
WORKLOADS = ["scannet.test.room"]


def read(run):
    return readers.stage_ms(run, "tower")

"""``stage_ms.tower.train``: the 2D tower's forward a step: the program's tower mark."""

from port_bench.lib import readers

UNIT = "ms"
MOVES = "train_scenes_per_s"
WORKLOADS = ["scannet.train.room"]


def read(run):
    return readers.stage_ms(run, "tower")

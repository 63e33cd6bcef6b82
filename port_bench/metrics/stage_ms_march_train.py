"""``stage_ms.march.train``: the TSDF losses, the march, the subsample and the feature gather a step (the program's march mark)."""

from port_bench.lib import readers

UNIT = "ms"
MOVES = "train_scenes_per_s"
WORKLOADS = ["scannet.train.room"]


def read(run):
    return readers.stage_ms(run, "march")

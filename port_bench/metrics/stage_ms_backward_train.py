"""``stage_ms.backward.train``: the backward a step (train/loop.py): the program's backward mark."""

from port_bench.lib import readers

UNIT = "ms"
MOVES = "train_scenes_per_s"
WORKLOADS = ["fcaf3d.train.room", "scannet.train.room"]


def read(run):
    return readers.stage_ms(run, "backward")

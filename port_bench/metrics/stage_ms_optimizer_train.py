"""``stage_ms.optimizer.train``: the clip and AdamW update a step (train/optim.py): the program's optimizer mark."""

from port_bench.lib import readers

UNIT = "ms"
MOVES = "train_scenes_per_s"
WORKLOADS = ["fcaf3d.train.room", "scannet.train.room"]


def read(run):
    return readers.stage_ms(run, "optimizer")

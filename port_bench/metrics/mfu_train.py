"""``mfu.train``: a training step's model FLOPs (forward and the gradients it needs, no recomputation) over the window's time, against fp32's 67 TFLOP/s."""

from port_bench.lib import readers

UNIT = "%"
MOVES = "train_scenes_per_s"
WORKLOADS = ["fcaf3d.train.room", "scannet.train.room"]


def read(run):
    return readers.mfu_pct(run)

"""``stage_ms.detector.train``: the detector's forward a step (ops/voxelize.py, ops/sparse.py, models/fcaf3d.py): the program's detector mark."""

from port_bench.lib import readers

UNIT = "ms"
MOVES = "train_scenes_per_s"
WORKLOADS = ["fcaf3d.train.room", "scannet.train.room"]


def read(run):
    return readers.stage_ms(run, "detector")

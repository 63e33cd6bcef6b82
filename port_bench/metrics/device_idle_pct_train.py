"""``device_idle_pct.train``: the share of the traced window in which no device operation runs."""

from port_bench.lib import readers

UNIT = "%"
MOVES = "train_scenes_per_s"
WORKLOADS = ["fcaf3d.train.room", "scannet.train.room"]


def read(run):
    return readers.idle_pct(run)

"""``volume_accum_bwd_roofline``: K1b (csrc/volume_accum_bwd.cu): its least time (from the cell's projections and grid) over its device time."""

from port_bench.lib import readers

UNIT = "%"
MOVES = "train_scenes_per_s"
WORKLOADS = ["scannet.train.room"]


def read(run):
    return readers.roofline_pct(run, "volume_accum_bwd_kernel")

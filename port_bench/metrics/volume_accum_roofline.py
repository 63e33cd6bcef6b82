"""``volume_accum_roofline``: K1 (csrc/volume_accum.cu): its least time (bytes and operations from the cell's projections and grid) over its device time."""

from port_bench.lib import readers

UNIT = "%"
MOVES = "test_scenes_per_s"
WORKLOADS = ["scannet.test.room"]


def read(run):
    return readers.roofline_pct(run, "volume_accum_kernel")

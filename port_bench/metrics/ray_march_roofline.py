"""``ray_march_roofline``: K2 (csrc/ray_march.cu): its least time (from the planted TSDF and the rays, marched by the reference) over its device time."""

from port_bench.lib import readers

UNIT = "%"
MOVES = "test_scenes_per_s"
WORKLOADS = ["scannet.test.room"]


def read(run):
    return readers.roofline_pct(run, "ray_march_kernel")

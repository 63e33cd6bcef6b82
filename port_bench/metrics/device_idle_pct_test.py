"""``device_idle_pct.test``: the share of the traced window in which no device operation runs."""

from port_bench.lib import readers

UNIT = "%"
MOVES = "test_scenes_per_s"
WORKLOADS = ["scannet.test.room"]


def read(run):
    return readers.idle_pct(run)

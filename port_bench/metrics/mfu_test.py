"""``mfu.test``: the test forward's model FLOPs (counted by the benchmark) over the window's time, against fp32's 67 TFLOP/s."""

from port_bench.lib import readers

UNIT = "%"
MOVES = "test_scenes_per_s"
WORKLOADS = ["scannet.test.room"]


def read(run):
    return readers.mfu_pct(run)

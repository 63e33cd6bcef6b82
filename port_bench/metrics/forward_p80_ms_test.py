"""``forward_p80_ms.test``: the 80th percentile of the window's per-scene times (the copy and the forward, host clock around a synchronised call)."""

from port_bench.lib import readers

UNIT = "ms"
MOVES = "test_scenes_per_s"
WORKLOADS = ["scannet.test.room"]


def read(run):
    return readers.p80_ms(run)

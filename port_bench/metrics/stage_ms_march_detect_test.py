"""``stage_ms.march_detect.test``: from the unet_head mark to the forward's return: the march, the detector and get_bboxes a scene."""

from port_bench.lib import readers

UNIT = "ms"
MOVES = "test_scenes_per_s"
WORKLOADS = ["scannet.test.room"]


def read(run):
    return readers.stage_ms(run, "march_detect")

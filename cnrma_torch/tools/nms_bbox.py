"""Offline per-class 3D NMS over the raw box dumps of the test CLI.

    python -m cnrma_torch.tools.nms_bbox --result_path DIR [--postfix P]
        [--score_thr 0.01] [--iou_thr 0.5] [--device cpu]

Port of ``tools/nms_bbox.py``, with its arguments and file contract: reads
``{result_path}/{scene}/{scene}_bbox_raw.npz`` (gravity-center boxes +
[N, n_classes] scores), runs per-class NMS at score_thr 0.01 / iou_thr 0.5
(IoU on ``--device``, the card by default) and writes ``{scene}{postfix}``
with {boxes (gravity-center z), scores, labels}, ready for
``cnrma_torch.tools.evaluate_bbox``.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np

from cnrma_torch.ops.nms import multiclass_nms_np


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--result_path", required=True)
    p.add_argument("--postfix", default="_atlas_bbox.npz")
    p.add_argument("--score_thr", type=float, default=0.01)
    p.add_argument("--iou_thr", type=float, default=0.5)
    p.add_argument("--device", default="cuda:0", help="cuda:0 or cpu")
    args = p.parse_args(argv)

    for scene in sorted(os.listdir(args.result_path)):
        raw = os.path.join(args.result_path, scene, scene + "_bbox_raw.npz")
        if not os.path.isfile(raw):
            continue
        data = np.load(raw)
        boxes, scores, labels = multiclass_nms_np(
            data["bboxes"], data["scores"], score_thr=args.score_thr,
            iou_thr=args.iou_thr, device=args.device)
        # the raw dump and the NMS output both carry gravity-center z: the
        # boxes pass through unchanged (see tools/nms_bbox.py)
        np.savez(os.path.join(args.result_path, scene, scene + args.postfix),
                 boxes=boxes, scores=scores, labels=labels)
        print("Saved", scene, f"({len(boxes)} boxes)")


if __name__ == "__main__":
    main()

"""mAP@0.25/0.5 scoring of NMS'ed results against GT boxes.

    python -m cnrma_torch.tools.evaluate_bbox --data_path DATA
        --result_path DIR [--dataset scannet|arkit] [--postfix P]
        [--device cpu]

Port of ``tools/evaluate_bbox.py``, with its arguments and data contract:
reads ``{scene}{postfix}.npz`` result files and
``{data_path}/{dataset}_instance_data/{scene}_aligned_bbox.npy`` GT, with
the reference's class lists and NYU40 id maps; ``--dataset arkit`` scores
rotated boxes.  IoU runs on ``--device`` (the card by default).
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, Optional, Sequence

import numpy as np

from cnrma_torch.eval.indoor_eval import indoor_eval

SCANNET_CLASSES = ['cabinet', 'bed', 'chair', 'sofa', 'table', 'door',
                   'window', 'bookshelf', 'picture', 'counter', 'desk',
                   'curtain', 'refrigerator', 'showercurtrain', 'toilet',
                   'sink', 'bathtub', 'garbagebin']
SCANNET_CAT_IDS = [3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24, 28, 33,
                   34, 36, 39]
ARKIT_CLASSES = ['cabinet', 'refrigerator', 'shelf', 'stove', 'bed',
                 'sink', 'washer', 'toilet', 'bathtub', 'oven',
                 'dishwasher', 'fireplace', 'stool', 'chair', 'table',
                 'tv_monitor', 'sofa']


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", default="scannet",
                   choices=["scannet", "arkit"])
    p.add_argument("--data_path", required=True)
    p.add_argument("--result_path", required=True)
    p.add_argument("--postfix", default="_atlas_bbox")
    p.add_argument("--device", default="cuda:0", help="cuda:0 or cpu")
    args = p.parse_args(argv)

    if args.dataset == "scannet":
        classes = SCANNET_CLASSES
        catid2label = {c: i for i, c in enumerate(SCANNET_CAT_IDS)}
        gt_dir = os.path.join(args.data_path, "scannet_instance_data")
        rotated = False
    else:
        classes = ARKIT_CLASSES
        catid2label = {i: i for i in range(len(classes))}
        gt_dir = os.path.join(args.data_path, "arkit_instance_data")
        rotated = True
    label2cat = {i: c for i, c in enumerate(classes)}

    scene_ids = sorted(
        s for s in os.listdir(args.result_path)
        if os.path.isfile(os.path.join(
            args.result_path, s, s + args.postfix + ".npz")))

    results, gt_annos = [], []
    for scene in scene_ids:
        data = np.load(os.path.join(args.result_path, scene,
                                    scene + args.postfix + ".npz"))
        boxes = data["boxes"].astype(np.float32)
        # stored with gravity-center z; indoor_eval wants bottom-z storage
        if len(boxes):
            boxes[:, 2] -= boxes[:, 5] / 2
        results.append({"boxes": boxes, "scores": data["scores"],
                        "labels": data["labels"]})
        gt_raw = np.load(os.path.join(gt_dir, scene + "_aligned_bbox.npy"))
        if len(gt_raw):
            gt_boxes = gt_raw[:, :-1].astype(np.float32)
            gt_boxes = np.concatenate(
                [gt_boxes,
                 np.zeros((len(gt_boxes),
                           7 - gt_boxes.shape[1]), np.float32)], axis=1
            ) if gt_boxes.shape[1] < 7 else gt_boxes
            gt_boxes[:, 2] -= gt_boxes[:, 5] / 2     # gravity -> bottom z
            gt_labels = np.array(
                [catid2label[int(c)] for c in gt_raw[:, -1]])
        else:
            gt_boxes = np.zeros((0, 7), np.float32)
            gt_labels = np.zeros((0,), np.int64)
        gt_annos.append({"gt_boxes": gt_boxes, "labels": gt_labels})

    metrics = indoor_eval(gt_annos, results, iou_thrs=(0.25, 0.5),
                          label2cat=label2cat, rotated=rotated,
                          device=args.device)
    print(f"\nmAP@0.25 = {metrics['mAP_0.25']:.4f}   "
          f"mAP@0.50 = {metrics['mAP_0.50']:.4f}")
    return metrics


if __name__ == "__main__":
    main()

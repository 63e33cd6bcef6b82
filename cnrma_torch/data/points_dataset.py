"""Dumped-point-cloud dataset for stage-2 detector pretraining, a copy of
``cnrma_tpu/data/points_dataset.py``.

Loads the 35-column ``{scene}_vert.npy`` files that the stage-2.1 dump
writes (``python -m cnrma_torch.tools.test configs/scannet_middle.py CKPT
--middle-save-path DIR``: xyz and the 32 weighted features of the kept
points) with the scene's GT boxes, and emits fixed-shape samples: the
points subsampled without replacement to ``num_points`` (a draw of the
dataset's ``np.random.RandomState``, as the JAX reader's) or padded with
``point_valid`` False, the boxes padded to ``max_gt_boxes``.  The
augmentation (flips, rotation, scale, translation) runs in the model.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional

import numpy as np

from cnrma_torch.core.registry import DATASETS
from cnrma_torch.geometry.boxes import DepthBoxes


@DATASETS.register()
class MiddlePointsDataset:
    def __init__(self, data_root: str, ann_file: str,
                 points_dir: str,
                 classes: Optional[List[str]] = None,
                 test_mode: bool = False,
                 num_points: int = 500000,
                 load_dim: int = 35,
                 with_yaw: bool = False,
                 max_gt_boxes: int = 64,
                 repeat: int = 1,
                 seed: Optional[int] = None):
        self.data_root = data_root
        self.points_dir = points_dir
        self.classes = classes
        self.test_mode = test_mode
        self.num_points = num_points
        self.load_dim = load_dim
        self.with_yaw = with_yaw
        self.max_gt_boxes = max_gt_boxes
        self.repeat = repeat
        self.rng = np.random.RandomState(seed)
        with open(ann_file, "rb") as f:
            infos = sorted(pickle.load(f), key=lambda x: x["scene"])
        # keep only scenes whose dump exists
        self.data_infos = [
            i for i in infos
            if os.path.isfile(os.path.join(points_dir,
                                           i["scene"] + "_vert.npy"))]

    def __len__(self) -> int:
        return len(self.data_infos) * self.repeat

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        info = self.data_infos[index % len(self.data_infos)]
        scene = info["scene"]
        pts = np.load(os.path.join(self.points_dir, scene + "_vert.npy"))
        pts = pts[:, :self.load_dim].astype(np.float32)

        p = self.num_points
        out_pts = np.zeros((p, pts.shape[1]), np.float32)
        valid = np.zeros((p,), bool)
        n = len(pts)
        if n > p:
            sel = self.rng.choice(n, p, replace=False)
            out_pts[:] = pts[sel]
            valid[:] = True
        else:
            out_pts[:n] = pts
            valid[:n] = True

        annos = info.get("annos", {})
        box_dim = 7 if self.with_yaw else 6
        if annos.get("gt_num", 0) != 0:
            raw = np.asarray(annos["gt_boxes_upright_depth"], np.float32)
            labels = np.asarray(annos["class"], np.int64)
        else:
            raw = np.zeros((0, box_dim), np.float32)
            labels = np.zeros((0,), np.int64)
        boxes = DepthBoxes(raw, box_dim=raw.shape[-1] if len(raw)
                           else box_dim, with_yaw=self.with_yaw,
                           origin=(0.5, 0.5, 0.5))

        m = self.max_gt_boxes
        gt = np.zeros((m, 7), np.float32)
        gt_labels = np.zeros((m,), np.int32)
        gt_valid = np.zeros((m,), bool)
        k = min(len(boxes), m)
        if k:
            gt[:k] = boxes.gravity_tensor()[:k]
            gt_labels[:k] = labels[:k]
            gt_valid[:k] = True

        return {"scene": scene,
                "points": out_pts[:, :3],
                "point_feats": out_pts[:, 3:],
                "point_valid": valid,
                "gt_boxes": gt, "gt_labels": gt_labels,
                "gt_valid": gt_valid}

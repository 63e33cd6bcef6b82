"""Mesh reconstruction metrics (acc/comp distances, precision/recall/
F-score), a copy of ``cnrma_tpu/eval/mesh_eval.py`` — scipy-KDTree version
of the reference's open3d evaluation (``post_process/evaluate_mesh.py:
29-92``): 2 cm voxel downsample of both vertex clouds, nearest-neighbor
distances in both directions, 5 cm threshold.  The downsample is the
numpy one (the JAX package's optional native library is not used).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
from scipy.spatial import cKDTree


def voxel_downsample(points: np.ndarray, voxel: float) -> np.ndarray:
    """Average points per occupied voxel (open3d voxel_down_sample)."""
    if len(points) == 0 or not voxel:
        return points
    keys = np.floor(points / voxel).astype(np.int64)
    _, inv = np.unique(keys, axis=0, return_inverse=True)
    n = inv.max() + 1
    sums = np.zeros((n, 3), np.float64)
    cnts = np.zeros((n,), np.float64)
    np.add.at(sums, inv, points)
    np.add.at(cnts, inv, 1)
    return (sums / cnts[:, None]).astype(np.float32)


def eval_mesh_metrics(verts_pred: np.ndarray, verts_trgt: np.ndarray,
                      threshold: float = 0.05,
                      down_sample: float = 0.02) -> Dict[str, float]:
    """Returns {dist1, dist2, prec, recal, fscore} with the reference's
    (slightly confusing) key convention: dist1 = mean pred->gt distance
    (accuracy), dist2 = mean gt->pred distance (completeness)."""
    if down_sample:
        verts_pred = voxel_downsample(np.asarray(verts_pred, np.float64),
                                      down_sample)
        verts_trgt = voxel_downsample(np.asarray(verts_trgt, np.float64),
                                      down_sample)
    if len(verts_pred) == 0 or len(verts_trgt) == 0:
        return {"dist1": float("inf"), "dist2": float("inf"),
                "prec": 0.0, "recal": 0.0, "fscore": 0.0}
    d_pred_to_gt, _ = cKDTree(verts_trgt).query(verts_pred, k=1)
    d_gt_to_pred, _ = cKDTree(verts_pred).query(verts_trgt, k=1)
    precision = float(np.mean(d_pred_to_gt < threshold))
    recall = float(np.mean(d_gt_to_pred < threshold))
    fscore = (2 * precision * recall / (precision + recall)
              if precision + recall > 0 else 0.0)
    return {"dist1": float(np.mean(d_pred_to_gt)),
            "dist2": float(np.mean(d_gt_to_pred)),
            "prec": precision, "recal": recall, "fscore": fscore}

"""3D NMS over BEV IoU (port of ``cnrma_tpu/ops/nms.py``).

The reference runs NMS offline with pcdet's CUDA kernels (rotated BEV
``nms_gpu``, axis-aligned ``nms_normal_gpu``).  Here the BEV IoU matrix is
computed in torch on the caller's device, and the greedy suppression walks
it on the host in score order: the same keep mask as the JAX
``lax.fori_loop``.  The JAX package pads each class to a power of two to
bound its recompiles; nothing here compiles, so there is no padding.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from cnrma_torch.ops.iou3d import iou_bev_matrix


def nms_bev(boxes: torch.Tensor, scores: torch.Tensor, iou_thr: float,
            rotated: bool) -> torch.Tensor:
    """Greedy BEV NMS.

    Args:
        boxes: [N, 7] (cx, cy, cz, dx, dy, dz, yaw) gravity-center boxes.
        scores: [N]; a score of -inf is never kept and suppresses nothing.
        iou_thr: suppression threshold (strict ``>``).
        rotated: rotated rectangle overlap (yaw) or axis-aligned.

    Returns:
        keep: [N] bool mask of the surviving boxes, on ``boxes``' device.
    """
    n = boxes.shape[0]
    order = torch.argsort(-scores, stable=True)
    b = boxes[order]
    over = (iou_bev_matrix(b, b, rotated=rotated) > iou_thr).cpu().numpy()
    alive = (scores[order] > -torch.inf).cpu().numpy()
    keep_sorted = np.ones(n, bool)
    for i in range(n):
        if keep_sorted[i] and alive[i]:
            keep_sorted[i + 1:] &= ~over[i, i + 1:]
    keep_sorted &= alive
    keep = torch.zeros(n, dtype=torch.bool, device=boxes.device)
    keep[order] = torch.from_numpy(keep_sorted).to(boxes.device)
    return keep


def multiclass_nms_np(bboxes: np.ndarray, scores: np.ndarray,
                      score_thr: float = 0.01, iou_thr: float = 0.5,
                      device: torch.device | str = "cpu"
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-class NMS over raw head outputs, matching
    ``post_process/nms_bbox.py:nms`` (:17-58); IoU on ``device``.

    Args:
        bboxes: [N, 6|7] gravity-center boxes, as stored in
            ``{scene}_bbox_raw.npz``.
        scores: [N, n_classes] (sigmoid cls x sigmoid centerness).

    Returns:
        (boxes [M, 6|7], scores [M], labels [M]) with **gravity-center z**,
        the reference's ``_atlas_bbox.npz`` convention.
    """
    n_classes = scores.shape[1]
    yaw_flag = bboxes.shape[1] == 7
    if not yaw_flag:
        bboxes = np.concatenate(
            [bboxes, np.zeros((len(bboxes), 1), bboxes.dtype)], axis=1)
    out_b, out_s, out_l = [], [], []
    for cls in range(n_classes):
        ids = scores[:, cls] > score_thr
        if not ids.any():
            continue
        cb = bboxes[ids]
        cs = scores[ids, cls]
        keep = nms_bev(torch.as_tensor(cb, dtype=torch.float32,
                                       device=device),
                       torch.as_tensor(cs, dtype=torch.float32,
                                       device=device),
                       iou_thr, rotated=yaw_flag).cpu().numpy()
        out_b.append(cb[keep])
        out_s.append(cs[keep])
        out_l.append(np.full(int(keep.sum()), cls, np.int64))
    if out_b:
        boxes = np.concatenate(out_b)
        scs = np.concatenate(out_s)
        labels = np.concatenate(out_l)
    else:
        boxes = np.zeros((0, 7), np.float32)
        scs = np.zeros((0,), np.float32)
        labels = np.zeros((0,), np.int64)
    if not yaw_flag:
        boxes = boxes[:, :6]
    return boxes, scs, labels

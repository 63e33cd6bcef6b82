"""Indoor 3D detection mAP evaluation (numpy), a copy of
``cnrma_tpu/eval/indoor_eval.py`` on the port's torch IoU.

Re-implements the mmdet3d ``indoor_eval`` metric used by the reference's
offline scorer (``post_process/evaluate_bbox.py:93-100``): per-class
greedy matching of score-sorted predictions to GT at IoU thresholds
(0.25, 0.5), VOC-style area AP, printed per-class table + mAP/mAR.

Box format here: [N, 6|7] with **bottom-center z** (DepthInstance3DBoxes
storage); IoU is full 3D (rotated when yaw present), computed by
``cnrma_torch.ops.iou3d.iou_3d_matrix`` on ``device``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from cnrma_torch.ops.iou3d import iou_3d_matrix


def _to_gravity(boxes: np.ndarray) -> np.ndarray:
    out = np.array(boxes, np.float32, copy=True)
    if len(out):
        out[:, 2] += out[:, 5] / 2
    if out.shape[1] == 6:
        out = np.concatenate(
            [out, np.zeros((len(out), 1), np.float32)], axis=1)
    return out


def _average_precision(recall: np.ndarray, precision: np.ndarray) -> float:
    """VOC 'area' AP."""
    mrec = np.concatenate([[0.0], recall, [1.0]])
    mpre = np.concatenate([[0.0], precision, [0.0]])
    for i in range(len(mpre) - 2, -1, -1):
        mpre[i] = max(mpre[i], mpre[i + 1])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def indoor_eval(gt_annos: Sequence[Dict], results: Sequence[Dict],
                iou_thrs: Sequence[float] = (0.25, 0.5),
                label2cat: Optional[Dict[int, str]] = None,
                rotated: bool = False,
                logger=print,
                device: torch.device | str = "cpu") -> Dict[str, float]:
    """Args:
        gt_annos: per scene {'gt_boxes': [G, 6|7] bottom-z, 'labels': [G]}.
        results: per scene {'boxes': [N, 6|7] bottom-z, 'scores': [N],
                 'labels': [N]}.
    Returns dict with per-class AP/recall and mAP/mAR per threshold.
    """
    classes = sorted({int(l) for g in gt_annos
                      for l in np.asarray(g["labels"]).ravel()}
                     | {int(l) for r in results
                        for l in np.asarray(r["labels"]).ravel()})
    metrics: Dict[str, float] = {}

    # precompute per-scene IoU between all preds and gts of same class
    for thr in iou_thrs:
        aps, recalls = {}, {}
        for cls in classes:
            # gather class predictions across scenes
            scene_pred = []
            n_gt = 0
            for si, (g, r) in enumerate(zip(gt_annos, results)):
                gl = np.asarray(g["labels"]).ravel()
                rl = np.asarray(r["labels"]).ravel()
                gmask = gl == cls
                pmask = rl == cls
                n_gt += int(gmask.sum())
                if pmask.sum() == 0:
                    continue
                gboxes = _to_gravity(np.asarray(g["gt_boxes"])[gmask])
                pboxes = _to_gravity(np.asarray(r["boxes"])[pmask])
                scores = np.asarray(r["scores"])[pmask]
                if len(gboxes):
                    iou = iou_3d_matrix(
                        torch.from_numpy(pboxes).to(device),
                        torch.from_numpy(gboxes).to(device),
                        rotated=rotated).cpu().numpy()
                else:
                    iou = np.zeros((len(pboxes), 0), np.float32)
                scene_pred.append((si, scores, iou))

            # global score sort, greedy match per scene
            flat = []
            for si, scores, iou in scene_pred:
                for j, s in enumerate(scores):
                    flat.append((float(s), si, j))
            flat.sort(key=lambda t: -t[0])
            matched = {si: np.zeros(iou.shape[1], bool)
                       for si, _, iou in scene_pred}
            ious = {si: iou for si, _, iou in scene_pred}
            tp = np.zeros(len(flat))
            fp = np.zeros(len(flat))
            for rank, (s, si, j) in enumerate(flat):
                iou = ious[si]
                if iou.shape[1] == 0:
                    fp[rank] = 1
                    continue
                best = int(np.argmax(iou[j]))
                # STRICT > like mmdet3d eval_det_cls / the original VOC
                # scorer: a detection at exactly the threshold is a FP
                if iou[j, best] > thr and not matched[si][best]:
                    matched[si][best] = True
                    tp[rank] = 1
                else:
                    fp[rank] = 1
            if n_gt == 0:
                continue
            ctp = np.cumsum(tp)
            cfp = np.cumsum(fp)
            recall = ctp / n_gt
            precision = ctp / np.maximum(ctp + cfp, 1e-12)
            name = (label2cat or {}).get(cls, str(cls))
            aps[name] = _average_precision(recall, precision)
            recalls[name] = float(recall[-1]) if len(recall) else 0.0

        for name in aps:
            metrics[f"{name}_AP_{thr:.2f}"] = aps[name]
            metrics[f"{name}_rec_{thr:.2f}"] = recalls[name]
        metrics[f"mAP_{thr:.2f}"] = (float(np.mean(list(aps.values())))
                                     if aps else 0.0)
        metrics[f"mAR_{thr:.2f}"] = (float(np.mean(list(recalls.values())))
                                     if recalls else 0.0)

    if logger:
        for thr in iou_thrs:
            logger(f"--- IoU {thr:.2f} ---")
            for k in sorted(metrics):
                if k.endswith(f"AP_{thr:.2f}"):
                    logger(f"  {k}: {metrics[k]:.4f}")
            logger(f"  mAP_{thr:.2f}: {metrics[f'mAP_{thr:.2f}']:.4f}  "
                   f"mAR_{thr:.2f}: {metrics[f'mAR_{thr:.2f}']:.4f}")
    return metrics

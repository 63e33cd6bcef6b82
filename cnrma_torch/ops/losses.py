"""Detection and reconstruction losses.

Port of ``cnrma_tpu/ops/losses.py`` (the reference's mmcv
``SigmoidFocalLoss``, mmdet ``CrossEntropyLoss`` with sigmoid and the
fcaf3d ``IoU3DLoss``): masked, fixed-shape reductions with explicit
``avg_factor`` denominators, so padding rows count for nothing.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from cnrma_torch.ops.iou3d import aligned_iou_3d, rotated_iou_3d


def sigmoid_focal_loss(logits: torch.Tensor, labels: torch.Tensor,
                       valid: torch.Tensor, avg_factor: torch.Tensor,
                       gamma: float = 2.0, alpha: float = 0.25,
                       loss_weight: float = 1.0) -> torch.Tensor:
    """Multi-class sigmoid focal loss of [N, C] logits; ``labels`` [N] is
    the class in [0, C) of a positive row, -1 for background; rows with
    ``valid`` False give nothing; the sum is divided by ``avg_factor``."""
    c = logits.shape[1]
    onehot = F.one_hot(labels.long().clamp(0, c - 1), c).float()
    onehot = torch.where((labels >= 0)[:, None], onehot, 0.0)
    x = logits.float()
    p = torch.sigmoid(x)
    ce = -onehot * F.logsigmoid(x) - (1 - onehot) * F.logsigmoid(-x)
    p_t = p * onehot + (1 - p) * (1 - onehot)
    alpha_t = alpha * onehot + (1 - alpha) * (1 - onehot)
    loss = alpha_t * ((1 - p_t) ** gamma) * ce
    loss = torch.where(valid[:, None], loss, 0.0)
    return loss_weight * loss.sum() / avg_factor


def bce_loss(logits: torch.Tensor, targets: torch.Tensor,
             valid: torch.Tensor, avg_factor: torch.Tensor,
             loss_weight: float = 1.0) -> torch.Tensor:
    """Binary cross entropy with logits over the ``valid`` rows (the
    centerness loss)."""
    ce = (-targets * F.logsigmoid(logits)
          - (1 - targets) * F.logsigmoid(-logits))
    return loss_weight * torch.where(valid, ce, 0.0).sum() / avg_factor


def iou3d_loss(pred_boxes: torch.Tensor, target_boxes: torch.Tensor,
               weight: torch.Tensor, valid: torch.Tensor,
               avg_factor: torch.Tensor, with_yaw: bool,
               loss_weight: float = 1.0) -> torch.Tensor:
    """``1 - IoU3D`` weighted by ``weight`` (the centerness targets) over
    the ``valid`` rows; boxes (cx, cy, cz, dx, dy, dz[, yaw]) with
    gravity-center z, axis-aligned without yaw, rotated with it.  The
    rotated form first puts a unit box in every invalid row (degenerate
    padding boxes would give NaN gradients through the polygon clip even
    though the mask drops their values); valid rows are untouched."""
    if with_yaw:
        unit = torch.tensor([0., 0., 0., 1., 1., 1., 0.],
                            device=pred_boxes.device)
        iou = rotated_iou_3d(torch.where(valid[:, None], pred_boxes, unit),
                             torch.where(valid[:, None], target_boxes, unit))
    else:
        iou = aligned_iou_3d(pred_boxes, target_boxes)
    loss = torch.where(valid, (1.0 - iou) * weight, 0.0)
    return loss_weight * loss.sum() / avg_factor


def log_transform(x: torch.Tensor, shift: float = 1.0) -> torch.Tensor:
    """TSDF log rescaling ``sign(x) * log1p(|x| / shift)`` (reference
    ``atlas_head.py:83-86``)."""
    return torch.sign(x) * torch.log1p(torch.abs(x) / shift)

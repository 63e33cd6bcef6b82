"""The standalone FCAF3D detector of stage-2 pretraining, trained on the
points that the stage-2.1 dump wrote.

Port of ``cnrma_tpu/models/fcaf3d_only.py``: the same ``detector`` submodule
as ``CNRMA``'s, with the same names, so its parameters move 1:1 into the
stage-3 model (``python -m port_bench.reference.tools.combine_models``).  In training
the feature augmentation runs on the points, with the draws of a
``torch.Generator`` or, in the parity tests, the caller's; the test forward
returns the raw per-level top-k boxes; ``with_yaw`` (ARKit) gives 7-DoF
boxes to the augmentation and the IoU loss.

Batch layout (as in the JAX package): ``points`` [B, P, 3], ``point_feats``
[B, P, C], ``point_valid`` [B, P]; in training also ``gt_boxes`` [B, M, 7],
``gt_labels`` and ``gt_valid`` [B, M].
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch
from torch import nn

from port_bench.reference.models.cn_rma import FEATURE_TRANSFORM, augment_scenes
from port_bench.reference.models.fcaf3d import DetectionCapacities, FCAF3DDetector
from port_bench.reference.timing import mark


class FCAF3DOnly(nn.Module):
    def __init__(self, in_channels: int = 32, n_classes: int = 18,
                 n_reg_outs: int = 6, with_yaw: bool = False,
                 voxel_size: float = 0.01,
                 pts_threshold: int = 200000, assigner_limit: int = 27,
                 assigner_topk: int = 18, nms_pre: int = 1000,
                 capacities: DetectionCapacities = DetectionCapacities(),
                 use_feature_transform: bool = True,
                 feature_transform: Optional[Dict[str, Any]] = None):
        super().__init__()
        self.use_feature_transform = use_feature_transform
        self.feature_transform = {**FEATURE_TRANSFORM,
                                  **(feature_transform or {})}
        self.with_yaw = with_yaw
        # same submodule name as CNRMA's, so parameters move between stages
        self.detector = FCAF3DDetector(
            in_channels=in_channels, n_classes=n_classes,
            n_reg_outs=n_reg_outs, voxel_size=voxel_size,
            pts_threshold=pts_threshold, assigner_limit=assigner_limit,
            assigner_topk=assigner_topk, with_yaw=with_yaw, nms_pre=nms_pre,
            capacities=capacities)

    @torch.no_grad()
    def forward(self, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, Any]:
        """Test-mode forward: the raw per-level top-k ``bboxes``,
        ``scores`` and ``bbox_valid``; with ``gt_boxes`` in the batch also
        the detector's ``losses`` (no augmentation)."""
        level_outs = self.detector(batch["points"], batch["point_feats"],
                                   batch["point_valid"])
        bboxes, scores, bvalid = self.detector.get_bboxes(level_outs)
        out = {"bboxes": bboxes, "scores": scores, "bbox_valid": bvalid}
        if "gt_boxes" in batch:
            out["losses"] = self.detector.loss(
                level_outs, batch["gt_boxes"], batch["gt_labels"],
                batch["gt_valid"])
        return out

    def forward_train(self, batch: Dict[str, Any],
                      generator: Optional[torch.Generator] = None,
                      aug_draws: Optional[Sequence[Dict[str, torch.Tensor]]]
                      = None, group=None) -> Dict[str, torch.Tensor]:
        """The training forward's losses ``loss_centerness``, ``loss_bbox``
        and ``loss_cls``; the augmentation's draws come from ``generator``
        unless ``aug_draws`` (one ``draw_feature_transform`` dict a scene)
        gives them.  With a process ``group`` the positive count and
        centerness sum are its ranks' mean."""
        points, gt_boxes = batch["points"], batch["gt_boxes"]
        if self.use_feature_transform:
            points, gt_boxes = augment_scenes(points, gt_boxes,
                                              self.feature_transform,
                                              self.with_yaw, generator,
                                              aug_draws)
        mark("augment")
        level_outs = self.detector(points, batch["point_feats"],
                                   batch["point_valid"])
        mark("detector")
        losses = self.detector.loss(level_outs, gt_boxes, batch["gt_labels"],
                                    batch["gt_valid"], group=group)
        mark("det_loss")
        return losses

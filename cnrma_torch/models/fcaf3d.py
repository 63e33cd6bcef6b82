"""FCAF3D sparse detection network: backbone, neck, anchor-free head, box
decoding and the loss.

Port of ``cnrma_tpu/models/fcaf3d.py`` on the fixed-capacity sparse
tensors of ``cnrma_torch/ops/sparse.py``; capacities are the JAX package's
``DetectionCapacities``.  The detector runs scene by scene and stacks the
per-level outputs.  In eval mode every norm is per row (batch norm with
running statistics) or per scene (the stem's instance norm), so that is
exact for any batch.  In training the batch norms take their statistics
over the scene's rows, so a training batch holds one scene: the JAX
package's statistics over all scenes of a batch come with multi-scene
steps (data parallel, one scene a card).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from cnrma_torch.models.assigner import fcaf3d_assign
from cnrma_torch.models.layers import MaskedBatchNorm, MaskedInstanceNorm
from cnrma_torch.ops import sparse as sp
from cnrma_torch.ops.losses import bce_loss, iou3d_loss, sigmoid_focal_loss


class DetectionCapacities(NamedTuple):
    """Static buffer sizes along the detection path (voxel counts)."""
    voxelize: int = 409600
    stride2: int = 262144
    stride4: int = 131072
    levels: Tuple[int, ...] = (32768, 12288, 4096, 2048)   # strides 8..64
    neck: Tuple[int, ...] = (262144, 65536, 16384)         # strides 8,16,32

    @classmethod
    def tiny(cls) -> "DetectionCapacities":
        return cls(voxelize=2048, stride2=1024, stride4=512,
                   levels=(256, 128, 64, 32), neck=(512, 256, 128))


def _kernel(k: int, cin: int, cout: int) -> nn.Parameter:
    """Kaiming-normal over the (K x Cin) fan-in, like ME kaiming_normal_."""
    return nn.Parameter(torch.randn(k, cin, cout) * math.sqrt(2.0 / (k * cin)))


class SparseConv(nn.Module):
    """Sparse conv (+ masked BN or IN + activation) on one scene."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 stride_factor: int = 1, capacity: Optional[int] = None,
                 norm: Optional[str] = "BN", act=None):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride_factor = stride_factor
        self.capacity = capacity
        self.act = act
        self.kernel = _kernel(kernel_size ** 3, in_channels, features)
        self.norm = {"BN": MaskedBatchNorm, "IN": MaskedInstanceNorm,
                     None: None}[norm]
        if self.norm is not None:
            self.norm = self.norm(features)

    def forward(self, st: sp.SparseTensor, kmap=None) -> sp.SparseTensor:
        offsets = sp.kernel_offsets(self.kernel_size)
        if self.stride_factor == 1:
            out = sp.subm_conv(st, self.kernel, kmap=kmap, offsets=offsets)
        else:
            out = sp.strided_conv(st, self.kernel, self.stride_factor,
                                  self.capacity, offsets=offsets)
        if self.norm is not None:
            out = out.with_feats(self.norm(out.feats, out.valid))
        if self.act is not None:
            out = out.with_feats(self.act(out.feats))
        return out


class SparseBasicBlock(nn.Module):
    """ME ResNet BasicBlock: conv3(s)-BN-relu, conv3-BN, (+ 1x1(s)-BN
    downsample of the identity), add, relu.  A shared ``kmap`` serves both
    convs when the stride is 1."""

    def __init__(self, in_channels: int, features: int,
                 stride_factor: int = 1, capacity: Optional[int] = None):
        super().__init__()
        self.stride_factor = stride_factor
        self.conv1 = SparseConv(in_channels, features, 3, stride_factor,
                                capacity, "BN", F.relu)
        self.conv2 = SparseConv(features, features, 3, 1, None, "BN")
        self.downsample = (
            SparseConv(in_channels, features, 1, stride_factor, capacity,
                       "BN")
            if stride_factor != 1 or in_channels != features else None)

    def forward(self, st: sp.SparseTensor, kmap=None) -> sp.SparseTensor:
        y = self.conv1(st, kmap=kmap)
        y = self.conv2(y, kmap=kmap if self.stride_factor == 1 else None)
        identity = st if self.downsample is None else self.downsample(st)
        return y.with_feats(F.relu(y.feats + identity.feats))


class FCAF3DBackboneNet(nn.Module):
    """Sparse ResNet trunk: stem (conv s2 + IN + relu, max-pool s2), four
    stride-2 stages -> tensors at voxel strides 8/16/32/64."""

    def __init__(self, in_channels: int, depth: int = 34,
                 init_dim: int = 64,
                 planes: Tuple[int, ...] = (64, 128, 256, 512),
                 capacities: DetectionCapacities = DetectionCapacities()):
        super().__init__()
        self.capacities = capacities
        self.layers = {14: (1, 1, 1, 1), 18: (2, 2, 2, 2), 34: (3, 4, 6, 3),
                       50: (4, 3, 6, 3)}[depth]
        self.stem = SparseConv(in_channels, init_dim, 3, 2,
                               capacities.stride2, "IN", F.relu)
        cin = init_dim
        for i, (n_blocks, p) in enumerate(zip(self.layers, planes)):
            for b in range(n_blocks):
                self.add_module(f"layer{i + 1}_block{b}", SparseBasicBlock(
                    cin, p, 2 if b == 0 else 1,
                    capacities.levels[i] if b == 0 else None))
                cin = p

    def forward(self, st: sp.SparseTensor) -> List[sp.SparseTensor]:
        x = sp.max_pool(self.stem(st), 2, self.capacities.stride4)
        outs = []
        for i, n_blocks in enumerate(self.layers):
            x = getattr(self, f"layer{i + 1}_block0")(x)
            kmap = sp.kernel_map(x, sp.kernel_offsets(3))
            for b in range(1, n_blocks):
                x = getattr(self, f"layer{i + 1}_block{b}")(x, kmap=kmap)
            outs.append(x)
        return outs


class SparseUpBlock(nn.Module):
    """Generative transpose k2 s2 + BN + ELU + conv k3 + BN + ELU
    (reference ``_make_up_block``)."""

    def __init__(self, in_channels: int, features: int):
        super().__init__()
        self.up_kernel = _kernel(8, in_channels, features)
        self.norm1 = MaskedBatchNorm(features)
        self.conv = SparseConv(features, features, 3, 1, None, "BN", F.elu)

    def forward(self, st: sp.SparseTensor) -> sp.SparseTensor:
        x = sp.generative_transpose_conv(st, self.up_kernel)
        x = x.with_feats(F.elu(self.norm1(x.feats, x.valid)))
        return self.conv(x)


class LevelOut(NamedTuple):
    """Per-pyramid-level head outputs (fixed capacity; batched [B, N, ...]
    out of ``FCAF3DDetector``, one scene [N, ...] inside)."""
    centerness: torch.Tensor
    bbox_pred: torch.Tensor
    cls_scores: torch.Tensor
    points: torch.Tensor
    valid: torch.Tensor


class FCAF3DHeadNet(nn.Module):
    """Neck + shared head: top-down generative upsampling with score-based
    pruning, per-level out block, shared 1x1 centerness/reg/cls convs with
    a per-level learnable reg scale."""

    def __init__(self, n_classes: int,
                 in_channels: Tuple[int, ...] = (64, 128, 256, 512),
                 out_channels: int = 128, n_reg_outs: int = 6,
                 voxel_size: float = 0.01, pts_threshold: int = 200000,
                 capacities: DetectionCapacities = DetectionCapacities()):
        super().__init__()
        self.n_levels = len(in_channels)
        self.voxel_size = voxel_size
        self.pts_threshold = pts_threshold
        self.capacities = capacities
        c = out_channels
        self.centerness_conv = _kernel(1, c, 1)
        self.reg_conv = _kernel(1, c, n_reg_outs)
        self.cls_conv = _kernel(1, c, n_classes)
        self.cls_bias = nn.Parameter(
            torch.full((n_classes,), -math.log((1 - 0.01) / 0.01)))
        for i in range(self.n_levels):
            self.register_parameter(f"scale_{i}", nn.Parameter(torch.ones(())))
            self.add_module(f"out_block_{i}", SparseConv(
                in_channels[i], c, 3, 1, None, "BN", F.elu))
            if i < self.n_levels - 1:
                self.add_module(f"up_block_{i + 1}", SparseUpBlock(
                    in_channels[i + 1], in_channels[i]))

    def forward(self, inputs: List[sp.SparseTensor]) -> List[LevelOut]:
        offsets27 = sp.kernel_offsets(3)
        outs: List[LevelOut] = [None] * self.n_levels
        x = inputs[-1]
        kmap27 = sp.kernel_map(x, offsets27)
        prune_scores = None
        for i in range(self.n_levels - 1, -1, -1):
            if i < self.n_levels - 1:
                parent = x
                x = getattr(self, f"up_block_{i + 1}")(x)
                x = sp.add_skip_into_children(x, inputs[i], parent.keys)
                scores = sp.interpolate_children_scores(
                    prune_scores, kmap27, parent.valid)
                keep = (min(self.capacities.neck[i], self.pts_threshold)
                        if self.pts_threshold > 0 else self.capacities.neck[i])
                x = sp.prune_topk(x, scores, keep)
                kmap27 = sp.kernel_map(x, offsets27)
            out = getattr(self, f"out_block_{i}")(x, kmap=kmap27)
            outs[i], prune_scores = self._forward_single(out, i)
        return outs

    def _forward_single(self, st: sp.SparseTensor, level: int
                        ) -> Tuple[LevelOut, torch.Tensor]:
        feats = st.feats.float()
        centerness = (feats @ self.centerness_conv[0])[:, 0]
        cls_scores = feats @ self.cls_conv[0] + self.cls_bias
        reg = feats @ self.reg_conv[0]
        reg_dist = torch.exp(reg[:, :6] * getattr(self, f"scale_{level}"))
        bbox_pred = torch.cat([reg_dist, reg[:, 6:]], dim=-1)
        points = st.coords.float() * self.voxel_size
        return (LevelOut(centerness, bbox_pred, cls_scores, points, st.valid),
                cls_scores.detach().max(dim=-1).values)


def decode_bbox(points: torch.Tensor, bbox_pred: torch.Tensor,
                yaw_parametrization: str = "fcaf3d") -> torch.Tensor:
    """Face distances -> boxes [..., 6] (no yaw) or [..., 7] (reference
    ``_bbox_pred_to_bbox``), with the JAX package's guard for the
    degenerate (sin, cos) == (0, 0) rows kept exactly as written."""
    x = points[..., 0] + (bbox_pred[..., 1] - bbox_pred[..., 0]) / 2
    y = points[..., 1] + (bbox_pred[..., 3] - bbox_pred[..., 2]) / 2
    z = points[..., 2] + (bbox_pred[..., 5] - bbox_pred[..., 4]) / 2
    dx = bbox_pred[..., 0] + bbox_pred[..., 1]
    dy = bbox_pred[..., 2] + bbox_pred[..., 3]
    dz = bbox_pred[..., 4] + bbox_pred[..., 5]
    if bbox_pred.shape[-1] == 6:
        return torch.stack([x, y, z, dx, dy, dz], dim=-1)
    if yaw_parametrization == "naive":
        return torch.stack([x, y, z, dx, dy, dz, bbox_pred[..., 6]], dim=-1)
    s6, c7 = bbox_pred[..., 6], bbox_pred[..., 7]
    sq = s6 ** 2 + c7 ** 2
    degenerate = sq == 0.0
    sq_safe = torch.where(degenerate, 1.0, sq)
    c7_safe = torch.where(degenerate, 1.0, c7)
    if yaw_parametrization == "sin-cos":
        norm = torch.clamp(torch.where(degenerate, 1.0, torch.sqrt(sq_safe)),
                           min=1e-12)
        return torch.stack([x, y, z, dx, dy, dz,
                            torch.atan2(s6 / norm, c7_safe / norm)], dim=-1)
    scale = (bbox_pred[..., 0] + bbox_pred[..., 1]
             + bbox_pred[..., 2] + bbox_pred[..., 3])
    q = torch.exp(torch.where(degenerate, 0.0, torch.sqrt(sq_safe)))
    alpha = 0.5 * torch.atan2(s6, c7_safe)
    return torch.stack([x, y, z, scale / (1 + q), scale / (1 + q) * q,
                        bbox_pred[..., 5] + bbox_pred[..., 4], alpha], dim=-1)


class FCAF3DDetector(nn.Module):
    """Backbone + head: the forward, ``loss`` and ``get_bboxes``."""

    def __init__(self, in_channels: int = 32, n_classes: int = 18,
                 n_reg_outs: int = 6, voxel_size: float = 0.01,
                 depth: int = 34, pts_threshold: int = 200000,
                 assigner_limit: int = 27, assigner_topk: int = 18,
                 yaw_parametrization: str = "fcaf3d", nms_pre: int = 1000,
                 capacities: DetectionCapacities = DetectionCapacities(),
                 compute_dtype: Any = torch.float32):
        super().__init__()
        self.n_classes = n_classes
        self.assigner_limit = assigner_limit
        self.assigner_topk = assigner_topk
        self.voxel_size = voxel_size
        self.yaw_parametrization = yaw_parametrization
        self.nms_pre = nms_pre
        self.capacities = capacities
        self.compute_dtype = compute_dtype
        self.backbone = FCAF3DBackboneNet(in_channels, depth=depth,
                                          capacities=capacities)
        self.head = FCAF3DHeadNet(n_classes, n_reg_outs=n_reg_outs,
                                  voxel_size=voxel_size,
                                  pts_threshold=pts_threshold,
                                  capacities=capacities)

    def forward(self, points: torch.Tensor, feats: torch.Tensor,
                point_valid: torch.Tensor) -> List[LevelOut]:
        """points [B, P, 3] metric, feats [B, P, C], valid [B, P] ->
        per-level outputs stacked over scenes."""
        if self.training and points.shape[0] != 1:
            raise ValueError(f"a training batch holds one scene here (the "
                             f"sparse batch norms' statistics are the "
                             f"scene's), got {points.shape[0]}")
        scenes = []
        for b in range(points.shape[0]):
            st = sp.voxelize_points(points[b],
                                    feats[b].to(self.compute_dtype),
                                    point_valid[b], self.voxel_size,
                                    self.capacities.voxelize)
            scenes.append(self.head(self.backbone(st)))
        return [LevelOut(*(torch.stack(f) for f in zip(*level)))
                for level in zip(*scenes)]

    def loss(self, level_outs: List[LevelOut], gt_boxes: torch.Tensor,
             gt_labels: torch.Tensor, gt_valid: torch.Tensor
             ) -> Dict[str, torch.Tensor]:
        """``loss_centerness``, ``loss_bbox``, ``loss_cls`` (reference
        ``FCAF3DHead._loss``, JAX ``FCAF3DDetector.loss``): every level's
        rows concatenated, assigned per scene; focal and centerness losses
        over the positive count and the IoU loss over the summed
        centerness targets, each averaged over the scenes and clamped at 1
        and 1e-6; axis-aligned boxes (the yaw loss comes with the ARKit
        path, ROADMAP queue 1, item 9).  gt_boxes [B, M, 7] gravity-center
        z, gt_labels and gt_valid [B, M]."""
        def cat(xs):
            return torch.cat(xs, dim=1)
        centerness = cat([o.centerness for o in level_outs])
        bbox_pred = cat([o.bbox_pred for o in level_outs])
        cls_scores = cat([o.cls_scores for o in level_outs])
        points = cat([o.points for o in level_outs])
        valid = cat([o.valid for o in level_outs])
        scale_ids = cat([torch.full(o.valid.shape, i, dtype=torch.int64,
                                    device=o.valid.device)
                         for i, o in enumerate(level_outs)])
        assign = [fcaf3d_assign(points[b], scale_ids[b], valid[b],
                                gt_boxes[b], gt_labels[b], gt_valid[b],
                                n_scales=len(level_outs),
                                limit=self.assigner_limit,
                                topk=self.assigner_topk)
                  for b in range(points.shape[0])]
        labels = torch.stack([a.labels for a in assign])
        ctr_t = torch.stack([a.centerness_targets for a in assign])
        box_t = torch.stack([a.bbox_targets for a in assign])

        pos = (labels >= 0) & valid
        n_pos = torch.clamp(pos.float().sum(dim=1).mean(), min=1.0)
        denorm = torch.clamp(torch.where(pos, ctr_t, 0.0).sum(dim=1).mean(),
                             min=1e-6)
        b = centerness.shape[0]
        loss_cls = sigmoid_focal_loss(
            cls_scores.reshape(-1, self.n_classes), labels.reshape(-1),
            valid.reshape(-1), avg_factor=n_pos * b)
        loss_ctr = bce_loss(centerness.reshape(-1), ctr_t.reshape(-1),
                            pos.reshape(-1), avg_factor=n_pos * b)
        preds = decode_bbox(points, bbox_pred, self.yaw_parametrization)
        loss_bbox = iou3d_loss(
            preds[..., :6].reshape(-1, 6), box_t[..., :6].reshape(-1, 6),
            weight=ctr_t.reshape(-1), valid=pos.reshape(-1),
            avg_factor=denorm * b, with_yaw=False)
        return {"loss_centerness": loss_ctr, "loss_bbox": loss_bbox,
                "loss_cls": loss_cls}

    def get_bboxes(self, level_outs: List[LevelOut]
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Per level the top ``nms_pre`` rows by max score (ties to the
        lower row), decoded and concatenated: (bboxes [B, K, 6|7], scores
        [B, K, n_classes], valid [B, K])."""
        all_b, all_s, all_v = [], [], []
        for o in level_outs:
            scores = (torch.sigmoid(o.cls_scores)
                      * torch.sigmoid(o.centerness)[..., None])
            max_scores = torch.where(o.valid, scores.max(dim=-1).values,
                                     -math.inf)
            k = min(self.nms_pre, o.valid.shape[1])
            idx = torch.sort(max_scores, dim=1, descending=True,
                             stable=True)[1][:, :k]

            def take(a):
                return torch.gather(a, 1, idx[..., None].expand(
                    -1, -1, a.shape[-1]) if a.dim() == 3 else idx)
            all_b.append(decode_bbox(take(o.points), take(o.bbox_pred),
                                     self.yaw_parametrization))
            all_s.append(take(scores))
            all_v.append(take(o.valid))
        return (torch.cat(all_b, dim=1), torch.cat(all_s, dim=1),
                torch.cat(all_v, dim=1))

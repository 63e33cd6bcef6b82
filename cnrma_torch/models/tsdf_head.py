"""Multi-scale TSDF regression head and its losses.

Port of ``cnrma_tpu/models/tsdf_head.py`` (reference ``AtlasTSDFHead``):
per scale a 1x1x1 decoder in fp32, ``tanh * 1.05``; coarse to fine,
voxels whose nearest-upsampled coarser TSDF is not near the surface
(``|prev| >= 0.99``) are clamped to ``sign(prev) * 0.999``.
``tsdf_losses`` is the log-transformed masked L1 per scale.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
from torch import nn

from cnrma_torch.models.layers import Conv, upsample_nearest
from cnrma_torch.ops.losses import log_transform

LABEL_SMOOTHING = 1.05
SPARSE_THRESHOLD = 0.99


def tsdf_losses(output: Dict[str, torch.Tensor],
                targets: Dict[str, torch.Tensor], keys: Sequence[str],
                sparse_threshold: float = SPARSE_THRESHOLD
                ) -> Dict[str, torch.Tensor]:
    """``tsdf_loss_<key>`` per scale (reference ``atlas_head.py:56-80``):
    the mean of ``|log_transform(pred) - log_transform(gt)|`` over the
    voxels that are observed (``gt < 1``) or lie in a column that is
    free all along z; at the finer scales only where the coarser
    prediction, nearest-upsampled, is near the surface (``< 0.99``), the
    mask the head's sparsification used.  [B, X, Y, Z] tensors."""
    losses: Dict[str, torch.Tensor] = {}
    for i, key in enumerate(keys):
        pred = output[f"scene_tsdf_{key}"]
        trgt = targets[f"tsdf_gt_{key}"]
        mask = (trgt < 1) | (trgt == 1).all(dim=-1, keepdim=True)
        l1 = torch.abs(log_transform(pred) - log_transform(trgt))
        if i > 0:
            prev = output[f"scene_tsdf_{keys[i - 1]}"]
            prev_up = upsample_nearest(prev[:, None], 2)[:, 0]
            mask = mask & (prev_up.abs() < sparse_threshold)
        denom = torch.clamp(mask.float().sum(), min=1.0)
        losses[f"tsdf_loss_{key}"] = torch.where(mask, l1, 0.0).sum() / denom
    return losses


class TSDFHead(nn.Module):
    """Inputs: coarse-to-fine feature volumes [B, X_i, Y_i, Z_i, C_i];
    output: {"scene_tsdf_<key>": [B, X_i, Y_i, Z_i]} with keys such as
    ('016', '008', '004')."""

    def __init__(self, input_channels: Sequence[int] = (32, 64, 128),
                 n_scales: int = 3, voxel_size: float = 0.04):
        super().__init__()
        self.n_scales = n_scales
        self.voxel_size = voxel_size
        for i, c in enumerate(tuple(input_channels)[::-1][:n_scales]):
            self.add_module(f"decoder{i}", Conv(c, 1, 1, ndim=3))

    @property
    def keys(self) -> Tuple[str, ...]:
        sizes = [self.voxel_size * (2 ** i)
                 for i in range(self.n_scales)][::-1]
        return tuple(str(int(round(v * 100))).zfill(3) for v in sizes)

    def forward(self, xs: Sequence[torch.Tensor]) -> Dict[str, torch.Tensor]:
        keys = self.keys
        output: Dict[str, torch.Tensor] = {}
        for i, x in enumerate(xs):
            xf = x.permute(0, 4, 1, 2, 3).float()
            tsdf = torch.tanh(getattr(self, f"decoder{i}")(xf)[:, 0]) \
                * LABEL_SMOOTHING
            if i > 0:
                prev = output[f"scene_tsdf_{keys[i - 1]}"]
                prev_up = upsample_nearest(prev[:, None], 2)[:, 0]
                near = prev_up.abs() < SPARSE_THRESHOLD
                tsdf = torch.where(near, tsdf, torch.sign(prev_up) * 0.999)
            output[f"scene_tsdf_{keys[i]}"] = tsdf
        return output

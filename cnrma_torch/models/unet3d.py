"""Dense 3D U-Net over the accumulated feature volume.

Port of ``cnrma_tpu/models/unet3d.py`` (reference ``AtlasBackbone3D``):
channels (32, 64, 128, 256), layers down (1, 2, 3, 4), layers up (3, 2, 1),
3x3x3 residual blocks whose second BN scale starts at zero, trilinear x2
decoder upsampling and a projected skip merged as ``(x + y) / 2``; outputs
coarse to fine (1/4, 1/2, 1/1).  The volume stays in ``channels_last_3d``
memory, so the [B, X, Y, Z, C] tensors at the public boundary are views of
the same bytes.  Remat has no counterpart in the test-mode forward.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from cnrma_torch.models.layers import BatchNorm, Conv, ConvBN, upsample_linear

relu = F.relu
LAYERS_DOWN = (1, 2, 3, 4)      # residual blocks per encoder level
LAYERS_UP = (3, 2, 1)           # residual blocks per decoder level


class BatchNormZero(BatchNorm):
    """BatchNorm whose scale initializes to zero (the block starts as the
    identity, reference ``zero_init_residual``)."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__(channels, eps)
        nn.init.zeros_(self.weight)


class BasicBlock3dZeroInit(nn.Module):
    """3x3x3 conv-BN-relu, 3x3x3 conv-BN, residual add, relu."""

    def __init__(self, features: int):
        super().__init__()
        self.conv1 = ConvBN(features, features, 3, 1, ndim=3, act=relu)
        self.conv2 = Conv(features, features, 3, 1, ndim=3)
        self.bn2 = BatchNormZero(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return relu(x + self.bn2(self.conv2(self.conv1(x))))


class UNet3D(nn.Module):
    """Encoder-decoder over [B, X, Y, Z, C]; returns the coarse-to-fine
    tuple [1/4 @ ch[2], 1/2 @ ch[1], 1/1 @ ch[0]] in the same layout."""

    def __init__(self, channels: Sequence[int] = (32, 64, 128, 256)):
        super().__init__()
        self.channels = tuple(channels)
        ch = self.channels
        for i in range(len(ch)):
            if i > 0:
                self.add_module(f"down{i}_stride", ConvBN(
                    ch[i - 1], ch[i], 3, 2, ndim=3, act=relu))
            for b in range(LAYERS_DOWN[i]):
                self.add_module(f"down{i}_block{b}",
                                BasicBlock3dZeroInit(ch[i]))
        rev = ch[::-1]
        for i in range(1, len(rev)):
            self.add_module(f"up{i}_conv", Conv(rev[i - 1], rev[i], 1, ndim=3))
            self.add_module(f"up{i}_proj", Conv(rev[i], rev[i], 1, ndim=3))
            self.add_module(f"up{i}_proj_norm", BatchNorm(rev[i]))
            for b in range(LAYERS_UP[i - 1]):
                self.add_module(f"up{i}_block{b}",
                                BasicBlock3dZeroInit(rev[i]))

    def forward(self, volume: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        x = volume.permute(0, 4, 1, 2, 3).contiguous(
            memory_format=torch.channels_last_3d)
        skips = []
        for i in range(len(self.channels)):
            if i > 0:
                x = getattr(self, f"down{i}_stride")(x)
            for b in range(LAYERS_DOWN[i]):
                x = getattr(self, f"down{i}_block{b}")(x)
            skips.append(x)
        outs = []
        n = len(self.channels)
        for i in range(1, n):
            x = getattr(self, f"up{i}_conv")(upsample_linear(x, 2))
            y = getattr(self, f"up{i}_proj")(skips[n - 1 - i])
            y = relu(getattr(self, f"up{i}_proj_norm")(y))
            x = (x + y) / 2
            for b in range(LAYERS_UP[i - 1]):
                x = getattr(self, f"up{i}_block{b}")(x)
            outs.append(x.permute(0, 2, 3, 4, 1))
        return tuple(outs)

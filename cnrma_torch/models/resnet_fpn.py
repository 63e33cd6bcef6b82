"""2D feature tower: Detectron-style ResNet-50 + FPN + pyramid fuse.

Port of ``cnrma_tpu/models/resnet_fpn.py``: R-50 in the caffe2 layout
(stride in the first 1x1 of a bottleneck), stem 7x7/2 + max-pool 3x3/2, FPN
with 1x1 laterals, nearest top-down and BN 3x3 outputs, p6 a 1x1/2
max-pool of p5, and the pyramid fuse that sums p2..p5 into one stride-4,
32-channel map.  The convolutions are ``torch.nn.functional`` convs
(cuDNN on the card), as the JAX package left them to XLA.  Activations are
kept in ``channels_last`` memory, so the public [V, H, W, C] layout is a
free view.  ``freeze_at=2`` (detectron's ``freeze()``): the stem and res2
keep FrozenBN, running statistics in training too; that their parameters
get no update is the optimizer's mask (``train/optim.py``).
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from cnrma_torch.models.layers import (
    ConvBN, upsample_linear, upsample_nearest)

relu = F.relu


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 -> 1x1 with the stride in the first 1x1 (caffe2)."""

    def __init__(self, in_channels: int, bottleneck: int, features: int,
                 stride: int = 1, frozen: bool = False):
        super().__init__()
        self.shortcut = (ConvBN(in_channels, features, 1, stride,
                                frozen=frozen)
                         if in_channels != features or stride != 1 else None)
        self.conv1 = ConvBN(in_channels, bottleneck, 1, stride, act=relu,
                            frozen=frozen)
        self.conv2 = ConvBN(bottleneck, bottleneck, 3, 1, act=relu,
                            frozen=frozen)
        self.conv3 = ConvBN(bottleneck, features, 1, 1, frozen=frozen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x if self.shortcut is None else self.shortcut(x)
        y = self.conv3(self.conv2(self.conv1(x)))
        return relu(y + shortcut)


class ResNet50(nn.Module):
    """R-50 trunk returning {res2..res5} (strides 4/8/16/32); the stem and
    the stages below ``freeze_at`` keep FrozenBN."""

    num_blocks = (3, 4, 6, 3)

    def __init__(self, freeze_at: int = 2):
        super().__init__()
        self.stem = ConvBN(3, 64, 7, 2, act=relu, frozen=freeze_at >= 1)
        cin, out_ch, bottleneck = 64, 256, 64
        for s in range(4):
            for b in range(self.num_blocks[s]):
                stride = (1 if s == 0 else 2) if b == 0 else 1
                self.add_module(f"res{s + 2}_block{b}", BottleneckBlock(
                    cin, bottleneck, out_ch, stride,
                    frozen=freeze_at >= s + 2))
                cin = out_ch
            out_ch *= 2
            bottleneck *= 2

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = self.stem(x)
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        outs = {}
        for s in range(4):
            for b in range(self.num_blocks[s]):
                x = getattr(self, f"res{s + 2}_block{b}")(x)
            outs[f"res{s + 2}"] = x
        return outs


class FPN(nn.Module):
    """FPN over res2..res5 -> p2..p6 (sum fuse, BN, no conv bias)."""

    def __init__(self, in_channels: Sequence[int] = (256, 512, 1024, 2048),
                 out_channels: int = 256):
        super().__init__()
        for i, c in enumerate(in_channels):
            self.add_module(f"lateral{i + 2}", ConvBN(c, out_channels, 1))
            self.add_module(f"output{i + 2}",
                            ConvBN(out_channels, out_channels, 3))

    def forward(self, feats: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        lat = [getattr(self, f"lateral{i + 2}")(feats[f"res{i + 2}"])
               for i in range(4)]
        merged = [None, None, None, lat[3]]
        for i in (2, 1, 0):
            merged[i] = lat[i] + upsample_nearest(merged[i + 1], 2)
        outs = {f"p{i + 2}": getattr(self, f"output{i + 2}")(merged[i])
                for i in range(4)}
        outs["p6"] = outs["p5"][:, :, ::2, ::2]   # 1x1 max-pool, stride 2
        return outs


class PyramidFuse(nn.Module):
    """p2..p5 -> one stride-4 map: per level conv3x3+BN+ReLU steps with a
    bilinear x2 after each (none for p2), summed (AtlasFPNFeature)."""

    def __init__(self, in_channels: int = 256, output_dim: int = 32):
        super().__init__()
        for i in range(4):
            for k in range(max(1, i)):
                self.add_module(f"p{i + 2}_head{k}", ConvBN(
                    in_channels if k == 0 else output_dim, output_dim, 3,
                    act=relu))

    def forward(self, pyramid: Dict[str, torch.Tensor]) -> torch.Tensor:
        out = None
        for i in range(4):
            x = pyramid[f"p{i + 2}"]
            for k in range(max(1, i)):
                x = getattr(self, f"p{i + 2}_head{k}")(x)
                if i > 0:
                    x = upsample_linear(x, 2)
            out = x if out is None else out + x
        return out


class ResNetFPN2D(nn.Module):
    """Full 2D tower: images [V, H, W, 3] -> stride-4 features
    [V, H/4, W/4, output_dim] in ``compute_dtype``."""

    def __init__(self, output_dim: int = 32, fpn_channels: int = 256,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.resnet = ResNet50()
        self.fpn = FPN(out_channels=fpn_channels)
        self.fuse = PyramidFuse(fpn_channels, output_dim)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = images.permute(0, 3, 1, 2).to(self.compute_dtype)
        x = x.contiguous(memory_format=torch.channels_last)
        fused = self.fuse(self.fpn(self.resnet(x)))
        return fused.permute(0, 2, 3, 1)

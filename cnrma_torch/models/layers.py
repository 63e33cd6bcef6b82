"""Shared layers: convs that run in their input's dtype, eval-mode batch
norms (dense, masked-sparse) and instance norm, resampling.

Port of ``cnrma_tpu/models/layers.py``.  Dense tensors here are torch's
channels-first [N, C, *spatial] (kept in ``channels_last`` memory by the
callers, so the same bytes are the JAX package's [N, *spatial, C]); sparse
features are [N, C] rows.  Parameters stay fp32 and are cast to the
activation dtype at each conv, as the flax modules do with
``dtype=compute_dtype``.

Only the test-mode forward is ported: the norms use running statistics
(which is also what detectron's FrozenBatchNorm does in every mode), and
they refuse to run in training mode.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn


def _eval_only(module: nn.Module) -> None:
    if module.training:
        raise RuntimeError(f"{type(module).__name__}: only the test-mode "
                           "forward is ported; call .eval()")


class BatchNorm(nn.Module):
    """BatchNorm over channel dim 1 with running statistics, torch
    semantics: ``(x - mean) * (rsqrt(var + eps) * weight) + bias`` in fp32,
    cast back to the input dtype."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _eval_only(self)
        shape = (1, -1) + (1,) * (x.dim() - 2)
        inv = torch.rsqrt(self.running_var + self.eps) * self.weight
        y = ((x.float() - self.running_mean.view(shape)) * inv.view(shape)
             + self.bias.view(shape))
        return y.to(x.dtype)


class MaskedBatchNorm(BatchNorm):
    """BatchNorm of sparse rows [N, C]; invalid rows (``mask`` False) come
    out as 0 (ME ``MinkowskiBatchNorm`` over the active voxels)."""

    def forward(self, feats: torch.Tensor, mask: torch.Tensor
                ) -> torch.Tensor:
        _eval_only(self)
        inv = torch.rsqrt(self.running_var + self.eps) * self.weight
        y = (feats.float() - self.running_mean) * inv + self.bias
        return torch.where(mask[:, None], y, 0.0).to(feats.dtype)


class MaskedInstanceNorm(nn.Module):
    """Instance norm of one scene's sparse rows [N, C] over its valid rows
    (ME ``MinkowskiInstanceNorm``); invalid rows come out as 0."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, feats: torch.Tensor, mask: torch.Tensor
                ) -> torch.Tensor:
        m = mask.float()[:, None]
        n = torch.clamp(m.sum(), min=1.0)
        xf = feats.float() * m
        mean = xf.sum(dim=0, keepdim=True) / n
        var = (xf * xf).sum(dim=0, keepdim=True) / n - mean * mean
        inv = torch.rsqrt(torch.clamp(var, min=0.0) + self.eps)
        y = (feats.float() - mean) * inv * self.weight + self.bias
        return torch.where(mask[:, None], y, 0.0).to(feats.dtype)


class Conv(nn.Module):
    """Bias-free 2D or 3D convolution with torch's symmetric
    ``kernel_size // 2`` padding, run in the input's dtype (fp32 parameters
    are cast)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, ndim: int = 2):
        super().__init__()
        self.stride = stride
        self.padding = kernel_size // 2
        self.conv = F.conv2d if ndim == 2 else F.conv3d
        self.weight = nn.Parameter(torch.empty(
            (out_channels, in_channels) + (kernel_size,) * ndim))
        nn.init.kaiming_uniform_(self.weight, a=5 ** 0.5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x, self.weight.to(x.dtype), None, self.stride,
                         self.padding)


class ConvBN(nn.Module):
    """Conv + BatchNorm + optional activation (``ConvBN``); FrozenBN and BN
    are the same module in the test-mode forward."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, ndim: int = 2,
                 act: Optional[Callable[[torch.Tensor], torch.Tensor]] = None):
        super().__init__()
        self.conv = Conv(in_channels, out_channels, kernel_size, stride, ndim)
        self.norm = BatchNorm(out_channels)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.norm(self.conv(x))
        return x if self.act is None else self.act(x)


def upsample_nearest(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Nearest x``factor`` upsample of every spatial axis of [N, C, ...]."""
    return F.interpolate(x, scale_factor=factor, mode="nearest")


def upsample_linear(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Bi/tri-linear x``factor`` upsample with half-pixel centres and
    clamped edges (align_corners=False) over every spatial axis of
    [N, C, ...]: the JAX package's shifted-add x2 kernel, up to fp32
    rounding (a test shows it)."""
    mode = "bilinear" if x.dim() == 4 else "trilinear"
    return F.interpolate(x, scale_factor=factor, mode=mode,
                         align_corners=False)

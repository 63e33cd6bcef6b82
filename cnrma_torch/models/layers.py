"""Shared layers: convs that run in their input's dtype, batch norms
(dense, masked-sparse, frozen) and instance norm, resampling, and the
activation checkpointing the 3D U-Net trains under.

Port of ``cnrma_tpu/models/layers.py``.  Dense tensors here are torch's
channels-first [N, C, *spatial] (kept in ``channels_last`` memory by the
callers, so the same bytes are the JAX package's [N, *spatial, C]); sparse
features are [N, C] rows.  Parameters stay fp32 and are cast to the
activation dtype at each conv, as the flax modules do with
``dtype=compute_dtype``.

The norms follow flax's ``BatchNorm`` as the JAX package uses it.  In
training mode (``module.train()``) they normalize with the batch's
statistics over every axis but the channel, in fp32: the mean and the
biased variance ``E[x^2] - E[x]^2`` (clamped at 0 in the masked form), and
update the running statistics once a forward as ``0.9 * old + 0.1 *
batch`` with that biased variance.  In eval mode, and always when
``frozen`` (detectron's FrozenBatchNorm), they use the running statistics.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

_recompute_depth = 0


@contextlib.contextmanager
def _recomputing():
    global _recompute_depth
    _recompute_depth += 1
    try:
        yield
    finally:
        _recompute_depth -= 1


def checkpoint(fn: Callable, *args):
    """``fn(*args)`` under activation checkpointing (``torch.utils.
    checkpoint``, non-reentrant; the JAX package's ``nn.remat``): the
    activations inside are recomputed in the backward.  The batch norms of
    the recompute normalize with the batch statistics again but leave the
    running statistics alone, so these update once a step."""
    return torch.utils.checkpoint.checkpoint(
        fn, *args, use_reentrant=False,
        context_fn=lambda: (contextlib.nullcontext(), _recomputing()))


class BatchNorm(nn.Module):
    """BatchNorm over channel dim 1, flax semantics (module docstring):
    ``(x - mean) * (rsqrt(var + eps) * weight) + bias`` in fp32, cast back
    to the input dtype.  The subtraction comes first: activations whose
    mean is far above their spread (the frozen stem's) would lose their
    low bits in ``x * s + (bias - mean * s)``."""

    momentum = 0.9

    def __init__(self, channels: int, eps: float = 1e-5,
                 frozen: bool = False):
        super().__init__()
        self.eps = eps
        self.frozen = frozen
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def _update(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        """Running statistics from one batch's, unless this forward is a
        checkpointed block's recompute."""
        if _recompute_depth:
            return
        with torch.no_grad():
            m = self.momentum
            self.running_mean.copy_(m * self.running_mean
                                    + (1 - m) * mean.detach())
            self.running_var.copy_(m * self.running_var
                                   + (1 - m) * var.detach())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1) + (1,) * (x.dim() - 2)
        if self.training and not self.frozen:
            axes = [0, *range(2, x.dim())]
            xf = x.float()
            mean = xf.mean(dim=axes)
            var = (xf * xf).mean(dim=axes) - mean * mean
            self._update(mean, var)
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.rsqrt(var + self.eps) * self.weight
        y = ((x.float() - mean.view(shape)) * inv.view(shape)
             + self.bias.view(shape))
        return y.to(x.dtype)


class MaskedBatchNorm(BatchNorm):
    """BatchNorm of sparse rows [N, C] over the valid rows (``mask``;
    ME ``MinkowskiBatchNorm`` over the active voxels); invalid rows come
    out as 0."""

    def forward(self, feats: torch.Tensor, mask: torch.Tensor
                ) -> torch.Tensor:
        if self.training:
            m = mask.float()[:, None]
            n = torch.clamp(m.sum(), min=1.0)
            xf = feats.float() * m
            mean = xf.sum(dim=0) / n
            var = torch.clamp((xf * xf).sum(dim=0) / n - mean * mean,
                              min=0.0)
            self._update(mean, var)
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.rsqrt(var + self.eps) * self.weight
        y = (feats.float() - mean) * inv + self.bias
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
    """Conv + BatchNorm (FrozenBN where ``frozen``) + optional activation
    (``ConvBN``)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, ndim: int = 2,
                 act: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
                 frozen: bool = False):
        super().__init__()
        self.conv = Conv(in_channels, out_channels, kernel_size, stride, ndim)
        self.norm = BatchNorm(out_channels, frozen=frozen)
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

"""One scene split across the ranks of a view group: the contexts the
layers read and the collectives with their gradients.

Port of ``cnrma_tpu/utils/shard_ctx.py``.  The view-sharded training step
(``CNRMA.forward_view_sharded``) gives each rank of a view group V/n of a
scene's views for the 2D tower and the volume, and an X-slab of the
volume for the 3D U-Net and the TSDF head.  Two contexts let the layers
take part without a change of their parameters or buffers (checkpoints
stay compatible):

* ``bn_sync_group(group)``: a ``BatchNorm`` in training takes the mean
  over the group of each rank's (mean, mean of squares), which with equal
  shards is the statistics of the whole batch (``sync_batch_stats``);
* ``halo_group(group)``: a 3x3x3 convolution pads its slab along X with
  one slice from each neighbour (zeros at the global edge, torch's zero
  padding) and runs with no X padding; the x2 linear upsample takes
  clamped halos.

Both are read when a layer runs.  A block under activation checkpointing
runs again in the backward, outside the ``with``: ``snapshot`` and
``restored`` carry the contexts of its forward into that recompute
(``models/layers.py:checkpoint``).

Gradients.  Each rank runs the backward of its own copy of the loss, so
every collective below has a backward that makes the ranks' gradients
add up to the true one:

* ``sync_batch_stats``: the rank's statistics reach every rank's output,
  so the backward all-reduces the cotangents too (their mean);
* ``halo_pad``: each halo's cotangent goes back to the rank it came from;
* ``gather_replicated``: a value gathered and then consumed identically
  on every rank (the TSDFs, the feature maps of the detector's points)
  has the same, true, cotangent on every rank, and the backward keeps
  the rank's own slice of it.  Summing the n copies (what the collective's
  plain transpose does) would count the replicated consumer n times; JAX
  undoes that with ``scale_grad(1/n)``;
* a sum over the group consumed as each rank's own part of it (the
  volume's, each rank's slab: ``ops/backproject.py:PartialVolume``): the
  true cotangent is the sum of the ranks' cotangents.

The sharded modules' gradients then come back as partials to be summed
over the view group, and the replicated detector's as full gradients on
every rank (``train/loop.py:mean_over_ranks``).

Collectives are ``all_reduce`` and ``all_gather``.  Gloo takes CUDA
tensors in ``all_reduce`` only, so where it is the backend of a group of
CUDA tensors (two ranks sharing one card), a gather goes through host
memory.  A failed collective raises; nothing runs on one rank quietly.
"""

from __future__ import annotations

import contextlib
from contextvars import ContextVar
from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist

_BN_SYNC: ContextVar[Optional[Any]] = ContextVar("cnrma_torch_bn_sync",
                                                 default=None)
_HALO: ContextVar[Optional[Any]] = ContextVar("cnrma_torch_halo",
                                              default=None)


@contextlib.contextmanager
def bn_sync_group(group):
    """Batch norms in training take the group's statistics."""
    tok = _BN_SYNC.set(group)
    try:
        yield
    finally:
        _BN_SYNC.reset(tok)


@contextlib.contextmanager
def halo_group(group):
    """Dense 3D layers run on X-slabs with halos from the group."""
    tok = _HALO.set(group)
    try:
        yield
    finally:
        _HALO.reset(tok)


def current_bn_sync_group():
    return _BN_SYNC.get()


def current_halo_group():
    return _HALO.get()


def snapshot() -> Tuple[Any, Any]:
    """The contexts in force, for ``restored``."""
    return _BN_SYNC.get(), _HALO.get()


@contextlib.contextmanager
def restored(snap: Tuple[Any, Any]):
    """The contexts of ``snapshot`` again (a checkpointed block's
    recompute)."""
    with bn_sync_group(snap[0]), halo_group(snap[1]):
        yield


# --- collectives ------------------------------------------------------------

def _gloo_cuda(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over the group, in place."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def gather_stack(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``t`` (one shape on all ranks), stacked in rank order:
    [n, *t.shape]."""
    t = t.contiguous()
    host = _gloo_cuda(t, group)
    src = t.cpu() if host else t
    out = torch.empty((dist.get_world_size(group),) + tuple(t.shape),
                      dtype=t.dtype, device=src.device)
    dist.all_gather(list(out.unbind(0)), src, group=group)
    return out.to(t.device) if host else out


def gather_cat(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim`` in rank order; no
    gradient."""
    parts = gather_stack(t, group)
    return torch.cat(list(parts.unbind(0)), dim=dim)


class _SyncMean(torch.autograd.Function):
    """The mean over the group; its backward is the mean of the
    cotangents."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_sum(x.clone(), group) / dist.get_world_size(
            group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g.clone(), ctx.group) / dist.get_world_size(
            ctx.group), None


def sync_batch_stats(mean: torch.Tensor, meansq: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean, mean of squares) over the group of ``bn_sync_group``: the
    mean of the ranks' own, which with shards of one size is the whole
    batch's; unchanged outside the context."""
    group = current_bn_sync_group()
    if group is None:
        return mean, meansq
    both = _SyncMean.apply(torch.stack([mean, meansq]), group)
    return both[0], both[1]


class _HaloPad(torch.autograd.Function):
    """``x`` with one slice of each neighbour's on either side of ``dim``.
    Rank r's left halo is rank r-1's last slice and its right halo rank
    r+1's first; at the group's edges zeros, or with ``clamp`` the rank's
    own edge slice."""

    @staticmethod
    def forward(ctx, x, dim, group, clamp):
        n, r = dist.get_world_size(group), dist.get_rank(group)
        size = x.shape[dim]
        ctx.meta = (dim, group, clamp, size)
        first, last = x.narrow(dim, 0, 1), x.narrow(dim, size - 1, 1)
        edges = gather_stack(torch.cat([first, last], dim), group)
        left = (edges[r - 1].narrow(dim, 1, 1) if r > 0
                else first if clamp else torch.zeros_like(first))
        right = (edges[r + 1].narrow(dim, 0, 1) if r < n - 1
                 else last if clamp else torch.zeros_like(last))
        out = torch.cat([left, x, right], dim)
        if x.dim() == 5 and x.is_contiguous(
                memory_format=torch.channels_last_3d):
            out = out.contiguous(memory_format=torch.channels_last_3d)
        return out

    @staticmethod
    def backward(ctx, g):
        dim, group, clamp, size = ctx.meta
        n, r = dist.get_world_size(group), dist.get_rank(group)
        g_left, g_right = g.narrow(dim, 0, 1), g.narrow(dim, size + 1, 1)
        sent = gather_stack(torch.cat([g_left, g_right], dim), group)
        gx = g.narrow(dim, 1, size).clone()
        first, last = gx.narrow(dim, 0, 1), gx.narrow(dim, size - 1, 1)
        if r < n - 1:           # my last slice was rank r+1's left halo
            last += sent[r + 1].narrow(dim, 0, 1)
        elif clamp:
            last += g_right
        if r > 0:               # my first slice was rank r-1's right halo
            first += sent[r - 1].narrow(dim, 1, 1)
        elif clamp:
            first += g_left
        return gx, None, None, None


def halo_pad(x: torch.Tensor, dim: int, group, clamp_edges: bool = False
             ) -> torch.Tensor:
    """``x`` (a rank's slab along ``dim``) padded with one slice from each
    neighbour in the group: zeros at the global edges (a convolution's
    zero padding) or, ``clamp_edges``, the rank's own edge slice (an
    edge-clamped interpolation)."""
    return _HaloPad.apply(x, dim, group, clamp_edges)


class _GatherReplicated(torch.autograd.Function):
    """The ranks' ``x`` concatenated along ``dim``, for a consumer that
    every rank runs alike; the backward keeps the rank's own slice."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.meta = (dim, dist.get_rank(group), x.shape[dim])
        return gather_cat(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        dim, r, size = ctx.meta
        return g.narrow(dim, r * size, size).contiguous(), None, None


def gather_replicated(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The sharded -> replicated boundary: every rank's ``x`` along
    ``dim`` in rank order, consumed identically on every rank; its
    cotangent is the true one on each rank, and the rank keeps its own
    slice of it."""
    return _GatherReplicated.apply(x, dim, group)

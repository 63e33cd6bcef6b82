"""Back-projection of 2D feature maps into a 3D feature volume.

Port of ``cnrma_tpu/ops/backproject.py``, dense path (``tile=0``): every
voxel centre is projected into every view and takes the pixel feature it
lands on; the volume is the mean over the views that see the voxel, and 0
where none does.  The TPU package's frustum-tile, rect and overflow
capacities are not ported: they exist to work around the TPU's gather rate
and drop tiles when a capacity saturates.

On a CUDA tensor the accumulation is the hand-written kernel
``csrc/volume_accum.cu`` (8x8x4 voxel tiles, views culled per tile, pixel
rows read through L1/L2); on a CPU tensor it is
``volume_accum_plain``, the same function in torch.  Layout is
channels-last: features [V, H, W, C], volume [X, Y, Z, C].

The volume is differentiable in the features through ``VolumeAccum``, on
both devices: its backward (the JAX package's custom VJP
``_accum_core_bwd`` after the mean's division) is the kernel
``csrc/volume_accum_bwd.cu`` (each tile's pairs merged in shared memory
before they leave as atomics) on a CUDA tensor and
``volume_accum_bwd_plain`` on a CPU tensor.  Projections, view flags and
the origin get no gradient: camera geometry is data.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from cnrma_torch.ops import _build

VOLUME_ACCUM = _build.LaunchCounter()
VOLUME_ACCUM_BWD = _build.LaunchCounter()
MAX_VIEWS = 1024          # the kernels keep 53-69 B per view in shared memory
# K1b's voxel tile (csrc/volume_accum_bwd.cu, BwdTile): its pairs are
# merged per (tile, view, pixel) before they leave the block
K1B_TILE = (8, 8, 4)


def _grid_axes(voxel_dim: Sequence[int], voxel_size: float,
               origin: Sequence[float], device) -> Tuple[torch.Tensor, ...]:
    org = torch.as_tensor(origin, dtype=torch.float32, device=device)
    return tuple(torch.arange(n, dtype=torch.float32, device=device)
                 * voxel_size + org[i] for i, n in enumerate(voxel_dim))


def project_voxels(projection: torch.Tensor, voxel_dim: Sequence[int],
                   voxel_size: float, origin: Sequence[float], height: int,
                   width: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-voxel flat pixel index (clipped in bounds) and validity
    (``_project_indices``): ([X, Y, Z] int64, [X, Y, Z] bool).

    Operation order as in the reference: ``((P0 x + P1 y) + P2 z) + P3``,
    ``1 / pz`` then a product, and rounding half to even."""
    xs, ys, zs = _grid_axes(voxel_dim, voxel_size, origin, projection.device)
    xs, ys, zs = xs[:, None, None], ys[None, :, None], zs[None, None, :]
    cam = [((projection[r, 0] * xs + projection[r, 1] * ys)
            + projection[r, 2] * zs) + projection[r, 3] for r in range(3)]
    pz = cam[2]
    inv_z = torch.where(pz != 0, 1.0 / pz, torch.zeros_like(pz))
    px = torch.round(cam[0] * inv_z).to(torch.int32)
    py = torch.round(cam[1] * inv_z).to(torch.int32)
    valid = (px >= 0) & (py >= 0) & (px < width) & (py < height) & (pz > 0)
    flat = (py.clamp(0, height - 1).long() * width
            + px.clamp(0, width - 1).long())
    return flat, valid


def volume_accum_plain(projections: torch.Tensor, features: torch.Tensor,
                       view_valid: torch.Tensor, voxel_dim: Sequence[int],
                       voxel_size: float, origin: Sequence[float]
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain torch version of the volume kernel, on any device.

    Sums the views one by one in fp32 and returns (mean volume
    [X, Y, Z, C] in the feature dtype, view count [X, Y, Z] fp32, valid
    [X, Y, Z] bool)."""
    V, H, W, C = features.shape
    n = voxel_dim[0] * voxel_dim[1] * voxel_dim[2]
    vol = torch.zeros(n, C, dtype=torch.float32, device=features.device)
    cnt = torch.zeros(n, dtype=torch.float32, device=features.device)
    for v in range(V):
        flat, valid = project_voxels(projections[v], voxel_dim, voxel_size,
                                     origin, H, W)
        m = valid.reshape(-1) & view_valid[v]
        rows = features[v].reshape(H * W, C)[flat.reshape(-1)]
        vol += torch.where(m[:, None], rows.float(), 0.0)
        cnt += m.float()
    denom = torch.where(cnt > 0, cnt, torch.ones_like(cnt))
    mean = (vol / denom[:, None]).to(features.dtype)
    return (mean.reshape(*voxel_dim, C), cnt.reshape(*voxel_dim),
            (cnt > 0).reshape(*voxel_dim))


def _kernel_inputs(projections: torch.Tensor, view_valid: torch.Tensor,
                   rows: torch.Tensor, V: int, H: int, W: int, C: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Raise on inputs K1 and K1b do not take (``rows``: the features or
    the volume's cotangent, read as 16-byte rows of 32 channels); return
    the projections as fp32 and the view flags as bool, contiguous on the
    rows' device."""
    dev = rows.device
    if rows.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"volume kernels take fp32 or bf16, got {rows.dtype}")
    if C != 32:
        raise ValueError(f"volume kernels are built for 32 channels, got {C}")
    if V > MAX_VIEWS:
        raise ValueError(f"volume kernels take at most {MAX_VIEWS} views")
    if H * W >= 2 ** 30:
        raise ValueError(f"volume kernels take under 2**30 pixels a view, "
                         f"got {H} x {W}")
    if projections.shape != (V, 3, 4) or view_valid.shape != (V,):
        raise ValueError("projections must be [V, 3, 4] and view_valid [V]")
    if not rows.is_contiguous() or rows.data_ptr() % 16:
        raise ValueError("features and cotangents must be contiguous and "
                         "16-byte aligned")
    return (projections.to(device=dev, dtype=torch.float32).contiguous(),
            view_valid.to(device=dev, dtype=torch.bool).contiguous())


def volume_accum_cuda(projections: torch.Tensor, features: torch.Tensor,
                      view_valid: torch.Tensor, voxel_dim: Sequence[int],
                      voxel_size: float, origin: Sequence[float]
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The ``csrc/volume_accum.cu`` kernel; same contract as
    ``volume_accum_plain``.  Raises on inputs the kernel does not take."""
    V, H, W, C = features.shape
    dev = features.device
    proj, ok = _kernel_inputs(projections, view_valid, features, V, H, W, C)
    out = torch.empty(*voxel_dim, C, dtype=features.dtype, device=dev)
    cnt = torch.empty(*voxel_dim, dtype=torch.float32, device=dev)
    valid = torch.empty(*voxel_dim, dtype=torch.bool, device=dev)
    org = [float(o) for o in origin]
    _build.launch("cnrma_volume_accum", VOLUME_ACCUM, dev,
                  features.data_ptr(), proj.data_ptr(), ok.data_ptr(),
                  out.data_ptr(), cnt.data_ptr(), valid.data_ptr(), V, H, W,
                  C, *voxel_dim, float(voxel_size), *org,
                  int(features.dtype == torch.bfloat16))
    return out, cnt, valid


def volume_accum(projections: torch.Tensor, features: torch.Tensor,
                 view_valid: torch.Tensor, voxel_dim: Sequence[int],
                 voxel_size: float, origin: Sequence[float]
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(mean volume, count, valid): the CUDA kernel for CUDA features, the
    plain version for CPU features.  No gradient: see ``VolumeAccum``."""
    return _build.dispatch(features, volume_accum_cuda, volume_accum_plain,
                           projections, features, view_valid, voxel_dim,
                           voxel_size, origin)


def _sum_cotangent(g_mean: torch.Tensor, cnt: torch.Tensor) -> torch.Tensor:
    """The mean's division taken backwards: [n, C] fp32 ``g_mean / cnt``
    where ``cnt > 0``, else 0 (``_normalize_volume``)."""
    c = cnt.reshape(-1, 1)
    return torch.where(c > 0, g_mean.reshape(c.shape[0], -1).float()
                       / torch.where(c > 0, c, 1.0), 0.0)


def volume_accum_bwd_plain(projections: torch.Tensor, g_mean: torch.Tensor,
                           cnt: torch.Tensor, view_valid: torch.Tensor,
                           feat_hw: Tuple[int, int],
                           voxel_dim: Sequence[int], voxel_size: float,
                           origin: Sequence[float], dtype: torch.dtype
                           ) -> torch.Tensor:
    """Plain torch version of the volume backward, on any device: the
    features' gradient [V, H, W, C] in ``dtype`` from the mean volume's
    cotangent ``g_mean`` [X, Y, Z, C] and the view count ``cnt``
    [X, Y, Z]: per view, an fp32 ``index_add_`` of ``g_mean / cnt`` onto
    the pixel each voxel of that view reads."""
    H, W = feat_hw
    V, C = projections.shape[0], g_mean.shape[-1]
    g_sum = _sum_cotangent(g_mean, cnt)
    out = torch.zeros(V, H * W, C, dtype=torch.float32, device=g_mean.device)
    for v in range(V):
        flat, valid = project_voxels(projections[v], voxel_dim, voxel_size,
                                     origin, H, W)
        m = valid.reshape(-1) & view_valid[v]
        out[v].index_add_(0, flat.reshape(-1),
                          torch.where(m[:, None], g_sum, 0.0))
    return out.reshape(V, H, W, C).to(dtype)


def volume_accum_bwd_cuda(projections: torch.Tensor, g_mean: torch.Tensor,
                          cnt: torch.Tensor, view_valid: torch.Tensor,
                          feat_hw: Tuple[int, int],
                          voxel_dim: Sequence[int], voxel_size: float,
                          origin: Sequence[float], dtype: torch.dtype,
                          direct: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """The ``csrc/volume_accum_bwd.cu`` kernel (K1b); same contract as
    ``volume_accum_bwd_plain``.  The kernel sums in fp32 with atomics, in
    an order that changes from run to run; the result is cast to
    ``dtype``.  Where ``direct`` is given (one int64 on the card), the
    kernel adds to it the (voxel, view) pairs that skipped its
    shared-memory window.  Raises on inputs the kernel does not take."""
    H, W = feat_hw
    V, C = projections.shape[0], g_mean.shape[-1]
    dev = g_mean.device
    if tuple(g_mean.shape) != (*voxel_dim, C) \
            or tuple(cnt.shape) != tuple(voxel_dim):
        raise ValueError(f"cotangent {tuple(g_mean.shape)} and count "
                         f"{tuple(cnt.shape)} do not match the grid "
                         f"{tuple(voxel_dim)}")
    proj, ok = _kernel_inputs(projections, view_valid, g_mean, V, H, W, C)
    count = cnt.to(device=dev, dtype=torch.float32).contiguous()
    out = torch.empty(V, H, W, C, dtype=torch.float32, device=dev)
    org = [float(o) for o in origin]
    if direct is not None and (direct.dtype != torch.int64
                               or direct.numel() != 1
                               or direct.device != dev):
        raise ValueError("direct must be one int64 on the cotangent's device")
    _build.launch("cnrma_volume_accum_bwd", VOLUME_ACCUM_BWD, dev,
                  g_mean.data_ptr(), count.data_ptr(), proj.data_ptr(),
                  ok.data_ptr(), out.data_ptr(), V, H, W, C, *voxel_dim,
                  float(voxel_size), *org,
                  int(g_mean.dtype == torch.bfloat16),
                  None if direct is None else direct.data_ptr())
    return out if dtype == torch.float32 else out.to(dtype)


def volume_accum_bwd(projections: torch.Tensor, g_mean: torch.Tensor,
                     cnt: torch.Tensor, view_valid: torch.Tensor,
                     feat_hw: Tuple[int, int], voxel_dim: Sequence[int],
                     voxel_size: float, origin: Sequence[float],
                     dtype: torch.dtype) -> torch.Tensor:
    """The features' gradient: K1b for a CUDA cotangent, the plain version
    for a CPU one."""
    return _build.dispatch(g_mean, volume_accum_bwd_cuda,
                           volume_accum_bwd_plain, projections, g_mean, cnt,
                           view_valid, feat_hw, voxel_dim, voxel_size,
                           origin, dtype)


class VolumeAccum(torch.autograd.Function):
    """The mean volume as a function of the features, with its gradient.

    Forward: ``volume_accum`` (K1 on a CUDA tensor, the plain version on a
    CPU one); returns (mean volume, count, valid) and saves the
    projections, the view flags and the fp32 count.  Backward: the mean's
    cotangent onto the features through ``volume_accum_bwd`` (K1b or its
    plain version), cast to the feature dtype; no gradient for anything
    else."""

    @staticmethod
    def forward(ctx, projections, features, view_valid, voxel_dim,
                voxel_size, origin):
        mean, cnt, valid = volume_accum(projections, features, view_valid,
                                        voxel_dim, voxel_size, origin)
        ctx.save_for_backward(projections, view_valid, cnt)
        ctx.grid = (tuple(voxel_dim), float(voxel_size), tuple(origin))
        ctx.feat = (tuple(features.shape[1:3]), features.dtype)
        ctx.mark_non_differentiable(cnt, valid)
        return mean, cnt, valid

    @staticmethod
    def backward(ctx, g_mean, _g_cnt, _g_valid):
        projections, view_valid, cnt = ctx.saved_tensors
        voxel_dim, voxel_size, origin = ctx.grid
        hw, dtype = ctx.feat
        g_feat = volume_accum_bwd(projections, g_mean.contiguous(), cnt,
                                  view_valid, hw, voxel_dim, voxel_size,
                                  origin, dtype)
        return None, g_feat, None, None, None, None


def accumulate_views(projections: torch.Tensor, features: torch.Tensor,
                     view_valid: torch.Tensor, voxel_dim: Sequence[int],
                     voxel_size: float, origin: Sequence[float],
                     accum_dtype=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Accumulate all views into the mean feature volume
    (``accumulate_views``), differentiable in ``features``.

    Args:
        projections: [V, 3, 4] stride-adjusted projections (fp32).
        features: [V, H, W, C] feature maps (fp32 or bf16).
        view_valid: [V] bool; invalid views contribute nothing.
        origin: world position of voxel (0, 0, 0), three floats.
        accum_dtype: accepted for config compatibility and ignored: sums
            and view counts are always fp32 here, the reference's exact
            ``volume += ...`` semantics.

    Returns:
        volume [X, Y, Z, C] in the feature dtype (0 where unobserved) and
        valid [X, Y, Z] bool (observed by at least one view).
    """
    del accum_dtype
    volume, _, valid = VolumeAccum.apply(projections, features, view_valid,
                                         tuple(voxel_dim), voxel_size,
                                         tuple(origin))
    return volume, valid

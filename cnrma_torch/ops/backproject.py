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
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from cnrma_torch.ops import _build

VOLUME_ACCUM = _build.LaunchCounter()
MAX_VIEWS = 1024          # the kernel keeps 53 B per view in shared memory


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


def volume_accum_cuda(projections: torch.Tensor, features: torch.Tensor,
                      view_valid: torch.Tensor, voxel_dim: Sequence[int],
                      voxel_size: float, origin: Sequence[float]
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The ``csrc/volume_accum.cu`` kernel; same contract as
    ``volume_accum_plain``.  Raises on inputs the kernel does not take."""
    V, H, W, C = features.shape
    dev = features.device
    if features.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"volume kernel takes fp32 or bf16, got "
                        f"{features.dtype}")
    if C != 32:
        raise ValueError(f"volume kernel is built for 32 channels, got {C}")
    if V > MAX_VIEWS:
        raise ValueError(f"volume kernel takes at most {MAX_VIEWS} views")
    if H * W >= 2 ** 30:
        raise ValueError(f"volume kernel takes under 2**30 pixels a view, "
                         f"got {H} x {W}")
    if projections.shape != (V, 3, 4) or view_valid.shape != (V,):
        raise ValueError("projections must be [V, 3, 4] and view_valid [V]")
    if not features.is_contiguous() or features.data_ptr() % 16:
        raise ValueError("features must be contiguous and 16-byte aligned")
    proj = projections.to(device=dev, dtype=torch.float32).contiguous()
    ok = view_valid.to(device=dev, dtype=torch.bool).contiguous()
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
    plain version for CPU features."""
    return _build.dispatch(features, volume_accum_cuda, volume_accum_plain,
                           projections, features, view_valid, voxel_dim,
                           voxel_size, origin)


def accumulate_views(projections: torch.Tensor, features: torch.Tensor,
                     view_valid: torch.Tensor, voxel_dim: Sequence[int],
                     voxel_size: float, origin: Sequence[float],
                     accum_dtype=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Accumulate all views into the mean feature volume
    (``accumulate_views``).

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
    volume, _, valid = volume_accum(projections, features, view_valid,
                                    voxel_dim, voxel_size, origin)
    return volume, valid

"""NeuS ray marching with empty-space skipping: the predicted TSDF becomes a
weighted point cloud.

Port of ``cnrma_tpu/ops/ray_marching.py`` (``ray_march_neus`` and its
helpers).  Every pixel of a view casts a ray; a coarse march over the
occupancy grid finds the first surface band, a ``skip_window``-sample fine
window there is sampled from the TSDF, NeuS weights are computed along it,
and the samples above the weight threshold are kept in a fixed-capacity
buffer.

The coarse march is the hand-written kernel ``csrc/coarse_march.cu`` on a
CUDA tensor and ``coarse_march_plain`` on a CPU tensor.  The fine window,
``neus_weights`` and the per-ray top-k stay plain torch.

Slot order follows the JAX package exactly: per ray, samples in descending
weight with ties to the lower sample index (``lax.top_k``); then, under
capacity, pixel-major compaction, and over capacity the global weight
ranking.  With that order the downstream subsample draw picks the same
points.

Divisions by a config scalar divide by a 0-dim device tensor: on CUDA,
torch turns ``tensor / python_float`` into a product with the reciprocal,
which is not the IEEE division the kernels and the reference use.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence, Tuple

import torch

from cnrma_torch.ops import _build

COARSE_MARCH = _build.LaunchCounter()
# dynamic shared memory of the coarse kernel, one byte per cell: within the
# 48 KiB a launch may take without opting in, with room for its static 32 B
MAX_GRID_BYTES = 47 * 1024


class RayMarchPoints(NamedTuple):
    """Fixed-capacity point buffer emitted per view (or concatenated)."""
    xyz: torch.Tensor      # [K, 3] f32 world coords
    weight: torch.Tensor   # [K] f32, 0 for empty slots
    uv: torch.Tensor       # [K, 2] int32 (u=col, v=row) source pixel
    view: torch.Tensor     # [K] int32 source view index (-1 for empty)


def get_ray_parameters(projection: torch.Tensor, height: int, width: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-pixel ray origin [3] and unit directions [H*W, 3], pixel-major
    (row v, column u)."""
    dev = projection.device
    P = torch.cat([projection.float(),
                   torch.tensor([[0., 0., 0., 1.]], device=dev)], dim=0)
    Pinv = torch.linalg.inv(P)
    o = Pinv[:3, 3]
    v, u = torch.meshgrid(torch.arange(height, dtype=torch.float32,
                                       device=dev),
                          torch.arange(width, dtype=torch.float32,
                                       device=dev), indexing="ij")
    ones = torch.ones(height * width, dtype=torch.float32, device=dev)
    uv1 = torch.stack([u.reshape(-1), v.reshape(-1), ones, ones], dim=1)
    d = uv1 @ Pinv[:3, :].T - o[None, :]
    d = d / torch.linalg.norm(d, dim=1, keepdim=True)
    return o, d


def _voxel_ids(places: torch.Tensor, origin: torch.Tensor, cell: float,
               dims: Sequence[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nearest-voxel flat index (0 where outside) and in-grid mask."""
    cell_t = torch.tensor(cell, dtype=torch.float32, device=places.device)
    ids = torch.round((places - origin) / cell_t).to(torch.int32)
    valid = torch.ones(ids.shape[:-1], dtype=torch.bool, device=ids.device)
    for a, n in enumerate(dims):
        valid &= (ids[..., a] >= 0) & (ids[..., a] < n)
    ids = torch.where(valid[..., None], ids, 0).long()
    flat = (ids[..., 0] * dims[1] + ids[..., 1]) * dims[2] + ids[..., 2]
    return flat, valid


def _sample_tsdf(tsdf: torch.Tensor, places: torch.Tensor,
                 origin: torch.Tensor, voxel_size: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nearest-voxel TSDF lookup; out-of-volume samples give (1.0, False)."""
    flat, valid = _voxel_ids(places, origin, voxel_size, tsdf.shape)
    vals = tsdf.reshape(-1)[flat]
    return torch.where(valid, vals, torch.ones_like(vals)), valid


def _shift_pool(x: torch.Tensor, op) -> torch.Tensor:
    """3x3x3 neighbourhood pool (edge-replicated) via three 1-D passes."""
    for ax in range(3):
        n = x.shape[ax]
        lo = torch.cat([x.narrow(ax, 1, n - 1), x.narrow(ax, n - 1, 1)], ax)
        hi = torch.cat([x.narrow(ax, 0, 1), x.narrow(ax, 0, n - 1)], ax)
        x = op(x, op(lo, hi))
    return x


def build_occupancy(tsdf: torch.Tensor, factor: int,
                    delta: float = 0.04) -> torch.Tensor:
    """Coarse 'can produce NeuS weight' grid for empty-space skipping: a
    cell is 1.0 where the TSDF range over its 3x3x3 cell neighbourhood
    exceeds ``delta`` (see the JAX docstring for why that is conservative).

    Returns float32 [X/f, Y/f, Z/f]."""
    X, Y, Z = tsdf.shape
    f = factor
    if X % f or Y % f or Z % f:
        raise ValueError(f"voxel_dim {tuple(tsdf.shape)} not divisible by "
                         f"skip factor {f}")
    t = tsdf.reshape(X // f, f, Y // f, f, Z // f, f)
    nmin = _shift_pool(t.amin(dim=(1, 3, 5)), torch.minimum)
    nmax = _shift_pool(t.amax(dim=(1, 3, 5)), torch.maximum)
    return (nmax - nmin > delta).float()


def neus_weights(tsdf_samples: torch.Tensor) -> torch.Tensor:
    """NeuS weights along the last axis: alpha_i = max((s_i - s_{i+1}) /
    s_i, 0) with s = sigmoid(-t), w_i = alpha_i * prod_{j<i} (1 - alpha_j),
    the product taken as the exp of an exclusive cumsum of log1p."""
    sig = torch.sigmoid(-tsdf_samples)
    sig_next = torch.cat([sig[..., 1:], sig[..., -1:]], dim=-1)
    alpha = ((sig - sig_next) / torch.clamp(sig, min=1e-12)).clamp(min=0.0)
    log1m = torch.log1p(-alpha.clamp(max=1.0 - 1e-7))
    t_log = torch.cumsum(log1m, dim=-1) - log1m
    return torch.exp(t_log) * alpha


def _select_topk(weights: torch.Tensor, capacity: int) -> torch.Tensor:
    """Indices of up to ``capacity`` positive weights, -1 for empty slots:
    all positives in index order when they fit, else the ``capacity``
    largest in descending order (ties to the lower index)."""
    n = weights.shape[0]
    k = min(capacity, n)
    keep = weights > 0
    if k == n or int(keep.sum()) <= k:
        pos = torch.cumsum(keep.long(), 0) - 1
        pos = torch.where(keep & (pos < k), pos, k)
        buf = torch.full((k + 1,), -1, dtype=torch.long, device=weights.device)
        buf.scatter_(0, pos, torch.arange(n, device=weights.device))
        sel = buf[:k]
    else:
        vals, idx = torch.sort(weights, descending=True, stable=True)
        sel = torch.where(vals[:k] > 0, idx[:k], -1)
    if k < capacity:
        sel = torch.cat([sel, sel.new_full((capacity - k,), -1)])
    return sel


def coarse_march_plain(o: torch.Tensor, d: torch.Tensor,
                       occupancy: torch.Tensor, origin: torch.Tensor,
                       t_one: float, coarse_step: int, n_coarse: int,
                       cell_size: float
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of the coarse-march kernel, on any device.

    Returns (j0 [HW] int32: first coarse step whose sample lands in an
    occupied cell, 0 without a hit; has_hit [HW] bool)."""
    tc = (torch.arange(n_coarse, dtype=torch.float32, device=d.device)
          * coarse_step + coarse_step * 0.5) * t_one
    places = o[None, None, :] + d[:, None, :] * tc[None, :, None]
    flat, valid = _voxel_ids(places, origin, cell_size, occupancy.shape)
    hit = valid & (occupancy.reshape(-1)[flat] > 0.5)
    return (hit.to(torch.uint8).argmax(dim=1).to(torch.int32),
            hit.any(dim=1))


def coarse_march_cuda(o: torch.Tensor, d: torch.Tensor,
                      occupancy: torch.Tensor, origin: torch.Tensor,
                      t_one: float, coarse_step: int, n_coarse: int,
                      cell_size: float
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``csrc/coarse_march.cu`` kernel; same contract as
    ``coarse_march_plain``.  Raises on inputs the kernel does not take."""
    dev = d.device
    n = d.shape[0]
    if d.dim() != 2 or d.shape[1] != 3:
        raise ValueError(f"directions must be [n, 3], got {tuple(d.shape)}")
    if o.numel() != 3 or origin.numel() != 3:
        raise ValueError("ray origin and grid origin must hold 3 values")
    if occupancy.dim() != 3:
        raise ValueError("occupancy must be [Xc, Yc, Zc]")
    if occupancy.numel() > MAX_GRID_BYTES:
        raise ValueError(f"occupancy grid of {occupancy.numel()} cells "
                         f"exceeds the kernel's {MAX_GRID_BYTES} B shared "
                         "memory buffer")
    f32 = dict(device=dev, dtype=torch.float32)
    o = o.to(**f32).contiguous()
    d = d.to(**f32).contiguous()
    origin = origin.to(**f32).contiguous()
    occ = occupancy.to(**f32).contiguous()
    j0 = torch.empty(n, dtype=torch.int32, device=dev)
    has_hit = torch.empty(n, dtype=torch.bool, device=dev)
    _build.launch("cnrma_coarse_march", COARSE_MARCH, dev, o.data_ptr(),
                  d.data_ptr(), origin.data_ptr(), occ.data_ptr(),
                  j0.data_ptr(), has_hit.data_ptr(), n, n_coarse, coarse_step,
                  *occ.shape, float(t_one), float(cell_size))
    return j0, has_hit


def coarse_march(o, d, occupancy, origin, t_one, coarse_step, n_coarse,
                 cell_size) -> Tuple[torch.Tensor, torch.Tensor]:
    """(j0, has_hit): the CUDA kernel for CUDA rays, the plain version for
    CPU rays."""
    return _build.dispatch(d, coarse_march_cuda, coarse_march_plain, o, d,
                           occupancy, origin, t_one, coarse_step, n_coarse,
                           cell_size)


def ray_march_neus(projection: torch.Tensor, tsdf: torch.Tensor,
                   voxel_dim: Sequence[int], voxel_size: float,
                   origin: Sequence[float], height: int, width: int,
                   view_index: int, n_samples: int = 300,
                   weight_threshold: float = 0.05, capacity: int = 32768,
                   occupancy: torch.Tensor = None, skip_factor: int = 8,
                   skip_window: int = 48, coarse_step: int = 4
                   ) -> RayMarchPoints:
    """March all pixels of one view through the TSDF with NeuS weighting.

    Args:
        projection: [3, 4] stride-adjusted projection of this view.
        tsdf: [X, Y, Z] predicted fine TSDF (fp32).
        occupancy: optional ``build_occupancy(tsdf, skip_factor)`` grid;
            when given (and ``n_samples > skip_window``) the coarse march
            places a ``skip_window``-sample fine window at the first band.
        capacity: points kept for this view (fixed shape).

    Returns:
        RayMarchPoints of ``capacity`` slots; weight 0 marks empty ones.
    """
    X, Y, Z = voxel_dim
    dev = tsdf.device
    HW = height * width
    org = torch.as_tensor(origin, dtype=torch.float32, device=dev)
    o, d = get_ray_parameters(projection, height, width)
    t_one = math.sqrt(X * X + Y * Y + Z * Z) * voxel_size / n_samples

    if occupancy is None or n_samples <= skip_window:
        window, start, has_hit = n_samples, None, None
        ts = torch.arange(n_samples, dtype=torch.float32, device=dev) * t_one
        ts = ts[None, :].expand(HW, n_samples)
    else:
        window = skip_window
        n_coarse = (n_samples + coarse_step - 1) // coarse_step
        j0, has_hit = coarse_march(o, d, occupancy, org, t_one, coarse_step,
                                   n_coarse, voxel_size * skip_factor)
        # the fine window starts one coarse step before the band entry
        start = torch.clamp(j0 * coarse_step - coarse_step, 0,
                            max(n_samples - window, 0)).to(torch.int32)
        idx = start[:, None] + torch.arange(window, dtype=torch.int32,
                                            device=dev)[None]
        ts = idx.float() * t_one
    places = o[None, None, :] + d[:, None, :] * ts[:, :, None]
    tsdf_vals, valid = _sample_tsdf(tsdf, places.reshape(-1, 3), org,
                                    voxel_size)
    w = neus_weights(tsdf_vals.reshape(HW, window))
    keep = valid.reshape(HW, window) & (w >= weight_threshold)
    if has_hit is not None:
        keep &= has_hit[:, None]
    w = torch.where(keep, w, 0.0)

    # per-ray pre-selection, exact: NeuS weights along a ray sum to <= 1,
    # so at most ceil(1 / threshold) samples can clear the threshold
    k_max = min(window, max(1, math.ceil(1.0 / weight_threshold)))
    wk, sk = torch.sort(w, dim=1, descending=True, stable=True)
    wk, sk = wk[:, :k_max], sk[:, :k_max]
    keep_k = wk >= weight_threshold
    ray_id = torch.arange(HW, device=dev)[:, None]
    flat_k = ray_id * window + sk                       # window-local

    sel = _select_topk(torch.where(keep_k, wk, 0.0).reshape(-1), capacity)
    ok = sel >= 0
    sel_c = torch.where(ok, sel, 0)
    src = flat_k.reshape(-1)[sel_c]
    pix = src // window
    smp = src - pix * window
    if start is not None:
        smp = smp + start[pix]                          # global sample id
    xyz = o[None, :] + d[pix] * (smp.float() * t_one)[:, None]
    w_c = torch.where(ok, wk.reshape(-1)[sel_c], 0.0)
    uv = torch.stack([pix % width, pix // width], dim=1).to(torch.int32)
    uv = torch.where(ok[:, None], uv, 0)
    xyz = torch.where(ok[:, None], xyz, 0.0)
    view = torch.where(ok & (w_c > 0), view_index, -1).to(torch.int32)
    return RayMarchPoints(xyz=xyz, weight=w_c, uv=uv, view=view)

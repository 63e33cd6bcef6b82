"""NeuS ray marching with empty-space skipping: the predicted TSDF becomes a
weighted point cloud.

Port of ``cnrma_tpu/ops/ray_marching.py`` (``ray_march_neus`` and its
helpers).  Every pixel of a view casts a ray; a coarse march over the
occupancy grid finds the first surface band, a ``skip_window``-sample fine
window there is sampled from the TSDF, NeuS weights are computed along it,
and the samples above the weight threshold are kept in a fixed-capacity
buffer.

A scene's views are marched together (``ray_march_scene``): the rays of all
views, the per-ray march up to each ray's top ``k_max`` kept samples
(``march_rays``), then the per-view capacity selection and the payload, all
batched over the views with no host sync.  ``march_rays`` is the
hand-written kernel ``csrc/ray_march.cu`` on a CUDA tensor, one launch per
scene, and ``march_rays_plain`` on a CPU tensor.  ``ray_march_neus`` marches
one view with the plain pieces, as the JAX package's function does.

The depth variant (``ray_march_depth``, ``ray_marching_type='depth'``) keeps
the samples around each ray's first TSDF sign change instead; it has no
kernel of its own in the JAX package either, so plain torch ops are the
port, and ``ray_march_depth_scene`` marches a scene view by view, so that
one view's [rays, samples] positions are alive at a time.

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
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from cnrma_torch.capacity import report as report_capacity
from cnrma_torch.ops import _build

RAY_MARCH = _build.LaunchCounter()
MAX_K = 32                # the kernel keeps a ray's kept samples in registers
# dynamic shared memory of the ray-march kernel: the occupancy bits, then
# 13 B per view (ray origin and flag); beyond 48 KiB the launcher opts in
MAX_SHARED_BYTES = 227 * 1024


class RayMarchPoints(NamedTuple):
    """Fixed-capacity point buffer emitted per view ([K] fields, or
    [V, K] for a scene's views)."""
    xyz: torch.Tensor      # [K, 3] f32 world coords
    weight: torch.Tensor   # [K] f32, 0 for empty slots
    uv: torch.Tensor       # [K, 2] int32 (u=col, v=row) source pixel
    view: torch.Tensor     # [K] int32 source view index (-1 for empty)


def get_ray_parameters(projection: torch.Tensor, height: int, width: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-pixel ray origin [..., 3] and unit directions [..., H*W, 3],
    pixel-major (row v, column u), of [..., 3, 4] projections.  No host
    sync: ``inv_ex`` does not check the inverse on the host."""
    dev = projection.device
    lead = projection.shape[:-2]
    P = torch.zeros(*lead, 4, 4, dtype=torch.float32, device=dev)
    P[..., :3, :] = projection
    P[..., 3, 3] = 1.0
    Pinv = torch.linalg.inv_ex(P).inverse
    o = Pinv[..., :3, 3]
    v, u = torch.meshgrid(torch.arange(height, dtype=torch.float32,
                                       device=dev),
                          torch.arange(width, dtype=torch.float32,
                                       device=dev), indexing="ij")
    ones = torch.ones(height * width, dtype=torch.float32, device=dev)
    uv1 = torch.stack([u.reshape(-1), v.reshape(-1), ones, ones], dim=1)
    d = uv1 @ Pinv[..., :3, :].mT - o[..., None, :]
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    return o, d


def _voxel_ids(places: torch.Tensor, origin, cell: float,
               dims: Sequence[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nearest-voxel flat index (0 where outside) and in-grid mask.  The
    origin is filled on the device, not copied there (a copy from the
    host would synchronise)."""
    dev = places.device
    org = torch.stack([torch.full((), float(x), dtype=torch.float32,
                                  device=dev) for x in origin])
    cell_t = torch.full((), cell, dtype=torch.float32, device=dev)
    ids = torch.round((places - org) / cell_t).to(torch.int32)
    valid = torch.ones(ids.shape[:-1], dtype=torch.bool, device=dev)
    for a, n in enumerate(dims):
        valid &= (ids[..., a] >= 0) & (ids[..., a] < n)
    ids = torch.where(valid[..., None], ids, 0).long()
    flat = (ids[..., 0] * dims[1] + ids[..., 1]) * dims[2] + ids[..., 2]
    return flat, valid


def _sample_tsdf(tsdf: torch.Tensor, places: torch.Tensor, origin,
                 voxel_size: float) -> Tuple[torch.Tensor, torch.Tensor]:
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
    """Indices of up to ``capacity`` positive weights along the last axis,
    -1 for empty slots: all positives in index order when they fit, else
    the ``capacity`` largest in descending order (ties to the lower index).

    Each row ([V, n]: each view) picks its branch on the device, as the JAX
    ``lax.cond`` does under ``vmap``: both are computed, no host sync."""
    n = weights.shape[-1]
    k = min(capacity, n)
    dev = weights.device
    keep = weights > 0
    pos = torch.cumsum(keep.int(), -1) - 1           # int32: a faster scan
    pos = torch.where(keep & (pos < k), pos, k).long()
    buf = torch.full((*weights.shape[:-1], k + 1), -1, dtype=torch.long,
                     device=dev)
    buf.scatter_(-1, pos, torch.arange(n, device=dev).expand(pos.shape))
    sel = buf[..., :k]
    if k < n:
        vals, idx = torch.sort(weights, dim=-1, descending=True, stable=True)
        ranked = torch.where(vals[..., :k] > 0, idx[..., :k], -1)
        fits = keep.sum(-1, keepdim=True) <= k
        sel = torch.where(fits, sel, ranked)
    if k < capacity:
        sel = torch.cat([sel, sel.new_full((*sel.shape[:-1], capacity - k),
                                           -1)], dim=-1)
    return sel


def coarse_march_plain(o: torch.Tensor, d: torch.Tensor,
                       occupancy: torch.Tensor, origin,
                       t_one: float, coarse_step: int, n_coarse: int,
                       cell_size: float
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The coarse march of rays o [..., 3], d [..., n, 3] over the
    occupancy grid, on any device.

    Returns (j0 [..., n] int32: first coarse step whose sample lands in an
    occupied cell, 0 without a hit; has_hit [..., n] bool)."""
    tc = (torch.arange(n_coarse, dtype=torch.float32, device=d.device)
          * coarse_step + coarse_step * 0.5) * t_one
    places = o[..., None, None, :] + d[..., :, None, :] * tc[:, None]
    flat, valid = _voxel_ids(places, origin, cell_size, occupancy.shape)
    hit = valid & (occupancy.reshape(-1)[flat] > 0.5)
    return (hit.to(torch.uint8).argmax(dim=-1).to(torch.int32),
            hit.any(dim=-1))


def _march_shape(occupancy: Optional[torch.Tensor], n_samples: int,
                 skip_window: int, weight_threshold: float
                 ) -> Tuple[bool, int, int]:
    """(skipping, fine window length, kept slots a ray k_max).  k_max is
    exact: NeuS weights along a ray sum to <= 1, so at most
    ceil(1 / threshold) samples can clear the threshold."""
    skip = occupancy is not None and n_samples > skip_window
    window = skip_window if skip else n_samples
    k_max = min(window, max(1, math.ceil(1.0 / weight_threshold)))
    return skip, window, k_max


def _t_one(dims: Sequence[int], voxel_size: float, n_samples: int) -> float:
    """Distance between fine samples: the grid diagonal over n_samples."""
    X, Y, Z = dims
    return math.sqrt(X * X + Y * Y + Z * Z) * voxel_size / n_samples


def _check_dims(tsdf: torch.Tensor, voxel_dim: Sequence[int]) -> None:
    """The march spaces its samples by ``tsdf.shape`` and the payload its
    points by ``voxel_dim``: they must be one grid."""
    if tuple(tsdf.shape) != tuple(voxel_dim):
        raise ValueError(f"tsdf shape {tuple(tsdf.shape)} is not voxel_dim "
                         f"{tuple(voxel_dim)}")


def march_rays_plain(o: torch.Tensor, d: torch.Tensor,
                     view_valid: torch.Tensor, tsdf: torch.Tensor,
                     occupancy: Optional[torch.Tensor], origin,
                     voxel_size: float, n_samples: int,
                     weight_threshold: float, skip_factor: int,
                     skip_window: int, coarse_step: int
                     ) -> Tuple[torch.Tensor, ...]:
    """Plain torch version of the ray-march kernel, on any device: the
    rays o [V, 3], d [V, HW, 3] of a scene's views through the TSDF.

    Returns (weight [V, HW, k_max] fp32, descending per ray, 0 in empty
    slots; sample [V, HW, k_max] int32 global sample ids, 0 in empty
    slots; j0 [V, HW] int32; has_hit [V, HW] bool).  A view whose
    ``view_valid`` is False emits nothing: all four are 0 there."""
    V, HW = d.shape[:2]
    dev = d.device
    t_one = _t_one(tsdf.shape, voxel_size, n_samples)
    skip, window, k_max = _march_shape(occupancy, n_samples, skip_window,
                                       weight_threshold)
    ok = view_valid.to(device=dev, dtype=torch.bool)[:, None]
    if skip:
        n_coarse = (n_samples + coarse_step - 1) // coarse_step
        j0, has_hit = coarse_march_plain(o, d, occupancy, origin, t_one,
                                         coarse_step, n_coarse,
                                         voxel_size * skip_factor)
        j0 = torch.where(ok, j0, 0)
        has_hit &= ok
        # the fine window starts one coarse step before the band entry
        start = torch.clamp(j0 * coarse_step - coarse_step, 0,
                            max(n_samples - window, 0)).to(torch.int32)
    else:
        j0 = torch.zeros(V, HW, dtype=torch.int32, device=dev)
        has_hit = ok.expand(V, HW).clone()
        start = j0
    idx = start[..., None] + torch.arange(window, dtype=torch.int32,
                                          device=dev)
    ts = idx.float() * t_one
    places = o[:, None, None, :] + d[:, :, None, :] * ts[..., None]
    tsdf_vals, valid = _sample_tsdf(tsdf, places, origin, voxel_size)
    w = neus_weights(tsdf_vals)
    keep = valid & (w >= weight_threshold) & has_hit[..., None]
    w = torch.where(keep, w, 0.0)
    wk, sk = torch.sort(w, dim=-1, descending=True, stable=True)
    wk, sk = wk[..., :k_max], sk[..., :k_max]
    kept = wk >= weight_threshold
    return (torch.where(kept, wk, 0.0),
            torch.where(kept, start[..., None] + sk, 0).to(torch.int32),
            j0, has_hit)


def pack_occupancy(occupancy: torch.Tensor) -> torch.Tensor:
    """The occupancy grid as bits (cell i is bit i % 8 of byte i // 8),
    padded to whole 32-bit words: uint8 [4 * ceil(cells / 32)]."""
    bits = occupancy.reshape(-1) > 0.5
    n = bits.numel()
    n_bytes = 4 * ((n + 31) // 32)
    padded = torch.zeros(8 * n_bytes, dtype=torch.int32, device=bits.device)
    padded[:n] = bits
    place = torch.pow(2, torch.arange(8, dtype=torch.int32,
                                      device=bits.device))
    return (padded.reshape(n_bytes, 8) * place).sum(1).to(torch.uint8)


def march_rays_cuda(o: torch.Tensor, d: torch.Tensor,
                    view_valid: torch.Tensor, tsdf: torch.Tensor,
                    occupancy: Optional[torch.Tensor], origin,
                    voxel_size: float, n_samples: int,
                    weight_threshold: float, skip_factor: int,
                    skip_window: int, coarse_step: int
                    ) -> Tuple[torch.Tensor, ...]:
    """The ``csrc/ray_march.cu`` kernel, one launch for all of a scene's
    views; same contract as ``march_rays_plain``.  Raises on inputs the
    kernel does not take."""
    dev = d.device
    if d.dim() != 3 or d.shape[2] != 3 or o.shape != (d.shape[0], 3):
        raise ValueError(f"rays must be o [V, 3] and d [V, HW, 3], got "
                         f"{tuple(o.shape)} and {tuple(d.shape)}")
    V, HW = d.shape[:2]
    if view_valid.shape != (V,):
        raise ValueError("view_valid must be [V]")
    if tsdf.dim() != 3 or tsdf.dtype != torch.float32:
        raise ValueError("tsdf must be a [X, Y, Z] fp32 grid")
    if not 0.0 < weight_threshold:
        raise ValueError("the kernel keeps samples above a positive "
                         "weight threshold")
    if any(t.device != dev for t in (o, view_valid, tsdf)):
        raise ValueError("rays, view flags and TSDF must be on one device")
    skip, window, k_max = _march_shape(occupancy, n_samples, skip_window,
                                       weight_threshold)
    if k_max > MAX_K:
        raise ValueError(f"{k_max} kept samples a ray exceed the kernel's "
                         f"{MAX_K}")
    if skip:
        if occupancy.dim() != 3 or occupancy.device != dev:
            raise ValueError("occupancy must be [Xc, Yc, Zc] on the rays' "
                             "device")
        occ = pack_occupancy(occupancy)
        coarse = occupancy.shape
        n_coarse = (n_samples + coarse_step - 1) // coarse_step
    else:
        occ = torch.zeros(4, dtype=torch.uint8, device=dev)
        coarse, n_coarse = (0, 0, 0), 0
    if occ.numel() + 13 * V > MAX_SHARED_BYTES:
        raise ValueError(f"occupancy grid {tuple(coarse)} and {V} views "
                         f"exceed the kernel's {MAX_SHARED_BYTES} B of "
                         "shared memory")
    X, Y, Z = tsdf.shape
    t_one = _t_one(tsdf.shape, voxel_size, n_samples)
    o = o.to(torch.float32).contiguous()
    d = d.to(torch.float32).contiguous()
    ok = view_valid.to(torch.bool).contiguous()
    tsdf = tsdf.contiguous()
    weight = torch.empty(V, HW, k_max, dtype=torch.float32, device=dev)
    sample = torch.empty(V, HW, k_max, dtype=torch.int32, device=dev)
    j0 = torch.empty(V, HW, dtype=torch.int32, device=dev)
    has_hit = torch.empty(V, HW, dtype=torch.bool, device=dev)
    org = [float(x) for x in origin]
    _build.launch("cnrma_ray_march", RAY_MARCH, dev, o.data_ptr(),
                  d.data_ptr(), ok.data_ptr(), occ.data_ptr(),
                  tsdf.data_ptr(), weight.data_ptr(), sample.data_ptr(),
                  j0.data_ptr(), has_hit.data_ptr(), V, HW, X, Y, Z, *coarse,
                  n_samples, window, k_max, n_coarse, coarse_step,
                  float(t_one), float(voxel_size),
                  float(voxel_size * skip_factor), *org,
                  float(weight_threshold))
    return weight, sample, j0, has_hit


def kept_mismatch(a: Tuple[torch.Tensor, torch.Tensor],
                  b: Tuple[torch.Tensor, torch.Tensor], n_samples: int,
                  weight_threshold: float, near: float = 1e-5
                  ) -> Tuple[int, float]:
    """Compare two (weight, sample) results of ``march_rays`` ray by ray as
    sets of kept samples: (samples that one keeps and the other does not,
    leaving out those whose weight is within ``near`` of the threshold in
    either; the largest weight difference over samples both keep).  Slot
    order may differ where two weights of a ray differ by an ulp."""
    dense = []
    for weight, sample in (a, b):
        w = weight.reshape(-1, weight.shape[-1])
        idx = torch.where(w > 0, sample.reshape(w.shape).long(), n_samples)
        dense.append(torch.zeros(w.shape[0], n_samples + 1,
                                 device=w.device).scatter_(1, idx, w))
    da, db = dense
    band = ((da - weight_threshold).abs() < near) \
        | ((db - weight_threshold).abs() < near)
    differ = int((((da > 0) != (db > 0)) & ~band).sum())
    both = (da > 0) & (db > 0)
    err = float((da - db).abs()[both].max()) if bool(both.any()) else 0.0
    return differ, err


def march_rays(o, d, view_valid, tsdf, occupancy, origin, voxel_size,
               n_samples, weight_threshold, skip_factor, skip_window,
               coarse_step) -> Tuple[torch.Tensor, ...]:
    """(weight, sample, j0, has_hit): the CUDA kernel for CUDA rays, the
    plain version for CPU rays."""
    return _build.dispatch(d, march_rays_cuda, march_rays_plain, o, d,
                           view_valid, tsdf, occupancy, origin, voxel_size,
                           n_samples, weight_threshold, skip_factor,
                           skip_window, coarse_step)


def _points(weight: torch.Tensor, sample: torch.Tensor, o: torch.Tensor,
            d: torch.Tensor, view_ids: torch.Tensor, t_one: float,
            width: int, capacity: int) -> RayMarchPoints:
    """Per view, the capacity selection over the rays' kept samples
    (weight, sample [V, HW, k_max]) and the payload of the selected ones:
    [V, capacity] fields."""
    V, HW, k_max = weight.shape
    w_flat = weight.reshape(V, HW * k_max)
    if capacity < HW * k_max:
        report_capacity("ray-march kept samples/view",
                        lambda: (w_flat > 0).sum(-1), capacity)
    sel = _select_topk(w_flat, capacity)                # [V, cap]
    ok = sel >= 0
    sel_c = torch.where(ok, sel, 0)
    pix = sel_c // k_max
    smp = torch.gather(sample.reshape(V, HW * k_max), 1, sel_c)
    d_sel = torch.gather(d, 1, pix[..., None].expand(V, capacity, 3))
    xyz = o[:, None, :] + d_sel * (smp.float() * t_one)[..., None]
    w_c = torch.where(ok, torch.gather(w_flat, 1, sel_c), 0.0)
    uv = torch.stack([pix % width, pix // width], dim=-1).to(torch.int32)
    uv = torch.where(ok[..., None], uv, 0)
    xyz = torch.where(ok[..., None], xyz, 0.0)
    view = torch.where(ok & (w_c > 0), view_ids[:, None].to(torch.int32), -1)
    return RayMarchPoints(xyz=xyz, weight=w_c, uv=uv,
                          view=view.to(torch.int32))


def ray_march_scene(projections: torch.Tensor, tsdf: torch.Tensor,
                    view_valid: torch.Tensor, voxel_dim: Sequence[int],
                    voxel_size: float, origin: Sequence[float], height: int,
                    width: int, n_samples: int = 300,
                    weight_threshold: float = 0.05, capacity: int = 32768,
                    occupancy: torch.Tensor = None, skip_factor: int = 8,
                    skip_window: int = 48, coarse_step: int = 4,
                    view_offset: int = 0) -> RayMarchPoints:
    """March every pixel of every view of one scene: ``ray_march_neus`` for
    all views at once, one ``march_rays`` call, no host sync.

    Args:
        projections: [V, 3, 4] stride-adjusted projections.
        tsdf: [X, Y, Z] predicted fine TSDF (fp32).
        view_valid: [V] bool; an invalid view emits no point.
        occupancy: optional ``build_occupancy(tsdf, skip_factor)`` grid.
        capacity: points kept per view (fixed shape).
        view_offset: the scene's index of the first of these views (a
            rank's block of a scene split across ranks): the points carry
            the views' ids ``view_offset + i``.  The kernel's outputs are
            per ray and hold no view id, so they do not depend on it.

    Returns:
        RayMarchPoints of [V, capacity] slots; weight 0 marks empty ones.
    """
    _check_dims(tsdf, voxel_dim)
    o, d = get_ray_parameters(projections, height, width)
    weight, sample, _, _ = march_rays(
        o, d, view_valid, tsdf, occupancy, origin, voxel_size, n_samples,
        weight_threshold, skip_factor, skip_window, coarse_step)
    t_one = _t_one(voxel_dim, voxel_size, n_samples)
    views = view_offset + torch.arange(projections.shape[0], device=d.device)
    return _points(weight, sample, o, d, views, t_one, width, capacity)


def ray_march_neus(projection: torch.Tensor, tsdf: torch.Tensor,
                   voxel_dim: Sequence[int], voxel_size: float,
                   origin: Sequence[float], height: int, width: int,
                   view_index: int, n_samples: int = 300,
                   weight_threshold: float = 0.05, capacity: int = 32768,
                   occupancy: torch.Tensor = None, skip_factor: int = 8,
                   skip_window: int = 48, coarse_step: int = 4
                   ) -> RayMarchPoints:
    """March all pixels of one view through the TSDF with NeuS weighting,
    with the plain versions on any device (the JAX ``ray_march_neus``).

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
    _check_dims(tsdf, voxel_dim)
    o, d = get_ray_parameters(projection[None], height, width)
    weight, sample, _, _ = march_rays_plain(
        o, d, torch.ones(1, dtype=torch.bool), tsdf, occupancy, origin,
        voxel_size, n_samples, weight_threshold, skip_factor, skip_window,
        coarse_step)
    t_one = _t_one(voxel_dim, voxel_size, n_samples)
    views = torch.full((1,), view_index, device=d.device)
    return RayMarchPoints(*(f[0] for f in _points(
        weight, sample, o, d, views, t_one, width, capacity)))


def _depth_view(o: torch.Tensor, d: torch.Tensor, tsdf: torch.Tensor,
                voxel_dim: Sequence[int], voxel_size: float,
                origin: Sequence[float], width: int, view_index: int,
                n_samples: int, depth_points: int, capacity: int,
                valid=True) -> RayMarchPoints:
    """``ray_march_depth`` of one view's rays (origin o [3], directions
    d [HW, 3]); a view that is not ``valid`` (a 0-dim bool tensor or a
    bool) keeps no point."""
    t_one = _t_one(voxel_dim, voxel_size, n_samples)
    hw, dev = d.shape[0], d.device
    ts = torch.arange(n_samples, dtype=torch.float32, device=dev) * t_one
    places = o[None, None, :] + d[:, None, :] * ts[None, :, None]
    tv, _ = _sample_tsdf(tsdf, places, origin, voxel_size)     # [HW, n]
    del places
    prod = torch.cat([tv[:, :-1] * tv[:, 1:],
                      torch.ones(hw, 1, dtype=torch.float32, device=dev)],
                     dim=1)
    change = prod <= 0
    best_index = change.to(torch.uint8).argmax(dim=1)         # first change
    best_weight = (change.any(dim=1) & valid).float()
    if depth_points > 0:
        num = 2 * depth_points
        add = torch.arange(num, device=dev) - depth_points + 1
        ramp = torch.arange(1, depth_points + 1, dtype=torch.float32,
                            device=dev)
        multi_w = torch.cat([ramp, ramp.flip(0)]) / depth_points
        sel_idx = best_index[:, None] + add[None, :]           # [HW, num]
        sel_w = best_weight[:, None] * multi_w[None, :]
        sel_w = sel_w * ((sel_idx >= 0) & (sel_idx < n_samples))
        sel_t = sel_idx.float() * t_one
    else:
        num = 1
        sel_t = (best_index.float() + 0.5)[:, None] * t_one
        sel_w = best_weight[:, None]
    w_flat = sel_w.reshape(-1)
    if capacity < w_flat.shape[0]:
        report_capacity("ray-march kept samples/view",
                        lambda: (w_flat > 0).sum(), capacity)
    # weight-ranked selection of indices into the [HW, num] grid; the
    # payload (position, weight, pixel) is rebuilt for the survivors
    sel = _select_topk(w_flat, capacity)
    ok = sel >= 0
    sel_c = torch.where(ok, sel, 0)
    pix = sel_c // num
    xyz = o[None, :] + d[pix] * sel_t.reshape(-1)[sel_c][:, None]
    w_c = torch.where(ok, w_flat[sel_c], 0.0)
    uv = torch.stack([pix % width, pix // width], dim=1).to(torch.int32)
    uv = torch.where(ok[:, None], uv, 0)
    xyz = torch.where(ok[:, None], xyz, 0.0)
    view = torch.where(ok & (w_c > 0), view_index, -1).to(torch.int32)
    return RayMarchPoints(xyz=xyz, weight=w_c, uv=uv, view=view)


def ray_march_depth(projection: torch.Tensor, tsdf: torch.Tensor,
                    voxel_dim: Sequence[int], voxel_size: float,
                    origin: Sequence[float], height: int, width: int,
                    view_index: int, n_samples: int = 300,
                    depth_points: int = 2, capacity: int = 32768
                    ) -> RayMarchPoints:
    """Depth marching of one view (port of the JAX ``ray_march_depth``,
    reference ``ray_projection_depth``): along each pixel's ray,
    ``n_samples`` nearest-voxel TSDF samples over the grid's diagonal; at
    the first sign change (a product of neighbours <= 0) it keeps
    ``2 * depth_points`` samples, from ``depth_points - 1`` before it, with
    weights ``[1 .. d, d .. 1] / d`` (0 off the ray), or with
    ``depth_points`` 0 one point half a sample past it, weight 1.  A ray
    without a sign change keeps nothing.  Then the weight-ranked selection
    of up to ``capacity`` points (``_select_topk``).

    Args:
        projection: [3, 4] stride-adjusted projection of this view.
        tsdf: [X, Y, Z] predicted fine TSDF (fp32).

    Returns:
        RayMarchPoints of ``capacity`` slots; weight 0 marks empty ones.
    """
    _check_dims(tsdf, voxel_dim)
    o, d = get_ray_parameters(projection[None], height, width)
    return _depth_view(o[0], d[0], tsdf, voxel_dim, voxel_size, origin,
                       width, view_index, n_samples, depth_points, capacity)


def ray_march_depth_scene(projections: torch.Tensor, tsdf: torch.Tensor,
                          view_valid: torch.Tensor,
                          voxel_dim: Sequence[int], voxel_size: float,
                          origin: Sequence[float], height: int, width: int,
                          n_samples: int = 300, depth_points: int = 2,
                          capacity: int = 32768, view_offset: int = 0
                          ) -> RayMarchPoints:
    """``ray_march_depth`` of every view of one scene, one view at a time
    (a full ScanNet view is 19,200 rays x 300 samples); an invalid view
    (``view_valid`` [V] False) keeps no point.  Returns RayMarchPoints of
    [V, capacity] slots, the views' ids from ``view_offset`` on (as
    ``ray_march_scene``)."""
    _check_dims(tsdf, voxel_dim)
    o, d = get_ray_parameters(projections, height, width)
    views = [_depth_view(o[i], d[i], tsdf, voxel_dim, voxel_size, origin,
                         width, view_offset + i, n_samples, depth_points,
                         capacity, view_valid[i])
             for i in range(projections.shape[0])]
    return RayMarchPoints(*(torch.stack(f) for f in zip(*views)))

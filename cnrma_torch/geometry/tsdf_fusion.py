"""GT TSDF fusion from posed depth maps (port of
``cnrma_tpu/geometry/tsdf_fusion.py``).

``fuse_tsdf`` integrates the frames one after another on a fixed voxel
grid, as the JAX ``lax.scan`` does, so that the fp32 running sum adds in
the same order:

* signed distance ``dist = pz - depth`` in units of the truncation margin
  (``trunc_ratio`` voxels), clamped to -1; voxels more than one margin
  behind the surface (dist >= 1) are not integrated;
* near-surface observations (dist > -1) add to a running sum with a
  weight count; a clamped free-space observation (dist == -1) is only
  remembered, so a voxel seen as deep free space alone reads -1 with
  weight 0, and a voxel never seen reads +1.

The sign is Atlas's: negative in front of the surface, positive behind
it (``geometry/tsdf.py:get_mesh`` negates it).  The frames stream from
the host to the device ``chunk`` at a time, in order; the result does not
depend on ``chunk``.  The JAX fusion is plain XLA with no Pallas kernel,
and this is plain torch on the caller's device.

``depth_to_world_points`` and ``volume_bounds_from_depths`` are numpy
copies of the JAX module's (the volume bounds from a quantile of the
backprojected depth).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

FRAME_CHUNK = 32            # frames copied to the device at a time


def _frames(frames, lo: int, hi: int, dev: torch.device,
            dtype: torch.dtype) -> torch.Tensor:
    """Frames ``lo:hi`` of an array, a tensor or a list of arrays, as one
    contiguous tensor on ``dev``."""
    if isinstance(frames, torch.Tensor):
        part = frames[lo:hi]
    elif isinstance(frames, np.ndarray):
        part = torch.from_numpy(np.ascontiguousarray(frames[lo:hi]))
    else:
        part = torch.from_numpy(np.stack(
            [np.asarray(f) for f in frames[lo:hi]]))
    return part.to(dev, dtype).contiguous()


@torch.no_grad()
def fuse_tsdf(depths, projections, frame_valid, origin,
              voxel_dim: Tuple[int, int, int], voxel_size: float,
              trunc_ratio: float = 3.0, max_depth: float = 3.0,
              device: Optional[torch.device] = None,
              chunk: int = FRAME_CHUNK) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fuse depth maps into a TSDF volume.

    Args:
        depths: [F, H, W] metric depth (0 = invalid): an array, a tensor on
            any device, or a list of [H, W] arrays.
        projections: [F, 3, 4] K @ world-to-camera.
        frame_valid: [F] bool.
        origin: [3] world position of voxel (0, 0, 0).
        device: where the volume lives (default: ``depths``' device if it
            is a tensor, else the CPU).
        chunk: frames moved to ``device`` at a time.
    Returns:
        tsdf [X, Y, Z] in [-1, 1] (+1 unknown), weights [X, Y, Z], fp32 on
        ``device``.
    """
    if device is None:
        device = (depths.device if isinstance(depths, torch.Tensor)
                  else torch.device("cpu"))
    dev = torch.device(device)
    f32 = torch.float32
    X, Y, Z = (int(d) for d in voxel_dim)
    n = len(depths)
    h, w = (int(s) for s in np.shape(depths[0]))
    projs = _frames(projections, 0, n, dev, f32)
    ok = _frames(frame_valid, 0, n, dev, torch.bool)
    org = torch.as_tensor(np.asarray(origin, np.float32)
                          if not isinstance(origin, torch.Tensor)
                          else origin).to(dev, f32).reshape(3)
    # a 0-dim device tensor: CUDA turns a division by a host scalar into a
    # product with its reciprocal
    trunc = torch.tensor(trunc_ratio * voxel_size, dtype=f32, device=dev)
    axes = [torch.arange(d, dtype=f32, device=dev) * voxel_size + org[i]
            for i, d in enumerate((X, Y, Z))]

    tsdf_sum = torch.zeros((X, Y, Z), dtype=f32, device=dev)
    weight = torch.zeros((X, Y, Z), dtype=f32, device=dev)
    free_seen = torch.zeros((X, Y, Z), dtype=torch.bool, device=dev)
    zero = torch.zeros((), dtype=f32, device=dev)
    for lo in range(0, n, chunk):
        block = _frames(depths, lo, min(n, lo + chunk), dev, f32)
        for k in range(block.shape[0]):
            proj, depth = projs[lo + k], block[k].reshape(-1)
            # the JAX broadcast sum's term order: ((x + y) + z) + t
            cam = [((proj[c, 0] * axes[0])[:, None, None]
                    + (proj[c, 1] * axes[1])[None, :, None]
                    + (proj[c, 2] * axes[2])[None, None, :]) + proj[c, 3]
                   for c in range(3)]
            pz = cam[2]
            inv_z = torch.where(pz != 0, 1.0 / pz, zero)
            # half to even, as jnp.round; compared as floats, so that no
            # value outside int32 is cast
            px = torch.round(cam[0] * inv_z)
            py = torch.round(cam[1] * inv_z)
            in_view = (px >= 0) & (py >= 0) & (px < w) & (py < h) & (pz > 0)
            flat = (py.clamp(0, h - 1) * w + px.clamp(0, w - 1)).long()
            d = depth[flat]
            has_depth = (d > 0) & (d <= max_depth)
            dist = torch.clamp((pz - d) / trunc, min=-1.0)
            valid = in_view & has_depth & (dist < 1.0) & ok[lo + k]
            near = valid & (dist > -1.0)
            tsdf_sum = tsdf_sum + torch.where(near, dist, zero)
            weight = weight + near.to(f32)
            free_seen = free_seen | (valid & ~near)
    tsdf = torch.where(weight > 0, tsdf_sum / torch.clamp(weight, min=1.0),
                       torch.where(free_seen, -1.0, 1.0))
    return tsdf, weight


def depth_to_world_points(depth: np.ndarray, intrinsic: np.ndarray,
                          cam2world: np.ndarray,
                          max_depth: float = 3.0) -> np.ndarray:
    """Backproject one depth map to world points (numpy, for the volume
    bounds)."""
    h, w = depth.shape
    v, u = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    valid = (depth > 0) & (depth <= max_depth)
    z = depth[valid]
    uu, vv = u[valid], v[valid]
    fx, fy = intrinsic[0, 0], intrinsic[1, 1]
    cx, cy = intrinsic[0, 2], intrinsic[1, 2]
    xyz_cam = np.stack([(uu - cx) / fx * z, (vv - cy) / fy * z, z,
                        np.ones_like(z)], axis=0)
    return (cam2world @ xyz_cam)[:3].T


def volume_bounds_from_depths(points: np.ndarray, voxel_size: float,
                              margin: float = 1.5,
                              quantile: float = 0.005
                              ) -> Tuple[np.ndarray, Tuple[int, int, int]]:
    """0.5%-quantile bounds + margin -> (origin, voxel_dim)."""
    lo = np.quantile(points, quantile, axis=0) - margin
    hi = np.quantile(points, 1 - quantile, axis=0) + margin
    origin = lo.astype(np.float32)
    dim = np.ceil((hi - lo) / voxel_size).astype(int)
    return origin, (int(dim[0]), int(dim[1]), int(dim[2]))


def near_ties(depths, projections, origin, voxel_size: float,
              idx: np.ndarray, trunc_ratio: float = 3.0,
              pixel_tol: float = 1e-3, dist_tol: float = 1e-4
              ) -> np.ndarray:
    """[N] bool: which voxels ``idx`` [N, 3] project, in some frame, within
    ``pixel_tol`` of a half-integer pixel, or to a signed distance within
    ``dist_tol`` (truncation units) of -1 or 1: where one ulp of the fp32
    projection (an FMA, another order of its terms) can take the other
    pixel or the other branch.  Computed in fp64 from the frames
    ``depths`` [F, H, W] and ``projections`` [F, 3, 4]; used to compare
    two fusions."""
    idx = np.asarray(idx, np.int64).reshape(-1, 3)
    pts = idx * float(voxel_size) + np.asarray(origin, np.float64)[None]
    tie = np.zeros(len(idx), bool)
    trunc = trunc_ratio * voxel_size
    for depth, p in zip(depths, np.asarray(projections, np.float64)):
        depth = np.asarray(depth)
        h, w = depth.shape
        cam = pts @ p[:, :3].T + p[:, 3]
        with np.errstate(divide="ignore", invalid="ignore"):
            uv = cam[:, :2] / cam[:, 2:3]
        frac = np.abs(np.abs(uv - np.floor(uv)) - 0.5)
        tie |= (frac < pixel_tol).any(axis=1)
        px = np.clip(np.nan_to_num(np.round(uv[:, 0])), 0, w - 1)
        py = np.clip(np.nan_to_num(np.round(uv[:, 1])), 0, h - 1)
        dist = (cam[:, 2] - depth[py.astype(np.int64), px.astype(np.int64)]
                ) / trunc
        tie |= np.abs(np.abs(dist) - 1) < dist_tol
    return tie


# two fusions of the same frames (the port against JAX, the card against
# the CPU) agree within PARITY_ATOL on the TSDF and exactly on the weights,
# except at near ties, and at most PARITY_MAX_SHARE of the voxels differ
PARITY_ATOL = 1e-5
PARITY_MAX_SHARE = 0.01


def fusion_mismatch(got, want, depths, projections, origin,
                    voxel_size: float, trunc_ratio: float = 3.0
                    ) -> Tuple[float, np.ndarray]:
    """Two fusions (tsdf, weight) of the same frames: the share of voxels
    that differ (TSDF beyond ``PARITY_ATOL`` or another weight), and those
    of them [K, 3] that are no near tie (``near_ties``), which must be
    none."""
    (t, w), (t2, w2) = [(np.asarray(a), np.asarray(b)) for a, b in
                        (got, want)]
    off = (np.abs(t - t2) > PARITY_ATOL) | (w != w2)
    idx = np.argwhere(off)
    ties = near_ties(depths, projections, origin, voxel_size, idx,
                     trunc_ratio)
    return float(off.mean()), idx[~ties]

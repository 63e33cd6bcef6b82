"""TSDF container: npz IO, resampling under rigid transforms, mesh extraction
(a copy of ``cnrma_tpu/geometry/tsdf.py``).

The volume is held as a numpy array on the host, in the reference's npz
format (keys ``origin`` [1, 3] float, ``voxel_size`` scalar, ``tsdf``
[X, Y, Z]), so GT files load unchanged and saved results score with the
reference's offline tools.  ``get_mesh`` and ``transform`` run in torch on a
device the caller names (the CPU by default): the mesh through the port's
marching cubes, the resample as the JAX package's numpy path
(``cnrma_tpu/geometry/tsdf.py:115-157``), op for op.  The JAX package's
C++ resample (``native/``) is not used.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from cnrma_torch.utils.marching_cubes import marching_cubes


def coordinates_grid(voxel_dim: Sequence[int], device="cpu") -> torch.Tensor:
    """Voxel indices of a grid, [3, nx*ny*nz] int64, z fastest (reference
    ``tsdf.py:coordinates``, :14-29)."""
    axes = [torch.arange(int(n), device=device) for n in voxel_dim]
    return torch.stack([a.reshape(-1) for a in
                        torch.meshgrid(*axes, indexing="ij")])


class TSDF:
    """Truncated signed distance volume with voxel size + world origin."""

    def __init__(self, voxel_size: float, origin, tsdf_vol):
        self.voxel_size = float(voxel_size)
        self.origin = np.asarray(origin, dtype=np.float32).reshape(1, 3)
        self.tsdf_vol = np.asarray(tsdf_vol, dtype=np.float32)

    # -- IO ----------------------------------------------------------------
    def save(self, fname: str) -> None:
        np.savez_compressed(
            fname, origin=self.origin, voxel_size=self.voxel_size,
            tsdf=self.tsdf_vol)

    @classmethod
    def load(cls, fname: str) -> "TSDF":
        with np.load(fname) as data:
            return cls(float(data["voxel_size"]),
                       np.asarray(data["origin"]).reshape(1, 3),
                       np.asarray(data["tsdf"]))

    def copy(self) -> "TSDF":
        return TSDF(self.voxel_size, self.origin.copy(), self.tsdf_vol.copy())

    # -- mesh --------------------------------------------------------------
    def get_mesh(self, device="cpu"
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Extract the zero isosurface on ``device``.

        Matches reference ``tsdf.py:get_mesh`` (:81-114): negate (surface
        front positive), suppress the unknown-empty boundary (==1 after
        negation of -1), clamp to [-1, 1], marching cubes at level 0,
        vertices scaled to world coordinates.

        Returns: (verts [N,3] world-space, faces [M,3], normals [N,3]) as
        numpy arrays.
        """
        vol = -torch.from_numpy(self.tsdf_vol).to(device)
        vol = torch.where(vol == -1, 1.0, vol).clamp(-1, 1)
        if bool(vol.min() >= 0) or bool(vol.max() <= 0):
            z3 = np.zeros((0, 3), np.float32)
            return z3, np.zeros((0, 3), np.int32), z3
        verts, faces, normals = marching_cubes(vol, level=0.0)
        verts = verts.cpu().numpy() * self.voxel_size + self.origin
        return (verts.astype(np.float32), faces.cpu().numpy(),
                normals.cpu().numpy())

    # -- resampling --------------------------------------------------------
    def transform(self, transform: Optional[np.ndarray] = None,
                  voxel_dim: Optional[Sequence[int]] = None,
                  origin=None, device="cpu") -> "TSDF":
        """Resample the TSDF under a 4x4 world-space transform, on
        ``device``.

        Mirrors reference ``tsdf.py:transform`` (:117-178): build the output
        voxel grid, map through ``transform``, sample the old volume with
        nearest interpolation, blend in trilinear samples where |tsdf|<1
        (near surface), and mark voxels that fall outside the old volume
        as empty (+1).  Reproduces the grid_sample(align_corners=False)
        coordinate convention including its normalize-by-(dim-1) quirk.
        """
        old_dim = self.tsdf_vol.shape
        if transform is None:
            transform = np.eye(4, dtype=np.float32)
        if voxel_dim is None:
            voxel_dim = [int(d) for d in old_dim]
        if origin is None:
            origin = self.origin
        origin = np.asarray(origin, dtype=np.float32).reshape(1, 3)

        f32 = dict(dtype=torch.float32, device=device)
        vs = torch.tensor(self.voxel_size, **f32)
        coords = coordinates_grid(voxel_dim, device).float()       # [3, P]
        world = coords * vs + torch.as_tensor(origin.T, **f32)
        world = torch.cat([world, torch.ones_like(world[:1])])
        world = torch.as_tensor(np.asarray(transform, np.float32)[:3, :],
                                **f32) @ world
        coords = (world - torch.as_tensor(self.origin.T, **f32)) / vs

        # normalized as in the reference: 2*c/(dim-1) - 1, then sampled with
        # the align_corners=False unnormalization ((n+1)*W - 1)/2.
        dim = torch.tensor(old_dim, **f32)[:, None]
        norm = 2.0 * coords / (dim - 1.0) - 1.0
        sample = ((norm + 1.0) * dim - 1.0) / 2.0

        vol = torch.from_numpy(self.tsdf_vol).to(device)
        nearest = _sample_nearest(vol, sample)
        out = torch.where(nearest.abs() < 1, _sample_trilinear(vol, sample),
                          nearest.double()).float()
        out = torch.where((norm.abs() >= 1).any(0), 1.0, out)
        out = out.reshape(tuple(int(d) for d in voxel_dim))
        return TSDF(self.voxel_size, origin, out.cpu().numpy())


def _clip_index(p: torch.Tensor, dims: Sequence[int]) -> torch.Tensor:
    return torch.stack([p[a].clamp(0, dims[a] - 1) for a in range(3)])


def _sample_nearest(vol: torch.Tensor, sample: torch.Tensor) -> torch.Tensor:
    # round-half-to-even like torch grid_sample nearest (nearbyint)
    p = _clip_index(torch.round(sample).long(), vol.shape)
    return vol[p[0], p[1], p[2]]


def _sample_trilinear(vol: torch.Tensor, sample: torch.Tensor
                      ) -> torch.Tensor:
    """In float64, as numpy promotes ``sample - floor index`` there."""
    fl = torch.floor(sample)
    f = sample.double() - fl.double()
    p0 = fl.long()
    vol = vol.double()
    x0, y0, z0 = _clip_index(p0, vol.shape)
    x1, y1, z1 = _clip_index(p0 + 1, vol.shape)
    fx, fy, fz = f[0], f[1], f[2]

    def c(xi, yi, zi):
        return vol[xi, yi, zi]
    return (((c(x0, y0, z0) * (1 - fx) + c(x1, y0, z0) * fx) * (1 - fy)
             + (c(x0, y1, z0) * (1 - fx) + c(x1, y1, z0) * fx) * fy)
            * (1 - fz)
            + ((c(x0, y0, z1) * (1 - fx) + c(x1, y0, z1) * fx) * (1 - fy)
               + (c(x0, y1, z1) * (1 - fx) + c(x1, y1, z1) * fx) * fy)
            * fz)

"""Synthetic scenes and parameters for driving the port without a dataset or
a checkpoint: bench.py's ring of cameras, a sphere TSDF and bench.py's
parameter recipe, all made from a seed."""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def ring_projections(n_views: int, height: int, width: int,
                     voxel_dim: Sequence[int], voxel_size: float = 0.04
                     ) -> np.ndarray:
    """[V, 3, 4] full-resolution projections (intrinsics @ world-to-camera)
    of cameras on a ring 3 m around the volume centre, 0.5 m up, looking
    at it (``bench.py:158-176``)."""
    center = np.asarray(voxel_dim, np.float64) * voxel_size / 2
    intr = np.array([[580.0 * width / 640, 0, width / 2],
                     [0, 580.0 * height / 480, height / 2], [0, 0, 1]],
                    np.float32)
    projs = []
    for i in range(n_views):
        a = 2 * np.pi * i / n_views
        eye = center + np.array([3.0 * np.cos(a), 3.0 * np.sin(a), 0.5])
        fwd = center - eye
        fwd = fwd / np.linalg.norm(fwd)
        right = np.cross(fwd, [0, 0, 1.0])
        right /= np.linalg.norm(right)
        up = np.cross(right, fwd)
        E = np.eye(4, dtype=np.float32)            # camera-to-world
        E[:3, 0], E[:3, 1], E[:3, 2], E[:3, 3] = right, -up, fwd, eye
        projs.append(intr @ np.linalg.inv(E)[:3])
    return np.stack(projs).astype(np.float32)


def sphere_tsdf(voxel_dim: Sequence[int], voxel_size: float,
                radius: float, trunc: float) -> torch.Tensor:
    """[X, Y, Z] fp32 truncated signed distance (in units of ``trunc``,
    clipped to [-1, 1]) to a sphere at the volume centre."""
    axes = [(torch.arange(n, dtype=torch.float64) + 0.5) * voxel_size
            for n in voxel_dim]
    gx, gy, gz = torch.meshgrid(*axes, indexing="ij")
    c = [n * voxel_size / 2 for n in voxel_dim]
    r = torch.sqrt((gx - c[0]) ** 2 + (gy - c[1]) ** 2 + (gz - c[2]) ** 2)
    return ((r - radius) / trunc).clamp(-1.0, 1.0).float()


@torch.no_grad()
def synthesize_parameters(module: torch.nn.Module, seed: int) -> None:
    """bench.py's recipe (``bench.py:226-239``): every floating parameter
    and buffer drawn from N(0, 0.02), variance buffers as |N(0, 0.02)| + 1
    so the eval BatchNorms stay finite.  Deterministic in ``seed``."""
    g = torch.Generator().manual_seed(seed)
    for name, t in module.state_dict().items():
        if not t.is_floating_point():
            continue
        draw = torch.randn(t.shape, generator=g, dtype=torch.float32) * 0.02
        if name.endswith("running_var"):
            draw = draw.abs() + 1.0
        t.copy_(draw)

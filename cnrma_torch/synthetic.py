"""Synthetic scenes and parameters for driving the port without a dataset or
a checkpoint: bench.py's ring of cameras, a sphere TSDF, bench.py's
parameter recipe, whole ScanNet scenes on disk (``write_scannet``) and
stage-2 point dumps of them (``write_point_dumps``), all made from a
seed."""

from __future__ import annotations

import os
import pickle
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from PIL import Image


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


# NYU40 ids of the planted objects (ScanNet's table, chair, bed, cabinet)
_ROOM_OBJECTS = ((0.35, 0.35, 0.40, 0.20, 0.15, 0.20, 7),
                 (0.62, 0.40, 0.25, 0.08, 0.08, 0.25, 5),
                 (0.40, 0.68, 0.30, 0.25, 0.18, 0.15, 4),
                 (0.75, 0.75, 0.50, 0.10, 0.20, 0.40, 3))
_SCANNET_CAT_IDS = (3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24, 28, 33, 34,
                    36, 39)


def room_boxes(extent: Sequence[float]) -> np.ndarray:
    """[4, 7] planted objects of a room of ``extent`` metres: gravity-center
    (cx, cy, cz, dx, dy, dz) and the NYU40 category id.  Positions and
    sizes are fractions of the extent (z of the height, capped at 3 m)."""
    ex, ey, ez = (float(e) for e in extent)
    h = min(ez, 3.0)
    rows = [(fx * ex, fy * ey, fz * h, sx * ex, sy * ey, sz * h, cat)
            for fx, fy, fz, sx, sy, sz, cat in _ROOM_OBJECTS]
    return np.array(rows, np.float32)


def room_tsdf(dim: Sequence[int], voxel_size: float, extent: Sequence[float],
              boxes: np.ndarray, trunc: float = 0.12) -> np.ndarray:
    """[X, Y, Z] TSDF (in units of ``trunc``, clipped to [-1, 1]; positive in
    free space) of a room of ``extent`` metres from the grid origin: its
    floor, four walls 0.1 m inside the extent, and solid ``boxes``."""
    axes = [(np.arange(n, dtype=np.float32) + 0.5) * voxel_size
            for n in dim]
    x, y, z = np.meshgrid(*axes, indexing="ij")
    ex, ey, _ = extent
    sdf = np.minimum.reduce([x - 0.1, ex - 0.1 - x, y - 0.1, ey - 0.1 - y,
                             z - 0.05])
    for cx, cy, cz, dx, dy, dz in boxes[:, :6]:
        q = np.stack([np.abs(x - cx) - dx / 2, np.abs(y - cy) - dy / 2,
                      np.abs(z - cz) - dz / 2])
        outside = np.linalg.norm(np.maximum(q, 0.0), axis=0)
        box = outside + np.minimum(q.max(axis=0), 0.0)
        sdf = np.minimum(sdf, box)
    return np.clip(sdf / trunc, -1.0, 1.0).astype(np.float32)


def _look_at(eye: np.ndarray, target: np.ndarray) -> np.ndarray:
    """Camera-to-world pose, ScanNet's camera axes (x right, y down, z
    forward)."""
    fwd = target - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, [0.0, 0.0, 1.0])
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    pose = np.eye(4)
    pose[:3, 0], pose[:3, 1], pose[:3, 2], pose[:3, 3] = right, down, fwd, eye
    return pose


def write_scannet(root: str, n_scenes: int = 2, n_frames: int = 60,
                  tsdf_dim: Tuple[int, int, int] = (208, 208, 80),
                  voxel_size: float = 0.04, image_size=(1296, 968),
                  seed: int = 0, ann_name: str = "scannet_infos_val.pkl",
                  target: Optional[Sequence[float]] = None,
                  radius: Optional[float] = None) -> str:
    """Write ``n_scenes`` synthetic scenes in ScanNet's on-disk layout, as
    ``data/scannet.py`` reads it, and return the infos file's path:

    * ``posed_images/{scene}/{id:05d}.jpg`` (``image_size`` JPEG frames of
      a smooth random pattern), ``{id:05d}.txt`` camera-to-world poses on a
      ring of ``radius`` (0.3 of the room's width) around ``target`` (the
      room's centre, a third of its height up), 0.3 ``radius`` above it and
      looking at it, ``intrinsic.txt``;
    * ``atlas_tsdf/{scene}/tsdf_{04,08,16}.npz``: a room (floor, walls, four
      boxes) over ``tsdf_dim`` voxels at ``voxel_size`` and the two coarser
      scales, origin 0;
    * ``scannet_instance_data/{scene}_aligned_bbox.npy``: the planted boxes
      (gravity-center z, NYU40 id last), for ``evaluate_bbox``;
    * ``{ann_name}``: the infos pickle."""
    rng = np.random.RandomState(seed)
    w, h = image_size
    extent = np.asarray(tsdf_dim, np.float64) * voxel_size
    center = np.asarray(target if target is not None else
                        (extent[0] / 2, extent[1] / 2,
                         min(extent[2], 3.0) / 3), np.float64)
    radius = radius or 0.3 * min(extent[0], extent[1])
    intrinsic = np.array([[1170.0 * w / 1296, 0, w / 2, 0],
                          [0, 1170.0 * h / 968, h / 2, 0],
                          [0, 0, 1, 0], [0, 0, 0, 1]])
    gt_dir = os.path.join(root, "scannet_instance_data")
    os.makedirs(gt_dir, exist_ok=True)
    infos: List[dict] = []
    for s in range(n_scenes):
        scene = f"scene{s:04d}_00"
        posed = os.path.join(root, "posed_images", scene)
        os.makedirs(posed, exist_ok=True)
        np.savetxt(os.path.join(posed, "intrinsic.txt"), intrinsic)
        for i in range(n_frames):
            small = rng.randint(0, 255, (h // 16, w // 16, 3), np.uint8)
            Image.fromarray(small).resize((w, h), Image.BILINEAR).save(
                os.path.join(posed, f"{i:05d}.jpg"), quality=90)
            a = 2 * np.pi * i / n_frames
            eye = center + radius * np.array([np.cos(a), np.sin(a), 0.3])
            np.savetxt(os.path.join(posed, f"{i:05d}.txt"),
                       _look_at(eye, center))
        boxes = room_boxes(extent)
        tsdf_dir = os.path.join(root, "atlas_tsdf", scene)
        os.makedirs(tsdf_dir, exist_ok=True)
        for k in (1, 2, 4):
            vs = voxel_size * k
            np.savez_compressed(
                os.path.join(tsdf_dir, f"tsdf_{int(round(vs * 100)):02d}.npz"),
                origin=np.zeros((1, 3), np.float32), voxel_size=vs,
                tsdf=room_tsdf([d // k for d in tsdf_dim], vs, extent, boxes))
        np.save(os.path.join(gt_dir, scene + "_aligned_bbox.npy"), boxes)
        infos.append({
            "scene": scene,
            "total_image_ids": list(range(n_frames)),
            "annos": {
                "gt_num": len(boxes),
                "gt_boxes_upright_depth": boxes[:, :6].copy(),
                "class": np.array([_SCANNET_CAT_IDS.index(int(c))
                                   for c in boxes[:, 6]]),
                "axis_align_matrix": np.eye(4, dtype=np.float32),
            }})
    ann = os.path.join(root, ann_name)
    with open(ann, "wb") as f:
        pickle.dump(infos, f)
    return ann


def room_surface_points(extent: Sequence[float], boxes: np.ndarray, n: int,
                        rng: np.random.RandomState) -> np.ndarray:
    """[n, 3] points drawn uniformly (by area) on the surfaces of
    ``room_tsdf``'s room: its floor, four walls up to the room's height
    (capped at 3 m) and the six faces of each gravity-center box [M, 6+]."""
    ex, ey, ez = (float(e) for e in extent)
    h = min(ez, 3.0)
    # (axis of the plane, its coordinate, the low and high corners)
    planes = [(2, 0.05, (0.1, 0.1), (ex - 0.1, ey - 0.1))]
    for axis, c, lo, hi in ((0, 0.1, (0.1, 0.05), (ey - 0.1, h)),
                            (0, ex - 0.1, (0.1, 0.05), (ey - 0.1, h)),
                            (1, 0.1, (0.1, 0.05), (ex - 0.1, h)),
                            (1, ey - 0.1, (0.1, 0.05), (ex - 0.1, h))):
        planes.append((axis, c, lo, hi))
    for cx, cy, cz, dx, dy, dz in boxes[:, :6]:
        ctr, half = np.array([cx, cy, cz]), np.array([dx, dy, dz]) / 2
        for axis in range(3):
            rest = [a for a in range(3) if a != axis]
            lo = tuple(ctr[rest] - half[rest])
            hi = tuple(ctr[rest] + half[rest])
            for sign in (-1, 1):
                planes.append((axis, ctr[axis] + sign * half[axis], lo, hi))
    area = np.array([(hi[0] - lo[0]) * (hi[1] - lo[1])
                     for _, _, lo, hi in planes])
    which = rng.choice(len(planes), n, p=area / area.sum())
    u = rng.rand(n, 2)
    pts = np.empty((n, 3), np.float32)
    for i, (axis, c, lo, hi) in enumerate(planes):
        m = which == i
        rest = [a for a in range(3) if a != axis]
        pts[m, axis] = c
        pts[m, rest[0]] = lo[0] + u[m, 0] * (hi[0] - lo[0])
        pts[m, rest[1]] = lo[1] + u[m, 1] * (hi[1] - lo[1])
    return pts


def write_point_dumps(root: str, points_dir: str, n_points: int = 600000,
                      seed: int = 0) -> List[str]:
    """Write a stage-2.1 dump, ``{points_dir}/{scene}_vert.npy``, for each
    scene of ``write_scannet``'s training split
    (``{root}/scannet_infos_train.pkl``): ``n_points`` rows
    of xyz on the room's GT surface (``room_surface_points``, its extent
    from the scene's ``tsdf_04``) and 32 feature columns of N(0, 1), fp32,
    drawn from ``seed``.  Returns the paths written."""
    rng = np.random.RandomState(seed)
    with open(os.path.join(root, "scannet_infos_train.pkl"), "rb") as f:
        infos = sorted(pickle.load(f), key=lambda x: x["scene"])
    os.makedirs(points_dir, exist_ok=True)
    paths = []
    for info in infos:
        scene = info["scene"]
        with np.load(os.path.join(root, "atlas_tsdf", scene,
                                  "tsdf_04.npz")) as z:
            extent = np.asarray(z["tsdf"].shape) * float(z["voxel_size"])
        boxes = np.asarray(info["annos"]["gt_boxes_upright_depth"],
                           np.float32)
        xyz = room_surface_points(extent, boxes, n_points, rng)
        feats = rng.randn(n_points, 32).astype(np.float32)
        path = os.path.join(points_dir, scene + "_vert.npy")
        np.save(path, np.concatenate([xyz, feats], axis=1))
        paths.append(path)
    return paths

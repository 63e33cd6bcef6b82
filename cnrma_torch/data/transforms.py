"""Host-side data pipeline transforms, a copy of
``cnrma_tpu/data/transforms.py``.

Replaces the reference's mmcv pipeline stages
(``datasets/pipelines/atlas_transforms.py`` and the space-crop part of
``fcaf3d_transforms.py``): image resize/pad + intrinsics rescale with PIL,
intrinsics/pose -> projection, and the world-space transforms that crop the
GT TSDFs to the voxel grid: the detection crops and the stage-1 recon
augmentations (a random z-rotation and crop; a fixed shift at test time).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
from PIL import Image

from cnrma_torch.geometry.boxes import DepthBoxes
from cnrma_torch.geometry.tsdf import TSDF


def pad_scannet_image(img: Image.Image, intrinsic: np.ndarray
                      ) -> Tuple[Image.Image, np.ndarray]:
    """ScanNet 1296x968 -> 1296x972 vertical pad (4:3), cy += 2
    (reference ``atlas_transforms.py:60-69``)."""
    w, h = img.size
    if w == 1296 and h == 968:
        padded = Image.new(img.mode, (1296, 972))
        padded.paste(img, (0, 2))
        intrinsic = intrinsic.copy()
        intrinsic[1, 2] += 2
    return (padded if (w, h) == (1296, 968) else img), intrinsic


def resize_image(img: Image.Image, intrinsic: np.ndarray,
                 size: Tuple[int, int] = (640, 480)
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Bilinear resize + intrinsics rescale
    (reference ``AtlasResizeImage``, ``atlas_transforms.py:71-94``)."""
    img, intrinsic = pad_scannet_image(img, intrinsic)
    w, h = img.size
    img = img.resize(size, Image.BILINEAR)
    intrinsic = intrinsic.copy()
    intrinsic[0, :] /= (w / size[0])
    intrinsic[1, :] /= (h / size[1])
    return np.asarray(img, dtype=np.float32), intrinsic.astype(np.float32)


def projection_from(intrinsic: np.ndarray, extrinsic: np.ndarray
                    ) -> np.ndarray:
    """projection = K @ E^-1 [:3]
    (``AtlasIntrinsicsPoseToProjection``, ``atlas_transforms.py:97-110``)."""
    return (intrinsic @ np.linalg.inv(extrinsic)[:3, :]).astype(np.float32)


def transform_space(extrinsics: List[np.ndarray],
                    tsdf_dict: Dict[str, TSDF],
                    transform: np.ndarray,
                    voxel_dim: Sequence[int],
                    origin: Sequence[float]
                    ) -> Tuple[List[np.ndarray], Dict[str, TSDF]]:
    """Apply a world transform: rewrite extrinsics, resample all GT TSDF
    scales to the target grid (reference ``transform_space``,
    ``atlas_transforms.py:114-129``)."""
    inv = np.linalg.inv(transform)
    new_ext = [inv @ e for e in extrinsics]
    sizes = sorted(int(k[8:]) for k in tsdf_dict)
    new_tsdf = {}
    for vs in sizes:
        scale = vs / sizes[0]
        vd = [int(d / scale) for d in voxel_dim]
        key = f"tsdf_gt_{str(vs).zfill(3)}"
        new_tsdf[key] = tsdf_dict[key].transform(transform, vd, origin)
    return new_ext, new_tsdf


def space_transform_detection(extrinsics, tsdf_dict, gt_boxes: DepthBoxes,
                              voxel_dim, origin=(0, 0, 0), test=False,
                              mode="middle"):
    """Detection-path crop (``AtlasTransformSpaceDetection``,
    ``fcaf3d_transforms.py:204-266``): 'middle' centers the scene in the
    voxel grid (train), 'origin' anchors at the scene origin (test); returns
    the offset needed to restore world coordinates.
    """
    tsdf = tsdf_dict["tsdf_gt_004"]
    if mode == "middle":
        span = np.array(tsdf.tsdf_vol.shape) * tsdf.voxel_size
        start = tsdf.origin[0].astype(np.float64)
        end = (start + span
               - np.asarray(voxel_dim) * tsdf.voxel_size)
        t = -(0.5 * start + 0.5 * end)
    elif mode == "origin":
        shift = np.floor_divide(np.array([0.5, 0.5, 0.5]),
                                tsdf.voxel_size)
        t = shift * tsdf.voxel_size - tsdf.origin[0]
    else:
        raise ValueError(mode)
    t = t.astype(np.float32)

    if test:
        offset = -t
    else:
        offset = np.asarray(origin, np.float32)
        gt_boxes = gt_boxes.copy()
        gt_boxes.translate(t)

    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = t
    new_ext, new_tsdf = transform_space(
        extrinsics, tsdf_dict, np.linalg.inv(T), voxel_dim, origin)
    return new_ext, new_tsdf, gt_boxes, offset


def space_transform_recon_random(rng: np.random.RandomState, extrinsics,
                                 tsdf_dict, voxel_dim, origin=(0, 0, 0),
                                 random_rotation=True,
                                 random_translation=True,
                                 padding_xy=1.5, padding_z=0.25):
    """Random z-rotation + crop for recon pretraining
    (``AtlasRandomTransformSpaceRecon``, ``atlas_transforms.py:132-205``)."""
    tsdf = tsdf_dict["tsdf_gt_004"]
    r = rng.rand() * 2 * np.pi if random_rotation else 0.0
    R = np.array([[np.cos(r), -np.sin(r)], [np.sin(r), np.cos(r)]],
                 np.float32)
    span = np.array(tsdf.tsdf_vol.shape) * tsdf.voxel_size
    o = tsdf.origin[0]
    corners = np.array([[o[0], o[0], o[0] + span[0], o[0] + span[0]],
                        [o[1], o[1] + span[1], o[1], o[1] + span[1]]],
                       np.float32)
    corners = R @ corners
    xmin, xmax = corners[0].min(), corners[0].max()
    ymin, ymax = corners[1].min(), corners[1].max()
    zmin, zmax = o[2], o[2] + span[2]

    start = (np.array([xmin, ymin, zmin])
             - np.array([padding_xy, padding_xy, padding_z]))
    end = (np.array([xmax, ymax, zmax])
           + np.array([padding_xy, padding_xy, 0.0])
           - np.asarray(voxel_dim) * tsdf.voxel_size)
    t = rng.rand(3) if random_translation else 0.5
    t = t * start + (1 - t) * end

    T = np.eye(4, dtype=np.float32)
    T[:2, :2] = R
    T[:3, 3] = -t
    offset = (-t).astype(np.float32)
    new_ext, new_tsdf = transform_space(
        extrinsics, tsdf_dict, np.linalg.inv(T), voxel_dim, origin)
    return new_ext, new_tsdf, offset


def space_transform_recon_test(extrinsics, tsdf_dict, voxel_dim,
                               origin=(0, 0, 0)):
    """Deterministic half-meter-aligned shift for recon eval
    (``AtlasTestTransformSpaceRecon``, ``atlas_transforms.py:207-227``)."""
    tsdf = tsdf_dict["tsdf_gt_004"]
    shift = np.floor_divide(np.array([0.5, 0.5, 0.5]), tsdf.voxel_size)
    offset = (tsdf.origin[0] - shift * tsdf.voxel_size).astype(np.float32)
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = offset
    new_ext, new_tsdf = transform_space(extrinsics, tsdf_dict, T,
                                        voxel_dim, origin)
    return new_ext, new_tsdf, offset


def select_frames(total_ids: List, num_frames: int, select_type: str,
                  rng: Optional[np.random.RandomState] = None) -> List:
    """'random' sample or 'unit' stride selection
    (``scannet_dataset.py:55-71``)."""
    if num_frames <= 0 or num_frames > len(total_ids):
        ids = list(total_ids)
    elif select_type == "random":
        rng = rng or np.random.RandomState()
        ids = [total_ids[i] for i in
               rng.choice(len(total_ids), num_frames, replace=False)]
    elif select_type == "unit":
        m, n = len(total_ids), num_frames
        k = (m - 1) // (n - 1)
        ids = [total_ids[i * k] for i in range(n)]
    else:
        raise ValueError(select_type)
    try:
        ids.sort(key=float)
    except (TypeError, ValueError):
        ids.sort()
    return ids

"""Oriented-box geometry for ARKitScenes annotation extraction.

A copy of the JAX package's ``tools/data_prepare/arkit_boxes.py``, its
``box3d_iou`` on the port's rotated IoU (``cnrma_torch.ops.iou3d``, CPU
tensors).  Like the JAX module, it re-implements (vectorized, no per-box
Python loops) the semantics of the reference's
``data_prepare/arkit/box_utils.py`` + ``rotation.py``:

* ``normalizedAxes`` stores the box axes as ROWS of N; world corners are
  ``N.T @ template`` (``compute_box_3d``, box_utils.py:40-62);
* the stored 7-DoF heading is the CLOCKWISE z angle recovered from corner
  0 -> 1 (``get_heading_angle``, box_utils.py:26-37) — note this is the
  NEGATIVE of the usual counter-clockwise yaw;
* ``rotate_points_along_z`` (rotation.py:104-138) rotates row-vector points
  clockwise by the angle, making ``boxes_to_corners_3d`` the exact inverse
  of ``corners_to_boxes`` for upright boxes;
* ``points_in_boxes`` (box_utils.py:129-167) uses the three edge-projection
  interval tests;
* ``box3d_iou`` BEV polygon clipping reuses the port's rotated IoU.
"""

from __future__ import annotations

import numpy as np

# corner template (order matches box_utils.py:92-127 figure):
#     7 -------- 4
#    /|         /|
#   6 -------- 5 .
#   | |        | |
#   . 3 -------- 0
#   |/         |/
#   2 -------- 1
CORNER_TEMPLATE = np.array([
    [1, 1, -1], [1, -1, -1], [-1, -1, -1], [-1, 1, -1],
    [1, 1, 1], [1, -1, 1], [-1, -1, 1], [-1, 1, 1]], np.float64) / 2.0


def compute_box_3d(size, center, rotmat) -> np.ndarray:
    """OBB (axesLengths, centroid, normalizedAxes-rows) -> [8,3] corners."""
    size = np.asarray(size, np.float64).reshape(3)
    center = np.asarray(center, np.float64).reshape(3)
    N = np.asarray(rotmat, np.float64).reshape(3, 3)
    # reference corner order: x [l,l,-l,-l,l,l,-l,-l], y [h,-h,-h,h,...],
    # z [w,w,w,w,-w,-w,-w,-w] == CORNER_TEMPLATE * size
    local = CORNER_TEMPLATE * size[None, :]
    return local @ N + center[None, :]


def get_size(corners: np.ndarray) -> np.ndarray:
    """[...,8,3] corners -> [...,3] (dx, dy, dz) edge lengths."""
    corners = np.asarray(corners, np.float64)
    dx = np.linalg.norm(corners[..., 0, :] - corners[..., 3, :], axis=-1)
    dy = np.linalg.norm(corners[..., 0, :] - corners[..., 1, :], axis=-1)
    dz = np.linalg.norm(corners[..., 0, :] - corners[..., 4, :], axis=-1)
    return np.stack([dx, dy, dz], axis=-1)


def get_heading_angle(corners: np.ndarray) -> np.ndarray:
    """[...,8,3] corners -> clockwise z heading (box_utils.py:26-37)."""
    d = corners[..., 0, :] - corners[..., 1, :]
    return np.arctan2(d[..., 0], d[..., 1])


def rotate_points_along_z(points: np.ndarray, angle) -> np.ndarray:
    """Rotate [...,N,3+] row-vector points CLOCKWISE by ``angle`` [...]."""
    points = np.asarray(points, np.float64)
    c = np.cos(np.asarray(angle, np.float64))[..., None]   # [..., 1]
    s = np.sin(np.asarray(angle, np.float64))[..., None]
    x, y = points[..., 0], points[..., 1]                  # [..., N]
    # row-vector p @ [[c,-s,0],[s,c,0],[0,0,1]] = (x*c + y*s, -x*s + y*c)
    xr = x * c + y * s
    yr = -x * s + y * c
    return np.concatenate([xr[..., None], yr[..., None],
                           points[..., 2:]], axis=-1)


def corners_to_boxes(corners: np.ndarray) -> np.ndarray:
    """[N,8,3] corners -> [N,7] (cx,cy,cz,dx,dy,dz,heading)."""
    corners = np.asarray(corners, np.float64)
    centers = corners.mean(axis=-2)
    return np.concatenate([centers, get_size(corners),
                           get_heading_angle(corners)[..., None]], axis=-1)


def boxes_to_corners_3d(boxes: np.ndarray) -> np.ndarray:
    """[N,7] boxes -> [N,8,3] corners (inverse of ``corners_to_boxes``)."""
    boxes = np.asarray(boxes, np.float64)
    local = boxes[:, None, 3:6] * CORNER_TEMPLATE[None, :, :]
    return rotate_points_along_z(local, boxes[:, 6]) + boxes[:, None, :3]


def points_in_boxes(points: np.ndarray, corners: np.ndarray) -> np.ndarray:
    """[n,3+] points x [m,8,3] box corners -> [n,m] membership mask.

    Interval test along the three box edge directions meeting at corner 6
    (box_utils.py:129-167).
    """
    points = np.asarray(points, np.float64)[:, :3]
    corners = np.asarray(corners, np.float64)
    if len(corners) == 0:
        return np.zeros((points.shape[0], 1), bool)
    mask = np.ones((points.shape[0], corners.shape[0]), bool)
    for a in (5, 7, 2):
        e = corners[:, 6, :] - corners[:, a, :]          # [m,3]
        px = points @ e.T                                # [n,m]
        hi = np.sum(e * corners[:, 6, :], axis=1)        # [m]
        lo = np.sum(e * corners[:, a, :], axis=1)
        mask &= (px <= hi[None, :]) & (px >= lo[None, :])
    return mask


def box3d_iou(corners1: np.ndarray, corners2: np.ndarray) -> float:
    """3D IoU of two [8,3] corner boxes (upright; BEV polygon clip x z
    overlap — box_utils.py:242-268)."""
    import torch

    from cnrma_torch.ops.iou3d import rotated_iou_3d

    b = []
    for c in (corners1, corners2):
        box7 = corners_to_boxes(np.asarray(c)[None])[0]
        # our iou3d uses CCW yaw; stored heading is clockwise
        box7[6] = -box7[6]
        b.append(box7)
    return float(rotated_iou_3d(
        torch.as_tensor(b[0][None], dtype=torch.float32),
        torch.as_tensor(b[1][None], dtype=torch.float32))[0])

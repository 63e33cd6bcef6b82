"""Depth-frame 3D box structure (gravity-aligned, optional yaw); a copy of
``cnrma_tpu/geometry/boxes.py``.

Numpy replacement for mmdet3d ``DepthInstance3DBoxes`` as used by the
reference (datasets ``scannet_dataset.py:127-128``, augmentation
``fcaf3d_transforms.py:71-126``, assigner ``fcaf3d_head.py:425-435``).

Convention (same as mmdet3d Depth boxes):
  tensor [N, 6|7] = (cx, cy, z_bottom, dx, dy, dz[, yaw]); yaw rotates
  around +z.  ``origin=(0.5,0.5,0.5)`` inputs (gravity-center z) are shifted
  to bottom-center storage.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def _rot_mat_z(angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], dtype=np.float32)


class DepthBoxes:
    def __init__(self, tensor, box_dim: Optional[int] = None,
                 with_yaw: bool = True, origin: Tuple[float, float, float] = (0.5, 0.5, 0)):
        tensor = np.asarray(tensor, dtype=np.float32).reshape(-1, box_dim or
                                                              (np.asarray(tensor).shape[-1] if np.asarray(tensor).size else 7))
        if box_dim is None:
            box_dim = tensor.shape[-1] if tensor.size else 7
        if box_dim == 6:
            with_yaw = False
            tensor = np.concatenate(
                [tensor, np.zeros((len(tensor), 1), np.float32)], axis=1)
        self.tensor = tensor.astype(np.float32)
        self.box_dim = box_dim
        self.with_yaw = with_yaw
        # shift origin to bottom center (mmdet3d default dst origin (.5,.5,0))
        dst = np.array((0.5, 0.5, 0.0), np.float32)
        src = np.array(origin, np.float32)
        if len(self.tensor):
            self.tensor[:, :3] += self.tensor[:, 3:6] * (dst - src)

    def __len__(self) -> int:
        return len(self.tensor)

    def copy(self) -> "DepthBoxes":
        b = DepthBoxes.__new__(DepthBoxes)
        b.tensor = self.tensor.copy()
        b.box_dim = self.box_dim
        b.with_yaw = self.with_yaw
        return b

    # -- derived quantities ------------------------------------------------
    @property
    def gravity_center(self) -> np.ndarray:
        out = self.tensor[:, :3].copy()
        out[:, 2] += self.tensor[:, 5] * 0.5
        return out

    @property
    def dims(self) -> np.ndarray:
        return self.tensor[:, 3:6]

    @property
    def yaw(self) -> np.ndarray:
        return self.tensor[:, 6]

    @property
    def volume(self) -> np.ndarray:
        return self.tensor[:, 3] * self.tensor[:, 4] * self.tensor[:, 5]

    @property
    def corners(self) -> np.ndarray:
        """[N, 8, 3] box corners (yaw applied around gravity center z-axis)."""
        if len(self.tensor) == 0:
            return np.zeros((0, 8, 3), np.float32)
        dims = self.dims
        signs = np.array([[dx, dy, dz]
                          for dx in (-0.5, 0.5) for dy in (-0.5, 0.5)
                          for dz in (0.0, 1.0)], np.float32)
        local = signs[None] * dims[:, None, :]          # z from bottom
        local[:, :, 2] -= 0.0
        # rotate xy by yaw
        c, s = np.cos(self.yaw), np.sin(self.yaw)
        x = local[:, :, 0] * c[:, None] - local[:, :, 1] * s[:, None]
        y = local[:, :, 0] * s[:, None] + local[:, :, 1] * c[:, None]
        out = np.stack([x, y, local[:, :, 2]], axis=-1)
        out += self.tensor[:, None, :3]
        return out

    # -- in-place transforms (mirror mmdet3d semantics) --------------------
    def translate(self, trans) -> None:
        self.tensor[:, :3] += np.asarray(trans, np.float32).reshape(3)

    def scale(self, factor: float) -> None:
        self.tensor[:, :6] *= float(factor)

    def rotate(self, angle: float) -> None:
        rot = _rot_mat_z(angle)
        self.tensor[:, :3] = self.tensor[:, :3] @ rot.T
        if self.with_yaw:
            self.tensor[:, 6] += angle
        else:
            # axis-aligned: replace xy dims with the rotated enclosing box
            corners = self.corners
            rot_corners = corners @ rot.T
            self.tensor[:, 3] = (rot_corners[:, :, 0].max(1)
                                 - rot_corners[:, :, 0].min(1))
            self.tensor[:, 4] = (rot_corners[:, :, 1].max(1)
                                 - rot_corners[:, :, 1].min(1))

    def flip(self, direction: str = "horizontal") -> None:
        if direction == "horizontal":
            self.tensor[:, 0] = -self.tensor[:, 0]
            if self.with_yaw:
                self.tensor[:, 6] = np.pi - self.tensor[:, 6]
        elif direction == "vertical":
            self.tensor[:, 1] = -self.tensor[:, 1]
            if self.with_yaw:
                self.tensor[:, 6] = -self.tensor[:, 6]
        else:
            raise ValueError(direction)

    # -- export ------------------------------------------------------------
    def gravity_tensor(self) -> np.ndarray:
        """[N,7] with gravity-center z (format fed to the assigner/loss)."""
        out = self.tensor.copy()
        out[:, 2] += out[:, 5] * 0.5
        return out

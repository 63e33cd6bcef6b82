"""ARKitScenes multi-view scene dataset, a copy of ``cnrma_tpu/data/arkit.py``.

Reads the reference's layout (``datasets/arkit_dataset.py``): an infos pkl
with either inline ``image_paths``/``intrinsics``/``extrinsics`` or the raw
``{split}/{scene}/{scene}_frames`` tree (``lowres_wide.traj`` axis-angle
poses inverted to camera-to-world, per-frame ``.pincam`` intrinsics with a
±0.001 s timestamp fallback in the file name, ``lowres_wide/*.png``
frames); 7-DoF yaw boxes.  The rest of the sample (frame draw, resize,
space modes, packing) is the ScanNet reader's.
"""

from __future__ import annotations

import os

import numpy as np
from PIL import Image

from cnrma_torch.core.registry import DATASETS
from cnrma_torch.data.scannet import AtlasScanNetDataset


def rodrigues(axis_angle: np.ndarray) -> np.ndarray:
    """Axis-angle -> rotation matrix (replaces cv2.Rodrigues)."""
    theta = np.linalg.norm(axis_angle)
    if theta < 1e-12:
        return np.eye(3)
    k = axis_angle / theta
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return (np.eye(3) + np.sin(theta) * K
            + (1 - np.cos(theta)) * (K @ K))


def parse_traj_line(line: str) -> tuple:
    """A ``lowres_wide.traj`` line (timestamp, axis-angle, translation of
    the world-to-camera transform) -> (timestamp string, the inverse:
    camera-to-world 4x4), the extrinsic used downstream
    (``arkit_dataset.py:31-61``)."""
    tok = line.split()
    ts = tok[0]
    R = rodrigues(np.array([float(t) for t in tok[1:4]]))
    t = np.array([float(t) for t in tok[4:7]])
    M = np.eye(4)
    M[:3, :3] = R
    M[:3, 3] = t
    return ts, np.linalg.inv(M)


def load_pincam(path: str) -> np.ndarray:
    """A ``.pincam`` file (width, height, fx, fy, cx, cy) -> 3x3 intrinsics."""
    w, h, fx, fy, hw, hh = np.loadtxt(path)
    return np.array([[fx, 0, hw], [0, fy, hh], [0, 0, 1]], np.float32)


@DATASETS.register()
class AtlasARKitDataset(AtlasScanNetDataset):
    """Registered under the reference's config name ``AtlasARKitDataset``."""

    def __init__(self, *args, **kwargs):
        kwargs.setdefault("voxel_dim", (192, 192, 80))
        super().__init__(*args, **kwargs)
        self.box_dim = 7
        self.with_yaw = True

    def load_frames(self, info, image_ids):
        scene = info["scene"]
        imgs, intrinsics, extrinsics = [], [], []
        if "image_paths" in info:
            for vid in image_ids:
                img = Image.open(os.path.join(self.data_root,
                                              info["image_paths"][vid]))
                imgs.append(img)
                intrinsics.append(
                    np.asarray(info["intrinsics"][vid], np.float32))
                extrinsics.append(
                    np.asarray(info["extrinsics"][vid], np.float32))
            return imgs, intrinsics, extrinsics

        split = info["split"]
        data_path = os.path.join(self.data_root, split, scene,
                                 f"{scene}_frames")
        poses = {}
        with open(os.path.join(data_path, "lowres_wide.traj")) as f:
            for line in f:
                ts, mat = parse_traj_line(line)
                poses[f"{round(float(ts), 3):.3f}"] = mat
        for vid in image_ids:
            intr_dir = os.path.join(data_path, "lowres_wide_intrinsics")
            cand = [f"{scene}_{vid}.pincam",
                    f"{scene}_{float(vid) - 0.001:.3f}.pincam",
                    f"{scene}_{float(vid) + 0.001:.3f}.pincam"]
            intr_fn = next((os.path.join(intr_dir, c) for c in cand
                            if os.path.exists(os.path.join(intr_dir, c))),
                           None)
            if intr_fn is None:
                raise FileNotFoundError(f"intrinsics for {scene}_{vid}")
            img = Image.open(os.path.join(
                data_path, "lowres_wide", f"{scene}_{vid}.png"))
            if str(vid) in poses:
                pose = poses[str(vid)]
            else:
                # as the JAX reader (ROADMAP F3): the reference tries
                # exactly ts±0.001 and fails (arkit_dataset.py:140-151);
                # this takes the first pose in the trajectory's order
                # within ±0.005 s, which is the nearest one only when a
                # single pose lies in that window
                pose = next((poses[k] for k in poses
                             if abs(float(vid) - float(k)) < 0.005), None)
                if pose is None:
                    raise ValueError(f"pose for {scene}_{vid}")
            if not np.isfinite(pose).all():
                raise ValueError(f"{scene}/{vid} has invalid pose")
            imgs.append(img)
            intrinsics.append(load_pincam(intr_fn))
            extrinsics.append(pose.astype(np.float32))
        return imgs, intrinsics, extrinsics

"""ScanNet multi-view scene dataset, a copy of ``cnrma_tpu/data/scannet.py``:
the detection space modes (``'origin'`` at test time, ``'middle'``) and the
stage-1 recon modes (``'recon_random'``, ``'recon_test'``).

Reads the reference's on-disk layout unchanged
(``datasets/scannet_dataset.py``): ``{ann_file}`` infos pkl with per-scene
``total_image_ids`` + annos; ``posed_images/{scene}/{id:05d}.jpg`` +
per-frame extrinsic ``.txt`` + shared ``intrinsic.txt`` (axis-aligned via
``axis_align_matrix @ extrinsic``); 3-scale GT TSDFs from
``atlas_tsdf/{scene}/tsdf_{04,08,16}.npz``.

Emits fixed-shape numpy dicts (views padded to ``num_frames``, boxes padded
to ``max_gt_boxes``), packed as the JAX package packs them.  The samples
draw from one ``np.random.RandomState(seed)`` as the JAX reader's do, so a
seed gives the same sample in both.  ``draw(i)`` makes a scene's draws and
``load(i, draws)`` reads it; ``dataset[i]`` is the two in turn.  A loader
makes every scene's draws in order on one thread and loads in several
(``data/loader.py``), so the samples do not depend on the thread count.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict, List, Optional

import numpy as np
from PIL import Image

from cnrma_torch.core.registry import DATASETS
from cnrma_torch.data import transforms as T
from cnrma_torch.geometry.boxes import DepthBoxes
from cnrma_torch.geometry.tsdf import TSDF

# the ``recon_pipeline`` keys that decide what ``draw`` draws
RECON_DRAW_KEYS = ("random_rotation", "random_translation")


def load_tsdf_scales(path: str, scene: str, voxel_size: float
                     ) -> Dict[str, TSDF]:
    out = {}
    for i in range(3):
        vs = voxel_size * (2 ** i)
        fname = os.path.join(path, scene,
                             f"tsdf_{str(int(vs * 100)).zfill(2)}.npz")
        with np.load(fname, allow_pickle=True) as data:
            out[f"tsdf_gt_{str(int(vs * 100)).zfill(3)}"] = TSDF(
                vs, np.asarray(data["origin"]).reshape(1, 3),
                np.asarray(data["tsdf"]))
    return out


@DATASETS.register()
class AtlasScanNetDataset:
    """Registered under the reference's config name ``AtlasScanNetDataset``."""

    def __init__(self, data_root: str, ann_file: str,
                 classes: Optional[List[str]] = None,
                 pipeline=None,               # accepted for config compat
                 test_mode: bool = False, num_frames: int = 50,
                 voxel_size: float = 0.04, select_type: str = "random",
                 voxel_dim=(192, 192, 80), space_mode: str = "middle",
                 max_gt_boxes: int = 64, image_size=(640, 480),
                 seed: Optional[int] = None,
                 recon_pipeline: Optional[Dict] = None):
        if pipeline is not None:
            import warnings
            warnings.warn(
                "dataset 'pipeline=' is accepted for reference-config "
                "compatibility only: the transform chain here is the "
                "fixed reference pipeline (resize/pad, space transform, "
                "projection build — data/transforms.py); editing the "
                "pipeline list has NO effect", stacklevel=2)
        self.data_root = data_root
        self.classes = classes
        self.test_mode = test_mode
        self.num_frames = num_frames
        self.voxel_size = voxel_size
        self.select_type = select_type
        self.voxel_dim = tuple(voxel_dim)
        self.space_mode = space_mode
        self.max_gt_boxes = max_gt_boxes
        self.image_size = tuple(image_size)
        self.recon_pipeline = dict(recon_pipeline or {})
        self.rng = np.random.RandomState(seed)
        with open(ann_file, "rb") as f:
            self.data_infos = sorted(pickle.load(f),
                                     key=lambda x: x["scene"])
        self.box_dim = 6
        self.with_yaw = False

    def __len__(self) -> int:
        return len(self.data_infos)

    # -- per-scene raw loading --------------------------------------------
    def load_frames(self, info, image_ids):
        scene = info["scene"]
        root = os.path.join(self.data_root, "posed_images", scene)
        intrinsic = np.loadtxt(os.path.join(root, "intrinsic.txt"),
                               delimiter=" ")[:3, :3].astype(np.float32)
        axis_align = self.get_axis_align(info)
        imgs, intrinsics, extrinsics = [], [], []
        for vid in image_ids:
            vid = str(int(vid)).zfill(5)
            img = Image.open(os.path.join(root, vid + ".jpg"))
            extrinsic = axis_align @ np.loadtxt(
                os.path.join(root, vid + ".txt"))
            if not np.isfinite(extrinsic).all():
                raise ValueError(f"{scene}/{vid} has invalid pose")
            imgs.append(img)
            intrinsics.append(intrinsic.copy())
            extrinsics.append(extrinsic.astype(np.float32))
        return imgs, intrinsics, extrinsics

    def get_axis_align(self, info) -> np.ndarray:
        annos = info.get("annos", {})
        if "axis_align_matrix" in annos:
            return np.asarray(annos["axis_align_matrix"], np.float32)
        return np.eye(4, dtype=np.float32)

    def get_boxes(self, info):
        annos = info.get("annos", {})
        if annos.get("gt_num", 0) != 0:
            raw = np.asarray(annos["gt_boxes_upright_depth"], np.float32)
            labels = np.asarray(annos["class"], np.int64)
        else:
            raw = np.zeros((0, self.box_dim), np.float32)
            labels = np.zeros((0,), np.int64)
        boxes = DepthBoxes(raw, box_dim=raw.shape[-1] if len(raw) else
                           self.box_dim, with_yaw=self.with_yaw,
                           origin=(0.5, 0.5, 0.5))
        return boxes, labels

    # -- sample assembly ---------------------------------------------------
    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        return self.load(index, self.draw(index))

    def draw(self, index: int) -> Dict[str, Any]:
        """Scene ``index``'s random draws from ``self.rng``, in the order
        the JAX reader makes them: the frames (``select_frames``), then in
        ``recon_random`` mode the rotation and the crop's translation.
        How many numbers it draws depends on the scene's info only."""
        info = self.data_infos[index]
        draws = {"image_ids": T.select_frames(
            list(info["total_image_ids"]), self.num_frames,
            self.select_type, self.rng)}
        if self.space_mode == "recon_random":
            draws["recon"] = T.draw_recon_random(self.rng, **{
                k: v for k, v in self.recon_pipeline.items()
                if k in RECON_DRAW_KEYS})
        return draws

    def load(self, index: int, draws: Dict[str, Any]
             ) -> Dict[str, np.ndarray]:
        """Scene ``index``'s sample at the draws of ``draw(index)``: the
        frames' decode and resize, the TSDF resample, the packing.  It
        draws nothing, so several threads may load at once."""
        info = self.data_infos[index]
        scene = info["scene"]
        image_ids = draws["image_ids"]
        imgs, intrinsics, extrinsics = self.load_frames(info, image_ids)
        tsdf_dict = load_tsdf_scales(
            os.path.join(self.data_root, "atlas_tsdf"), scene,
            self.voxel_size)
        boxes, labels = self.get_boxes(info)

        resized, res_intr = [], []
        for img, K in zip(imgs, intrinsics):
            im, k = T.resize_image(img, K, self.image_size)
            resized.append(im)
            res_intr.append(k)

        # space-mode dispatch: detection crops ('middle'/'origin') vs the
        # stage-1 recon augmentations (reference
        # ``atlas_transforms.py:132-227``); the recon path leaves GT boxes
        # untouched (the Atlas model has no detection branch)
        if self.space_mode == "recon_random":
            extrinsics, tsdf_dict, offset = T.space_transform_recon_random(
                draws["recon"], extrinsics, tsdf_dict, self.voxel_dim,
                **{k: v for k, v in self.recon_pipeline.items()
                   if k not in RECON_DRAW_KEYS})
        elif self.space_mode == "recon_test":
            extrinsics, tsdf_dict, offset = T.space_transform_recon_test(
                extrinsics, tsdf_dict, self.voxel_dim)
        else:
            extrinsics, tsdf_dict, boxes, offset = (
                T.space_transform_detection(
                    extrinsics, tsdf_dict, boxes, self.voxel_dim,
                    test=self.test_mode, mode=self.space_mode))
        projections = np.stack([
            T.projection_from(k, e)
            for k, e in zip(res_intr, extrinsics)])

        return self.pack(scene, image_ids, resized, projections,
                         tsdf_dict, boxes, labels, offset)

    def pack(self, scene, image_ids, imgs, projections, tsdf_dict, boxes,
             labels, offset) -> Dict[str, np.ndarray]:
        v = self.num_frames
        n = len(imgs)
        imgs_arr = np.zeros((v,) + imgs[0].shape, np.float32)
        imgs_arr[:n] = np.stack(imgs)
        proj_arr = np.zeros((v, 3, 4), np.float32)
        proj_arr[:n] = projections
        proj_arr[n:] = np.eye(3, 4, dtype=np.float32)  # harmless padding
        view_valid = np.zeros((v,), bool)
        view_valid[:n] = True

        m = self.max_gt_boxes
        gt = np.zeros((m, 7), np.float32)
        gt_labels = np.zeros((m,), np.int32)
        gt_valid = np.zeros((m,), bool)
        k = min(len(boxes), m)
        if k:
            gt[:k] = boxes.gravity_tensor()[:k]
            gt_labels[:k] = labels[:k]
            gt_valid[:k] = True

        sample = {
            "scene": scene,
            "image_ids": image_ids,
            "imgs": imgs_arr,                       # [V, H, W, 3]
            "projection": proj_arr,                 # [V, 3, 4]
            "view_valid": view_valid,
            "offset": offset.astype(np.float32),
            "gt_boxes": gt,
            "gt_labels": gt_labels,
            "gt_valid": gt_valid,
        }
        for key, tsdf in tsdf_dict.items():
            sample[key] = tsdf.tsdf_vol.astype(np.float32)
        sample["tsdf_origin"] = tsdf_dict["tsdf_gt_004"].origin[0]
        return sample

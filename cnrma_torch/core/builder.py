"""Build the port's models and datasets from reference-style config dicts
(port of ``cnrma_tpu/core/builder.py:33-159``).

The config surface is the JAX package's (``configs/ray_marching_scannet.py``:
nested backbone2d / feature_2d / detection_head blocks with the reference's
knob names).  ``cnrma_kwargs`` reads the knobs that parameterize the torch
``CNRMA`` (``type='RayMarching'``) or ``Atlas`` (``type='Atlas'``, the
reconstruction knobs only), ``fcaf3d_only_kwargs`` those of ``FCAF3DOnly``,
each with the JAX builder's defaults; ``build_model`` builds the config's
model, on the training grid for ``mode="train"`` and the test grid for
``mode="test"``; ``loss_bbox.with_yaw`` (``model.with_yaw`` for
``FCAF3DOnly``) gives the ARKit configs their 7-DoF detector;
``ray_marching_type='depth'`` selects the depth march, with
``depth_points`` 2 where the config sets none (or 0), as the JAX builder
reads it.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

from cnrma_torch.core.registry import DATASETS, build_from_cfg
from cnrma_torch.data import arkit  # noqa: F401  (registers the reader)
from cnrma_torch.data import points_dataset  # noqa: F401  (registers it)
from cnrma_torch.data import scannet  # noqa: F401  (registers the reader)
from cnrma_torch.models.cn_rma import CNRMA, Atlas
from cnrma_torch.models.fcaf3d import DetectionCapacities
from cnrma_torch.models.fcaf3d_only import FCAF3DOnly

def _build_capacities(caps_cfg) -> DetectionCapacities:
    if not caps_cfg:
        return DetectionCapacities()
    return DetectionCapacities(
        voxelize=caps_cfg["voxelize"], stride2=caps_cfg["stride2"],
        stride4=caps_cfg["stride4"], levels=tuple(caps_cfg["levels"]),
        neck=tuple(caps_cfg["neck"]))


def cnrma_kwargs(cfg, mode: str = "test") -> Dict[str, Any]:
    """The torch ``CNRMA``'s (or, for ``type='Atlas'``, ``Atlas``'s)
    constructor arguments from a config (a full Config or a dict with a
    ``model`` key), read as the JAX builder reads them; ``mode`` ("train"
    or "test") picks the voxel grid."""
    if mode not in ("train", "test"):
        raise ValueError(f"mode must be 'train' or 'test', got {mode!r}")
    m = cfg["model"] if "model" in cfg.keys() else cfg
    model_type = m.get("type", "RayMarching")
    if model_type not in ("RayMarching", "Atlas"):
        raise ValueError(f"unknown model type {model_type!r} (FCAF3DOnly: "
                         f"fcaf3d_only_kwargs)")
    if m.get("use_batchnorm_train") is False:
        # as the JAX builder: per-frame batch statistics are not
        # implemented, and the reference always trains the views jointly
        raise ValueError("use_batchnorm_train=False (per-frame batch "
                         "statistics in training) is not implemented")
    # use_batchnorm_test is accepted and ignored, as by the JAX builder: at
    # test time the norms use running statistics, so per-frame and joint
    # views give the same result
    common = dict(
        voxel_dim=tuple(m["voxel_dim_train" if mode == "train"
                          else "voxel_dim_test"]),
        voxel_size=m.get("voxel_size", 0.04),
        n_scales=m.get("n_scales", 3),
        origin=tuple(m.get("origin", (0, 0, 0))),
        pixel_mean=tuple(m.get("pixel_mean", (103.53, 116.28, 123.675))),
        pixel_std=tuple(m.get("pixel_std", (1.0, 1.0, 1.0))),
        backbone2d_stride=m.get("backbone2d_stride", 4),
        feature_dim=m.get("feature_2d", {}).get("output_dim", 32),
        loss_weight_recon=m.get("loss_weight_recon", 1.0),
        compute_dtype=getattr(torch, m.get("compute_dtype", "float32")),
    )
    if model_type == "Atlas":
        return common

    head = m.get("detection_head", {})
    test_cfg = head.get("test_cfg", {}) or {}
    # Ignored: the TPU knobs of the JAX volume and sparse paths (bp_tile,
    # bp_tile_frac, bp_rect_h, bp_rect_w, bp_rect_frac, bp_overflow_frac,
    # sparse_lut_budget) have no counterpart in the port's K1 and kernel
    # maps.
    assigner = head.get("assigner", {}) or {}
    return dict(
        common,
        ray_marching_type=m.get("ray_marching_type", "neus"),
        neus_threshold=m.get("neus_threshold") or 0.05,
        depth_points=m.get("depth_points") or 2,
        ray_samples=m.get("ray_samples", 300),
        rays_per_view_cap=m.get("rays_per_view_cap", 32768),
        max_points=m.get("max_points", 500000),
        ray_skip_factor=m.get("ray_skip_factor", 8),
        ray_skip_window=m.get("ray_skip_window", 48),
        ray_skip_coarse_step=m.get("ray_skip_coarse_step", 8),
        # accepted and ignored: the port sums the volume in fp32 always
        # (cnrma_torch/ops/backproject.py)
        bp_accum_dtype=m.get("bp_accum_dtype", "float32"),
        n_classes=head.get("n_classes", 18),
        n_reg_outs=head.get("n_reg_outs", 6),
        with_yaw=bool((head.get("loss_bbox", {}) or {}).get("with_yaw",
                                                             False)),
        voxel_size_fcaf3d=m.get("voxel_size_fcaf3d", 0.01),
        pts_threshold=head.get("pts_threshold", 200000),
        assigner_limit=assigner.get("limit", 27),
        assigner_topk=assigner.get("topk", 18),
        nms_pre=test_cfg.get("nms_pre", 1000),
        capacities=_build_capacities(m.get("capacities")),
        loss_weight_detection=m.get("loss_weight_detection", 1.0),
        use_feature_transform=m.get("use_feature_transform", True),
        feature_transform=dict(m.get("feature_transform") or {}),
    )


def fcaf3d_only_kwargs(cfg) -> Dict[str, Any]:
    """The torch ``FCAF3DOnly``'s constructor arguments from a config with
    ``model.type='FCAF3DOnly'`` (flat knobs, ``configs/
    fcaf3d_middle_scannet.py``), read as the JAX builder reads them."""
    m = cfg["model"] if "model" in cfg.keys() else cfg
    assigner = m.get("assigner", {}) or {}
    return dict(
        n_classes=m.get("n_classes", 18),
        n_reg_outs=m.get("n_reg_outs", 6),
        with_yaw=bool(m.get("with_yaw", False)),
        voxel_size=m.get("voxel_size", 0.01),
        pts_threshold=m.get("pts_threshold", 200000),
        assigner_limit=assigner.get("limit", 27),
        assigner_topk=assigner.get("topk", 18),
        nms_pre=m.get("nms_pre", 1000),
        capacities=_build_capacities(m.get("capacities")),
        use_feature_transform=m.get("use_feature_transform", True),
        feature_transform=dict(m.get("feature_transform") or {}))


def build_model(cfg, mode: str = "test") -> nn.Module:
    """The config's model (``CNRMA``, ``Atlas`` or ``FCAF3DOnly``) on the
    CPU, in training mode for ``mode="train"`` and eval mode for
    ``mode="test"``."""
    m = cfg["model"] if "model" in cfg.keys() else cfg
    model_type = m.get("type", "RayMarching")
    if model_type == "FCAF3DOnly":
        model = FCAF3DOnly(**fcaf3d_only_kwargs(cfg))
    elif model_type == "Atlas":
        model = Atlas(**cnrma_kwargs(cfg, mode))
    else:
        model = CNRMA(**cnrma_kwargs(cfg, mode))
    return model.train(mode == "train")


def build_dataset(cfg, data_key: str = "test", **overrides):
    """cfg.data.{train,val,test} dict -> dataset instance."""
    d = dict(cfg["data"][data_key])
    d.pop("pipeline", None)
    if d.get("type") == "MiddlePointsDataset":
        # dumped points: no voxel grid, no space mode (the JAX builder
        # passes both, which that reader does not take)
        d.update(overrides)
        return build_from_cfg(d, DATASETS)
    # derive grid / mode from the pipeline-free config surface
    if "voxel_dim" not in d:
        m = cfg.get("model", {})
        key = ("voxel_dim_test" if data_key in ("val", "test")
               else "voxel_dim_train")
        if key in m:
            d["voxel_dim"] = tuple(m[key])
    d.setdefault("space_mode",
                 overrides.pop("space_mode",
                               "origin" if data_key in ("val", "test")
                               else "middle"))
    # stage-1 recon configs carry the augmentation knobs in a top-level
    # ``recon_pipeline`` block (reference AtlasRandomTransformSpaceRecon args)
    if (str(d.get("space_mode", "")).startswith("recon")
            and "recon_pipeline" in cfg):
        d.setdefault("recon_pipeline", dict(cfg["recon_pipeline"]))
    d.update(overrides)
    return build_from_cfg(d, DATASETS)

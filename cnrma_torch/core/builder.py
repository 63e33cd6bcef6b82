"""Build the port's test-mode model and dataset from reference-style config
dicts (port of ``cnrma_tpu/core/builder.py:33-159``).

The config surface is the JAX package's (``configs/ray_marching_scannet.py``:
nested backbone2d / feature_2d / detection_head blocks with the reference's
knob names).  ``cnrma_kwargs`` reads the knobs that parameterize the torch
``CNRMA``, with the JAX builder's defaults; ``build_model`` builds it.  The
port has the test-mode ScanNet detector only: the other model types and
datasets raise ``NotImplementedError`` naming the ROADMAP item that brings
them.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from cnrma_torch.core.registry import DATASETS, build_from_cfg
from cnrma_torch.data import scannet  # noqa: F401  (registers the reader)
from cnrma_torch.models.cn_rma import CNRMA
from cnrma_torch.models.fcaf3d import DetectionCapacities

_LATER = {
    "Atlas": "stage-1 Atlas (ROADMAP queue 1, item 9)",
    "FCAF3DOnly": "stage-2 FCAF3DOnly (ROADMAP queue 1, item 9)",
    "AtlasARKitDataset": "the ARKit reader (ROADMAP queue 1, item 9)",
    "MiddlePointsDataset": "the stage-2 point dataset (ROADMAP queue 1, "
                           "item 9)",
}


def _not_ported(name: str):
    return NotImplementedError(f"{name}: {_LATER[name]} is not ported yet")


def _build_capacities(caps_cfg) -> DetectionCapacities:
    if not caps_cfg:
        return DetectionCapacities()
    return DetectionCapacities(
        voxelize=caps_cfg["voxelize"], stride2=caps_cfg["stride2"],
        stride4=caps_cfg["stride4"], levels=tuple(caps_cfg["levels"]),
        neck=tuple(caps_cfg["neck"]))


def cnrma_kwargs(cfg, mode: str = "test") -> Dict[str, Any]:
    """The torch ``CNRMA``'s constructor arguments from a config (a full
    Config or a dict with a ``model`` key), read as the JAX builder reads
    them.  ``mode`` must be ``"test"``: training comes with ROADMAP queue 1,
    item 8."""
    if mode != "test":
        raise NotImplementedError(
            "mode 'train': the training path is ROADMAP queue 1, item 8")
    m = cfg["model"] if "model" in cfg.keys() else cfg
    model_type = m.get("type", "RayMarching")
    if model_type in _LATER:
        raise _not_ported(model_type)
    if model_type != "RayMarching":
        raise ValueError(f"unknown model type {model_type!r}")

    head = m.get("detection_head", {})
    test_cfg = head.get("test_cfg", {}) or {}
    loss_bbox = head.get("loss_bbox", {}) or {}
    if bool(loss_bbox.get("with_yaw", False)):
        raise NotImplementedError(
            "with_yaw: the ARKit yaw detector is ROADMAP queue 1, item 9")
    if m.get("ray_marching_type", "neus") != "neus":
        raise NotImplementedError(
            "ray_marching_type 'depth' is ROADMAP queue 1, item 9")
    # Ignored: the TPU knobs of the JAX volume and sparse paths (bp_tile,
    # bp_tile_frac, bp_rect_h, bp_rect_w, bp_rect_frac, bp_overflow_frac,
    # sparse_lut_budget) have no counterpart in the port's K1 and kernel
    # maps, and the training knobs (losses, assigner, feature transform)
    # come with the training path.
    return dict(
        voxel_dim=tuple(m["voxel_dim_test"]),
        voxel_size=m.get("voxel_size", 0.04),
        n_scales=m.get("n_scales", 3),
        origin=tuple(m.get("origin", (0, 0, 0))),
        pixel_mean=tuple(m.get("pixel_mean", (103.53, 116.28, 123.675))),
        pixel_std=tuple(m.get("pixel_std", (1.0, 1.0, 1.0))),
        backbone2d_stride=m.get("backbone2d_stride", 4),
        feature_dim=m.get("feature_2d", {}).get("output_dim", 32),
        neus_threshold=m.get("neus_threshold") or 0.05,
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
        voxel_size_fcaf3d=m.get("voxel_size_fcaf3d", 0.01),
        pts_threshold=head.get("pts_threshold", 200000),
        nms_pre=test_cfg.get("nms_pre", 1000),
        capacities=_build_capacities(m.get("capacities")),
        compute_dtype=getattr(torch, m.get("compute_dtype", "float32")),
    )


def build_model(cfg, mode: str = "test") -> CNRMA:
    """The torch ``CNRMA`` of a config, in eval mode, on the CPU."""
    return CNRMA(**cnrma_kwargs(cfg, mode)).eval()


def build_dataset(cfg, data_key: str = "test", **overrides):
    """cfg.data.{train,val,test} dict -> dataset instance."""
    d = dict(cfg["data"][data_key])
    d.pop("pipeline", None)
    if d.get("type") in _LATER:
        raise _not_ported(d["type"])
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
    d.update(overrides)
    return build_from_cfg(d, DATASETS)

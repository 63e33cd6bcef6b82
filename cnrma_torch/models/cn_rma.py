"""CN-RMA combined detector, test-mode forward: 2D tower -> volume -> TSDF
-> NeuS ray marching -> sparse FCAF3D detection -> per-level top-k boxes.

Port of ``cnrma_tpu/models/cn_rma.py`` (``CNRMA.__call__`` with
``train=False``, ``_normalize_subsample``, ``_gather_point_feats``).  The
per-view buffers, the subsample to ``max_points`` and the detector
capacities are the JAX package's fixed shapes, so both packages keep the
same points; the one random draw (the subsample order) comes from a
``torch.Generator`` or, in the parity tests, from the caller.

Batch layout (as in the JAX package): imgs [B, V, H, W, 3] raw RGB,
projection [B, V, 3, 4] full-resolution, view_valid [B, V] bool,
offset [B, 3].
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn

from cnrma_torch.capacity import report as report_capacity
from cnrma_torch.models.fcaf3d import DetectionCapacities, FCAF3DDetector
from cnrma_torch.models.resnet_fpn import ResNetFPN2D
from cnrma_torch.models.tsdf_head import TSDFHead
from cnrma_torch.models.unet3d import UNet3D
from cnrma_torch.ops.backproject import accumulate_views
from cnrma_torch.ops.ray_marching import (
    RayMarchPoints, build_occupancy, ray_march_scene)


class RayPoints(NamedTuple):
    """Per-scene point cloud fed to the detector."""
    xyz: torch.Tensor       # [B, P, 3] world coords (offset applied)
    feats: torch.Tensor     # [B, P, C] weight-scaled features
    valid: torch.Tensor     # [B, P]


def _normalize_subsample(flat: RayMarchPoints, max_points: int,
                         generator: Optional[torch.Generator] = None,
                         uniform: Optional[torch.Tensor] = None):
    """Mean-normalize the weights over all kept samples and draw an exact
    without-replacement subsample of up to ``max_points`` valid points:
    valid points ordered by a uniform draw (``uniform`` if given, else from
    ``generator``), invalid ones last."""
    n_flat = flat.weight.shape[0]
    valid = flat.weight > 0
    report_capacity("scene points before max_points subsample",
                    valid.sum, max_points)
    n_valid = valid.float().sum()
    mean_w = flat.weight.sum() / torch.clamp(n_valid, min=1.0)
    weights = flat.weight / torch.clamp(mean_w, min=1e-12)
    if uniform is None:
        uniform = torch.rand(n_flat, generator=generator,
                             device=flat.weight.device)
    order = torch.argsort(torch.where(valid, uniform, torch.inf), stable=True)
    sel = order[:max_points]
    return (flat.xyz[sel], weights[sel], flat.uv[sel], flat.view[sel],
            valid[sel])


def _gather_point_feats(f_b: torch.Tensor, uv_b: torch.Tensor,
                        view_b: torch.Tensor, valid_b: torch.Tensor
                        ) -> torch.Tensor:
    """Per-point pixel-feature fetch from the [V, h, w, C] feature maps."""
    v, h, w, c = f_b.shape
    vi = view_b.long().clamp(0, v - 1)
    flat = ((vi * h + uv_b[:, 1].long().clamp(0, h - 1)) * w
            + uv_b[:, 0].long().clamp(0, w - 1))
    g = f_b.reshape(v * h * w, c)[flat]
    return torch.where(valid_b[:, None], g, 0.0)


class CNRMA(nn.Module):
    """The combined detector (reference ``RayMarching``), test mode."""

    def __init__(self, voxel_dim: Tuple[int, int, int] = (192, 192, 80),
                 voxel_size: float = 0.04, n_scales: int = 3,
                 origin: Sequence[float] = (0.0, 0.0, 0.0),
                 pixel_mean: Sequence[float] = (103.53, 116.28, 123.675),
                 pixel_std: Sequence[float] = (1.0, 1.0, 1.0),
                 backbone2d_stride: int = 4, feature_dim: int = 32,
                 neus_threshold: float = 0.05, ray_samples: int = 300,
                 rays_per_view_cap: int = 98304, max_points: int = 500000,
                 ray_skip_factor: int = 8, ray_skip_window: int = 48,
                 ray_skip_coarse_step: int = 8,
                 bp_accum_dtype: str = "float32", n_classes: int = 18,
                 n_reg_outs: int = 6, voxel_size_fcaf3d: float = 0.01,
                 pts_threshold: int = 200000, nms_pre: int = 1000,
                 capacities: DetectionCapacities = DetectionCapacities(),
                 compute_dtype: Any = torch.float32):
        super().__init__()
        self.voxel_dim = tuple(voxel_dim)
        self.voxel_size = voxel_size
        self.origin = tuple(float(o) for o in origin)
        self.pixel_mean = tuple(pixel_mean)
        self.pixel_std = tuple(pixel_std)
        self.backbone2d_stride = backbone2d_stride
        self.neus_threshold = neus_threshold
        self.ray_samples = ray_samples
        self.rays_per_view_cap = rays_per_view_cap
        self.max_points = max_points
        self.ray_skip_factor = ray_skip_factor
        self.ray_skip_window = ray_skip_window
        self.ray_skip_coarse_step = ray_skip_coarse_step
        self.bp_accum_dtype = bp_accum_dtype
        self.tower2d = ResNetFPN2D(output_dim=feature_dim,
                                   compute_dtype=compute_dtype)
        self.backbone3d = UNet3D(channels=(feature_dim, 64, 128, 256))
        self.tsdf_head = TSDFHead(input_channels=(feature_dim, 64, 128),
                                  n_scales=n_scales, voxel_size=voxel_size)
        self.detector = FCAF3DDetector(
            in_channels=feature_dim, n_classes=n_classes,
            n_reg_outs=n_reg_outs, voxel_size=voxel_size_fcaf3d,
            pts_threshold=pts_threshold, nms_pre=nms_pre,
            capacities=capacities, compute_dtype=compute_dtype)

    # ------------------------------------------------------------------
    def normalize_images(self, imgs: torch.Tensor) -> torch.Tensor:
        mean = torch.tensor(self.pixel_mean, dtype=torch.float32,
                            device=imgs.device)
        std = torch.tensor(self.pixel_std, dtype=torch.float32,
                           device=imgs.device)
        return (imgs - mean) / std

    def extract_2d(self, imgs: torch.Tensor) -> torch.Tensor:
        """[B, V, H, W, 3] -> [B, V, h, w, C] stride-4 features; all views
        go through the tower as one batch."""
        b, v = imgs.shape[:2]
        x = self.normalize_images(imgs.reshape((b * v,) + imgs.shape[2:]))
        feats = self.tower2d(x)
        return feats.reshape((b, v) + feats.shape[1:])

    def _scaled_projections(self, projections: torch.Tensor) -> torch.Tensor:
        proj = projections.float().clone()
        proj[..., :2, :] /= self.backbone2d_stride
        return proj

    def build_volume(self, feats: torch.Tensor, projections: torch.Tensor,
                     view_valid: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Scaled-projection back-projection + mean accumulation, per
        scene: ([B, X, Y, Z, C], [B, X, Y, Z])."""
        proj = self._scaled_projections(projections)
        vols, valids = zip(*[accumulate_views(
            proj[b], feats[b], view_valid[b], self.voxel_dim,
            self.voxel_size, self.origin, accum_dtype=self.bp_accum_dtype)
            for b in range(feats.shape[0])])
        if len(vols) == 1:      # one scene: a view, no copy of the volume
            return vols[0][None], valids[0][None]
        return torch.stack(vols), torch.stack(valids)

    def reconstruct(self, volume: torch.Tensor) -> Dict[str, torch.Tensor]:
        return self.tsdf_head(self.backbone3d(volume))

    def ray_march(self, feats: torch.Tensor, projections: torch.Tensor,
                  view_valid: torch.Tensor, tsdf: torch.Tensor,
                  generator: Optional[torch.Generator] = None,
                  uniform: Optional[torch.Tensor] = None) -> RayPoints:
        """All-view NeuS marching -> weighted feature point cloud: one
        scene-level march per scene (all views at once), global mean weight
        normalization, subsample to ``max_points``, pixel-feature gather,
        weight multiply.  ``uniform`` ([B, V * rays_per_view_cap]) replaces
        the generator's draw.  An invalid view emits no point (the JAX
        package zeroes its weights: the same kept set)."""
        b, v, h, w, _ = feats.shape
        proj = self._scaled_projections(projections)
        use_skip = (self.ray_skip_factor > 0
                    and self.ray_samples > self.ray_skip_window
                    and all(n % self.ray_skip_factor == 0
                            for n in self.voxel_dim))
        scenes = []
        for i in range(b):
            occ = (build_occupancy(tsdf[i], self.ray_skip_factor)
                   if use_skip else None)
            pts = ray_march_scene(
                proj[i], tsdf[i], view_valid[i], self.voxel_dim,
                self.voxel_size, self.origin, h, w,
                n_samples=self.ray_samples,
                weight_threshold=self.neus_threshold,
                capacity=self.rays_per_view_cap, occupancy=occ,
                skip_factor=self.ray_skip_factor,
                skip_window=self.ray_skip_window,
                coarse_step=self.ray_skip_coarse_step)
            flat = RayMarchPoints(*(f.flatten(0, 1) for f in pts))
            scenes.append(_normalize_subsample(
                flat, self.max_points, generator,
                None if uniform is None else uniform[i]))
        xyz, wts, uv, view, valid = (torch.stack(f) for f in zip(*scenes))
        pf = torch.stack([_gather_point_feats(feats[i], uv[i], view[i],
                                              valid[i]) for i in range(b)])
        return RayPoints(xyz=xyz, feats=pf * wts[..., None], valid=valid)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def forward(self, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None,
                uniform: Optional[torch.Tensor] = None) -> Dict[str, Any]:
        """Test-mode forward.  Returns ``tsdf`` (the per-scale TSDFs),
        ``points`` (the detector's input cloud, offset applied) and the raw
        per-level top-k ``bboxes``/``scores``/``bbox_valid``."""
        imgs = batch["imgs"]
        view_valid = batch.get("view_valid")
        if view_valid is None:
            view_valid = torch.ones(imgs.shape[:2], dtype=torch.bool,
                                    device=imgs.device)
        feats = self.extract_2d(imgs)
        volume, _ = self.build_volume(feats, batch["projection"], view_valid)
        tsdf = self.reconstruct(volume)
        fine = tsdf[f"scene_tsdf_{self.tsdf_head.keys[-1]}"]
        pts = self.ray_march(feats, batch["projection"], view_valid, fine,
                             generator, uniform)
        xyz = pts.xyz + batch["offset"][:, None, :]
        level_outs = self.detector(xyz, pts.feats, pts.valid)
        bboxes, scores, bvalid = self.detector.get_bboxes(level_outs)
        return {"tsdf": tsdf,
                "points": RayPoints(xyz=xyz, feats=pts.feats,
                                    valid=pts.valid),
                "bboxes": bboxes, "scores": scores, "bbox_valid": bvalid}

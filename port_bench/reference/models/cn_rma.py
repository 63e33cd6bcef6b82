"""CN-RMA combined detector: 2D tower -> volume -> TSDF -> NeuS (or depth)
ray marching -> sparse FCAF3D detection; per-level top-k boxes in the test
forward, the joint losses in the training forward, and in the test forward
too where the batch holds the ground truth (the validation split).
``Atlas`` is its reconstruction half alone, the stage-1 model.

Port of ``cnrma_tpu/models/cn_rma.py`` (``CNRMA.__call__``, ``Atlas``,
``feature_transform_aug``, ``_rotate_boxes``, ``_normalize_subsample``,
``_gather_point_feats``).  The per-view buffers, the subsample to
``max_points`` and the detector capacities are the JAX package's fixed
shapes, so both packages keep the same points.  The random draws (the
subsample order; in training the augmentation's flips, angle, scale and
translation) come from a ``torch.Generator`` or, in the parity tests,
from the caller.

Gradients flow as in the JAX package: the TSDF entering the ray march is
detached (the reference marches under ``no_grad``), the gathered 2D
features are not, so the detection loss trains the 2D tower through the
points but not the TSDF head.

Batch layout (as in the JAX package): imgs [B, V, H, W, 3] raw RGB,
projection [B, V, 3, 4] full-resolution, view_valid [B, V] bool,
offset [B, 3].

One scene can be split across the ranks of a view group
(``parallel/shard.py``), as the JAX package's ``view`` mesh axis splits
it.  In the test forward (given a ``view_group``, JAX's ``view_mesh``) each
rank runs the 2D tower on its block of the views and the volume is
summed over the group; the U-Net, head, march and detector run alike on
every rank.  In training, ``forward_view_sharded`` also runs the U-Net
and TSDF head on an X-slab a rank and marches each rank's own views.
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn

from port_bench.reference.capacity import report as report_capacity
from port_bench.reference.models.fcaf3d import DetectionCapacities, FCAF3DDetector
from port_bench.reference.models.resnet_fpn import ResNetFPN2D
from port_bench.reference.models.tsdf_head import TSDFHead, tsdf_losses
from port_bench.reference.models.unet3d import UNet3D
from port_bench.reference.ops.backproject import accumulate_views, partial_volume
from port_bench.reference.ops.ray_marching import (
    RayMarchPoints, build_occupancy, ray_march_depth_scene, ray_march_scene)
from port_bench.reference.parallel import dist, shard
from port_bench.reference.timing import mark


class RayPoints(NamedTuple):
    """Per-scene point cloud fed to the detector."""
    xyz: torch.Tensor       # [B, P, 3] world coords (offset applied)
    feats: torch.Tensor     # [B, P, C] weight-scaled features
    valid: torch.Tensor     # [B, P]


FEATURE_TRANSFORM = dict(flip_ratio_horizontal=0.5, flip_ratio_vertical=0.5,
                         rot_range=(-0.087266, 0.087266),
                         scale_ratio_range=(0.9, 1.1),
                         translation_std=(0.1, 0.1, 0.1))


def draw_feature_transform(generator: Optional[torch.Generator],
                           device, flip_ratio_horizontal: float = 0.5,
                           flip_ratio_vertical: float = 0.5,
                           rot_range=(-0.087266, 0.087266),
                           scale_ratio_range=(0.9, 1.1),
                           translation_std=(0.1, 0.1, 0.1)
                           ) -> Dict[str, torch.Tensor]:
    """One scene's augmentation draws from ``generator``, as tensors on
    ``device``: ``flip_h`` and ``flip_v`` (bool), ``angle``, ``scale`` and
    ``trans`` [3] (gaussian times ``translation_std``)."""
    u = torch.rand(4, generator=generator, device=device)
    trans = torch.randn(3, generator=generator, device=device)
    lo, hi = rot_range
    s_lo, s_hi = scale_ratio_range
    return {"flip_h": u[0] < flip_ratio_horizontal,
            "flip_v": u[1] < flip_ratio_vertical,
            "angle": lo + (hi - lo) * u[2],
            "scale": s_lo + (s_hi - s_lo) * u[3],
            "trans": trans * torch.tensor(translation_std,
                                          dtype=torch.float32,
                                          device=device)}


def _rotate_boxes(boxes: torch.Tensor, angle: torch.Tensor,
                  with_yaw: bool) -> torch.Tensor:
    """Rotate gravity-center boxes [..., 7] about +z.  Without yaw the xy
    sizes become those of the rotated box's axis-aligned enclosure
    (mmdet3d depth boxes, ``TransformFeaturesBBoxes``)."""
    c, s = torch.cos(angle), torch.sin(angle)
    x = boxes[..., 0] * c - boxes[..., 1] * s
    y = boxes[..., 0] * s + boxes[..., 1] * c
    if with_yaw:
        dims = boxes[..., 3:6]
        yaw = boxes[..., 6] + angle
    else:
        w = torch.abs(boxes[..., 3] * c) + torch.abs(boxes[..., 4] * s)
        l = torch.abs(boxes[..., 3] * s) + torch.abs(boxes[..., 4] * c)
        dims = torch.stack([w, l, boxes[..., 5]], dim=-1)
        yaw = boxes[..., 6]
    return torch.cat([torch.stack([x, y, boxes[..., 2]], -1), dims,
                      yaw[..., None]], dim=-1)


def feature_transform_aug(points: torch.Tensor, boxes: torch.Tensor,
                          with_yaw: bool, draws: Dict[str, torch.Tensor]
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Train-time augmentation of one scene's points [P, 3] and GT boxes
    [M, 7], jointly (reference ``TransformFeaturesBBoxes``,
    ``fcaf3d_transforms.py:14-146``): horizontal and vertical flips, a
    small rotation about z, a global scale and a translation, with the
    ``draws`` of ``draw_feature_transform``."""
    one = torch.ones((), device=points.device)
    do_h, do_v = draws["flip_h"], draws["flip_v"]
    pts = points * torch.stack([torch.where(do_h, -one, one), one, one])
    byaw = boxes[..., 6]
    if with_yaw:
        byaw = torch.where(do_h, math.pi - byaw, byaw)
    boxes = torch.cat([torch.where(do_h, -boxes[..., :1], boxes[..., :1]),
                       boxes[..., 1:6], byaw[..., None]], dim=-1)

    pts = pts * torch.stack([one, torch.where(do_v, -one, one), one])
    byaw = boxes[..., 6]
    if with_yaw:
        byaw = torch.where(do_v, -byaw, byaw)
    boxes = torch.cat([boxes[..., :1],
                       torch.where(do_v, -boxes[..., 1:2], boxes[..., 1:2]),
                       boxes[..., 2:6], byaw[..., None]], dim=-1)

    angle = draws["angle"]
    c, s = torch.cos(angle), torch.sin(angle)
    px = pts[..., 0] * c - pts[..., 1] * s
    py = pts[..., 0] * s + pts[..., 1] * c
    pts = torch.stack([px, py, pts[..., 2]], dim=-1)
    boxes = _rotate_boxes(boxes, angle, with_yaw)

    scale = draws["scale"]
    pts = pts * scale
    boxes = torch.cat([boxes[..., :6] * scale, boxes[..., 6:]], dim=-1)

    trans = draws["trans"]
    return pts + trans, torch.cat([boxes[..., :3] + trans, boxes[..., 3:]],
                                  dim=-1)


def augment_scenes(points: torch.Tensor, boxes: torch.Tensor,
                   config: Dict[str, Any], with_yaw: bool,
                   generator: Optional[torch.Generator] = None,
                   aug_draws: Optional[Sequence[Dict[str, torch.Tensor]]]
                   = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``feature_transform_aug`` of each scene's points [B, P, 3] and GT
    boxes [B, M, 7] (7-DoF with ``with_yaw``), with the draws
    ``aug_draws`` (one ``draw_feature_transform`` dict a scene) or, without
    them, drawn from ``generator`` by the ``config``
    (``FEATURE_TRANSFORM``'s keys)."""
    scenes = []
    for b in range(points.shape[0]):
        draws = (aug_draws[b] if aug_draws is not None else
                 draw_feature_transform(generator, points.device, **config))
        scenes.append(feature_transform_aug(points[b], boxes[b], with_yaw,
                                            draws))
    return (torch.stack([p for p, _ in scenes]),
            torch.stack([bx for _, bx in scenes]))


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
    g = f_b.reshape(v * h * w, c).index_select(0, flat)
    return torch.where(valid_b[:, None], g, 0.0)


class CNRMA(nn.Module):
    """The combined detector (reference ``RayMarching``): ``forward`` is the
    test forward, ``forward_train`` the training forward's losses."""

    detection = True            # False in Atlas: no ``detector`` submodule

    def __init__(self, voxel_dim: Tuple[int, int, int] = (192, 192, 80),
                 voxel_size: float = 0.04, n_scales: int = 3,
                 origin: Sequence[float] = (0.0, 0.0, 0.0),
                 pixel_mean: Sequence[float] = (103.53, 116.28, 123.675),
                 pixel_std: Sequence[float] = (1.0, 1.0, 1.0),
                 backbone2d_stride: int = 4, feature_dim: int = 32,
                 ray_marching_type: str = "neus",
                 neus_threshold: float = 0.05, depth_points: int = 2,
                 ray_samples: int = 300,
                 rays_per_view_cap: int = 98304, max_points: int = 500000,
                 ray_skip_factor: int = 8, ray_skip_window: int = 48,
                 ray_skip_coarse_step: int = 8,
                 bp_accum_dtype: str = "float32", n_classes: int = 18,
                 n_reg_outs: int = 6, with_yaw: bool = False,
                 voxel_size_fcaf3d: float = 0.01,
                 pts_threshold: int = 200000, assigner_limit: int = 27,
                 assigner_topk: int = 18, nms_pre: int = 1000,
                 capacities: DetectionCapacities = DetectionCapacities(),
                 loss_weight_recon: float = 1.0,
                 loss_weight_detection: float = 1.0,
                 use_feature_transform: bool = True,
                 feature_transform: Optional[Dict[str, Any]] = None,
                 compute_dtype: Any = torch.float32):
        super().__init__()
        if ray_marching_type not in ("neus", "depth"):
            raise ValueError(f"ray_marching_type must be 'neus' or 'depth', "
                             f"got {ray_marching_type!r}")
        self.ray_marching_type = ray_marching_type
        self.depth_points = depth_points
        self.loss_weight_recon = loss_weight_recon
        self.loss_weight_detection = loss_weight_detection
        self.use_feature_transform = use_feature_transform
        self.feature_transform = {**FEATURE_TRANSFORM,
                                  **(feature_transform or {})}
        self.with_yaw = with_yaw
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
        if self.detection:
            self.detector = FCAF3DDetector(
                in_channels=feature_dim, n_classes=n_classes,
                n_reg_outs=n_reg_outs, voxel_size=voxel_size_fcaf3d,
                pts_threshold=pts_threshold, assigner_limit=assigner_limit,
                assigner_topk=assigner_topk, with_yaw=with_yaw,
                nms_pre=nms_pre, capacities=capacities,
                compute_dtype=compute_dtype)

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

    def _march(self, proj: torch.Tensor, tsdf: torch.Tensor,
               view_valid: torch.Tensor, height: int, width: int,
               view_offset: int = 0) -> RayMarchPoints:
        """One scene's views [v] marched through its fine TSDF [X, Y, Z]
        (NeuS: all views at once through K2; depth: view by view in
        torch): [v, rays_per_view_cap] slots, the views' ids from
        ``view_offset`` on."""
        if self.ray_marching_type == "depth":
            return ray_march_depth_scene(
                proj, tsdf, view_valid, self.voxel_dim, self.voxel_size,
                self.origin, height, width, n_samples=self.ray_samples,
                depth_points=self.depth_points,
                capacity=self.rays_per_view_cap, view_offset=view_offset)
        use_skip = (self.ray_skip_factor > 0
                    and self.ray_samples > self.ray_skip_window
                    and all(n % self.ray_skip_factor == 0
                            for n in self.voxel_dim))
        occ = build_occupancy(tsdf, self.ray_skip_factor) if use_skip \
            else None
        return ray_march_scene(
            proj, tsdf, view_valid, self.voxel_dim, self.voxel_size,
            self.origin, height, width, n_samples=self.ray_samples,
            weight_threshold=self.neus_threshold,
            capacity=self.rays_per_view_cap, occupancy=occ,
            skip_factor=self.ray_skip_factor,
            skip_window=self.ray_skip_window,
            coarse_step=self.ray_skip_coarse_step, view_offset=view_offset)

    def _point_cloud(self, marched: RayMarchPoints, feats: torch.Tensor,
                     generator: Optional[torch.Generator] = None,
                     uniform: Optional[torch.Tensor] = None):
        """One scene's point cloud from its marched views [V, cap] and
        feature maps [V, h, w, C]: the global mean weight normalization,
        the subsample to ``max_points``, the pixel-feature gather and the
        weight multiply.  (xyz [P, 3], weighted features [P, C], valid
        [P])."""
        flat = RayMarchPoints(*(f.flatten(0, 1) for f in marched))
        xyz, wts, uv, view, valid = _normalize_subsample(
            flat, self.max_points, generator, uniform)
        pf = _gather_point_feats(feats, uv, view, valid)
        return xyz, pf * wts[:, None], valid

    def ray_march(self, feats: torch.Tensor, projections: torch.Tensor,
                  view_valid: torch.Tensor, tsdf: torch.Tensor,
                  generator: Optional[torch.Generator] = None,
                  uniform: Optional[torch.Tensor] = None) -> RayPoints:
        """All-view marching -> weighted feature point cloud, scene by
        scene (``_march``, then ``_point_cloud``).  ``generator`` may be a
        list of one generator a scene (each scene's draw then does not
        depend on its batch); ``uniform`` ([B, V * rays_per_view_cap])
        replaces the generators' draw.  An invalid view emits no point
        (the JAX package zeroes its weights: the same kept set)."""
        b, v, h, w, _ = feats.shape
        proj = self._scaled_projections(projections)
        gens = (generator if isinstance(generator, (list, tuple))
                else [generator] * b)
        scenes = [self._point_cloud(
            self._march(proj[i], tsdf[i], view_valid[i], h, w), feats[i],
            gens[i], None if uniform is None else uniform[i])
            for i in range(b)]
        xyz, pf, valid = (torch.stack(f) for f in zip(*scenes))
        return RayPoints(xyz=xyz, feats=pf, valid=valid)

    def reconstruct_views(self, batch: Dict[str, Any], view_group=None
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     Dict[str, torch.Tensor]]:
        """The 2D features, the view flags (all valid unless the batch has
        ``view_valid``) and the per-scale TSDFs of a batch; with a
        ``view_group`` (the test forward's view sharding, the test CLI's
        ``--view-shard``; JAX's ``view_mesh``) its views split over the
        group's ranks."""
        imgs = batch["imgs"]
        view_valid = batch.get("view_valid")
        if view_valid is None:
            view_valid = torch.ones(imgs.shape[:2], dtype=torch.bool,
                                    device=imgs.device)
        if view_group is not None:
            return self._reconstruct_view_sharded(imgs, batch["projection"],
                                                  view_valid, view_group)
        feats = self.extract_2d(imgs)
        mark("tower")
        volume, _ = self.build_volume(feats, batch["projection"], view_valid)
        mark("volume")
        tsdf = self.reconstruct(volume)
        mark("unet_head")
        return feats, view_valid, tsdf

    def _reconstruct_view_sharded(self, imgs: torch.Tensor,
                                  projections: torch.Tensor,
                                  view_valid: torch.Tensor, group):
        """``reconstruct_views`` of one scene with its views split over
        ``group`` (the test forward; JAX's ``view_mesh``): the views
        padded to a multiple of the group's size with invalid copies of
        view 0, this rank's block through the tower (eval-mode norms: a
        view's features do not depend on the others), the volume of
        ``partial_volume``, and the U-Net, the head and the gathered
        feature maps of all V views alike on every rank."""
        if self.training:
            raise ValueError("the test forward's view sharding runs in eval "
                             "mode; training splits a scene through "
                             "forward_view_sharded")
        n, r = dist.world(group), dist.rank(group)
        b, V = imgs.shape[:2]
        if b != 1:
            raise ValueError("the view-sharded test forward takes one scene "
                             f"a batch, got {b}")
        pad = (-V) % n
        if pad:
            imgs = torch.cat([imgs, imgs[:, :1].expand(
                1, pad, *imgs.shape[2:])], 1)
            projections = torch.cat([projections, projections[:, :1].expand(
                1, pad, 3, 4)], 1)
            view_valid = torch.cat([view_valid, torch.zeros(
                1, pad, dtype=torch.bool, device=view_valid.device)], 1)
        vs = (V + pad) // n
        mine = slice(r * vs, (r + 1) * vs)
        feats_s = self.extract_2d(imgs[:, mine])
        mark("tower")
        proj = self._scaled_projections(projections[0, mine])
        volume, _ = partial_volume(proj, feats_s[0], view_valid[0, mine],
                                   self.voxel_dim, self.voxel_size,
                                   self.origin, group)
        mark("volume")
        tsdf = self.reconstruct(volume[None])
        mark("unet_head")
        feats = shard.gather_cat(feats_s, 1, group)[:, :V]
        return feats, view_valid[:, :V], tsdf

    def recon_losses(self, tsdf: Dict[str, torch.Tensor],
                     batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """``tsdf_loss_<key>`` against the batch's ``tsdf_list``, times
        ``loss_weight_recon``."""
        losses = {k: v * self.loss_weight_recon for k, v in
                  tsdf_losses(tsdf, batch["tsdf_list"],
                              self.tsdf_head.keys).items()}
        mark("tsdf_loss")
        return losses

    # ------------------------------------------------------------------
    def test_losses(self, tsdf: Dict[str, torch.Tensor], level_outs,
                    batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """The losses of a test forward whose batch holds ground truth
        (``CNRMA.__call__`` with ``train=False``): the reconstruction's where
        it has ``tsdf_list``, the detector's (times
        ``loss_weight_detection``, no feature augmentation) where it has
        ``gt_boxes``; empty without either."""
        losses = (self.recon_losses(tsdf, batch) if batch.get("tsdf_list")
                  else {})
        if level_outs is not None and "gt_boxes" in batch:
            det = self.detector.loss(level_outs, batch["gt_boxes"],
                                     batch["gt_labels"], batch["gt_valid"])
            losses.update({k: v * self.loss_weight_detection
                           for k, v in det.items()})
        return losses

    @torch.no_grad()
    def forward(self, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None,
                uniform: Optional[torch.Tensor] = None,
                view_group=None) -> Dict[str, Any]:
        """Test-mode forward (``generator`` one or a list of one a scene,
        as ``ray_march`` takes it; a ``view_group`` splits the scene's
        views over its ranks, ``reconstruct_views``).  Returns ``tsdf``
        (the per-scale TSDFs), ``points`` (the detector's input cloud,
        offset applied) and the raw per-level top-k
        ``bboxes``/``scores``/``bbox_valid``; with ground truth in the
        batch also ``losses`` (``test_losses``)."""
        feats, view_valid, tsdf = self.reconstruct_views(batch, view_group)
        fine = tsdf[f"scene_tsdf_{self.tsdf_head.keys[-1]}"]
        pts = self.ray_march(feats, batch["projection"], view_valid, fine,
                             generator, uniform)
        xyz = pts.xyz + batch["offset"][:, None, :]
        level_outs = self.detector(xyz, pts.feats, pts.valid)
        bboxes, scores, bvalid = self.detector.get_bboxes(level_outs)
        out = {"tsdf": tsdf,
               "points": RayPoints(xyz=xyz, feats=pts.feats, valid=pts.valid),
               "bboxes": bboxes, "scores": scores, "bbox_valid": bvalid}
        losses = self.test_losses(tsdf, level_outs, batch)
        if losses:
            out["losses"] = losses
        return out

    def forward_train(self, batch: Dict[str, Any],
                      generator: Optional[torch.Generator] = None,
                      uniform: Optional[torch.Tensor] = None,
                      aug_draws: Optional[Sequence[Dict[str, torch.Tensor]]]
                      = None, group=None) -> Dict[str, torch.Tensor]:
        """The training forward (``CNRMA.__call__`` with ``train=True``):
        the loss dict ``tsdf_loss_<key>`` (times ``loss_weight_recon``),
        ``loss_centerness``, ``loss_bbox`` and ``loss_cls`` (times
        ``loss_weight_detection``).  The norms run as the modules' mode
        says (``train()`` for batch statistics).  ``batch`` also holds
        ``tsdf_list`` ({``tsdf_gt_<key>``: [B, X_i, Y_i, Z_i]}) and the GT
        ``gt_boxes`` [B, M, 7], ``gt_labels`` and ``gt_valid`` [B, M].
        The draws come from ``generator`` (first the subsample's, then per
        scene the augmentation's) unless ``uniform`` and ``aug_draws``
        (one ``draw_feature_transform`` dict a scene) give them.  A batch
        of B scenes trains as the JAX package's does: the tower's norms
        over its B x V views, the U-Net's over its B volumes, the
        detector's over every scene's valid voxels, the TSDF losses pooled
        over the batch, the volume, march and augmentation scene by
        scene.  With a process ``group`` (JAX's ``pmean_axis``) the
        detector's positive count and centerness sum are its ranks'
        mean."""
        feats, view_valid, tsdf = self.reconstruct_views(batch)
        losses = self.recon_losses(tsdf, batch)
        fine = tsdf[f"scene_tsdf_{self.tsdf_head.keys[-1]}"]
        pts = self.ray_march(feats, batch["projection"], view_valid,
                             fine.detach(), generator, uniform)
        mark("march")
        return self._detection_losses(pts, batch, losses, generator,
                                      aug_draws, group)

    def _detection_losses(self, pts: RayPoints, batch: Dict[str, Any],
                          losses: Dict[str, torch.Tensor],
                          generator: Optional[torch.Generator],
                          aug_draws, group) -> Dict[str, torch.Tensor]:
        """The training forward's tail from the point cloud: the offset,
        the augmentation, the detector and its losses (times
        ``loss_weight_detection``) added to ``losses``."""
        xyz = pts.xyz + batch["offset"][:, None, :]
        gt_boxes = batch["gt_boxes"]
        if self.use_feature_transform:
            xyz, gt_boxes = augment_scenes(xyz, gt_boxes,
                                           self.feature_transform,
                                           self.with_yaw, generator,
                                           aug_draws)
        mark("augment")
        level_outs = self.detector(xyz, pts.feats, pts.valid)
        mark("detector")
        det = self.detector.loss(level_outs, gt_boxes, batch["gt_labels"],
                                 batch["gt_valid"], group=group)
        mark("det_loss")
        losses.update({k: v * self.loss_weight_detection
                       for k, v in det.items()})
        return losses

    def forward_view_sharded(self, batch: Dict[str, Any],
                             shards: dist.ViewShards,
                             generator: Optional[torch.Generator] = None,
                             uniform: Optional[torch.Tensor] = None,
                             aug_draws: Optional[
                                 Sequence[Dict[str, torch.Tensor]]] = None
                             ) -> Dict[str, torch.Tensor]:
        """The training forward's losses of ONE scene split across the
        ranks of ``shards.view`` (JAX ``CNRMA.forward_view_sharded``): the
        losses of ``forward_train`` on that scene, the same on every rank
        of the group.

        * 2D tower: this rank's V/n views, the norms' statistics synced
          over the group (``shard.bn_sync_group``), so they are the whole
          scene's;
        * volume: ``partial_volume`` (K1's sums, summed over the group);
        * U-Net and TSDF head: this rank's X-slab, with halos
          (``shard.halo_group``) and synced norms; the three TSDFs
          gathered across the boundary (``shard.gather_replicated``) for
          the TSDF losses, which every rank computes alike;
        * march: this rank's views (their global ids), the per-view
          buffers gathered in view order, which is the one-rank buffer;
        * the subsample, the feature gather (the feature maps gathered
          across the boundary), the augmentation and the detector, alike
          on every rank with one ``generator`` (the data row's), the
          positive count averaged over ``shards.data``.

        The sharded modules' gradients are then partials to be summed over
        the group, the detector's whole on every rank
        (``train/loop.py:mean_over_ranks``).  ``Atlas`` stops after the
        TSDF losses.  Checked: one scene a rank, V % n == 0 (equal shards
        keep the synced statistics exact), X % n == 0 and (X / n) % 8 ==
        0 (slabs start at even X through the three stride-2 levels)."""
        group, n, vix = shards.view, shards.n, shards.index
        imgs = batch["imgs"]
        b, V = imgs.shape[:2]
        X = self.voxel_dim[0]
        if b != 1:
            raise ValueError("forward_view_sharded: per-device batch must be "
                             f"1 scene, got {b}")
        if V % n:
            raise ValueError(f"views ({V}) must divide the view axis ({n}) "
                             "for joint-BN-exact sharding")
        if X % n or (X // n) % 8:
            raise ValueError(f"voxel X dim {X} must split into {n} slabs "
                             "divisible by 8 (three stride-2 levels)")
        view_valid = batch.get("view_valid")
        if view_valid is None:
            view_valid = torch.ones(imgs.shape[:2], dtype=torch.bool,
                                    device=imgs.device)
        vs = V // n
        mine = slice(vix * vs, (vix + 1) * vs)
        with shard.bn_sync_group(group):
            feats_s = self.extract_2d(imgs[:, mine])          # [1, vs, ...]
        mark("tower")
        proj = self._scaled_projections(batch["projection"][0, mine])
        volume, _ = partial_volume(proj, feats_s[0], view_valid[0, mine],
                                   self.voxel_dim, self.voxel_size,
                                   self.origin, group)
        mark("volume")
        xs = X // n
        slab = volume[None, vix * xs:(vix + 1) * xs]
        with shard.bn_sync_group(group), shard.halo_group(group):
            tsdf_slab = self.reconstruct(slab)
        tsdf = {k: shard.gather_replicated(t, 1, group)
                for k, t in tsdf_slab.items()}
        mark("unet_head")
        losses = self.recon_losses(tsdf, batch)
        if not self.detection:
            return losses
        fine = tsdf[f"scene_tsdf_{self.tsdf_head.keys[-1]}"].detach()
        h, w = feats_s.shape[2:4]
        with torch.no_grad():
            mine_pts = self._march(proj, fine[0], view_valid[0, mine], h, w,
                                   view_offset=vix * vs)
            marched = RayMarchPoints(*(shard.gather_cat(f, 0, group)
                                       for f in mine_pts))
        feats = shard.gather_replicated(feats_s, 1, group)
        xyz, pf, valid = self._point_cloud(
            marched, feats[0], generator,
            None if uniform is None else uniform[0])
        pts = RayPoints(xyz=xyz[None], feats=pf[None], valid=valid[None])
        mark("march")
        return self._detection_losses(pts, batch, losses, generator,
                                      aug_draws, shards.data)


class Atlas(CNRMA):
    """The reconstruction model of stage-1 pretraining (reference
    ``models/atlas.py``): CNRMA's 2D tower, volume, U-Net and TSDF head, no
    detector, so its state dict is a strict subset of CNRMA's.  Built with
    CNRMA's reconstruction arguments; the detection ones are unused."""

    detection = False

    @torch.no_grad()
    def forward(self, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None,
                uniform: Optional[torch.Tensor] = None,
                view_group=None) -> Dict[str, Any]:
        """Test-mode forward (a ``view_group`` as ``CNRMA.forward`` takes
        it): ``tsdf``, the per-scale TSDFs, and with ``tsdf_list`` in the
        batch their ``losses``."""
        tsdf = self.reconstruct_views(batch, view_group)[2]
        losses = self.test_losses(tsdf, None, batch)
        return {"tsdf": tsdf, "losses": losses} if losses else {"tsdf": tsdf}

    def forward_train(self, batch: Dict[str, Any],
                      generator: Optional[torch.Generator] = None,
                      uniform: Optional[torch.Tensor] = None,
                      aug_draws=None, group=None) -> Dict[str, torch.Tensor]:
        """The training forward's losses: ``tsdf_loss_<key>`` (times
        ``loss_weight_recon``) only; no ray march, no detector, so the
        ``group`` syncs nothing."""
        return self.recon_losses(self.reconstruct_views(batch)[2], batch)

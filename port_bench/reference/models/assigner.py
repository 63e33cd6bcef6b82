"""FCAF3D label assignment on fixed-shape [P, M] tensors.

Port of ``cnrma_tpu/models/assigner.py`` (reference
``FCAF3DAssigner.assign``, ``fcaf3d_head.py:405-484``), one scene:

1. a point is a candidate for a GT box if it lies inside it, after the
   reference's de-rotation;
2. the box goes to the last pyramid scale with at least ``limit`` inside
   points (else the scale just below the first one under the limit);
3. only the ``topk`` points of highest centerness per box stay positive;
4. a point claimed by several boxes takes the one of least volume (the
   first of equal ones).

Invalid points and boxes are masked out; a scene without boxes gives all
background.  The targets carry no gradient.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

FLOAT_MAX = 1e8


def compute_centerness(dx_min, dx_max, dy_min, dy_max, dz_min, dz_max
                       ) -> torch.Tensor:
    """sqrt of the product of the min/max face-distance ratios (reference
    ``compute_centerness``, ``fcaf3d_head.py:395-402``)."""
    eps = 1e-12

    def ratio(a, b):
        return torch.minimum(a, b) / torch.clamp(torch.maximum(a, b),
                                                 min=eps)
    r = ratio(dx_min, dx_max) * ratio(dy_min, dy_max) * ratio(dz_min, dz_max)
    return torch.sqrt(torch.clamp(r, min=0.0))


class AssignResult(NamedTuple):
    centerness_targets: torch.Tensor   # [P]
    bbox_targets: torch.Tensor         # [P, 7] assigned GT (gravity center)
    labels: torch.Tensor               # [P] int64, -1 = background


@torch.no_grad()
def fcaf3d_assign(points: torch.Tensor, scale_ids: torch.Tensor,
                  point_valid: torch.Tensor, gt_boxes: torch.Tensor,
                  gt_labels: torch.Tensor, gt_valid: torch.Tensor,
                  n_scales: int, limit: int, topk: int) -> AssignResult:
    """One scene.  points [P, 3] (all scales concatenated), scale_ids [P],
    point_valid [P]; gt_boxes [M, 7] (cx, cy, cz gravity, dx, dy, dz,
    yaw), gt_labels [M], gt_valid [M]."""
    p = points.shape[0]
    cx, cy, cz = gt_boxes[:, 0], gt_boxes[:, 1], gt_boxes[:, 2]
    w, l, h = gt_boxes[:, 3], gt_boxes[:, 4], gt_boxes[:, 5]
    yaw = gt_boxes[:, 6]

    # Local offsets [P, M].  The reference de-rotates with mmdet3d-0.15's
    # ``rotation_3d_in_axis(shift, -yaw, axis=2)``, whose einsum applies
    # the transpose of the textbook rotation, so the local frame is
    # lx = c*ox - s*oy, ly = s*ox + c*oy (the opposite sin sign from the
    # textbook world-to-box de-rotation), kept here as the JAX package
    # keeps it.
    ox = points[:, 0:1] - cx[None, :]
    oy = points[:, 1:2] - cy[None, :]
    oz = points[:, 2:3] - cz[None, :]
    c, s = torch.cos(yaw)[None, :], torch.sin(yaw)[None, :]
    lx = c * ox - s * oy
    ly = s * ox + c * oy

    dx_min = lx + w[None, :] / 2
    dx_max = w[None, :] / 2 - lx
    dy_min = ly + l[None, :] / 2
    dy_max = l[None, :] / 2 - ly
    dz_min = oz + h[None, :] / 2
    dz_max = h[None, :] / 2 - oz

    min_face = torch.minimum(
        torch.minimum(torch.minimum(dx_min, dx_max),
                      torch.minimum(dy_min, dy_max)),
        torch.minimum(dz_min, dz_max))
    inside = (min_face > 0) & point_valid[:, None] & gt_valid[None, :]

    # condition 2: the best scale per box
    scale_onehot = torch.nn.functional.one_hot(
        scale_ids.long(), n_scales).float()                      # [P, S]
    n_pos_per_scale = scale_onehot.T @ inside.float()            # [S, M]
    lower = n_pos_per_scale < limit
    lower_index = torch.clamp(torch.argmax(lower.int(), dim=0) - 1, min=0)
    all_upper = (~lower).all(dim=0)
    best_scale = torch.where(all_upper, n_scales - 1, lower_index)  # [M]
    inside_best = best_scale[None, :] == scale_ids[:, None].long()

    # condition 3: the top-k centerness per box
    centerness = compute_centerness(dx_min, dx_max, dy_min, dy_max,
                                    dz_min, dz_max)
    centerness = torch.where(inside & inside_best, centerness, -1.0)
    k = min(topk + 1, p)
    kth = torch.topk(centerness.T, k, dim=1).values[:, -1]        # [M]
    inside_top = centerness > kth[None, :]

    volumes = (w * l * h)[None, :].expand(p, -1)
    volumes = torch.where(inside & inside_best & inside_top, volumes,
                          FLOAT_MAX)
    min_area, min_inds = torch.min(volumes, dim=1)               # [P]

    labels = gt_labels.long()[min_inds]
    labels = torch.where(min_area >= FLOAT_MAX, -1, labels)
    labels = torch.where(point_valid, labels, -1)

    def gather(a):
        return torch.gather(a, 1, min_inds[:, None])[:, 0]
    centerness_targets = compute_centerness(
        gather(dx_min), gather(dx_max), gather(dy_min), gather(dy_max),
        gather(dz_min), gather(dz_max))
    return AssignResult(centerness_targets=centerness_targets,
                        bbox_targets=gt_boxes[min_inds], labels=labels)

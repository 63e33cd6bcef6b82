"""3D box IoU, axis-aligned and rotated, in torch on the caller's device.

Port of ``cnrma_tpu/ops/iou3d.py``.  The rotated rectangle intersection is
the same exact Sutherland–Hodgman convex clip with fixed 16-slot vertex
buffers, batched over any leading axes with torch ops in place of ``vmap``.
The pair matrices go through it in row chunks, so a large N x M stays in
bounded memory.

Box format: (cx, cy, cz, dx, dy, dz[, yaw]) with **gravity-center** z.
"""

from __future__ import annotations

import torch

_MAXV = 16
_PAIRS_PER_CHUNK = 1 << 18      # rotated pairs clipped at once


def rect_corners_bev(boxes: torch.Tensor) -> torch.Tensor:
    """[..., 7] rotated boxes -> [..., 4, 2] BEV corners (ccw)."""
    cx, cy = boxes[..., 0], boxes[..., 1]
    dx, dy = boxes[..., 3], boxes[..., 4]
    yaw = boxes[..., 6] if boxes.shape[-1] > 6 else torch.zeros_like(cx)
    c, s = torch.cos(yaw), torch.sin(yaw)
    hx, hy = dx / 2, dy / 2
    local = torch.stack([
        torch.stack([hx, hy], -1), torch.stack([-hx, hy], -1),
        torch.stack([-hx, -hy], -1), torch.stack([hx, -hy], -1)], dim=-2)
    x = local[..., 0] * c[..., None] - local[..., 1] * s[..., None]
    y = local[..., 0] * s[..., None] + local[..., 1] * c[..., None]
    return torch.stack([x + cx[..., None], y + cy[..., None]], dim=-1)


def _clip_polygon(verts: torch.Tensor, count: torch.Tensor,
                  p1: torch.Tensor, p2: torch.Tensor):
    """Clip convex polygons by the half-plane left of directed edges
    p1 -> p2.  verts: [..., 16, 2] fixed buffers, count: [...] valid
    vertices, p1, p2: [..., 2].  Returns the new (verts, count)."""
    v = _MAXV
    edge = p2 - p1
    rel = verts - p1[..., None, :]
    # signed area: >= 0 keeps (left side for a ccw clip polygon)
    side = edge[..., None, 0] * rel[..., 1] - edge[..., None, 1] * rel[..., 0]
    idx = torch.arange(v, device=verts.device)
    nxt = torch.where(idx + 1 < count[..., None], idx + 1, 0)
    side_n = torch.gather(side, -1, nxt)
    verts_n = torch.gather(verts, -2, nxt[..., None].expand(verts.shape))

    inside = side >= 0
    inside_n = side_n >= 0
    cross = inside != inside_n
    denom = side - side_n
    t = side / torch.where(denom.abs() > 1e-12, denom,
                           torch.full_like(denom, 1e-12))
    inter = verts + t[..., None] * (verts_n - verts)

    active = idx < count[..., None]
    emit_v = active & inside                 # emit the current vertex
    emit_i = active & cross                  # emit the intersection point
    n_emit = emit_v.int() + emit_i.int()
    pos = torch.cumsum(n_emit, -1) - n_emit  # exclusive cumsum
    out = verts.new_zeros(verts.shape[:-2] + (v + 1, 2))   # slot v: drops
    slot_v = torch.where(emit_v, pos, v).long()
    out.scatter_(-2, slot_v[..., None].expand(verts.shape), verts)
    slot_i = torch.where(emit_i, pos + emit_v.int(), v).long()
    out.scatter_(-2, slot_i[..., None].expand(verts.shape), inter)
    return out[..., :v, :], n_emit.sum(-1)


def _poly_area(verts: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    idx = torch.arange(_MAXV, device=verts.device)
    nxt = torch.where(idx + 1 < count[..., None], idx + 1, 0)
    x, y = verts[..., 0], verts[..., 1]
    xn, yn = torch.gather(x, -1, nxt), torch.gather(y, -1, nxt)
    terms = torch.where(idx < count[..., None], x * yn - xn * y, 0.0)
    return terms.sum(-1).abs() / 2


def rotated_rect_intersection_area(c1: torch.Tensor, c2: torch.Tensor
                                   ) -> torch.Tensor:
    """Intersection area of ccw rectangles given as [..., 4, 2] corners
    (leading axes broadcast)."""
    c1, c2 = torch.broadcast_tensors(c1.float(), c2.float())
    lead = c1.shape[:-2]
    verts = c1.new_zeros(lead + (_MAXV, 2))
    verts[..., :4, :] = c1
    count = torch.full(lead, 4, dtype=torch.int32, device=c1.device)
    for e in range(4):
        verts, count = _clip_polygon(verts, count, c2[..., e, :],
                                     c2[..., (e + 1) % 4, :])
    return _poly_area(verts, count)


def _z_overlap(b1: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    zmin1, zmax1 = b1[..., 2] - b1[..., 5] / 2, b1[..., 2] + b1[..., 5] / 2
    zmin2, zmax2 = b2[..., 2] - b2[..., 5] / 2, b2[..., 2] + b2[..., 5] / 2
    return torch.clamp(torch.minimum(zmax1, zmax2)
                       - torch.maximum(zmin1, zmin2), min=0.0)


def aligned_iou_3d(b1: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Elementwise axis-aligned 3D IoU of [..., 6+] boxes (yaw ignored)."""
    inter = _z_overlap(b1, b2)
    for a in (0, 1):
        lo = torch.maximum(b1[..., a] - b1[..., 3 + a] / 2,
                           b2[..., a] - b2[..., 3 + a] / 2)
        hi = torch.minimum(b1[..., a] + b1[..., 3 + a] / 2,
                           b2[..., a] + b2[..., 3 + a] / 2)
        inter = inter * torch.clamp(hi - lo, min=0.0)
    vol1 = b1[..., 3] * b1[..., 4] * b1[..., 5]
    vol2 = b2[..., 3] * b2[..., 4] * b2[..., 5]
    return inter / torch.clamp(vol1 + vol2 - inter, min=1e-8)


def rotated_iou_3d(b1: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Elementwise rotated 3D IoU of [N, 7] boxes (yaw around z)."""
    bev = rotated_rect_intersection_area(rect_corners_bev(b1),
                                         rect_corners_bev(b2))
    inter = bev * _z_overlap(b1, b2)
    vol1 = b1[..., 3] * b1[..., 4] * b1[..., 5]
    vol2 = b2[..., 3] * b2[..., 4] * b2[..., 5]
    return inter / torch.clamp(vol1 + vol2 - inter, min=1e-8)


def _rotated_bev_inter(boxes1: torch.Tensor, boxes2: torch.Tensor
                       ) -> torch.Tensor:
    """[N, M] rotated BEV intersection areas, clipped in row chunks."""
    c1, c2 = rect_corners_bev(boxes1), rect_corners_bev(boxes2)
    rows = max(1, _PAIRS_PER_CHUNK // max(1, c2.shape[0]))
    parts = [rotated_rect_intersection_area(c1[i:i + rows, None], c2[None])
             for i in range(0, c1.shape[0], rows)]
    if not parts:
        return c1.new_zeros((0, c2.shape[0]))
    return torch.cat(parts)


def _aligned_overlap(boxes1: torch.Tensor, boxes2: torch.Tensor, a: int
                     ) -> torch.Tensor:
    lo = torch.maximum((boxes1[:, a] - boxes1[:, 3 + a] / 2)[:, None],
                       (boxes2[:, a] - boxes2[:, 3 + a] / 2)[None, :])
    hi = torch.minimum((boxes1[:, a] + boxes1[:, 3 + a] / 2)[:, None],
                       (boxes2[:, a] + boxes2[:, 3 + a] / 2)[None, :])
    return torch.clamp(hi - lo, min=0)


def iou_bev_matrix(boxes1: torch.Tensor, boxes2: torch.Tensor,
                   rotated: bool) -> torch.Tensor:
    """[N, M] BEV IoU matrix, the overlap of the pcdet NMS kernels (rotated
    for ``nms_gpu``, axis-aligned for ``nms_normal_gpu``)."""
    a1 = boxes1[..., 3] * boxes1[..., 4]
    a2 = boxes2[..., 3] * boxes2[..., 4]
    if rotated:
        inter = _rotated_bev_inter(boxes1, boxes2)
    else:
        inter = (_aligned_overlap(boxes1, boxes2, 0)
                 * _aligned_overlap(boxes1, boxes2, 1))
    return inter / torch.clamp(a1[:, None] + a2[None, :] - inter, min=1e-8)


def iou_3d_matrix(boxes1: torch.Tensor, boxes2: torch.Tensor,
                  rotated: bool) -> torch.Tensor:
    """[N, M] full 3D IoU matrix (for mAP evaluation)."""
    z = _z_overlap(boxes1[:, None, :], boxes2[None, :, :])
    if rotated:
        bev = _rotated_bev_inter(boxes1, boxes2)
    else:
        bev = torch.ones_like(z)
        for a in (0, 1):
            bev = bev * _aligned_overlap(boxes1, boxes2, a)
    inter = bev * z
    vol1 = boxes1[:, 3] * boxes1[:, 4] * boxes1[:, 5]
    vol2 = boxes2[:, 3] * boxes2[:, 4] * boxes2[:, 5]
    return inter / torch.clamp(vol1[:, None] + vol2[None, :] - inter,
                               min=1e-8)

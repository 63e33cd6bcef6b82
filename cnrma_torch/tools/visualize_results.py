"""Visualize detections as wireframe boxes merged with the scene mesh.

    python -m cnrma_torch.tools.visualize_results --result_path RES \
        [--postfix _atlas_bbox] [--score_threshold 0.15] \
        [--generate_gt --gt_path INSTANCE_DATA] [--device cpu]

Port of the JAX package's ``tools/visualize_results.py`` on the port's
``cnrma_torch.utils.ply``: every box above ``--score_threshold`` becomes
twelve coloured edge ribbons (thin quads instead of open3d cylinders),
merged with the scene's mesh into ``{scene}{postfix}.ply``.  The ribbons
of all a scene's boxes are built at once in torch on ``--device``
(``cuda:0`` by default, which needs the card; ``cpu`` on the host), in
the JAX tool's dtypes and order, so that the files are the same.
``--generate_gt`` first converts the GT ``{scene}_aligned_bbox.npy``
instance data into the same ``{boxes, scores, labels}`` npz schema.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from cnrma_torch.tools._common import device_of
from cnrma_torch.utils.ply import read_ply, write_ply_mesh

PALETTE = np.array([
    [255, 99, 71], [65, 105, 225], [60, 179, 113], [255, 215, 0],
    [186, 85, 211], [0, 206, 209], [255, 140, 0], [119, 136, 153],
    [220, 20, 60], [0, 128, 128], [154, 205, 50], [138, 43, 226],
    [233, 150, 122], [70, 130, 180], [189, 183, 107], [205, 92, 92],
    [106, 90, 205], [218, 165, 32]], np.uint8)

EDGES = [(0, 1), (0, 2), (1, 3), (2, 3), (4, 5), (4, 6), (5, 7), (6, 7),
         (0, 4), (1, 5), (2, 6), (3, 7)]

# the corners' (ix, iy, iz) offsets, ix fastest
_CORNER_OFFSETS = [(ix, iy, iz) for iz in (0.0, 1.0) for iy in (-0.5, 0.5)
                   for ix in (-0.5, 0.5)]


def box_corners(boxes: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
                ) -> torch.Tensor:
    """[B, 7+] (cx, cy, cz_bottom, dx, dy, dz[, yaw]) -> [B, 8, 3] corners,
    ``cos``/``sin`` [B] of the yaw, each coordinate as ``cx + x c - y s``
    term by term."""
    cx, cy, cz, dx, dy, dz = boxes[:, :6].unbind(1)
    out = []
    for ix, iy, iz in _CORNER_OFFSETS:
        x, y = ix * dx, iy * dy
        out.append(torch.stack([cx + x * cos - y * sin,
                                cy + x * sin + y * cos, cz + iz * dz], 1))
    return torch.stack(out, 1)


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1]
                      + v[..., 2] * v[..., 2])


def edge_ribbons(corners: torch.Tensor, radius: float = 0.01
                 ) -> torch.Tensor:
    """[B, 8, 3] corners -> [B, 12, 4, 3] fp64 vertices of a thin
    two-triangle ribbon along each edge (``EDGES``), its width across the
    edge and +z (across +y where the edge is vertical)."""
    a = corners[:, [e0 for e0, _ in EDGES]]
    b = corners[:, [e1 for _, e1 in EDGES]]
    d = (b - a).double()
    d0, d1, d2 = d.unbind(-1)
    # numpy's cross product, term by term: d x (0, 0, 1), else d x (0, 1, 0)
    n = torch.stack([d1 * 1.0 - d2 * 0.0, d2 * 0.0 - d0 * 1.0,
                     d0 * 0.0 - d1 * 0.0], -1)
    vertical = _norm(n) < 1e-8
    n = torch.where(vertical[..., None],
                    torch.stack([d1 * 0.0 - d2 * 1.0, d2 * 0.0 - d0 * 0.0,
                                 d0 * 1.0 - d1 * 0.0], -1), n)
    n = n / _norm(n)[..., None] * radius
    p1, p2 = a.double(), b.double()
    return torch.stack([p1 - n, p1 + n, p2 + n, p2 - n], 2)


def wireframes(boxes: np.ndarray, labels: np.ndarray, dev: torch.device,
               base: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The ribbons of ``boxes`` [B, 6+] (gravity-center z) on ``dev``:
    vertices [B*48, 3], faces [B*24, 3] numbered from ``base``, colours
    [B*48, 3] by ``labels``."""
    b = boxes.copy()
    b[:, 2] -= b[:, 5] / 2              # corners want the bottom z
    if b.shape[1] > 6:
        yaw = b[:, 6]
        cos, sin = np.cos(yaw), np.sin(yaw)
    else:                               # a float yaw of 0: fp64 corners
        cos, sin = np.ones(len(b)), np.zeros(len(b))
    t = torch.from_numpy(b).to(dev)
    corners = box_corners(t, torch.from_numpy(cos).to(dev),
                          torch.from_numpy(sin).to(dev))
    verts = edge_ribbons(corners).reshape(-1, 3)
    quad = torch.tensor([[0, 1, 2], [0, 2, 3]], device=dev)
    offsets = torch.arange(len(b) * len(EDGES), device=dev) * 4 + base
    faces = (quad[None] + offsets[:, None, None]).reshape(-1, 3)
    colors = np.repeat(PALETTE[labels.astype(np.int64) % len(PALETTE)],
                       4 * len(EDGES), axis=0)
    return verts.cpu().numpy(), faces.cpu().numpy(), colors


def generate_gt(result_path: str, gt_path: str, postfix: str) -> None:
    """Convert GT ``{scene}_aligned_bbox.npy`` instance data into the same
    ``{boxes, scores, labels}`` npz schema the renderer consumes, so GT and
    predictions can be rendered side by side with different ``--postfix``
    values."""
    for scene in sorted(os.listdir(result_path)):
        scene_dir = os.path.join(result_path, scene)
        if not os.path.isdir(scene_dir):
            continue
        npy = os.path.join(gt_path, scene + "_aligned_bbox.npy")
        if not os.path.isfile(npy):
            continue
        arr = np.load(npy)
        boxes = arr[:, :7].astype(np.float32) if arr.shape[1] >= 7 else \
            np.concatenate([arr[:, :6],
                            np.zeros((len(arr), 1))], 1).astype(np.float32)
        labels = arr[:, -1].astype(np.int64)
        np.savez(os.path.join(scene_dir, scene + postfix + ".npz"),
                 boxes=boxes, scores=np.ones(len(arr), np.float32),
                 labels=labels)
        print(scene, len(arr), "gt boxes")


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--result_path", required=True)
    p.add_argument("--postfix", default="_atlas_bbox")
    p.add_argument("--score_threshold", type=float, default=0.15)
    p.add_argument("--generate_gt", action="store_true")
    p.add_argument("--gt_path", default=None,
                   help="instance-data dir for --generate_gt")
    p.add_argument("--device", default="cuda:0",
                   help="where the ribbons are built (default cuda:0, which "
                        "needs the card; cpu on the host)")
    args = p.parse_args(argv)
    dev = device_of(args.device)

    if args.generate_gt:
        if not args.gt_path:
            p.error("--generate_gt requires --gt_path")
        generate_gt(args.result_path, args.gt_path, args.postfix)

    for scene in sorted(os.listdir(args.result_path)):
        scene_dir = os.path.join(args.result_path, scene)
        npz = os.path.join(scene_dir, scene + args.postfix + ".npz")
        if not os.path.isfile(npz):
            continue
        data = np.load(npz)
        boxes, scores, labels = (data["boxes"], data["scores"],
                                 data["labels"])
        keep = scores > args.score_threshold
        boxes, labels = boxes[keep], labels[keep]

        all_v, all_f, all_c = [], [], []
        base = 0
        mesh_file = os.path.join(scene_dir, scene + ".ply")
        if os.path.isfile(mesh_file):
            mv, mf = read_ply(mesh_file)
            if mv is not None and len(mv):
                all_v.append(mv)
                all_f.append(mf if mf is not None else
                             np.zeros((0, 3), np.int32))
                all_c.append(np.full((len(mv), 3), 190, np.uint8))
                base = len(mv)
        if len(boxes):
            v, f, c = wireframes(boxes, labels, dev, base)
            all_v.append(v)
            all_f.append(f)
            all_c.append(c)
        if not all_v:
            continue
        write_ply_mesh(os.path.join(scene_dir,
                                    scene + args.postfix + ".ply"),
                       np.concatenate(all_v), np.concatenate(all_f),
                       vertex_colors=np.concatenate(all_c))
        print(scene, f"{len(boxes)} boxes")


if __name__ == "__main__":
    main()

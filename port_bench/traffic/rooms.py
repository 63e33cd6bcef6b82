"""The one traffic generator: a pool of planted rooms drawn from the seed.

A mix (``traffic/<name>.json``) gives the pool's size, the room extents,
the box counts and the payload each scene carries:

* ``views``: the posed RGB views of a ring of cameras in the room
  (``ring_poses``, ``scannet_intrinsic``), random pixels, the room's TSDF
  for the march (``planted``, negated so that a ray entering a surface
  sees it rise, the sign the NeuS weights respond to), the subsample's
  uniform draw, and with ``gt_tsdf`` the three GT TSDF scales and the
  augmentation's draws of a training step;
* ``points``: ``num_points`` points on the room's surfaces
  (``room_surface_points``) with N(0, 1) features, and the augmentation's
  draws.

Every scene carries its GT boxes and labels.  Rewritten in torch on the
device from ``cnrma_torch/synthetic.py`` (``room_sdf``, ``room_tsdf``,
``ring_poses``, ``scannet_intrinsic``, ``room_surface_points``), so that
the set-up stays short; the pool then moves to pinned host memory, and
the timed loop copies each scene to the card as the CLIs copy a batch.

Every seed gets the same set of room extents and box counts, in another
order, so that seeds differ in what they draw and not in how much work
they make.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Sequence

import torch

MAX_BOXES = 20


def _spread(lo: float, hi: float, n: int) -> torch.Tensor:
    return torch.linspace(lo, hi, n, dtype=torch.float64)


def room_sdf(x, y, z, extent: Sequence[float], boxes: torch.Tensor):
    """Signed distance (metres, positive in free space) of a room of
    ``extent`` with its corner at the origin: the floor, four walls 0.1 m
    inside the extent, and solid gravity-center ``boxes`` [M, 6+]."""
    ex, ey = float(extent[0]), float(extent[1])
    sdf = torch.minimum(torch.minimum(x - 0.1, ex - 0.1 - x),
                        torch.minimum(y - 0.1, ey - 0.1 - y))
    sdf = torch.minimum(sdf, z - 0.05)
    for cx, cy, cz, dx, dy, dz in boxes[:, :6].tolist():
        qx = (x - cx).abs() - dx / 2
        qy = (y - cy).abs() - dy / 2
        qz = (z - cz).abs() - dz / 2
        outside = torch.sqrt(qx.clamp(min=0) ** 2 + qy.clamp(min=0) ** 2
                             + qz.clamp(min=0) ** 2)
        inside = torch.maximum(torch.maximum(qx, qy), qz).clamp(max=0)
        sdf = torch.minimum(sdf, outside + inside)
    return sdf


def room_tsdf(dim: Sequence[int], voxel_size: float, extent, boxes,
              device, trunc: float = 0.12) -> torch.Tensor:
    """[X, Y, Z] fp32 TSDF in units of ``trunc`` clipped to [-1, 1],
    positive in free space, sampled at the model's voxel positions
    (voxel i at i * voxel_size from the grid origin)."""
    axes = [torch.arange(n, dtype=torch.float32, device=device) * voxel_size
            for n in dim]
    x, y, z = (a.reshape(s) for a, s in zip(
        axes, ((-1, 1, 1), (1, -1, 1), (1, 1, -1))))
    return (room_sdf(x, y, z, extent, boxes) / trunc).clamp(-1.0, 1.0)


def ring_poses(extent: Sequence[float], n_frames: int) -> torch.Tensor:
    """[n, 4, 4] float64 camera-to-world poses (x right, y down, z
    forward) on a ring of 0.3 of the room's width around its centre, a
    third of its height up, 0.3 of the radius above it, each looking at
    it."""
    ex, ey, ez = (float(e) for e in extent)
    center = torch.tensor([ex / 2, ey / 2, min(ez, 3.0) / 3],
                          dtype=torch.float64)
    radius = 0.3 * min(ex, ey)
    poses = []
    for i in range(n_frames):
        a = 2 * math.pi * i / n_frames
        eye = center + radius * torch.tensor([math.cos(a), math.sin(a), 0.3],
                                             dtype=torch.float64)
        fwd = center - eye
        fwd = fwd / fwd.norm()
        right = torch.linalg.cross(fwd, torch.tensor([0.0, 0.0, 1.0],
                                                     dtype=torch.float64))
        right = right / right.norm()
        down = torch.linalg.cross(fwd, right)
        pose = torch.eye(4, dtype=torch.float64)
        pose[:3, 0], pose[:3, 1], pose[:3, 2], pose[:3, 3] = (right, down,
                                                              fwd, eye)
        poses.append(pose)
    return torch.stack(poses)


def scannet_intrinsic(width: int, height: int) -> torch.Tensor:
    """[3, 3] colour intrinsic of ScanNet's 1296x968 camera, scaled."""
    return torch.tensor([[1170.0 * width / 1296, 0, width / 2],
                         [0, 1170.0 * height / 968, height / 2],
                         [0, 0, 1]], dtype=torch.float64)


def projections(extent, n_views: int, height: int, width: int
                ) -> torch.Tensor:
    """[V, 3, 4] fp32 full-resolution projections (intrinsic @
    world-to-camera) of the ring's views."""
    world_to_cam = torch.linalg.inv(ring_poses(extent, n_views))[:, :3]
    return (scannet_intrinsic(width, height) @ world_to_cam).float()


def room_surface_points(extent, boxes: torch.Tensor, n: int,
                        g: torch.Generator) -> torch.Tensor:
    """[n, 3] points drawn by area on the floor, the four walls up to the
    room's height (capped at 3 m) and the six faces of each box."""
    ex, ey, ez = (float(e) for e in extent)
    h = min(ez, 3.0)
    planes = [(2, 0.05, (0.1, 0.1), (ex - 0.1, ey - 0.1)),
              (0, 0.1, (0.1, 0.05), (ey - 0.1, h)),
              (0, ex - 0.1, (0.1, 0.05), (ey - 0.1, h)),
              (1, 0.1, (0.1, 0.05), (ex - 0.1, h)),
              (1, ey - 0.1, (0.1, 0.05), (ex - 0.1, h))]
    for box in boxes[:, :6].tolist():
        ctr, half = box[:3], [d / 2 for d in box[3:6]]
        for axis in range(3):
            rest = [a for a in range(3) if a != axis]
            lo = tuple(ctr[a] - half[a] for a in rest)
            hi = tuple(ctr[a] + half[a] for a in rest)
            for sign in (-1, 1):
                planes.append((axis, ctr[axis] + sign * half[axis], lo, hi))
    dev = g.device
    table = torch.tensor([[axis, c, lo[0], lo[1], hi[0], hi[1]]
                          for axis, c, lo, hi in planes],
                         dtype=torch.float32, device=dev)
    area = (table[:, 4] - table[:, 2]) * (table[:, 5] - table[:, 3])
    which = torch.multinomial(area, n, replacement=True, generator=g)
    u = torch.rand(n, 2, generator=g, device=dev)
    t = table[which]
    a = (t[:, 2:4] + u * (t[:, 4:6] - t[:, 2:4]))
    axis = t[:, 0].long()
    pts = torch.empty(n, 3, dtype=torch.float32, device=dev)
    # the plane's own axis takes its coordinate, the other two in order
    first = torch.where(axis == 0, 1, 0)
    second = torch.where(axis == 2, 1, 2)
    rows = torch.arange(n, device=dev)
    pts[rows, axis] = t[:, 1]
    pts[rows, first] = a[:, 0]
    pts[rows, second] = a[:, 1]
    return pts


def _boxes(extent, n: int, n_classes: int, g: torch.Generator):
    """[n, 7] gravity-center boxes standing on the floor (yaw 0), sizes
    0.3-1.6 m across and 0.3-1.0 m high, inside the walls, and their
    labels."""
    ex, ey, _ = extent
    dev = g.device
    u = torch.rand(n, 5, generator=g, device=dev, dtype=torch.float64).cpu()
    d = torch.stack([0.3 + 1.3 * u[:, 0], 0.3 + 1.3 * u[:, 1],
                     0.3 + 0.7 * u[:, 2]], 1)
    cx = 0.2 + d[:, 0] / 2 + u[:, 3] * (ex - 0.4 - d[:, 0])
    cy = 0.2 + d[:, 1] / 2 + u[:, 4] * (ey - 0.4 - d[:, 1])
    cz = 0.05 + d[:, 2] / 2
    boxes = torch.cat([torch.stack([cx, cy, cz], 1), d,
                       torch.zeros(n, 1, dtype=torch.float64)], 1).float()
    labels = torch.randint(0, n_classes, (n,), generator=g,
                           device=dev).cpu()
    return boxes, labels


def _aug_draws(g: torch.Generator, cfg: Dict[str, Any]) -> Dict[str, Any]:
    """One scene's augmentation draws, as the port's
    ``draw_feature_transform`` keys them."""
    dev = g.device
    u = torch.rand(4, generator=g, device=dev)
    trans = torch.randn(3, generator=g, device=dev)
    lo, hi = cfg["rot_range"]
    s_lo, s_hi = cfg["scale_ratio_range"]
    return {"flip_h": u[0] < cfg["flip_ratio_horizontal"],
            "flip_v": u[1] < cfg["flip_ratio_vertical"],
            "angle": lo + (hi - lo) * u[2],
            "scale": s_lo + (s_hi - s_lo) * u[3],
            "trans": trans * torch.tensor(cfg["translation_std"],
                                          dtype=torch.float32, device=dev)}


def make_pool(mix: Dict[str, Any], config: Dict[str, Any], mode: str,
              seed: int, device: torch.device, pin: bool = True
              ) -> List[Dict[str, Any]]:
    """The mix's pool of scenes from ``seed``: a list of dicts of host
    tensors (pinned where ``pin``), each a one-scene batch as the port's
    loaders give it, plus ``planted`` (the march's TSDF) and the draws
    (``uniform``, ``aug_draws``) that the step takes."""
    n = int(mix["pool"])
    g = torch.Generator(device=device).manual_seed(int(seed))
    ext_xy, ext_z = mix["extent_xy"], mix["extent_z"]
    counts = mix["boxes_per_scene"]
    if len(counts) != n:
        raise ValueError("boxes_per_scene needs one count a scene")
    # the same n scene sizes for every seed, paired in a fixed way, in an
    # order drawn from the seed
    xy, z = _spread(*ext_xy, n).tolist(), _spread(*ext_z, n).tolist()
    sizes = [(xy[i], xy[(3 * i + 1) % n], z[(5 * i + 2) % n], counts[i])
             for i in range(n)]
    sizes = [sizes[i] for i in torch.randperm(n, generator=g,
                                              device=g.device).tolist()]
    model = config["model"]
    n_classes = int(model.get("n_classes", model.get(
        "detection_head", {}).get("n_classes", 18)))
    aug_cfg = model.get("feature_transform") or {}
    pool = []
    for s in range(n):
        extent = tuple(float(e) for e in sizes[s][:3])
        boxes, labels = _boxes(extent, int(sizes[s][3]), n_classes, g)
        m = len(boxes)
        scene: Dict[str, Any] = {
            "gt_boxes": torch.zeros(1, MAX_BOXES, 7),
            "gt_labels": torch.zeros(1, MAX_BOXES, dtype=torch.int64),
            "gt_valid": torch.zeros(1, MAX_BOXES, dtype=torch.bool)}
        scene["gt_boxes"][0, :m] = boxes
        scene["gt_labels"][0, :m] = labels
        scene["gt_valid"][0, :m] = True
        if mix["payload"] == "views":
            dim = model["voxel_dim_test" if mode == "test"
                        else "voxel_dim_train"]
            vs = float(model["voxel_size"])
            views = int(config["views"][mode])
            h, w = config["image_hw"]
            scene["imgs"] = torch.rand(1, views, h, w, 3, generator=g,
                                       device=device) * 255.0
            scene["projection"] = projections(extent, views, h, w)[None]
            scene["offset"] = torch.zeros(1, 3)
            tsdf = room_tsdf(dim, vs, extent, boxes, device)
            scene["planted"] = -tsdf
            cap = int(model["rays_per_view_cap"])
            scene["uniform"] = torch.rand(1, views * cap, generator=g,
                                          device=device)
            if mix.get("gt_tsdf"):
                scene["tsdf_list"] = {}
                for k in (1, 2, 4):
                    key = f"tsdf_gt_{int(round(vs * k * 100)):03d}"
                    scene["tsdf_list"][key] = room_tsdf(
                        [d // k for d in dim], vs * k, extent, boxes,
                        device)[None]
        elif mix["payload"] == "points":
            p = int(config["num_points"])
            scene["points"] = room_surface_points(extent, boxes, p, g)[None]
            scene["point_feats"] = torch.randn(
                1, p, int(config["point_feats"]), generator=g, device=device)
            scene["point_valid"] = torch.ones(1, p, dtype=torch.bool)
        else:
            raise ValueError(f"unknown payload {mix['payload']!r}")
        if mix.get("aug_draws"):
            scene["aug_draws"] = [_aug_draws(g, aug_cfg)]
        scene["extent"] = extent
        scene["n_boxes"] = m
        pool.append(to_host(scene, pin))
    return pool


def to_host(x, pin: bool):
    if isinstance(x, torch.Tensor):
        x = x.cpu()
        return x.pin_memory() if pin else x
    if isinstance(x, dict):
        return {k: to_host(v, pin) for k, v in x.items()}
    if isinstance(x, list):
        return [to_host(v, pin) for v in x]
    return x


def to_device(x, device: torch.device):
    """The scene's tensors on ``device``, copied without a host sync."""
    if isinstance(x, torch.Tensor):
        return x.to(device, non_blocking=True)
    if isinstance(x, dict):
        return {k: to_device(v, device) for k, v in x.items()}
    if isinstance(x, list):
        return [to_device(v, device) for v in x]
    return x

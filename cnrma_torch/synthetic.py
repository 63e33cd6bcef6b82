"""Synthetic scenes and parameters for driving the port without a dataset or
a checkpoint: bench.py's ring of cameras, a sphere TSDF, bench.py's
parameter recipe, whole ScanNet and ARKitScenes scenes on disk
(``write_scannet``, ``write_arkit``), stage-2 point dumps of them
(``write_point_dumps``), and ScanNet's raw inputs to the data preparation
(``write_scannet_raw``: a ``.sens`` stream with depth ray-cast from the
planted room, and the scan's mesh and annotations), all made from a
seed."""

from __future__ import annotations

import io
import json
import os
import pickle
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from PIL import Image


def ring_projections(n_views: int, height: int, width: int,
                     voxel_dim: Sequence[int], voxel_size: float = 0.04
                     ) -> np.ndarray:
    """[V, 3, 4] full-resolution projections (intrinsics @ world-to-camera)
    of cameras on a ring 3 m around the volume centre, 0.5 m up, looking
    at it (``bench.py:158-176``)."""
    center = np.asarray(voxel_dim, np.float64) * voxel_size / 2
    intr = np.array([[580.0 * width / 640, 0, width / 2],
                     [0, 580.0 * height / 480, height / 2], [0, 0, 1]],
                    np.float32)
    projs = []
    for i in range(n_views):
        a = 2 * np.pi * i / n_views
        eye = center + np.array([3.0 * np.cos(a), 3.0 * np.sin(a), 0.5])
        fwd = center - eye
        fwd = fwd / np.linalg.norm(fwd)
        right = np.cross(fwd, [0, 0, 1.0])
        right /= np.linalg.norm(right)
        up = np.cross(right, fwd)
        E = np.eye(4, dtype=np.float32)            # camera-to-world
        E[:3, 0], E[:3, 1], E[:3, 2], E[:3, 3] = right, -up, fwd, eye
        projs.append(intr @ np.linalg.inv(E)[:3])
    return np.stack(projs).astype(np.float32)


def sphere_tsdf(voxel_dim: Sequence[int], voxel_size: float,
                radius: float, trunc: float) -> torch.Tensor:
    """[X, Y, Z] fp32 truncated signed distance (in units of ``trunc``,
    clipped to [-1, 1]) to a sphere at the volume centre."""
    axes = [(torch.arange(n, dtype=torch.float64) + 0.5) * voxel_size
            for n in voxel_dim]
    gx, gy, gz = torch.meshgrid(*axes, indexing="ij")
    c = [n * voxel_size / 2 for n in voxel_dim]
    r = torch.sqrt((gx - c[0]) ** 2 + (gy - c[1]) ** 2 + (gz - c[2]) ** 2)
    return ((r - radius) / trunc).clamp(-1.0, 1.0).float()


@torch.no_grad()
def synthesize_parameters(module: torch.nn.Module, seed: int) -> None:
    """bench.py's recipe (``bench.py:226-239``): every floating parameter
    and buffer drawn from N(0, 0.02), variance buffers as |N(0, 0.02)| + 1
    so the eval BatchNorms stay finite.  Deterministic in ``seed``."""
    g = torch.Generator().manual_seed(seed)
    for name, t in module.state_dict().items():
        if not t.is_floating_point():
            continue
        draw = torch.randn(t.shape, generator=g, dtype=torch.float32) * 0.02
        if name.endswith("running_var"):
            draw = draw.abs() + 1.0
        t.copy_(draw)


# NYU40 ids of the planted objects (ScanNet's table, chair, bed, cabinet)
_ROOM_OBJECTS = ((0.35, 0.35, 0.40, 0.20, 0.15, 0.20, 7),
                 (0.62, 0.40, 0.25, 0.08, 0.08, 0.25, 5),
                 (0.40, 0.68, 0.30, 0.25, 0.18, 0.15, 4),
                 (0.75, 0.75, 0.50, 0.10, 0.20, 0.40, 3))
_SCANNET_CAT_IDS = (3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24, 28, 33, 34,
                    36, 39)


def room_boxes(extent: Sequence[float]) -> np.ndarray:
    """[4, 7] planted objects of a room of ``extent`` metres: gravity-center
    (cx, cy, cz, dx, dy, dz) and the NYU40 category id.  Positions and
    sizes are fractions of the extent (z of the height, capped at 3 m)."""
    ex, ey, ez = (float(e) for e in extent)
    h = min(ez, 3.0)
    rows = [(fx * ex, fy * ey, fz * h, sx * ex, sy * ey, sz * h, cat)
            for fx, fy, fz, sx, sy, sz, cat in _ROOM_OBJECTS]
    return np.array(rows, np.float32)


def room_tsdf(dim: Sequence[int], voxel_size: float, extent: Sequence[float],
              boxes: np.ndarray, trunc: float = 0.12,
              yaw: Optional[Sequence[float]] = None) -> np.ndarray:
    """[X, Y, Z] TSDF (in units of ``trunc``, clipped to [-1, 1]; positive in
    free space) of a room of ``extent`` metres from the grid origin: its
    floor, four walls 0.1 m inside the extent, and solid gravity-center
    ``boxes`` [M, 6+], each turned by its ``yaw`` about +z if given."""
    axes = [(np.arange(n, dtype=np.float32) + 0.5) * voxel_size
            for n in dim]
    x, y, z = np.meshgrid(*axes, indexing="ij")
    sdf = room_sdf(x, y, z, extent, boxes, yaw)
    return np.clip(sdf / trunc, -1.0, 1.0).astype(np.float32)


def room_sdf(x: np.ndarray, y: np.ndarray, z: np.ndarray,
             extent: Sequence[float], boxes: np.ndarray,
             yaw: Optional[Sequence[float]] = None) -> np.ndarray:
    """The signed distance (metres, positive in free space) of
    ``room_tsdf``'s room at the points ``(x, y, z)``, in the room's frame
    (its corner at the origin)."""
    ex, ey, _ = extent
    sdf = np.minimum.reduce([x - 0.1, ex - 0.1 - x, y - 0.1, ey - 0.1 - y,
                             z - 0.05])
    yaw = np.zeros(len(boxes)) if yaw is None else yaw
    for (cx, cy, cz, dx, dy, dz), a in zip(boxes[:, :6], yaw):
        c, s = np.float32(np.cos(a)), np.float32(np.sin(a))
        lx = c * (x - cx) + s * (y - cy)          # the box's own frame
        ly = c * (y - cy) - s * (x - cx)
        q = np.stack([np.abs(lx) - dx / 2, np.abs(ly) - dy / 2,
                      np.abs(z - cz) - dz / 2])
        outside = np.linalg.norm(np.maximum(q, 0.0), axis=0)
        box = outside + np.minimum(q.max(axis=0), 0.0)
        sdf = np.minimum(sdf, box)
    return sdf


def _look_at(eye: np.ndarray, target: np.ndarray) -> np.ndarray:
    """Camera-to-world pose, ScanNet's camera axes (x right, y down, z
    forward)."""
    fwd = target - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, [0.0, 0.0, 1.0])
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    pose = np.eye(4)
    pose[:3, 0], pose[:3, 1], pose[:3, 2], pose[:3, 3] = right, down, fwd, eye
    return pose


def ring_poses(extent: Sequence[float], n_frames: int,
               target: Optional[Sequence[float]] = None,
               radius: Optional[float] = None) -> List[np.ndarray]:
    """``write_scannet``'s camera-to-world poses: a ring of ``radius`` (0.3
    of the room's width) around ``target`` (the room's centre, a third of
    its height up), 0.3 ``radius`` above it, each camera looking at it."""
    extent = np.asarray(extent, np.float64)
    center = np.asarray(target if target is not None else
                        (extent[0] / 2, extent[1] / 2,
                         min(extent[2], 3.0) / 3), np.float64)
    radius = radius or 0.3 * min(extent[0], extent[1])
    poses = []
    for i in range(n_frames):
        a = 2 * np.pi * i / n_frames
        eye = center + radius * np.array([np.cos(a), np.sin(a), 0.3])
        poses.append(_look_at(eye, center))
    return poses


def scannet_intrinsic(width: int, height: int) -> np.ndarray:
    """[4, 4] colour intrinsic of ScanNet's 1296x968 camera, scaled to
    ``width`` x ``height``."""
    return np.array([[1170.0 * width / 1296, 0, width / 2, 0],
                     [0, 1170.0 * height / 968, height / 2, 0],
                     [0, 0, 1, 0], [0, 0, 0, 1]])


def render_room_depth(poses: Sequence[np.ndarray], intrinsic: np.ndarray,
                      size: Tuple[int, int], extent: Sequence[float],
                      boxes: np.ndarray) -> np.ndarray:
    """[F, H, W] fp32 depth (metres along the camera's z, 0 where a ray
    meets nothing) of ``room_tsdf``'s room seen from camera-to-world
    ``poses`` through ``intrinsic`` [3, 3] at ``size`` (width, height):
    each pixel's ray cast on the host against the floor, the four walls
    (of unbounded height, as ``room_sdf``'s) and the axis-aligned
    gravity-center ``boxes`` [M, 6+]."""
    w, h = size
    ex, ey = float(extent[0]), float(extent[1])
    v, u = np.meshgrid(np.arange(h, dtype=np.float32),
                       np.arange(w, dtype=np.float32), indexing="ij")
    cam = np.stack([(u.ravel() - np.float32(intrinsic[0, 2]))
                    / np.float32(intrinsic[0, 0]),
                    (v.ravel() - np.float32(intrinsic[1, 2]))
                    / np.float32(intrinsic[1, 1]),
                    np.ones(h * w, np.float32)])      # z = 1: t is depth
    lo_box = boxes[:, :3] - boxes[:, 3:6] / 2
    hi_box = boxes[:, :3] + boxes[:, 3:6] / 2
    walls = ((0, (0.1, ex - 0.1)), (1, (0.1, ey - 0.1)), (2, (0.05,)))

    def frame(pose: np.ndarray) -> np.ndarray:
        d = pose[:3, :3].astype(np.float32) @ cam              # [3, HW]
        o = pose[:3, 3]
        inv = 1.0 / np.where(np.abs(d) < 1e-12, np.float32(1e-12), d)
        # the room's inside, from within: its nearest plane ahead
        t = np.full(h * w, np.inf, np.float32)
        for axis, planes in walls:
            for c in planes:
                tp = np.float32(c - o[axis]) * inv[axis]
                np.minimum(t, np.where(tp > 0, tp, np.inf), out=t)
        for lo, hi in zip(lo_box, hi_box):
            near = np.zeros(h * w, np.float32)
            far = np.full(h * w, np.inf, np.float32)
            for a in range(3):
                t1 = np.float32(lo[a] - o[a]) * inv[a]
                t2 = np.float32(hi[a] - o[a]) * inv[a]
                np.maximum(near, np.minimum(t1, t2), out=near)
                np.minimum(far, np.maximum(t1, t2), out=far)
            hit = (near <= far) & (near > 0)
            np.minimum(t, np.where(hit, near, np.inf), out=t)
        return np.where(np.isfinite(t), t, 0.0).reshape(h, w)

    # numpy's loops release the GIL: frames on a few threads
    with ThreadPoolExecutor(max(1, min(8, os.cpu_count() or 1))) as pool:
        return np.stack(list(pool.map(frame, poses))).astype(np.float32)


def fused_sign_agreement(tsdf: np.ndarray, origin: Sequence[float],
                         voxel_size: float, extent: Sequence[float],
                         boxes: np.ndarray) -> Tuple[float, int]:
    """(share, count) of a fused TSDF's observed voxels (``|tsdf| < 1``,
    which is ``weight > 0``) whose sign agrees with ``room_sdf``'s room at
    the voxel's position ``origin + index * voxel_size``.  The fusion's
    sign is Atlas's, negative in front of the surface, and ``room_sdf``'s
    positive in free space: agreement is ``sign(tsdf) == -sign(sdf)``;
    voxels on the surface (sdf 0) are left out."""
    seen = np.abs(tsdf) < 1
    idx = np.nonzero(seen)
    pts = [np.float32(origin[a]) + idx[a].astype(np.float32)
           * np.float32(voxel_size) for a in range(3)]
    sdf = room_sdf(*pts, extent, boxes)
    val = tsdf[idx]
    keep = (sdf != 0) & (val != 0)
    agree = np.sign(val[keep]) == -np.sign(sdf[keep])
    return (float(agree.mean()) if agree.size else 0.0), int(agree.size)


def depth_mm(depth: np.ndarray) -> np.ndarray:
    """Metric depth -> uint16 millimetres, ScanNet's depth PNG (0 where
    invalid or beyond 65.535 m)."""
    mm = np.round(depth.astype(np.float64) * 1000.0)
    return np.where((mm > 0) & (mm < 65536), mm, 0).astype(np.uint16)


# ScanNet's depth camera, scaled from the colour camera's 1296x968 to
# 640x480 (the .sens depth size)
SCANNET_COLOR_SIZE = (1296, 968)
SCANNET_DEPTH_SIZE = (640, 480)


def write_sens(path: str, poses: Sequence[np.ndarray],
               colors: Sequence[bytes], depths_mm: Sequence[np.ndarray],
               intrinsic_color: np.ndarray, intrinsic_depth: np.ndarray,
               color_size: Tuple[int, int], depth_size: Tuple[int, int]
               ) -> None:
    """Write a ScanNet ``.sens`` stream (version 4): the header with both
    cameras' [4, 4] intrinsics (identity extrinsics), JPEG colour and
    ``zlib_ushort`` depth (mm, depth shift 1000), then one record a frame:
    its camera-to-world pose, two timestamps, the colour JPEG ``colors[i]``
    and the compressed ``depths_mm[i]``."""
    name = b"synthetic"
    eye = np.eye(4, dtype=np.float32)
    with open(path, "wb") as f:
        f.write(struct.pack("<IQ", 4, len(name)) + name)
        for m in (intrinsic_color, eye, intrinsic_depth, eye):
            f.write(np.asarray(m, "<f4").reshape(4, 4).tobytes())
        f.write(struct.pack("<ii", 2, 1))          # jpeg, zlib_ushort
        f.write(struct.pack("<IIII", *color_size, *depth_size))
        f.write(struct.pack("<fQ", 1000.0, len(poses)))
        for i, (pose, color, depth) in enumerate(zip(poses, colors,
                                                     depths_mm)):
            packed = zlib.compress(np.asarray(depth, "<u2").tobytes(), 1)
            f.write(np.asarray(pose, "<f4").reshape(4, 4).tobytes())
            f.write(struct.pack("<QQQQ", 33333 * i, 33333 * i, len(color),
                                len(packed)))
            f.write(color)
            f.write(packed)


# the scan's labels: raw category -> (NYU40 id, NYU40 class)
_SCAN_LABELS = {"wall": (1, "wall"), "floor": (2, "floor"),
                "kitchen cabinet": (3, "cabinet"), "bed": (4, "bed"),
                "chair": (5, "chair"), "table": (7, "table")}
_NYU_RAW = {3: "kitchen cabinet", 4: "bed", 5: "chair", 7: "table"}


def _grid_patch(origin, ax_u, ax_v, nu: int, nv: int):
    """Vertices [(nu+1)(nv+1), 3] and triangles of a planar patch spanned by
    ``ax_u`` and ``ax_v`` from ``origin``."""
    a, b = np.meshgrid(np.linspace(0, 1, nu + 1), np.linspace(0, 1, nv + 1),
                       indexing="ij")
    verts = (np.asarray(origin)[None] + a.reshape(-1, 1) * ax_u[None]
             + b.reshape(-1, 1) * ax_v[None])
    idx = np.arange((nu + 1) * (nv + 1)).reshape(nu + 1, nv + 1)
    q0, q1 = idx[:-1, :-1].ravel(), idx[1:, :-1].ravel()
    q2, q3 = idx[1:, 1:].ravel(), idx[:-1, 1:].ravel()
    faces = np.concatenate([np.stack([q0, q1, q2], 1),
                            np.stack([q0, q2, q3], 1)])
    return verts, faces


def write_scan(scan_dir: str, scene: str, extent: Sequence[float],
               boxes: np.ndarray, rng: np.random.RandomState,
               axis_align: Optional[np.ndarray] = None) -> None:
    """Write a ScanNet scan of ``room_tsdf``'s room into ``scan_dir``:
    ``{scene}_vh_clean_2.ply`` (binary, xyz and rgb, a triangle grid of
    0.1 m over the floor, the four walls up to the room's height and
    each box's six faces, in the poses' world frame),
    ``{scene}_vh_clean_2.0.010000.segs.json`` (one segment a face),
    ``{scene}.aggregation.json`` (the floor, the walls and each box as an
    object, labelled by ScanNet's raw categories) and ``{scene}.txt``
    (``axisAlignment``, identity unless ``axis_align`` is given)."""
    from cnrma_torch.utils.ply import write_ply_mesh
    ex, ey, ez = (float(e) for e in extent)
    hgt = min(ez, 3.0)
    e = np.eye(3)
    # (object label, [(origin, axis u, axis v)])
    objects = [("floor", [((0.1, 0.1, 0.05), (ex - 0.2) * e[0],
                           (ey - 0.2) * e[1])]),
               ("wall", [((0.1, 0.1, 0.05), (ey - 0.2) * e[1],
                          (hgt - 0.05) * e[2]),
                         ((ex - 0.1, 0.1, 0.05), (ey - 0.2) * e[1],
                          (hgt - 0.05) * e[2])]),
               ("wall", [((0.1, 0.1, 0.05), (ex - 0.2) * e[0],
                          (hgt - 0.05) * e[2]),
                         ((0.1, ey - 0.1, 0.05), (ex - 0.2) * e[0],
                          (hgt - 0.05) * e[2])])]
    for cx, cy, cz, dx, dy, dz, cat in boxes[:, :7]:
        lo = np.array([cx - dx / 2, cy - dy / 2, cz - dz / 2], np.float64)
        size = np.array([dx, dy, dz], np.float64)
        faces = []
        for axis in range(3):
            u, v = [a for a in range(3) if a != axis]
            for side in (0.0, 1.0):
                o = lo + side * size[axis] * e[axis]
                faces.append((o, size[u] * e[u], size[v] * e[v]))
        objects.append((_NYU_RAW[int(cat)], faces))
    verts, tris, seg_ids, groups = [], [], [], []
    seg = 0
    for obj_id, (label, patches) in enumerate(objects):
        segs = []
        for o, au, av in patches:
            nu = max(1, int(np.ceil(np.linalg.norm(au) / 0.1)))
            nv = max(1, int(np.ceil(np.linalg.norm(av) / 0.1)))
            pv, pf = _grid_patch(o, np.asarray(au), np.asarray(av), nu, nv)
            tris.append(pf + sum(len(x) for x in verts))
            verts.append(pv)
            seg_ids.append(np.full(len(pv), seg))
            segs.append(seg)
            seg += 1
        groups.append({"id": obj_id, "objectId": obj_id, "segments": segs,
                       "label": label})
    verts = np.concatenate(verts).astype(np.float32)
    colors = rng.randint(0, 256, (len(verts), 3)).astype(np.uint8)
    os.makedirs(scan_dir, exist_ok=True)
    base = os.path.join(scan_dir, scene)
    write_ply_mesh(base + "_vh_clean_2.ply", verts, np.concatenate(tris),
                   vertex_colors=colors)
    with open(base + "_vh_clean_2.0.010000.segs.json", "w") as f:
        json.dump({"params": {"segMinVerts": 20}, "sceneId": scene,
                   "segIndices": np.concatenate(seg_ids).tolist()}, f)
    with open(base + ".aggregation.json", "w") as f:
        json.dump({"sceneId": scene, "segGroups": groups,
                   "segmentsFile": f"{scene}_vh_clean_2.0.010000.segs.json"},
                  f)
    align = np.eye(4) if axis_align is None else np.asarray(axis_align)
    with open(base + ".txt", "w") as f:
        f.write("axisAlignment = " + " ".join(f"{x:.6f}" for x in
                                              align.ravel()) + "\n")


def write_label_map(path: str) -> None:
    """A ``scannetv2-labels.combined.tsv`` holding the scan's raw
    categories."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write("id\traw_category\tcategory\tcount\tnyu40id\tnyu40class\n")
        for i, (raw, (nyu, cls)) in enumerate(_SCAN_LABELS.items()):
            f.write(f"{i + 1}\t{raw}\t{raw}\t1\t{nyu}\t{cls}\n")


def write_scannet_raw(root: str, n_scenes: int = 1, n_frames: int = 300,
                      tsdf_dim: Tuple[int, int, int] = (208, 208, 80),
                      voxel_size: float = 0.04,
                      color_size: Tuple[int, int] = SCANNET_COLOR_SIZE,
                      depth_size: Tuple[int, int] = SCANNET_DEPTH_SIZE,
                      seed: int = 0,
                      axis_align: Optional[np.ndarray] = None
                      ) -> Dict[str, np.ndarray]:
    """Write ScanNet's raw inputs to the data preparation for ``n_scenes``
    synthetic scenes of ``room_tsdf``'s room (``tsdf_dim`` voxels at
    ``voxel_size``, its four boxes), and return the two cameras'
    intrinsics (``intrinsic_color``, ``intrinsic_depth``, [4, 4]):

    * ``scans/{scene}/{scene}.sens``: ``n_frames`` frames on
      ``write_scannet``'s ring of poses, colour ``color_size`` JPEG (a
      smooth random pattern), depth ``depth_size`` in mm ray-cast from the
      room through the depth camera's own intrinsic
      (``render_room_depth``);
    * the scan (``write_scan``): mesh, segments, aggregation, meta;
    * ``meta_data/scannetv2-labels.combined.tsv`` and
      ``meta_data/scannetv2_{train,val}.txt`` (every scene in both)."""
    rng = np.random.RandomState(seed)
    extent = np.asarray(tsdf_dim, np.float64) * voxel_size
    poses = ring_poses(extent, n_frames)
    boxes = room_boxes(extent)
    k_color = scannet_intrinsic(*color_size)
    k_depth = scannet_intrinsic(*depth_size)
    depths = render_room_depth(poses, k_depth[:3, :3], depth_size, extent,
                               boxes)
    cw, ch = color_size
    scenes = []
    for s in range(n_scenes):
        scene = f"scene{s:04d}_00"
        scan_dir = os.path.join(root, "scans", scene)
        os.makedirs(scan_dir, exist_ok=True)
        colors = []
        for _ in range(n_frames):
            small = rng.randint(0, 255, (ch // 16, cw // 16, 3), np.uint8)
            buf = io.BytesIO()
            Image.fromarray(small).resize((cw, ch), Image.BILINEAR).save(
                buf, format="JPEG", quality=90)
            colors.append(buf.getvalue())
        write_sens(os.path.join(scan_dir, scene + ".sens"), poses, colors,
                   [depth_mm(d) for d in depths], k_color, k_depth,
                   color_size, depth_size)
        write_scan(scan_dir, scene, extent, boxes, rng, axis_align)
        scenes.append(scene)
    meta = os.path.join(root, "meta_data")
    write_label_map(os.path.join(meta, "scannetv2-labels.combined.tsv"))
    for split in ("train", "val"):
        with open(os.path.join(meta, f"scannetv2_{split}.txt"), "w") as f:
            f.write("\n".join(scenes) + "\n")
    return {"intrinsic_color": k_color, "intrinsic_depth": k_depth}


def write_scannet(root: str, n_scenes: int = 2, n_frames: int = 60,
                  tsdf_dim: Tuple[int, int, int] = (208, 208, 80),
                  voxel_size: float = 0.04, image_size=(1296, 968),
                  seed: int = 0, ann_name: str = "scannet_infos_val.pkl",
                  target: Optional[Sequence[float]] = None,
                  radius: Optional[float] = None,
                  depth_png: bool = False) -> str:
    """Write ``n_scenes`` synthetic scenes in ScanNet's on-disk layout, as
    ``data/scannet.py`` reads it, and return the infos file's path:

    * ``posed_images/{scene}/{id:05d}.jpg`` (``image_size`` JPEG frames of
      a smooth random pattern), ``{id:05d}.txt`` camera-to-world poses on a
      ring of ``radius`` (0.3 of the room's width) around ``target`` (the
      room's centre, a third of its height up), 0.3 ``radius`` above it and
      looking at it, ``intrinsic.txt``; with ``depth_png``, also
      ``{id:05d}.png``: the room's depth in mm at ``image_size``, ray-cast
      through the same intrinsic (``render_room_depth``);
    * ``atlas_tsdf/{scene}/tsdf_{04,08,16}.npz``: a room (floor, walls, four
      boxes) over ``tsdf_dim`` voxels at ``voxel_size`` and the two coarser
      scales, origin 0;
    * ``scannet_instance_data/{scene}_aligned_bbox.npy``: the planted boxes
      (gravity-center z, NYU40 id last), for ``evaluate_bbox``;
    * ``{ann_name}``: the infos pickle."""
    rng = np.random.RandomState(seed)
    w, h = image_size
    extent = np.asarray(tsdf_dim, np.float64) * voxel_size
    poses = ring_poses(extent, n_frames, target, radius)
    intrinsic = scannet_intrinsic(w, h)
    boxes = room_boxes(extent)
    depths = (render_room_depth(poses, intrinsic[:3, :3], (w, h), extent,
                                boxes) if depth_png else None)
    gt_dir = os.path.join(root, "scannet_instance_data")
    os.makedirs(gt_dir, exist_ok=True)
    infos: List[dict] = []
    for s in range(n_scenes):
        scene = f"scene{s:04d}_00"
        posed = os.path.join(root, "posed_images", scene)
        os.makedirs(posed, exist_ok=True)
        np.savetxt(os.path.join(posed, "intrinsic.txt"), intrinsic)
        for i in range(n_frames):
            small = rng.randint(0, 255, (h // 16, w // 16, 3), np.uint8)
            Image.fromarray(small).resize((w, h), Image.BILINEAR).save(
                os.path.join(posed, f"{i:05d}.jpg"), quality=90)
            np.savetxt(os.path.join(posed, f"{i:05d}.txt"), poses[i])
            if depths is not None:
                Image.fromarray(depth_mm(depths[i])).save(
                    os.path.join(posed, f"{i:05d}.png"))
        tsdf_dir = os.path.join(root, "atlas_tsdf", scene)
        os.makedirs(tsdf_dir, exist_ok=True)
        for k in (1, 2, 4):
            vs = voxel_size * k
            np.savez_compressed(
                os.path.join(tsdf_dir, f"tsdf_{int(round(vs * 100)):02d}.npz"),
                origin=np.zeros((1, 3), np.float32), voxel_size=vs,
                tsdf=room_tsdf([d // k for d in tsdf_dim], vs, extent, boxes))
        np.save(os.path.join(gt_dir, scene + "_aligned_bbox.npy"), boxes)
        infos.append({
            "scene": scene,
            "total_image_ids": list(range(n_frames)),
            "annos": {
                "gt_num": len(boxes),
                "gt_boxes_upright_depth": boxes[:, :6].copy(),
                "class": np.array([_SCANNET_CAT_IDS.index(int(c))
                                   for c in boxes[:, 6]]),
                "axis_align_matrix": np.eye(4, dtype=np.float32),
            }})
    ann = os.path.join(root, ann_name)
    with open(ann, "wb") as f:
        pickle.dump(infos, f)
    return ann


def axis_angle(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> axis-angle vector (the inverse of
    ``data.arkit.rodrigues``), through the unit quaternion."""
    tr = np.trace(R)
    if tr > 0:
        w = np.sqrt(1.0 + tr) / 2
        v = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                      R[1, 0] - R[0, 1]]) / (4 * w)
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        q = np.sqrt(1.0 + R[i, i] - R[j, j] - R[k, k]) / 2
        v = np.empty(3)
        v[i] = q
        v[j] = (R[j, i] + R[i, j]) / (4 * q)
        v[k] = (R[k, i] + R[i, k]) / (4 * q)
        w = (R[k, j] - R[j, k]) / (4 * q)
    n = np.linalg.norm(v)
    if n < 1e-12:
        return np.zeros(3)
    return 2 * np.arctan2(n, w) * v / n


# ARKitScenes objects of a synthetic room: gravity-center box (position and
# size as fractions of the room, z of its height), yaw, class id (0-16)
_ARKIT_OBJECTS = ((0.30, 0.32, 0.20, 0.22, 0.12, 0.30, 0.45, 14),   # table
                  (0.64, 0.35, 0.15, 0.07, 0.10, 0.30, -0.80, 13),  # chair
                  (0.38, 0.70, 0.17, 0.30, 0.13, 0.33, 1.15, 16),   # sofa
                  (0.75, 0.72, 0.33, 0.10, 0.22, 0.66, -0.30, 0),   # cabinet
                  (0.55, 0.55, 0.10, 0.08, 0.06, 0.20, 2.40, 12))   # stool
_ARKIT_SPLITS = {"Training": "arkit_infos_train.pkl",
                 "Validation": "arkit_infos_val.pkl"}
ARKIT_PINCAM = (256, 192, 212.0, 212.0, 127.5, 95.5)   # lowres_wide


def arkit_room_boxes(extent: Sequence[float]) -> np.ndarray:
    """[5, 8] yaw objects of a room of ``extent`` metres from the grid
    origin: gravity-center (cx, cy, cz, dx, dy, dz), yaw and the ARKit
    class id; non-square, turned by yaws that no multiple of pi/2 undoes."""
    ex, ey, ez = (float(e) for e in extent)
    h = min(ez, 3.0)
    return np.array([(fx * ex, fy * ey, fz * h, sx * ex, sy * ey, sz * h,
                      yaw, cls) for fx, fy, fz, sx, sy, sz, yaw, cls
                     in _ARKIT_OBJECTS], np.float32)


def write_arkit(root: str, n_scenes: int = 2, n_frames: int = 60,
                seed: int = 0, split: str = "Validation",
                tsdf_dim: Tuple[int, int, int] = (168, 152, 64),
                voxel_size: float = 0.04,
                image_size: Tuple[int, int] = ARKIT_PINCAM[:2]) -> str:
    """Write ``n_scenes`` synthetic scenes in ARKitScenes' raw on-disk
    layout, as ``data/arkit.py`` reads it, and return the infos file's
    path (``arkit_infos_val.pkl`` for the ``Validation`` split,
    ``arkit_infos_train.pkl`` for ``Training``):

    * ``{split}/{scene}/{scene}_frames/lowres_wide/{scene}_{ts}.png``
      (``image_size`` PNG frames of a smooth random pattern; ``ts`` the
      frame's timestamp, 0.1 s apart, three decimals),
      ``lowres_wide_intrinsics/{scene}_{ts}.pincam`` (a quarter of them
      named 1 ms early and a quarter 1 ms late, as the reader's name
      fallback allows) and ``lowres_wide.traj``: a world-to-camera
      axis-angle pose for every frame, a third of them stamped 3 ms late
      (the reader's ±5 ms fallback, each the only pose in its window), and
      a pose between every two frames; cameras on a ring around the
      room's centre, looking at it;
    * ``atlas_tsdf/{scene}/tsdf_{04,08,16}.npz``: a room (floor, walls and
      five yaw boxes) over ``tsdf_dim`` voxels at ``voxel_size``, its origin
      off the world's;
    * ``arkit_instance_data/{scene}_aligned_bbox.npy``: the GT boxes
      (gravity-center z, yaw, class id last), for ``evaluate_bbox``;
    * the infos pickle (``total_image_ids`` the timestamps, ``split``,
      ``annos`` with 7-column ``gt_boxes_upright_depth`` and ``class``)."""
    rng = np.random.RandomState(seed)
    w, h = image_size
    sx, sy = w / ARKIT_PINCAM[0], h / ARKIT_PINCAM[1]
    pincam = (w, h, ARKIT_PINCAM[2] * sx, ARKIT_PINCAM[3] * sy,
              ARKIT_PINCAM[4] * sx, ARKIT_PINCAM[5] * sy)
    extent = np.asarray(tsdf_dim, np.float64) * voxel_size
    gt_dir = os.path.join(root, "arkit_instance_data")
    os.makedirs(gt_dir, exist_ok=True)
    infos: List[dict] = []
    for s in range(n_scenes):
        scene = str(41254900 + 17 * s)
        frames = os.path.join(root, split, scene, f"{scene}_frames")
        for sub in ("lowres_wide", "lowres_wide_intrinsics"):
            os.makedirs(os.path.join(frames, sub), exist_ok=True)
        origin = np.round(rng.uniform(-4.0, -1.0, 3) * 25) / 25
        origin[2] = -0.2
        center = origin + np.array([extent[0] / 2, extent[1] / 2,
                                    min(extent[2], 3.0) / 3])
        radius = 0.3 * min(extent[0], extent[1])
        base_ms = 5000000 + 37311 * (s + 1)
        ids, traj = [], []
        for i in range(2 * n_frames):       # frames at even i
            ms = base_ms + 50 * i
            a = 2 * np.pi * i / (2 * n_frames)
            eye = center + radius * np.array([np.cos(a), np.sin(a), 0.3])
            pose = np.linalg.inv(_look_at(eye, center))
            late = 3 if i % 2 == 0 and i % 6 == 2 else 0
            traj.append(f"{(ms + late) / 1000:.5f} "
                        + " ".join(f"{x:.9f}" for x in axis_angle(
                            pose[:3, :3]))
                        + " " + " ".join(f"{x:.9f}" for x in pose[:3, 3]))
            if i % 2:
                continue
            ts = f"{ms / 1000:.3f}"
            ids.append(ts)
            small = rng.randint(0, 255, (h // 16, w // 16, 3), np.uint8)
            Image.fromarray(small).resize((w, h), Image.BILINEAR).save(
                os.path.join(frames, "lowres_wide", f"{scene}_{ts}.png"))
            shift = {1: -1, 2: 1}.get(i // 2 % 4, 0)
            np.savetxt(os.path.join(
                frames, "lowres_wide_intrinsics",
                f"{scene}_{(ms + shift) / 1000:.3f}.pincam"),
                np.asarray(pincam)[None], fmt="%.6f")
        with open(os.path.join(frames, "lowres_wide.traj"), "w") as f:
            f.write("\n".join(traj) + "\n")
        boxes = arkit_room_boxes(extent)
        tsdf_dir = os.path.join(root, "atlas_tsdf", scene)
        os.makedirs(tsdf_dir, exist_ok=True)
        for k in (1, 2, 4):
            vs = voxel_size * k
            np.savez_compressed(
                os.path.join(tsdf_dir, f"tsdf_{int(round(vs * 100)):02d}.npz"),
                origin=origin.astype(np.float32)[None], voxel_size=vs,
                tsdf=room_tsdf([d // k for d in tsdf_dim], vs, extent, boxes,
                               yaw=boxes[:, 6]))
        world = boxes.copy()
        world[:, :3] += origin
        np.save(os.path.join(gt_dir, scene + "_aligned_bbox.npy"), world)
        infos.append({
            "scene": scene, "split": split, "total_image_ids": ids,
            "annos": {"gt_num": len(world),
                      "gt_boxes_upright_depth": world[:, :7].copy(),
                      "class": world[:, 7].astype(np.int64)}})
    ann = os.path.join(root, _ARKIT_SPLITS[split])
    with open(ann, "wb") as f:
        pickle.dump(infos, f)
    return ann


def room_surface_points(extent: Sequence[float], boxes: np.ndarray, n: int,
                        rng: np.random.RandomState,
                        yaw: Optional[Sequence[float]] = None) -> np.ndarray:
    """[n, 3] points drawn uniformly (by area) on the surfaces of
    ``room_tsdf``'s room: its floor, four walls up to the room's height
    (capped at 3 m) and the six faces of each gravity-center box [M, 6+],
    turned by its ``yaw`` about +z if given."""
    ex, ey, ez = (float(e) for e in extent)
    h = min(ez, 3.0)
    # (axis of the plane, its coordinate, the low and high corners)
    planes = [(2, 0.05, (0.1, 0.1), (ex - 0.1, ey - 0.1))]
    for axis, c, lo, hi in ((0, 0.1, (0.1, 0.05), (ey - 0.1, h)),
                            (0, ex - 0.1, (0.1, 0.05), (ey - 0.1, h)),
                            (1, 0.1, (0.1, 0.05), (ex - 0.1, h)),
                            (1, ey - 0.1, (0.1, 0.05), (ex - 0.1, h))):
        planes.append((axis, c, lo, hi))
    n_room = len(planes)
    for cx, cy, cz, dx, dy, dz in boxes[:, :6]:
        ctr, half = np.array([cx, cy, cz]), np.array([dx, dy, dz]) / 2
        for axis in range(3):
            rest = [a for a in range(3) if a != axis]
            lo = tuple(ctr[rest] - half[rest])
            hi = tuple(ctr[rest] + half[rest])
            for sign in (-1, 1):
                planes.append((axis, ctr[axis] + sign * half[axis], lo, hi))
    area = np.array([(hi[0] - lo[0]) * (hi[1] - lo[1])
                     for _, _, lo, hi in planes])
    which = rng.choice(len(planes), n, p=area / area.sum())
    u = rng.rand(n, 2)
    pts = np.empty((n, 3), np.float32)
    for i, (axis, c, lo, hi) in enumerate(planes):
        m = which == i
        rest = [a for a in range(3) if a != axis]
        pts[m, axis] = c
        pts[m, rest[0]] = lo[0] + u[m, 0] * (hi[0] - lo[0])
        pts[m, rest[1]] = lo[1] + u[m, 1] * (hi[1] - lo[1])
    for b, a in enumerate(() if yaw is None else yaw):
        m = (which >= n_room + 6 * b) & (which < n_room + 6 * b + 6)
        c, s = np.cos(a), np.sin(a)
        ox, oy = pts[m, 0] - boxes[b, 0], pts[m, 1] - boxes[b, 1]
        pts[m, 0] = boxes[b, 0] + c * ox - s * oy
        pts[m, 1] = boxes[b, 1] + s * ox + c * oy
    return pts


def write_point_dumps(root: str, points_dir: str, n_points: int = 600000,
                      seed: int = 0,
                      ann_name: str = "scannet_infos_train.pkl") -> List[str]:
    """Write a stage-2.1 dump, ``{points_dir}/{scene}_vert.npy``, for each
    scene of the split ``{root}/{ann_name}`` (``write_scannet``'s training
    split by default, or ``write_arkit``'s): ``n_points`` rows of xyz on the
    room's GT surface (``room_surface_points``, its extent and origin from
    the scene's ``tsdf_04``, yaw boxes turned) and 32 feature columns of
    N(0, 1), fp32, drawn from ``seed``.  Returns the paths written."""
    rng = np.random.RandomState(seed)
    with open(os.path.join(root, ann_name), "rb") as f:
        infos = sorted(pickle.load(f), key=lambda x: x["scene"])
    os.makedirs(points_dir, exist_ok=True)
    paths = []
    for info in infos:
        scene = info["scene"]
        with np.load(os.path.join(root, "atlas_tsdf", scene,
                                  "tsdf_04.npz")) as z:
            extent = np.asarray(z["tsdf"].shape) * float(z["voxel_size"])
            origin = np.asarray(z["origin"], np.float32).reshape(3)
        boxes = np.asarray(info["annos"]["gt_boxes_upright_depth"],
                           np.float32).copy()
        boxes[:, :3] -= origin
        xyz = room_surface_points(extent, boxes, n_points, rng,
                                  boxes[:, 6] if boxes.shape[1] > 6
                                  else None) + origin
        feats = rng.randn(n_points, 32).astype(np.float32)
        path = os.path.join(points_dir, scene + "_vert.npy")
        np.save(path, np.concatenate([xyz, feats], axis=1))
        paths.append(path)
    return paths

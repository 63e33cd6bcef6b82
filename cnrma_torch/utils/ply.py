"""Minimal PLY mesh / point-cloud IO (replaces trimesh/open3d exports and
reads); a copy of ``cnrma_tpu/utils/ply.py``.

The reference writes meshes with ``trimesh.Trimesh.export`` and point clouds
with ``open3d.io.write_point_cloud`` (``ray_marching.py:512,988-990``); neither
library is available here, so we write binary little-endian PLY directly.
"""

from __future__ import annotations

import struct
from typing import Optional

import numpy as np


def write_ply_mesh(path: str, vertices: np.ndarray, faces: np.ndarray,
                   vertex_normals: Optional[np.ndarray] = None,
                   vertex_colors: Optional[np.ndarray] = None) -> None:
    """Write a triangle mesh as binary PLY.

    Args:
        vertices: [N,3] float
        faces: [M,3] int
        vertex_normals: optional [N,3] float
        vertex_colors: optional [N,3] uint8
    """
    vertices = np.asarray(vertices, dtype=np.float32).reshape(-1, 3)
    faces = np.asarray(faces, dtype=np.int32).reshape(-1, 3)
    n, m = len(vertices), len(faces)
    props = ["property float x", "property float y", "property float z"]
    cols = [vertices]
    if vertex_normals is not None and len(vertex_normals) == n:
        props += ["property float nx", "property float ny", "property float nz"]
        cols.append(np.asarray(vertex_normals, dtype=np.float32).reshape(-1, 3))
    has_color = vertex_colors is not None and len(vertex_colors) == n
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {n}\n" + "\n".join(props) + "\n"
        + ("property uchar red\nproperty uchar green\nproperty uchar blue\n"
           if has_color else "")
        + f"element face {m}\n"
        "property list uchar int vertex_indices\nend_header\n"
    )
    vdata = np.concatenate(cols, axis=1).astype("<f4")
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        if has_color:
            colors = np.asarray(vertex_colors, dtype=np.uint8).reshape(-1, 3)
            for row, c in zip(vdata, colors):
                f.write(row.tobytes())
                f.write(c.tobytes())
        else:
            f.write(vdata.tobytes())
        # one packed record per face: uchar 3, then three int32 indices
        rec = np.empty(m, dtype=[("n", "u1"), ("v", "<i4", (3,))])
        rec["n"] = 3
        rec["v"] = faces
        f.write(rec.tobytes())


def write_ply_points(path: str, points: np.ndarray,
                     colors: Optional[np.ndarray] = None) -> None:
    """Write a point cloud as binary PLY ([N,3] floats, optional uint8 colors)."""
    points = np.asarray(points, dtype=np.float32).reshape(-1, 3)
    n = len(points)
    has_color = colors is not None and len(colors) == n
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {n}\n"
        "property float x\nproperty float y\nproperty float z\n"
        + ("property uchar red\nproperty uchar green\nproperty uchar blue\n"
           if has_color else "")
        + "end_header\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        if has_color:
            cc = np.asarray(colors, dtype=np.uint8).reshape(-1, 3)
            for i in range(n):
                f.write(points[i].astype("<f4").tobytes())
                f.write(cc[i].tobytes())
        else:
            f.write(points.astype("<f4").tobytes())


def read_ply(path: str, return_colors: bool = False):
    """Read a PLY file (ascii or binary-LE) -> (vertices [N,3], faces [M,3]
    or None)[, colors [N,3] float or None when ``return_colors``].

    Supports the subset written by :func:`write_ply_mesh` plus common
    ascii/binary exports (extra float vertex properties are skipped).
    """
    with open(path, "rb") as f:
        data = f.read()
    end = data.find(b"end_header\n")
    if end < 0:
        raise ValueError(f"{path}: not a PLY file")
    header = data[:end].decode("ascii", "replace").splitlines()
    body = data[end + len(b"end_header\n"):]

    fmt = "ascii"
    elements = []  # (name, count, [(type, name)...])
    cur = None
    for line in header:
        t = line.strip().split()
        if not t:
            continue
        if t[0] == "format":
            fmt = t[1]
        elif t[0] == "element":
            cur = (t[1], int(t[2]), [])
            elements.append(cur)
        elif t[0] == "property" and cur is not None:
            if t[1] == "list":
                cur[2].append(("list", t[2], t[3], t[4]))
            else:
                cur[2].append((t[1], t[2]))

    _SZ = {"float": ("f", 4), "float32": ("f", 4), "double": ("d", 8),
           "uchar": ("B", 1), "uint8": ("B", 1), "char": ("b", 1),
           "int": ("i", 4), "int32": ("i", 4), "uint": ("I", 4),
           "short": ("h", 2), "ushort": ("H", 2)}

    def _color_names(props):
        names = [p[1] for p in props]
        for trio in (("red", "green", "blue"), ("r", "g", "b")):
            if all(t in names for t in trio):
                return trio
        return None

    verts, faces, colors = None, None, None
    if fmt == "ascii":
        lines = body.decode("ascii").split("\n")
        li = 0
        for name, count, props in elements:
            rows = []
            for _ in range(count):
                rows.append(lines[li].split())
                li += 1
            if name == "vertex":
                verts = np.array(
                    [[float(r[i]) for i in range(3)] for r in rows],
                    dtype=np.float32)
                trio = _color_names(props)
                if trio is not None:
                    names = [p[1] for p in props]
                    cix = [names.index(t) for t in trio]
                    colors = np.array(
                        [[float(r[i]) for i in cix] for r in rows],
                        dtype=np.float32)
            elif name == "face":
                faces = np.array([[int(v) for v in r[1:4]] for r in rows],
                                 dtype=np.int32)
    else:
        off = 0
        for name, count, props in elements:
            if name == "vertex":
                codes = "".join(_SZ[p[0]][0] for p in props)
                size = struct.calcsize("<" + codes)
                arr = np.frombuffer(body, dtype=np.dtype(
                    [(p[1], "<" + _SZ[p[0]][0]) for p in props]),
                    count=count, offset=off)
                verts = np.stack([arr["x"], arr["y"], arr["z"]],
                                 axis=1).astype(np.float32)
                trio = _color_names(props)
                if trio is not None:
                    colors = np.stack([arr[t] for t in trio],
                                      axis=1).astype(np.float32)
                off += size * count
            elif name == "face":
                lp = props[0]
                cnt_code, cnt_sz = _SZ[lp[1]]
                idx_code, idx_sz = _SZ[lp[2]]
                out = []
                for _ in range(count):
                    k = struct.unpack_from("<" + cnt_code, body, off)[0]
                    off += cnt_sz
                    vals = struct.unpack_from("<" + idx_code * k, body, off)
                    off += idx_sz * k
                    out.append(vals[:3])
                faces = np.array(out, dtype=np.int32)
    if return_colors:
        return verts, faces, colors
    return verts, faces

"""Minimal PLY mesh / point-cloud IO (replaces trimesh/open3d exports); a
copy of ``cnrma_tpu/utils/ply.py``.

The reference writes meshes with ``trimesh.Trimesh.export`` and point clouds
with ``open3d.io.write_point_cloud`` (``ray_marching.py:512,988-990``); neither
library is available here, so we write binary little-endian PLY directly.
"""

from __future__ import annotations

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


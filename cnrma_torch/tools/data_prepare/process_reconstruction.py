"""Convert predicted reconstruction meshes to point arrays.

    python -m cnrma_torch.tools.data_prepare.process_reconstruction \
        --result_path RESULTS --output_path POINTS

Port of the JAX package's ``tools/data_prepare/process_reconstruction.py``
on the port's ``cnrma_torch.utils.ply``: reads
``{result_path}/{scene}/{scene}.ply`` predicted meshes and writes
``{scene}_vert.npy`` (xyz + vertex normals) for FCAF3D-style training on
reconstructed geometry.
"""

import argparse
import os
from typing import Optional, Sequence

import numpy as np

from cnrma_torch.utils.ply import read_ply


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--result_path", required=True)
    p.add_argument("--output_path", required=True)
    args = p.parse_args(argv)
    os.makedirs(args.output_path, exist_ok=True)

    for scene in sorted(os.listdir(args.result_path)):
        mesh_file = os.path.join(args.result_path, scene, scene + ".ply")
        if not os.path.isfile(mesh_file):
            continue
        verts, faces = read_ply(mesh_file)
        if verts is None or len(verts) == 0:
            print(scene, "empty mesh, skipped")
            continue
        # per-vertex normals from face normals
        normals = np.zeros_like(verts)
        if faces is not None and len(faces):
            v0, v1, v2 = (verts[faces[:, 0]], verts[faces[:, 1]],
                          verts[faces[:, 2]])
            fn = np.cross(v1 - v0, v2 - v0)
            for i in range(3):
                np.add.at(normals, faces[:, i], fn)
            norm = np.linalg.norm(normals, axis=1, keepdims=True)
            normals = normals / np.where(norm > 1e-12, norm, 1.0)
        out = np.hstack([verts, normals]).astype(np.float32)
        np.save(os.path.join(args.output_path, scene + "_vert.npy"), out)
        print(scene, len(out), "verts")


if __name__ == "__main__":
    main()

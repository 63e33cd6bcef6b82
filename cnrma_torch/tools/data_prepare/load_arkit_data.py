"""Extract ARKitScenes annotations + mesh vertices -> instance-data arrays.

    python -m cnrma_torch.tools.data_prepare.load_arkit_data \
        --data_path data/arkit --output_path data/arkit/arkit_instance_data

Port of the JAX package's ``tools/data_prepare/load_arkit_data.py`` on the
port's ``cnrma_torch.utils.ply`` and ``arkit_boxes``; the same files and
the same ``rng`` draws.  Per scan it writes six files —

* ``{scene}_vert.npy``               [N,6] xyz+rgb mesh vertices
  (subsampled to ``--max_num_point``),
* ``{scene}_sem_label.npy`` / ``{scene}_ins_label.npy``  zero placeholders
  (ARKitScenes has no per-vertex labels; reference writes zeros too),
* ``{scene}_axis_align_matrix.npy``  identity (ARKit scans are pre-aligned),
* ``{scene}_unaligned_bbox.npy`` / ``{scene}_aligned_bbox.npy``
  [M,8] = (cx,cy,cz,dx,dy,dz,heading,label) — box params recovered from
  the oriented-box CORNERS (centroid/size/heading re-derived via
  ``corners_to_boxes``, reference load_arkit_data.py:105-145), with the
  reference's clockwise heading convention.

Skipped-scene bookkeeping: annotations with ``skipped=true`` or zero known
instances are reported and still written (empty), matching the reference.
"""

import argparse
import json
import os
from typing import Optional, Sequence

import numpy as np

from cnrma_torch.tools.data_prepare.arkit_boxes import (
    compute_box_3d, corners_to_boxes)
from cnrma_torch.utils.ply import read_ply

ARKIT_CLASSES = ["cabinet", "refrigerator", "shelf", "stove", "bed",
                 "sink", "washer", "toilet", "bathtub", "oven",
                 "dishwasher", "fireplace", "stool", "chair", "table",
                 "tv_monitor", "sofa"]
CLASS_TO_ID = {c: i for i, c in enumerate(ARKIT_CLASSES)}


def normalize_label(label: str) -> str:
    """Reference class-name normalization (spaces/dashes/slashes -> _)."""
    for delim in (" ", "-", "/"):
        label = label.replace(delim, "_")
    return label


def extract_bbox_infos(json_file):
    """annotation.json -> (skipped, corners [M,8,3], labels [M])."""
    with open(json_file) as f:
        anno = json.load(f)
    skipped = bool(anno.get("skipped", False))
    corners, labels = [], []
    for item in anno.get("data", []):
        label = normalize_label(item.get("label", ""))
        if label not in CLASS_TO_ID:
            print(f"unknown category: {item.get('label')}")
            continue
        seg = item["segments"]["obbAligned"]
        c8 = compute_box_3d(seg["axesLengths"], seg["centroid"],
                            np.asarray(seg["normalizedAxes"]).reshape(3, 3))
        corners.append(c8)
        labels.append(CLASS_TO_ID[label])
    if not corners:
        return skipped, np.zeros((0, 8, 3)), np.zeros((0,), np.int64)
    return skipped, np.stack(corners), np.asarray(labels, np.int64)


def parse_annotation(json_file) -> np.ndarray:
    """annotation.json -> [M,8] (7-DoF box + label) array."""
    _, corners, labels = extract_bbox_infos(json_file)
    if len(corners) == 0:
        return np.zeros((0, 8))
    boxes = corners_to_boxes(corners)
    return np.concatenate([boxes, labels[:, None].astype(np.float64)],
                          axis=1)


def export_one_scan(scene, scan_dir, output_prefix, max_num_point,
                    rng) -> bool:
    """Write the six per-scan npy files; returns False for skipped scans."""
    mesh_file = os.path.join(scan_dir, f"{scene}_3dod_mesh.ply")
    json_file = os.path.join(scan_dir, f"{scene}_3dod_annotation.json")

    verts, _, colors = read_ply(mesh_file, return_colors=True)
    if colors is None:
        colors = np.zeros_like(verts)
    mesh_vertices = np.concatenate(
        [verts.astype(np.float32), colors.astype(np.float32)], axis=1)
    if max_num_point and len(mesh_vertices) > int(max_num_point):
        choice = rng.choice(len(mesh_vertices), int(max_num_point),
                            replace=False)
        mesh_vertices = mesh_vertices[choice]

    skipped, corners, labels = extract_bbox_infos(json_file)
    if skipped or len(corners) == 0:
        print(f"{scene}: no care instances found"
              + (" (annotation skipped)" if skipped else ""))
    if len(corners):
        boxes = np.concatenate(
            [corners_to_boxes(corners),
             labels[:, None].astype(np.float64)], axis=1)
    else:
        boxes = np.zeros((0, 8))

    np.save(f"{output_prefix}_vert.npy", mesh_vertices)
    np.save(f"{output_prefix}_sem_label.npy",
            np.zeros((len(mesh_vertices),), np.int64))
    np.save(f"{output_prefix}_ins_label.npy",
            np.zeros((len(mesh_vertices),), np.int64))
    np.save(f"{output_prefix}_axis_align_matrix.npy", np.eye(4))
    np.save(f"{output_prefix}_unaligned_bbox.npy", boxes)
    np.save(f"{output_prefix}_aligned_bbox.npy", boxes)
    print(scene, len(boxes), "boxes,", len(mesh_vertices), "verts")
    return not skipped


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--data_path", required=True,
                   help="root containing 3dod/{split}/{scene} (or directly"
                        " {split}/{scene})")
    p.add_argument("--output_path", required=True)
    p.add_argument("--max_num_point", type=int, default=200000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--splits", nargs="*",
                   default=["Training", "Validation"])
    args = p.parse_args(argv)
    os.makedirs(args.output_path, exist_ok=True)
    rng = np.random.RandomState(args.seed)
    n_skipped = 0
    for split in args.splits:
        for base in (os.path.join(args.data_path, "3dod", split),
                     os.path.join(args.data_path, split)):
            if os.path.isdir(base):
                break
        else:
            continue
        for scene in sorted(os.listdir(base)):
            scan_dir = os.path.join(base, scene)
            jf = os.path.join(scan_dir, f"{scene}_3dod_annotation.json")
            if not os.path.isfile(jf):
                continue
            prefix = os.path.join(args.output_path, scene)
            if os.path.isfile(f"{prefix}_vert.npy"):
                print(scene, "already exists, skipping")
                continue
            if not os.path.isfile(
                    os.path.join(scan_dir, f"{scene}_3dod_mesh.ply")):
                # annotation-only export (no mesh shipped)
                arr = parse_annotation(jf)
                np.save(f"{prefix}_aligned_bbox.npy", arr)
                np.save(f"{prefix}_unaligned_bbox.npy", arr)
                print(scene, len(arr), "boxes (annotation only)")
                continue
            if not export_one_scan(scene, scan_dir, prefix,
                                   args.max_num_point, rng):
                n_skipped += 1
    if n_skipped:
        print(f"{n_skipped} scans marked skipped in their annotations")


if __name__ == "__main__":
    main()

"""Extract ScanNet per-scene annotation arrays.

    python -m cnrma_torch.tools.data_prepare.batch_load_scannet_data \
        --scans_path data/scannet/scans \
        --label_map data/scannet/meta_data/scannetv2-labels.combined.tsv \
        --output_path data/scannet/scannet_instance_data

Port of the JAX package's ``tools/data_prepare/batch_load_scannet_data.py``
on the port's ``cnrma_torch.utils.ply``: reads the scan mesh
(``_vh_clean_2.ply``), over-segmentation (``.segs.json``), instance
aggregation (``.aggregation.json``), meta (``.txt`` axisAlignment) and the
NYU40 label map tsv, and writes
``{scene}_vert.npy`` (xyz+rgb), ``{scene}_sem_label.npy``,
``{scene}_ins_label.npy``, ``{scene}_aligned_bbox.npy`` /
``_unaligned_bbox.npy`` ([K, 7] = gravity-center box + NYU40 class id) and
``{scene}_axis_align_matrix.npy``.
"""

import argparse
import json
import os
from typing import Optional, Sequence

import numpy as np

from cnrma_torch.utils.ply import read_ply

OBJ_CLASS_IDS = np.array(
    [3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24, 28, 33, 34, 36, 39])


def read_label_map(tsv_file, label_from="raw_category",
                   label_to="nyu40id"):
    mapping = {}
    with open(tsv_file) as f:
        header = f.readline().rstrip("\n").split("\t")
        fi, ti = header.index(label_from), header.index(label_to)
        for line in f:
            parts = line.rstrip("\n").split("\t")
            mapping[parts[fi]] = int(parts[ti])
    return mapping


def read_mesh_with_color(path):
    """Read _vh_clean_2.ply (binary LE with rgb) -> [N,6] xyzrgb."""
    verts, _ = read_ply(path)
    # colors: re-read raw properties if present
    with open(path, "rb") as f:
        data = f.read()
    end = data.find(b"end_header\n")
    header = data[:end].decode("ascii", "replace")
    has_rgb = "property uchar red" in header
    if not has_rgb:
        return np.hstack([verts, np.zeros_like(verts)])
    # vertex struct: x y z [nx ny nz] red green blue [alpha]
    n_float = header.count("property float")
    n_uchar = header.count("property uchar")
    count = int(header.split("element vertex")[1].split()[0])
    rec = np.dtype([("f", "<f4", (n_float,)), ("c", "u1", (n_uchar,))])
    arr = np.frombuffer(data[end + 11:], dtype=rec, count=count)
    rgb = arr["c"][:, :3].astype(np.float32)
    return np.hstack([verts, rgb])


def compute_boxes(verts, ins_labels, sem_labels):
    boxes = []
    for iid in range(1, ins_labels.max() + 1 if len(ins_labels) else 0):
        mask = ins_labels == iid
        if mask.sum() < 1:
            continue
        cls = np.bincount(sem_labels[mask]).argmax()
        pts = verts[mask, :3]
        lo, hi = pts.min(0), pts.max(0)
        c = (lo + hi) / 2
        d = hi - lo
        boxes.append([c[0], c[1], c[2], d[0], d[1], d[2], cls])
    if not boxes:
        return np.zeros((0, 7))
    boxes = np.array(boxes)
    keep = np.isin(boxes[:, -1], OBJ_CLASS_IDS)
    return boxes[keep]


def process_scene(scans_dir, scene, label_map, out_dir):
    base = os.path.join(scans_dir, scene, scene)
    verts = read_mesh_with_color(base + "_vh_clean_2.ply")
    with open(base + "_vh_clean_2.0.010000.segs.json") as f:
        seg_to_verts = json.load(f)["segIndices"]
    seg_to_verts = np.asarray(seg_to_verts)
    with open(base + ".aggregation.json") as f:
        agg = json.load(f)["segGroups"]

    n = len(verts)
    sem = np.zeros(n, np.int64)
    ins = np.zeros(n, np.int64)
    for group in agg:
        nyu = label_map.get(group["label"], 0)
        gmask = np.isin(seg_to_verts, group["segments"])
        sem[gmask] = nyu
        ins[gmask] = group["objectId"] + 1

    # axis align matrix from meta txt
    axis_align = np.eye(4)
    meta = base + ".txt"
    if os.path.isfile(meta):
        for line in open(meta):
            if "axisAlignment" in line:
                axis_align = np.array(
                    [float(x) for x in
                     line.split("=", 1)[1].split()]).reshape(4, 4)
                break
    aligned = verts.copy()
    ones = np.hstack([verts[:, :3], np.ones((n, 1))])
    aligned[:, :3] = (ones @ axis_align.T)[:, :3]

    np.save(os.path.join(out_dir, scene + "_vert.npy"),
            verts.astype(np.float32))
    np.save(os.path.join(out_dir, scene + "_sem_label.npy"), sem)
    np.save(os.path.join(out_dir, scene + "_ins_label.npy"), ins)
    np.save(os.path.join(out_dir, scene + "_axis_align_matrix.npy"),
            axis_align)
    np.save(os.path.join(out_dir, scene + "_unaligned_bbox.npy"),
            compute_boxes(verts, ins, sem))
    np.save(os.path.join(out_dir, scene + "_aligned_bbox.npy"),
            compute_boxes(aligned, ins, sem))
    print(scene, "done")


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--scans_path", required=True)
    p.add_argument("--label_map", required=True,
                   help="scannetv2-labels.combined.tsv")
    p.add_argument("--output_path", required=True)
    p.add_argument("--scenes", nargs="*", default=None)
    args = p.parse_args(argv)
    os.makedirs(args.output_path, exist_ok=True)
    label_map = read_label_map(args.label_map)
    scenes = args.scenes or sorted(os.listdir(args.scans_path))
    for scene in scenes:
        try:
            process_scene(args.scans_path, scene, label_map,
                          args.output_path)
        except Exception as e:
            print(scene, "failed:", e)


if __name__ == "__main__":
    main()

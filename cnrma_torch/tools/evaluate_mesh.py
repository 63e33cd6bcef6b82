"""Mesh reconstruction metrics over a results directory.

    python -m cnrma_torch.tools.evaluate_mesh --data_path DATA
        --result_path DIR [--gt_path DIR] [--dataset scannet]
        [--axis_align 0|1]

Port of ``tools/evaluate_mesh.py``, with its arguments and file contract:
compares ``{result_path}/{scene}/{scene}.ply`` predicted meshes with GT
meshes (``{gt_path}/{scene}.ply``, else
``{data_path}/scans/{scene}/{scene}_vh_clean_2.ply``, axis-aligned through
the scene's ``.txt`` meta for ScanNet), writes each scene's
``metrics.json`` and the mean's ``metrics_mean.json``, and prints them
(acc/comp distance, precision/recall/F-score at 5 cm after a 2 cm
downsample; ``eval/mesh_eval.py``, on the host).  A scene without a GT
mesh is skipped with a message, as in the original.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, Optional, Sequence

import numpy as np

from cnrma_torch.eval.mesh_eval import eval_mesh_metrics
from cnrma_torch.utils.ply import read_ply

KEYS = ("dist1", "dist2", "prec", "recal", "fscore")


def read_axis_align_matrix(meta_file: str) -> np.ndarray:
    if not os.path.exists(meta_file):
        return np.eye(4)
    for line in open(meta_file):
        if "axisAlignment" in line:
            vals = [float(x) for x in
                    line.rstrip().strip("axisAlignment = ").split(" ")]
            return np.array(vals).reshape(4, 4)
    return np.eye(4)


def find_gt_mesh(args, scene: str) -> Optional[str]:
    cands = [
        os.path.join(args.gt_path or "", scene + ".ply"),
        os.path.join(args.data_path, "scans", scene,
                     scene + "_vh_clean_2.ply"),
    ]
    for c in cands:
        if c and os.path.isfile(c):
            return c
    return None


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    """Run the CLI; returns the mean metrics (empty if no scene had a GT
    mesh)."""
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", default="scannet")
    p.add_argument("--data_path", required=True)
    p.add_argument("--result_path", required=True)
    p.add_argument("--gt_path", default=None,
                   help="directory of GT meshes named {scene}.ply")
    p.add_argument("--axis_align", type=int, default=1)
    args = p.parse_args(argv)

    all_metrics = {k: [] for k in KEYS}
    scenes = sorted(s for s in os.listdir(args.result_path)
                    if os.path.isfile(os.path.join(
                        args.result_path, s, s + ".ply")))
    for scene in scenes:
        pred_file = os.path.join(args.result_path, scene, scene + ".ply")
        gt_file = find_gt_mesh(args, scene)
        if gt_file is None:
            print(f"{scene}: no GT mesh found, skipped")
            continue
        verts_pred, _ = read_ply(pred_file)
        verts_gt, _ = read_ply(gt_file)
        if args.axis_align and args.dataset == "scannet":
            meta = os.path.join(args.data_path, "scans", scene,
                                scene + ".txt")
            M = read_axis_align_matrix(meta)
            verts_gt = (np.hstack([verts_gt,
                                   np.ones((len(verts_gt), 1))])
                        @ M.T)[:, :3].astype(np.float32)
        m = eval_mesh_metrics(verts_pred, verts_gt)
        with open(os.path.join(args.result_path, scene,
                               "metrics.json"), "w") as f:
            json.dump(m, f, indent=2)
        for k in KEYS:
            all_metrics[k].append(m[k])
        print(scene, {k: round(m[k], 4) for k in KEYS})

    mean: Dict[str, float] = {}
    if all_metrics["fscore"]:
        mean = {k: float(np.mean(v)) for k, v in all_metrics.items()}
        print("\nmean:", {k: round(v, 4) for k, v in mean.items()})
        with open(os.path.join(args.result_path, "metrics_mean.json"),
                  "w") as f:
            json.dump(mean, f, indent=2)
    return mean


if __name__ == "__main__":
    main()

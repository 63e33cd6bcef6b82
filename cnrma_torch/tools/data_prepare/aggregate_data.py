"""Aggregate per-scene annotations into ``{dataset}_infos_{split}.pkl``.

    python -m cnrma_torch.tools.data_prepare.aggregate_data \
        --dataset scannet --data_path data/scannet --split train \
        --scene_list data/scannet/meta_data/scannetv2_train.txt

A copy of the JAX package's ``tools/data_prepare/aggregate_data.py``: per
scene records ``{scene, total_image_ids, annos{gt_boxes_upright_depth,
class, axis_align_matrix, gt_num}}``; scenes without GT boxes are dropped;
ARKit infos add a ``split`` key.  The frame ids come from the scene's
``atlas_tsdf/{scene}/info.json`` (``generate_tsdf``), else from its
``posed_images`` JPEGs.
"""

import argparse
import json
import os
import pickle
from typing import Optional, Sequence

import numpy as np

# ScanNet's 18 detection classes as NYU40 ids, in label order
SCANNET_CAT_IDS = [3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24, 28, 33, 34,
                   36, 39]


def scene_image_ids(data_path, scene):
    info_json = os.path.join(data_path, "atlas_tsdf", scene, "info.json")
    if os.path.isfile(info_json):
        with open(info_json) as f:
            return [img["id"] for img in json.load(f)["images"]]
    posed = os.path.join(data_path, "posed_images", scene)
    if os.path.isdir(posed):
        return sorted(f[:-4] for f in os.listdir(posed)
                      if f.endswith(".jpg"))
    return []


def main(argv: Optional[Sequence[str]] = None) -> str:
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", default="scannet",
                   choices=["scannet", "arkit"])
    p.add_argument("--data_path", required=True)
    p.add_argument("--split", required=True,
                   help="train / val / test")
    p.add_argument("--scene_list", default=None,
                   help="txt file of scene ids (e.g. scannetv2_val.txt)")
    p.add_argument("--splits_map", default=None,
                   help="arkit: json {scene: Training|Validation}")
    args = p.parse_args(argv)

    inst_dir = os.path.join(args.data_path,
                            f"{args.dataset}_instance_data")
    if args.scene_list:
        scenes = [l.strip() for l in open(args.scene_list) if l.strip()]
    else:
        scenes = sorted(os.listdir(
            os.path.join(args.data_path, "atlas_tsdf")))

    splits_map = {}
    if args.splits_map and os.path.isfile(args.splits_map):
        with open(args.splits_map) as f:
            splits_map = json.load(f)

    infos = []
    for scene in scenes:
        ids = scene_image_ids(args.data_path, scene)
        if not ids:
            print(scene, "no frames, skipped")
            continue
        bbox_file = os.path.join(inst_dir, scene + "_aligned_bbox.npy")
        annos = {"gt_num": 0}
        if os.path.isfile(bbox_file):
            arr = np.load(bbox_file)
            if len(arr):
                annos = {
                    "gt_num": len(arr),
                    "gt_boxes_upright_depth":
                        arr[:, :-1].astype(np.float32),
                    "class": arr[:, -1].astype(np.int64),
                }
                aam = os.path.join(inst_dir,
                                   scene + "_axis_align_matrix.npy")
                if os.path.isfile(aam):
                    annos["axis_align_matrix"] = np.load(aam).astype(
                        np.float32)
        if annos["gt_num"] == 0:
            print(scene, "no gt boxes, dropped")
            continue
        if args.dataset == "scannet":
            # classes stored as NYU40 ids in instance data -> label index
            id2label = {c: i for i, c in enumerate(SCANNET_CAT_IDS)}
            annos["class"] = np.array(
                [id2label.get(int(c), -1) for c in annos["class"]])
        info = {"scene": scene, "total_image_ids": ids, "annos": annos}
        if args.dataset == "arkit":
            info["split"] = splits_map.get(scene, "Training")
        infos.append(info)

    out = os.path.join(args.data_path,
                       f"{args.dataset}_infos_{args.split}.pkl")
    with open(out, "wb") as f:
        pickle.dump(infos, f)
    print(f"wrote {out} ({len(infos)} scenes)")
    return out


if __name__ == "__main__":
    main()

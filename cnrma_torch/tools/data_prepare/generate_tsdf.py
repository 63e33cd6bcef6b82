"""Generate GT TSDF volumes (tsdf_04/08/16.npz + info.json) per scene.

    python -m cnrma_torch.tools.data_prepare.generate_tsdf \
        --data_path data/scannet --save_path data/scannet [--device cpu]

Port of the JAX package's ``tools/data_prepare/generate_tsdf.py`` on
``cnrma_torch.geometry.tsdf_fusion``: the fusion runs on ``--device``
(``cuda:0`` by default, which needs the card; ``cpu`` runs the same torch
ops on the host), the frames streamed to it in order.  ``--num_workers``
> 1 fuses scenes in a spawn pool, every worker on ``--device``.

Inputs (ScanNet layout): ``{data_path}/posed_images/{scene}/*.jpg`` with
matching ``*.png`` depth (mm), per-frame pose ``*.txt``, shared
``intrinsic.txt``.  Outputs: ``{save_path}/atlas_tsdf/{scene}/tsdf_XX.npz``
(``origin`` [1, 3], ``voxel_size``, ``tsdf``; the 4 cm grid padded to
multiples of 4 so that the 8 and 16 cm grids nest) + ``info.json`` frame
index.  The depth maps are projected through ``intrinsic.txt``, which
``extract_posed_images`` writes from the colour camera (ROADMAP F17).
"""

import argparse
import json
import os
import time
from typing import Optional, Sequence

import numpy as np
from PIL import Image

from cnrma_torch.tools._common import device_of


def list_frames(scene_dir):
    ids = sorted(f[:-4] for f in os.listdir(scene_dir)
                 if f.endswith(".txt") and f != "intrinsic.txt")
    return ids


def read_scene(args, scene):
    """The scene's intrinsic, depth maps (metres), poses, projections and
    ``info.json`` image records, the frames without a depth PNG or with a
    pose that is not finite left out."""
    scene_dir = os.path.join(args.data_path, "posed_images", scene)
    intrinsic = np.loadtxt(os.path.join(scene_dir, "intrinsic.txt"),
                           delimiter=" ")[:3, :3]
    frame_ids = list_frames(scene_dir)[::args.stride]
    depths, projections, cam2worlds = [], [], []
    img_info = []
    for fid in frame_ids:
        pose = np.loadtxt(os.path.join(scene_dir, fid + ".txt"))
        depth_file = os.path.join(scene_dir, fid + ".png")
        if not os.path.isfile(depth_file) or not \
                np.isfinite(pose).all():
            continue
        depth = np.asarray(Image.open(depth_file),
                           np.float32) / 1000.0
        depths.append(depth)
        cam2worlds.append(pose)
        projections.append(intrinsic @ np.linalg.inv(pose)[:3])
        img_info.append({
            "file_name_image": os.path.join("posed_images", scene,
                                            fid + ".jpg"),
            "file_name_depth": os.path.join("posed_images", scene,
                                            fid + ".png"),
            "id": fid})
    return intrinsic, depths, cam2worlds, projections, img_info


def scene_bounds(args, intrinsic, depths, cam2worlds):
    """(origin [3], the 4 cm grid padded to multiples of 4) from a
    subsampled backprojected cloud."""
    from cnrma_torch.geometry.tsdf_fusion import (
        depth_to_world_points, volume_bounds_from_depths)
    pts = []
    for i in range(0, len(depths), max(1, len(depths) // 50)):
        pts.append(depth_to_world_points(depths[i][::8, ::8],
                                         intrinsic / 8.0, cam2worlds[i],
                                         args.max_depth))
    pts = np.concatenate([p for p in pts if len(p)], axis=0)
    origin, dim4 = volume_bounds_from_depths(pts, args.voxel_size,
                                             args.margin)
    # pad dims to multiples of 4 so the 3 scales nest exactly
    return origin, tuple(int(np.ceil(d / 4) * 4) for d in dim4)


def process_scene(args, scene):
    from cnrma_torch.geometry.tsdf_fusion import fuse_tsdf

    dev = device_of(args.device)
    out_dir = os.path.join(args.save_path, "atlas_tsdf", scene)
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    intrinsic, depths, cam2worlds, projections, img_info = read_scene(
        args, scene)
    if not depths:
        print(f"{scene}: no valid frames")
        return
    read_s = time.perf_counter() - t0
    origin, dim4 = scene_bounds(args, intrinsic, depths, cam2worlds)

    projs = np.stack(projections).astype(np.float32)
    ok = np.ones((len(depths),), bool)
    t0 = time.perf_counter()
    for scale in range(3):
        vs = args.voxel_size * (2 ** scale)
        dim = tuple(d // (2 ** scale) for d in dim4)
        tsdf, _ = fuse_tsdf(depths, projs, ok, origin, dim, vs,
                            trunc_ratio=args.trunc_ratio,
                            max_depth=args.max_depth, device=dev)
        np.savez_compressed(
            os.path.join(out_dir,
                         f"tsdf_{str(int(vs * 100)).zfill(2)}.npz"),
            origin=np.asarray(origin).reshape(1, 3),
            voxel_size=vs,
            tsdf=tsdf.cpu().numpy())
    with open(os.path.join(out_dir, "info.json"), "w") as f:
        json.dump({"scene": scene, "path": args.data_path,
                   "intrinsics": intrinsic.tolist(),
                   "images": img_info}, f)
    print("fused", scene, dim4, f"{len(depths)} frames: read "
          f"{read_s:.2f} s, fused and written {time.perf_counter() - t0:.2f}"
          f" s on {dev}")


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--data_path", required=True)
    p.add_argument("--save_path", required=True)
    p.add_argument("--voxel_size", type=float, default=0.04)
    p.add_argument("--trunc_ratio", type=float, default=3.0)
    p.add_argument("--max_depth", type=float, default=3.0)
    p.add_argument("--margin", type=float, default=1.5)
    p.add_argument("--stride", type=int, default=1)
    p.add_argument("--scenes", nargs="*", default=None)
    p.add_argument("--num_workers", type=int, default=1)
    p.add_argument("--device", default="cuda:0",
                   help="where the fusion runs (default cuda:0, which needs "
                        "the card; cpu runs it on the host)")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    device_of(args.device)              # no card: fail before any scene
    scenes = args.scenes or sorted(os.listdir(
        os.path.join(args.data_path, "posed_images")))
    if args.num_workers > 1:
        import multiprocessing as mp
        with mp.get_context("spawn").Pool(args.num_workers) as pool:
            pool.starmap(process_scene,
                         [(args, s) for s in scenes])
    else:
        for s in scenes:
            process_scene(args, s)


if __name__ == "__main__":
    main()

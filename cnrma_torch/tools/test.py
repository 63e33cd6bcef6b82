"""The test CLI of the port: dataset scenes -> the per-scene result files.

    python -m cnrma_torch.tools.test CONFIG [CHECKPOINT] [--save-path DIR]
        [--middle-save-path DIR] [--middle-visualize-path DIR]
        [--max-scenes N] [--seed S] [--cfg-options k=v ...] [--device cpu]

Port of ``tools/test.py`` (the reference ``test.py`` +
``RayMarching.forward_test``).  Per scene it writes, with the JAX tool's
names, keys, dtypes and z convention:

* ``{save_path}/{scene}/{scene}.npz``: the predicted fine TSDF;
* ``{save_path}/{scene}/{scene}.ply``: its marching-cubes mesh;
* ``{save_path}/{scene}/{scene}_bbox_raw.npz``: the valid rows of the raw
  ``bboxes`` (gravity-center z) and ``scores``;
* with a middle path, ``{middle}/{scene}_vert.npy``: xyz and the 32 weighted
  features of the kept points (and, with a visualize path, their ``.ply``).

Offline scoring is then ``python -m cnrma_torch.tools.nms_bbox`` and
``python -m cnrma_torch.tools.evaluate_bbox``.

``CHECKPOINT`` is a ``.pt`` state dict of the port, or an ``.npz`` of a flax
variable tree's flattened leaves (``params/...``, ``batch_stats/...``),
loaded through ``bridge.from_flax``.  Without one the parameters are
synthesized from ``--seed`` (``synthetic.synthesize_parameters``).

The forward runs on ``cuda:0`` unless ``--device cpu``.  A reader thread
decodes the next scene while the device runs this one (one scene ahead at
most), and a writer thread meshes and writes the files.  The subsample's generator is seeded by
the scene's global index, so a scene gives the same files alone or inside a
run of many; ``--max-scenes N`` writes exactly N scenes.  Any failure stops
the run with an error: no scene is skipped.
"""

from __future__ import annotations

import argparse
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from cnrma_torch.bridge import from_flax, read_flax_npz
from cnrma_torch.core.builder import build_dataset, build_model
from cnrma_torch.core.config import Config
from cnrma_torch.geometry.tsdf import TSDF
from cnrma_torch.synthetic import synthesize_parameters
from cnrma_torch.utils.ply import write_ply_mesh, write_ply_points

_BATCH_KEYS = ("imgs", "projection", "view_valid", "offset")


def parse_args(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description="Run the CN-RMA port's test "
                                            "forward over a dataset split")
    p.add_argument("config")
    p.add_argument("checkpoint", nargs="?", default=None,
                   help=".pt state dict of the port, or .npz of flattened "
                        "flax leaves")
    p.add_argument("--save-path")
    p.add_argument("--middle-save-path")
    p.add_argument("--middle-visualize-path",
                   help="also dump the ray-marched points as .ply")
    p.add_argument("--max-scenes", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cfg-options", nargs="+", default=[])
    p.add_argument("--device", default="cuda:0",
                   help="cuda:0 (default) or cpu")
    return p.parse_args(argv)


class _Head:
    """The first ``n`` scenes of a dataset; each sample records the seconds
    its reading took."""

    def __init__(self, dataset, n: Optional[int]):
        self.dataset = dataset
        self.n = len(dataset) if n is None else min(n, len(dataset))

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, i: int) -> Dict[str, Any]:
        t0 = time.perf_counter()
        sample = self.dataset[i]
        sample["load_s"] = time.perf_counter() - t0
        return sample


def load_parameters(model: torch.nn.Module, checkpoint: Optional[str],
                    seed: int) -> None:
    if checkpoint is None:
        synthesize_parameters(model, seed)
    elif checkpoint.endswith(".npz"):
        model.load_state_dict(from_flax(read_flax_npz(checkpoint), model))
    else:
        model.load_state_dict(torch.load(checkpoint, map_location="cpu",
                                         weights_only=True))


def write_scene(scene: str, out: Dict[str, Any], voxel_size: float,
                save_path: str, middle_path: Optional[str],
                middle_viz: Optional[str], device: torch.device
                ) -> Dict[str, Any]:
    """Write one scene's files from its host outputs; returns the seconds
    it took, the mesh's and the PLY's sizes."""
    t0 = time.perf_counter()
    scene_dir = os.path.join(save_path, scene)
    os.makedirs(scene_dir, exist_ok=True)
    tsdf = TSDF(voxel_size, out["offset"].reshape(1, 3), out["tsdf"])
    tsdf.save(os.path.join(scene_dir, scene + ".npz"))
    t_mesh = time.perf_counter()
    verts, faces, normals = tsdf.get_mesh(device)
    mesh_s = time.perf_counter() - t_mesh
    ply = os.path.join(scene_dir, scene + ".ply")
    write_ply_mesh(ply, verts, faces, vertex_normals=normals)
    valid = out["bbox_valid"]
    np.savez(os.path.join(scene_dir, scene + "_bbox_raw.npz"),
             bboxes=out["bboxes"][valid], scores=out["scores"][valid])
    if middle_path:
        pvalid = out["point_valid"]
        vert = np.concatenate([out["xyz"][pvalid], out["feats"][pvalid]],
                              axis=1).astype(np.float32)
        np.save(os.path.join(middle_path, scene + "_vert.npy"), vert)
        if middle_viz:
            os.makedirs(os.path.join(middle_viz, scene), exist_ok=True)
            write_ply_points(os.path.join(middle_viz, scene,
                                          scene + "_points.ply"), vert[:, :3])
    return {"write_s": time.perf_counter() - t0, "mesh_s": mesh_s,
            "faces": int(len(faces)), "ply_bytes": os.path.getsize(ply),
            "boxes": int(valid.sum())}


def _host_outputs(model, out: Dict[str, Any], sample: Dict[str, Any],
                  middle: bool) -> Dict[str, Any]:
    """Scene 0 of the forward's outputs, copied to the host."""
    fine = out["tsdf"][f"scene_tsdf_{model.tsdf_head.keys[-1]}"]
    host = {"tsdf": fine[0], "bboxes": out["bboxes"][0],
            "scores": out["scores"][0], "bbox_valid": out["bbox_valid"][0]}
    if middle:
        pts = out["points"]
        host.update(xyz=pts.xyz[0], feats=pts.feats[0],
                    point_valid=pts.valid[0])
    host = {k: v.float().cpu().numpy() if v.is_floating_point()
            else v.cpu().numpy() for k, v in host.items()}
    host["offset"] = np.asarray(sample["offset"], np.float32)
    return host


def main(argv: Optional[Sequence[str]] = None) -> List[Dict[str, Any]]:
    """Run the CLI; returns one record per scene (its name, the seconds of
    reading, forward and writing, the mesh's faces, the PLY's bytes)."""
    args = parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device here "
                         "(pass --device cpu to run on the CPU)")
    cfg = Config.fromfile(args.config)
    if args.cfg_options:
        cfg.merge_from_options(dict(kv.split("=", 1)
                                    for kv in args.cfg_options))
    save_path = args.save_path or cfg.get("save_path", "./results")
    middle_path = args.middle_save_path or cfg.get("middle_save_path")
    middle_viz = (args.middle_visualize_path
                  or cfg.get("middle_visualize_path"))
    for d in (save_path, middle_path, middle_viz):
        if d:
            os.makedirs(d, exist_ok=True)

    dataset = _Head(build_dataset(cfg, "test", seed=args.seed),
                    args.max_scenes)
    model = build_model(cfg, mode="test")
    load_parameters(model, args.checkpoint, args.seed)
    model.to(dev)

    # one reader thread, one scene ahead: the frame draws of the seeded
    # RandomState come in scene order, and at most two samples are alive
    reader = ThreadPoolExecutor(max_workers=1)
    writer = ThreadPoolExecutor(max_workers=1)
    pending, records = [], []
    try:
        ahead = reader.submit(dataset.__getitem__, 0) if len(dataset) else None
        for index in range(len(dataset)):
            t_wait = time.perf_counter()
            sample = ahead.result()
            wait_s = time.perf_counter() - t_wait
            ahead = (reader.submit(dataset.__getitem__, index + 1)
                     if index + 1 < len(dataset) else None)
            scene = sample["scene"]
            tb = {k: torch.from_numpy(np.asarray(sample[k])[None]).to(dev)
                  for k in _BATCH_KEYS}
            t0 = time.perf_counter()
            gen = torch.Generator(device=dev).manual_seed(index)
            out = model(tb, generator=gen)
            host = _host_outputs(model, out, sample, bool(middle_path))
            forward_s = time.perf_counter() - t0
            rec = {"scene": scene, "index": index,
                   "load_s": sample["load_s"], "wait_s": wait_s,
                   "forward_s": forward_s}
            del sample, tb, out
            pending.append((rec, writer.submit(
                write_scene, scene, host, model.voxel_size, save_path,
                middle_path, middle_viz, dev)))
            while len(pending) > 1 or (pending and pending[0][1].done()):
                records.append(_finish(*pending.pop(0)))
        while pending:
            records.append(_finish(*pending.pop(0)))
    finally:
        reader.shutdown(wait=True, cancel_futures=True)
        writer.shutdown(wait=True)
    return records


def _finish(rec: Dict[str, Any], fut) -> Dict[str, Any]:
    rec.update(fut.result())
    print(f"[{rec['index'] + 1}] {rec['scene']}: load {rec['load_s']:.3f} s "
          f"(waited {rec['wait_s']:.3f}), forward {rec['forward_s']:.3f} s, "
          f"write {rec['write_s']:.3f} s (mesh {rec['mesh_s']:.3f}), "
          f"{rec['faces']} faces, {rec['ply_bytes']} PLY bytes, "
          f"{rec['boxes']} raw boxes", flush=True)
    return rec


if __name__ == "__main__":
    main()

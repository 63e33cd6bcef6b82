"""The test CLI of the port: dataset scenes -> the per-scene result files.

    python -m cnrma_torch.tools.test CONFIG [CHECKPOINT] [--save-path DIR]
        [--middle-save-path DIR] [--middle-visualize-path DIR]
        [--max-scenes N] [--seed S] [--cfg-options k=v ...] [--device cpu]
        [--n-devices N | --view-shard]

Port of ``tools/test.py`` (the reference ``test.py`` +
``RayMarching.forward_test``).  Per scene it writes, with the JAX tool's
names, keys, dtypes and z convention:

* ``{save_path}/{scene}/{scene}.npz``: the predicted fine TSDF;
* ``{save_path}/{scene}/{scene}.ply``: its marching-cubes mesh;
* ``{save_path}/{scene}/{scene}_bbox_raw.npz``: the valid rows of the raw
  ``bboxes`` (gravity-center z) and ``scores``;
* with a middle path, ``{middle}/{scene}_vert.npy``: xyz and the 32 weighted
  features of the kept points (and, with a visualize path, their ``.ply``).

An ``Atlas`` config (stage 1, ``configs/atlas_recon_scannet.py``) writes the
TSDF and its mesh only.  Offline scoring is then ``python -m
cnrma_torch.tools.nms_bbox`` and ``python -m cnrma_torch.tools.evaluate_bbox``
for the boxes, ``python -m cnrma_torch.tools.evaluate_mesh`` for the mesh.

``CHECKPOINT`` is a ``.pt`` state dict of the port or a checkpoint of its
train CLI (``cnrma_torch.tools.train``), an ``.npz`` of a flax variable
tree's flattened leaves (``params/...``, ``batch_stats/...``), loaded
through ``bridge.from_flax``, or a reference ``.pth`` (``convert.py``).
Without one the parameters are synthesized from ``--seed``
(``synthetic.synthesize_parameters``).  A checkpoint without the detector
loads into ``CNRMA`` too (the stage-2.1 dump, ``configs/scannet_middle.py``
from a stage-1 checkpoint): its detector tensors keep their ``--seed``
synthesis and the CLI prints their count; any other missing or unexpected
key fails the load.

The forward runs on ``cuda:0`` unless ``--device cpu``, with TF32 off in
cuDNN and cuBLAS (fp32 is fp32), in every rank too.  W reader
threads (``data.workers_per_gpu`` x 2, the JAX train CLI's count; one
where that is 0) decode and resample the next W scenes while the device
runs this one (``data/loader.py``: the frame draws stay in scene order
on one thread, so the files do not depend on W), and one writer thread
meshes and writes the files.  ``--n-devices N`` shares the scenes out over N
processes, rank r on ``cuda:r`` (on ``cuda:r % cards`` where there are
fewer cards; N CPU processes with ``--device cpu``): rank r reads and
writes positions ``r, r + N, ...`` with its own readers and writer, and
needs no collective.  The subsample's generator is seeded by the scene's
global index, so a scene gives the same files alone, inside a run of
many, or on any rank; ``--max-scenes M`` writes exactly M scenes in all.
Any failure stops the run with an error: no scene is skipped.

``--view-shard`` splits each scene's views across the ranks of a
``torchrun`` world (JAX's ``--view-shard``, the multi-card latency path
for one scene):

    torchrun --nproc_per_node N -m cnrma_torch.tools.test CONFIG \
        --view-shard [...]

Rank r runs the 2D tower on its block of the views (padded to a multiple
of N with invalid views) and K1's sum of them; one all-reduce gives every
rank the scene's volume, and the U-Net, head, march and detector run
alike on every rank (the forward's ``view_group``).  Rank 0 alone reads
ahead (its reader threads) and sends each scene to the others, and rank 0
alone writes the files, which are one rank's.  NCCL across cards, gloo
with ``--device cpu``.  ``--view-shard`` with ``--n-devices`` is refused;
at world size 1 it warns and runs on one device.
"""

from __future__ import annotations

import argparse
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.multiprocessing as mp

from cnrma_torch.bridge import from_flax, read_flax_npz
from cnrma_torch.convert import read_pth, reference_state_dict
from cnrma_torch.core.builder import build_dataset, build_model
from cnrma_torch.core.config import Config
from cnrma_torch.data.loader import SceneLoader
from cnrma_torch.geometry.tsdf import TSDF
from cnrma_torch.models.fcaf3d_only import FCAF3DOnly
from cnrma_torch.parallel import dist
from cnrma_torch.synthetic import synthesize_parameters
from cnrma_torch.tools._common import no_tf32
from cnrma_torch.utils.ply import write_ply_mesh, write_ply_points

_BATCH_KEYS = ("imgs", "projection", "view_valid", "offset")
# what a scene's record and files need besides its tensors
_SCENE_KEYS = ("index", "scene", "offset", "load_s", "wait_s")


def parse_args(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description="Run the CN-RMA port's test "
                                            "forward over a dataset split")
    p.add_argument("config")
    p.add_argument("checkpoint", nargs="?", default=None,
                   help=".pt state dict or train checkpoint of the port, "
                        ".npz of flattened flax leaves, or a reference "
                        ".pth")
    p.add_argument("--save-path")
    p.add_argument("--middle-save-path")
    p.add_argument("--middle-visualize-path",
                   help="also dump the ray-marched points as .ply")
    p.add_argument("--max-scenes", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cfg-options", nargs="+", default=[])
    p.add_argument("--device", default="cuda:0",
                   help="cuda:0 (default) or cpu")
    p.add_argument("--n-devices", type=int, default=1,
                   help="share the scenes out over N processes, one a "
                        "card (N CPU processes with --device cpu)")
    p.add_argument("--view-shard", action="store_true",
                   help="under torchrun: split each scene's views across "
                        "the ranks (tower and volume), one all-reduce of "
                        "the volume")
    return p.parse_args(argv)


class _Head:
    """The first ``n`` scenes of a dataset; its other attributes
    (``draw``, ``load``) are the dataset's."""

    def __init__(self, dataset, n: Optional[int]):
        self.dataset = dataset
        self.n = len(dataset) if n is None else min(n, len(dataset))

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, i: int) -> Dict[str, Any]:
        return self.dataset[i]

    def __getattr__(self, name: str) -> Any:
        if name == "dataset":
            raise AttributeError(name)
        return getattr(self.dataset, name)


def reader_workers(cfg) -> int:
    """The readers' worker threads: ``data.workers_per_gpu`` x 2, as the
    JAX train CLI sets them."""
    return int(cfg.get("data", {}).get("workers_per_gpu", 2)) * 2


def read_parameters(checkpoint: str) -> Dict[str, torch.Tensor]:
    """A checkpoint's state dict: an ``.npz`` of flax leaves, a reference
    ``.pth``, or a ``.pt`` state dict or train checkpoint of the port."""
    if checkpoint.endswith(".npz"):
        return from_flax(read_flax_npz(checkpoint))
    if checkpoint.endswith(".pth"):
        return reference_state_dict(read_pth(checkpoint))
    state = torch.load(checkpoint, map_location="cpu", weights_only=True)
    if "model" in state and "optimizer" in state:       # a train checkpoint
        state = state["model"]
    return state


def load_parameters(model: torch.nn.Module, checkpoint: Optional[str],
                    seed: int, keep_missing: Sequence[str] = ()) -> int:
    """Load ``checkpoint`` into ``model``, or without one synthesize the
    parameters from ``seed``.  Tensors the checkpoint lacks under one of
    the ``keep_missing`` prefixes keep their synthesis from ``seed``; any
    other missing or unexpected key, or a shape that differs, raises.
    Returns the number of tensors kept so."""
    if checkpoint is None:
        synthesize_parameters(model, seed)
        return 0
    state = read_parameters(checkpoint)
    missing, unexpected = model.load_state_dict(state, strict=False)
    kept = [k for k in missing if k.startswith(tuple(keep_missing))]
    if unexpected or len(kept) != len(missing):
        raise KeyError(f"{checkpoint}: keys the model does not have "
                       f"{unexpected[:5]} ({len(unexpected)}); model keys "
                       f"missing {[k for k in missing if k not in kept][:5]}"
                       f" ({len(missing) - len(kept)})")
    if kept:
        synthesize_parameters(model, seed)
        model.load_state_dict(state, strict=False)
    return len(kept)


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
    boxes = None
    if "bboxes" in out:
        valid = out["bbox_valid"]
        np.savez(os.path.join(scene_dir, scene + "_bbox_raw.npz"),
                 bboxes=out["bboxes"][valid], scores=out["scores"][valid])
        boxes = int(valid.sum())
    if middle_path and "xyz" in out:
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
            "boxes": boxes}


def _host_outputs(model, out: Dict[str, Any], offset: np.ndarray,
                  middle: bool) -> Dict[str, Any]:
    """Scene 0 of the forward's outputs, copied to the host (the TSDF;
    with a detector the boxes and, with a middle path, the points)."""
    fine = out["tsdf"][f"scene_tsdf_{model.tsdf_head.keys[-1]}"]
    host = {"tsdf": fine[0]}
    if "bboxes" in out:
        host.update(bboxes=out["bboxes"][0], scores=out["scores"][0],
                    bbox_valid=out["bbox_valid"][0])
    if middle and "points" in out:
        pts = out["points"]
        host.update(xyz=pts.xyz[0], feats=pts.feats[0],
                    point_valid=pts.valid[0])
    host = {k: v.float().cpu().numpy() if v.is_floating_point()
            else v.cpu().numpy() for k, v in host.items()}
    host["offset"] = np.asarray(offset, np.float32)
    return host


def main(argv: Optional[Sequence[str]] = None) -> List[Dict[str, Any]]:
    """Run the CLI; returns one record per scene in scene order (its name
    and index, the seconds of reading, waiting, forward and writing, the
    mesh's faces, the PLY's bytes), every rank's with ``--n-devices``."""
    args = parse_args(argv)
    no_tf32()
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device here "
                         "(pass --device cpu to run on the CPU)")
    n = max(1, args.n_devices)
    if n > 1 and args.view_shard:
        raise SystemExit("--n-devices (scene sharding) and --view-shard "
                         "(view sharding) are mutually exclusive")
    if args.view_shard:
        if int(os.environ.get("WORLD_SIZE", "1")) == 1:
            print("WARNING: --view-shard needs >1 device; running "
                  "single-device", flush=True)
            return run_rank(args, 0, 1, dev)
        group, rank_dev = dist.init_from_env(dev.type)
        try:
            return run_rank(args, dist.rank(group), dist.world(group),
                            rank_dev, view_group=group)
        finally:
            dist.shutdown(group)
    if n == 1:
        return run_rank(args, 0, 1, dev)
    results = mp.get_context("spawn").SimpleQueue()
    procs = mp.start_processes(
        _rank_main, args=(args, n, results, torch.get_num_threads()),
        nprocs=n, join=False, start_method="spawn")
    records: List[Dict[str, Any]] = []
    done = False
    while not done:
        done = procs.join(timeout=1)      # raises where a rank failed
        while not results.empty():
            records.extend(results.get())
    return sorted(records, key=lambda r: r["index"])


def _rank_main(rank: int, args, world: int, results, threads: int) -> None:
    """Rank ``rank`` of ``--n-devices``: its device, its scenes, with TF32
    off and the caller's number of torch threads (the CPU's convolutions
    sum in an order that depends on it), so that its files are the ones
    the caller's process would write."""
    no_tf32()
    torch.set_num_threads(threads)
    if args.device == "cpu":
        dev = torch.device("cpu")
    else:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    results.put(run_rank(args, rank, world, dev))


def _broadcast_scenes(loader, n_scenes: int, group, dev: torch.device):
    """The scenes of rank 0's ``loader`` on every rank of ``group``: rank
    0 reads, the others take each scene's tensors and names from it.
    Yields (the loader's batch without its arrays, the tensors on
    ``dev``)."""
    main = dist.is_main(group)
    it = iter(loader) if main else None
    for _ in range(n_scenes):
        meta = [None]
        if main:
            batch = next(it)
            tb = {k: torch.from_numpy(np.asarray(batch[k])).to(dev)
                  for k in _BATCH_KEYS}
            meta = [({k: batch[k] for k in _SCENE_KEYS},
                     {k: (tuple(t.shape), t.dtype) for k, t in tb.items()})]
        torch.distributed.broadcast_object_list(meta, src=0, group=group)
        info, shapes = meta[0]
        if not main:
            tb = {k: torch.empty(shape, dtype=dtype, device=dev)
                  for k, (shape, dtype) in shapes.items()}
        for k in _BATCH_KEYS:
            torch.distributed.broadcast(tb[k], src=0, group=group)
        yield info, tb


def run_rank(args, rank: int, world: int, dev: torch.device,
             view_group=None) -> List[Dict[str, Any]]:
    """Rank ``rank`` of ``world``'s scenes through the forward and the
    writer; its records.  With a ``view_group`` the ranks take every
    scene together (``--view-shard``): rank 0 reads and writes, and the
    others return no record."""
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
    if isinstance(model, FCAF3DOnly):
        raise SystemExit("the test CLI runs the models that read views "
                         "(CNRMA, Atlas); FCAF3DOnly trains on dumped points")
    kept = load_parameters(model, args.checkpoint, args.seed,
                           keep_missing=("detector.",))
    if kept and rank == 0:
        print(f"{args.checkpoint} holds no detector: its {kept} tensors keep "
              f"their synthesis from --seed {args.seed}", flush=True)
    model.to(dev)
    writes = view_group is None or rank == 0
    if view_group is not None:
        scenes = _broadcast_scenes(
            SceneLoader(dataset, shuffle=False,
                        num_workers=reader_workers(cfg), drop_last=False)
            if rank == 0 else None, len(dataset), view_group, dev)
    else:
        loader = SceneLoader(dataset, shuffle=False,
                             num_workers=reader_workers(cfg),
                             rank=rank, world_size=world, drop_last=False)
        scenes = ((batch, {k: torch.from_numpy(np.asarray(batch[k])).to(dev)
                           for k in _BATCH_KEYS}) for batch in loader)
    writer = ThreadPoolExecutor(max_workers=1)
    pending, records = [], []
    try:
        for batch, tb in scenes:
            index, scene = batch["index"], batch["scene"][0]
            t0 = time.perf_counter()
            gen = torch.Generator(device=dev).manual_seed(index)
            out = model(tb, generator=gen, view_group=view_group)
            if not writes:
                continue
            host = _host_outputs(model, out, batch["offset"][0],
                                 bool(middle_path))
            forward_s = time.perf_counter() - t0
            rec = {"scene": scene, "index": index, "rank": rank,
                   "load_s": batch["load_s"], "wait_s": batch["wait_s"],
                   "forward_s": forward_s}
            del batch, tb, out
            pending.append((rec, writer.submit(
                write_scene, scene, host, model.voxel_size, save_path,
                middle_path, middle_viz, dev)))
            while len(pending) > 1 or (pending and pending[0][1].done()):
                records.append(_finish(*pending.pop(0)))
        while pending:
            records.append(_finish(*pending.pop(0)))
    finally:
        writer.shutdown(wait=True)
    return records


def _finish(rec: Dict[str, Any], fut) -> Dict[str, Any]:
    rec.update(fut.result())
    print(f"[{rec['index'] + 1}] {rec['scene']}: load {rec['load_s']:.3f} s "
          f"(waited {rec['wait_s']:.3f}), forward {rec['forward_s']:.3f} s, "
          f"write {rec['write_s']:.3f} s (mesh {rec['mesh_s']:.3f}), "
          f"{rec['faces']} faces, {rec['ply_bytes']} PLY bytes, "
          + ("no box file" if rec["boxes"] is None
             else f"{rec['boxes']} raw boxes"), flush=True)
    return rec


if __name__ == "__main__":
    main()

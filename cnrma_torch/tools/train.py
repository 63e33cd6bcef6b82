"""The train CLI of the port: any of the three stages of the ScanNet or
ARKitScenes recipe over a dataset split.

    python -m cnrma_torch.tools.train CONFIG [--work-dir DIR]
        [--load-from CKPT | --resume-from CKPT] [--seed S] [--max-steps N]
        [--batch-size B] [--cfg-options k=v ...] [--device cpu]

Port of ``tools/train.py`` on one device: the config's training split and
model (``build_dataset(cfg, "train")``, ``build_model(cfg, "train")``), the
optimizer of ``optimizer`` (AdamW or Adam), ``optimizer_config.grad_clip``
and ``lr_config`` with the 2D stem and res2 frozen where the model has a
2D tower (``train/optim.py``), and ``run_training`` over ``total_epochs``
(``train/loop.py``), logging every ``log_config.interval`` steps and
checkpointing every ``checkpoint_config.interval`` epochs into the work
dir.  The three configs of the recipe (``doc/train_val.md``):

* ``configs/atlas_recon_scannet.py``: stage 1, ``Atlas`` on the recon
  crops (``recon_random``), bf16, Adam;
* ``configs/fcaf3d_middle_scannet.py``: stage 2, ``FCAF3DOnly`` on the
  points a stage-2.1 dump wrote (``data.train.points_dir``);
* ``configs/ray_marching_scannet.py``: stage 3, ``CNRMA`` from the merge
  of the two (``python -m cnrma_torch.tools.combine_models``).

ARKit's configs (``atlas_recon_arkit.py``, ``fcaf3d_middle_arkit.py``,
``ray_marching_arkit.py``) run the same stages with the 7-DoF yaw detector.

The config's ``backbone2d.pretrained`` R-50 (a reference ``.pth``) is read
into the 2D tower when the file exists, through ``convert.py``, and the
number of tensors loaded is printed; when it is missing the CLI warns
that the tower trains from scratch.  ``--load-from`` then takes the
weights and statistics of a checkpoint: a train checkpoint or state dict
``.pt`` of the port, an ``.npz`` of a flax variable tree's flattened leaves
(``bridge.from_flax``) or a reference ``.pth``; ``--resume-from`` takes a
train checkpoint whole (step, epoch, optimizer).  Without either the
parameters are the model's default initialisation under
``torch.manual_seed(--seed)``, as the JAX tool starts from ``model.init``
(zero-initialised residual norms, the detector's class prior).

With ``evaluation`` and ``data.val`` in the config (every config has
``evaluation = dict(interval=10)``; the stage-3 ones ``metric='mAP'``), the
val split is read in scene order, every scene, and scored after every
``evaluation.interval``-th epoch, the last, and a stop by ``--max-steps``:
the mean val losses and, for ``metric='mAP'``, the NMS and mAP
(``train/loop.py:evaluate_split``); ``{work dir}/best.pt`` keeps the state
with the lowest ``val/total_loss`` or the highest ``val/mAP_0.25``, and
loads in the test CLI and in ``--resume-from``.  The interval counts
epochs, as the JAX package's does (the reference counts 3000 iterations;
ROADMAP F5).  Where the val split cannot be built the CLI warns and trains
without evaluation, as the JAX tool does.

The val split is scored at the config's test grid (``voxel_dim_test``, the
grid its samples and TSDF targets come at) by ``test_twin``: a test-mode
model whose parameters and buffers are the training model's own tensors,
so nothing is copied.  The JAX tool scores it with its training-grid
model, which cannot take the ScanNet configs' val samples (ROADMAP F14).

The step runs on ``cuda:0`` unless ``--device cpu``, with TF32 off in
cuDNN and cuBLAS (fp32 is fp32).  ``--batch-size B`` (default: one scene
a rank) is the number of scenes a step takes over all ranks, as the JAX
CLI's: the B scenes of each step are consecutive scenes of the epoch's
shuffle, the batch norms take their statistics over the step's scenes
(the sparse ones over every scene's valid voxels), and an epoch has
``len(dataset) // B`` steps, which the lr schedule counts.  The val split
is scored in batches of B too, the last one partial.  The reader runs
``data.workers_per_gpu`` x 2 worker threads (the JAX CLI's count; 4 in
every config).  The checkpoints load in ``python -m
cnrma_torch.tools.test``.

Data parallel, as the reference's DDP (``samples_per_gpu=1``: B = N):

    torchrun --nproc_per_node N -m cnrma_torch.tools.train CONFIG [...]

takes the process group from ``torchrun``'s environment (NCCL, rank r on
``cuda:LOCAL_RANK``; gloo with ``--device cpu``).  B must be a multiple
of N, and any other value is refused before the group is joined.  Of
each round of B scenes of the epoch's shared shuffle, rank r reads the
contiguous block ``[r * B / N, (r + 1) * B / N)`` (the JAX batch split
over its mesh; at B = N positions ``r, r + N, ...``), the last
incomplete round dropped; its norms take their statistics over its own
B / N scenes (the JAX step syncs none across devices), and each step then
averages the gradients, the batch norms' running statistics and the log
vars over the ranks (``train/loop.py:train_step``).  The val split is
shared out the same way without the drop and scored on rank 0.  Only
rank 0 logs and writes checkpoints; every rank reads ``--load-from`` and
``--resume-from``.

One scene split across ranks (JAX's ``--view-shards``, the ``('data',
'view')`` mesh):

    torchrun --nproc_per_node N -m cnrma_torch.tools.train CONFIG \
        --view-shards n [...]

gives each scene n ranks (n divides N): rank r is view index ``r % n``
of data row ``r // n`` (``parallel/dist.py:view_shards``).  The ranks of a
row read the same scene and step on it through
``CNRMA.forward_view_sharded`` (each its V/n views for the tower, volume
and march, its X-slab of the U-Net and TSDF head; ``Atlas`` alike without
the detector); the step sums the sharded modules' gradients over the
row and averages the detector's, then averages over the rows; a row's
draws fold in the row, not the rank.  A step takes one scene a row:
``--batch-size`` may only be N / n.  The val split is scored by the rows,
each scene through the test forward's view sharding.  ``FCAF3DOnly``
(stage 2) has no views to split and is refused.
"""

from __future__ import annotations

import argparse
import os
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from cnrma_torch.convert import load_pretrained_2d
from cnrma_torch.core.builder import build_dataset, build_model
from cnrma_torch.core.config import Config
from cnrma_torch.data.loader import SceneLoader
from cnrma_torch.parallel import dist
from cnrma_torch.tools._common import no_tf32
from cnrma_torch.tools.test import load_parameters, reader_workers
from cnrma_torch.train.loop import evaluate_split, run_training
from cnrma_torch.train.optim import (
    FROZEN_PREFIXES_FREEZE_AT_2, build_lr_schedule, build_optimizer)
from cnrma_torch.train.state import TrainState, load_checkpoint


def parse_args(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description="Train the CN-RMA port")
    p.add_argument("config")
    p.add_argument("--work-dir")
    p.add_argument("--load-from", help="weights only: a .pt of the port, "
                                       "an .npz of flax leaves or a "
                                       "reference .pth")
    p.add_argument("--resume-from",
                   help="a train checkpoint of the port, whole")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max-steps", type=int, default=None,
                   help="stop after N optimizer steps")
    p.add_argument("--cfg-options", nargs="+", default=[])
    p.add_argument("--device", default="cuda:0",
                   help="cuda:0 (default) or cpu; under torchrun a rank "
                        "takes cuda:LOCAL_RANK unless this is cpu")
    p.add_argument("--batch-size", type=int, default=None,
                   help="scenes a step over all ranks, a multiple of the "
                        "world size (default: one scene a rank)")
    p.add_argument("--view-shards", type=int, default=1,
                   help="split each scene across N ranks: views for the "
                        "2D tower, volume and march, X-slabs for the 3D "
                        "U-Net (N divides the world size)")
    return p.parse_args(argv)


def test_twin(cfg, model: nn.Module) -> nn.Module:
    """The config's test-mode model (eval mode, the ``voxel_dim_test``
    grid) whose parameters and buffers are ``model``'s tensors, shared,
    not copied: the training steps move both.  Make it after ``model``
    is on its device (``Module.to`` replaces buffers)."""
    twin = build_model(cfg, mode="test")
    ours, theirs = dict(twin.named_modules()), dict(model.named_modules())
    if ours.keys() != theirs.keys():
        raise ValueError("the test model's modules are not the training "
                         "model's")
    for name, mod in ours.items():
        for table in ("_parameters", "_buffers"):
            mine, shared = getattr(mod, table), getattr(theirs[name], table)
            if mine.keys() != shared.keys():
                raise ValueError(f"{name}: the test model's {table[1:]} "
                                 "are not the training model's")
            mine.update(shared)
    return twin


def val_evaluator(cfg, model: nn.Module, seed: int, device, group=None,
                  batch_size: Optional[int] = None,
                  shards: Optional[dist.ViewShards] = None
                  ) -> Tuple[Optional[Callable[[], Dict[str, float]]], int,
                             str]:
    """(the evaluator ``run_training`` calls, the interval in epochs, the
    metric) of the config's ``evaluation`` over ``data.val`` in batches of
    ``batch_size`` scenes over all ranks (default one a rank), each rank
    reading its share of the split; with ``shards`` one scene a data row
    through the test forward's view sharding, the rows' results gathered
    over each view index's data group; no evaluator when the config has
    neither or the split cannot be built."""
    eval_cfg = cfg.get("evaluation", {}) or {}
    metric = str(eval_cfg.get("metric", "loss"))
    interval = max(1, int(eval_cfg.get("interval", 1)))
    if not eval_cfg or not cfg.get("data", {}).get("val"):
        return None, interval, metric
    try:
        dataset = build_dataset(cfg, "val", seed=seed)
    except (OSError, KeyError, ValueError) as e:
        print(f"WARNING: val split unavailable ({e}); mid-training "
              "evaluation disabled", flush=True)
        return None, interval, metric
    twin = test_twin(cfg, model)
    rank, world, view = dist.rank(group), dist.world(group), None
    if shards is not None:
        rank, world, group = shards.row, shards.rows, shards.data
        view = shards.view
    loader = SceneLoader(dataset, shuffle=False,
                         num_workers=reader_workers(cfg), rank=rank,
                         world_size=world, drop_last=False,
                         batch_size=batch_size)
    return (lambda: evaluate_split(twin, loader, device, metric,
                                   group=group, view_group=view),
            interval, metric)


def main(argv: Optional[Sequence[str]] = None
         ) -> Tuple[List[Dict[str, Any]], Optional[str]]:
    """Run the CLI; returns the per-step records of ``run_training`` and
    the path of the last checkpoint."""
    args = parse_args(argv)
    no_tf32()
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device here "
                         "(pass --device cpu to run on the CPU)")
    world = int(os.environ.get("WORLD_SIZE", "1"))
    n = args.view_shards
    if n < 1 or world % n:
        raise SystemExit(f"--view-shards {n} must divide the {world} "
                         "visible devices")
    if n > 1:
        if args.batch_size not in (None, world // n):
            raise SystemExit(
                f"--batch-size {args.batch_size} with --view-shards {n}: "
                "forward_view_sharded: per-device batch must be 1 scene, "
                f"got {args.batch_size / (world // n):g}")
    elif args.batch_size is not None and (args.batch_size < 1
                                          or args.batch_size % world):
        raise SystemExit(f"--batch-size {args.batch_size}: a step takes a "
                         f"multiple of the world size, {world} here, of "
                         "scenes (the same number a rank)")
    group, rank_dev = dist.init_from_env(dev.type)
    try:
        return _train(args, group, rank_dev or dev)
    finally:
        dist.shutdown(group)


def _train(args, group, dev: torch.device
           ) -> Tuple[List[Dict[str, Any]], Optional[str]]:
    world = dist.world(group)
    shards = (dist.view_shards(group, args.view_shards)
              if args.view_shards > 1 else None)
    cfg = Config.fromfile(args.config)
    if args.cfg_options:
        cfg.merge_from_options(dict(kv.split("=", 1)
                                    for kv in args.cfg_options))
    work_dir = args.work_dir or cfg.get("work_dir", "./work_dirs/default")
    os.makedirs(work_dir, exist_ok=True)
    if dist.is_main(group):
        with open(os.path.join(work_dir, "config_dump.py"), "w") as f:
            f.write(cfg.dump())

    dataset = build_dataset(cfg, "train", seed=args.seed)
    # the ranks of a view group read their row's scene
    rank, rows = ((shards.row, shards.rows) if shards is not None
                  else (dist.rank(group), world))
    loader = SceneLoader(dataset, seed=args.seed,
                         num_workers=reader_workers(cfg), rank=rank,
                         world_size=rows,
                         batch_size=rows if shards else args.batch_size)
    torch.manual_seed(args.seed)
    model = build_model(cfg, mode="train")
    if shards is not None and not hasattr(model, "forward_view_sharded"):
        raise SystemExit(f"--view-shards {shards.n}: {type(model).__name__} "
                         "reads no views to split (stage 2 trains on "
                         "dumped points)")
    load_from = args.load_from or cfg.get("load_from")
    resume_from = args.resume_from or cfg.get("resume_from")
    # as tools/train.py: the R-50 goes in first, a checkpoint over it
    pre2d = (cfg.get("model", {}).get("backbone2d", {}) or {}).get(
        "pretrained")
    if pre2d:
        if os.path.isfile(pre2d):
            n = load_pretrained_2d(model, pre2d)
            print(f"loaded {n} pretrained 2D-backbone tensors from {pre2d}",
                  flush=True)
        else:
            print(f"WARNING: backbone2d.pretrained={pre2d} not found — "
                  "training the 2D tower from scratch (0 tensors loaded)",
                  flush=True)
    if load_from and not resume_from:
        load_parameters(model, load_from, args.seed)
    model.to(dev)

    clip = ((cfg.get("optimizer_config", {}) or {}).get("grad_clip")
            or {}).get("max_norm")
    schedule = build_lr_schedule(cfg.get("lr_config", {}),
                                 cfg.optimizer["lr"], max(1, len(loader)))
    optimizer = build_optimizer(cfg.optimizer, model, schedule,
                                grad_clip=clip,
                                frozen_prefixes=FROZEN_PREFIXES_FREEZE_AT_2)
    state = TrainState(model=model, optimizer=optimizer)
    if resume_from:
        load_checkpoint(resume_from, state)
    evaluate, eval_interval, eval_metric = val_evaluator(
        cfg, model, args.seed, dev, group,
        rows if shards else args.batch_size, shards)
    return run_training(
        state, loader, epochs=int(cfg.get("total_epochs", 1)),
        work_dir=work_dir, device=dev, seed=args.seed,
        log_interval=int(cfg.get("log_config", {}).get("interval", 10)),
        checkpoint_interval=int(cfg.get("checkpoint_config", {}).get(
            "interval", 10)),
        max_steps=args.max_steps, evaluate=evaluate,
        eval_interval=eval_interval, eval_metric=eval_metric, group=group,
        shards=shards)


if __name__ == "__main__":
    main()

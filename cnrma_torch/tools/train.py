"""The train CLI of the port: any of the three stages of the ScanNet recipe
over a dataset split.

    python -m cnrma_torch.tools.train CONFIG [--work-dir DIR]
        [--load-from CKPT | --resume-from CKPT] [--seed S] [--max-steps N]
        [--cfg-options k=v ...] [--device cpu]

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

The step runs on ``cuda:0`` unless ``--device cpu``; a batch holds one
scene.  The checkpoints load in ``python -m cnrma_torch.tools.test``.
Multi-card data parallel training and the mid-training evaluation are not
ported yet (ROADMAP).
"""

from __future__ import annotations

import argparse
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from cnrma_torch.convert import load_pretrained_2d
from cnrma_torch.core.builder import build_dataset, build_model
from cnrma_torch.core.config import Config
from cnrma_torch.data.loader import SceneLoader
from cnrma_torch.tools.test import load_parameters
from cnrma_torch.train.loop import run_training
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
                   help="cuda:0 (default) or cpu")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None
         ) -> Tuple[List[Dict[str, Any]], Optional[str]]:
    """Run the CLI; returns the per-step records of ``run_training`` and
    the path of the last checkpoint."""
    args = parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device here "
                         "(pass --device cpu to run on the CPU)")
    cfg = Config.fromfile(args.config)
    if args.cfg_options:
        cfg.merge_from_options(dict(kv.split("=", 1)
                                    for kv in args.cfg_options))
    work_dir = args.work_dir or cfg.get("work_dir", "./work_dirs/default")
    os.makedirs(work_dir, exist_ok=True)
    with open(os.path.join(work_dir, "config_dump.py"), "w") as f:
        f.write(cfg.dump())

    dataset = build_dataset(cfg, "train", seed=args.seed)
    loader = SceneLoader(dataset, seed=args.seed)
    torch.manual_seed(args.seed)
    model = build_model(cfg, mode="train")
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
    return run_training(
        state, loader, epochs=int(cfg.get("total_epochs", 1)),
        work_dir=work_dir, device=dev, seed=args.seed,
        log_interval=int(cfg.get("log_config", {}).get("interval", 10)),
        checkpoint_interval=int(cfg.get("checkpoint_config", {}).get(
            "interval", 10)),
        max_steps=args.max_steps)


if __name__ == "__main__":
    main()

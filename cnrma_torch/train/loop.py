"""The training step and the epoch loop (port of
``cnrma_tpu/train/loop.py``: ``total_loss``, ``make_train_step``'s step on
one device, ``run_training`` without the mid-training evaluation).  The
step runs any of the three stages' models (``CNRMA``, ``Atlas``,
``FCAF3DOnly``) through its ``forward_train``, on the batch keys it takes.

A step: the training forward (batch statistics in the norms, which update
their running statistics once), the backward, the optimizer's clip and
update.  Its draws come from a generator seeded by the run's seed and the
step number, so a resumed run draws what an unbroken one would.  The
loop times each step's stages (``timing.stage_marks``: the batch's copy
to the device, the forward's stages, the backward, the optimizer).
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from cnrma_torch.timing import mark, stage_marks
from cnrma_torch.train.optim import Optimizer
from cnrma_torch.train.state import TrainState, save_checkpoint

# the views of a scene (CNRMA, Atlas) or its dumped points (FCAF3DOnly),
# and the GT boxes (``cnrma_tpu/train/loop.py:33``)
BATCH_KEYS = ("imgs", "projection", "view_valid", "offset", "gt_boxes",
              "gt_labels", "gt_valid", "points", "point_feats",
              "point_valid")


def device_batch(batch: Dict[str, Any], device) -> Dict[str, Any]:
    """The arrays of a collated batch as tensors on ``device``; the TSDF
    targets, where the batch has them, stay grouped under ``tsdf_list``."""
    out = {k: torch.from_numpy(np.asarray(batch[k])).to(device)
           for k in BATCH_KEYS if k in batch}
    if batch.get("tsdf_list"):
        out["tsdf_list"] = {k: torch.from_numpy(np.asarray(v)).to(device)
                            for k, v in batch["tsdf_list"].items()}
    return out


def total_loss(losses: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Sum of the entries whose key contains 'loss' (reference
    ``parse_losses``)."""
    return sum(v for k, v in losses.items() if "loss" in k)


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The draws of step ``step`` of a run seeded ``seed``."""
    return torch.Generator(device=device).manual_seed(
        (int(seed) << 32) + int(step))


def train_step(model: torch.nn.Module, optimizer: Optimizer,
               batch: Dict[str, Any],
               generator: Optional[torch.Generator] = None,
               **draws) -> Dict[str, torch.Tensor]:
    """One optimizer step on ``batch`` (tensors on the model's device).
    ``draws`` (``uniform``, ``aug_draws``) replace the generator's, as in
    ``CNRMA.forward_train``.  Returns the log vars as 0-dim tensors: each
    loss, ``total_loss`` and ``grad_norm`` (the global norm of the
    gradients before the clip)."""
    model.train()
    losses = model.forward_train(batch, generator=generator, **draws)
    loss = total_loss(losses)
    model.zero_grad(set_to_none=True)
    loss.backward()
    mark("backward")
    grad_norm = optimizer.step({n: p.grad for n, p in
                                model.named_parameters()})
    mark("optimizer")
    log_vars = {k: v.detach() for k, v in losses.items()}
    log_vars["total_loss"] = loss.detach()
    log_vars["grad_norm"] = grad_norm
    return log_vars


class TextLogger:
    """A line every ``interval`` steps, to stdout and ``train.log``."""

    def __init__(self, work_dir: Optional[str], interval: int = 10):
        self.interval = max(1, interval)
        self.path = (os.path.join(work_dir, "train.log") if work_dir
                     else None)

    def __call__(self, rec: Dict[str, Any], force: bool = False) -> None:
        if rec["step"] % self.interval and not force:
            return
        parts = [f"epoch {rec['epoch']}", f"iter {rec['step']}",
                 f"lr {rec['lr']:.2e}", f"step {rec['step_s']:.3f}s",
                 f"waited {rec['wait_s']:.3f}s"]
        parts += [f"{k} {v:.4f}" for k, v in rec["log_vars"].items()]
        if rec.get("peak_gib") is not None:
            parts.append(f"peak {rec['peak_gib']:.2f} GiB")
        if rec.get("stages_ms"):
            parts.append("stages ms " + " ".join(
                f"{k} {v:.1f}" for k, v in rec["stages_ms"].items()))
        line = "  ".join(parts)
        print(line, flush=True)
        if self.path:
            with open(self.path, "a") as f:
                f.write(line + "\n")


def run_training(state: TrainState, loader, *, epochs: int, work_dir: str,
                 device, seed: int = 0, log_interval: int = 10,
                 checkpoint_interval: int = 10,
                 max_steps: Optional[int] = None
                 ) -> Tuple[List[Dict[str, Any]], Optional[str]]:
    """Epochs ``state.epoch`` .. ``epochs - 1`` over ``loader``; stops after
    ``max_steps`` optimizer steps in all.  Checkpoints
    ``{work_dir}/epoch_{n}.pt`` after every ``checkpoint_interval``-th
    epoch and the last, and ``{work_dir}/iter_{step}.pt`` where
    ``max_steps`` stops it.  Returns the path of the last checkpoint and
    one record a step: ``step``,
    ``epoch``, ``lr``, ``log_vars`` (floats), ``step_s`` (the step's
    seconds, synchronised), ``wait_s`` and ``load_s`` (the reader's),
    ``stages_ms`` (each stage's milliseconds: CUDA events on a GPU, so
    device time in stream order, the host clock on the CPU) and, on a
    GPU, ``peak_gib`` (the step's peak device memory)."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    logger = TextLogger(work_dir, log_interval)
    records: List[Dict[str, Any]] = []
    path = None
    done = max_steps is not None and state.step >= max_steps
    while state.epoch < epochs and not done:
        for batch in loader:
            if cuda:
                torch.cuda.reset_peak_memory_stats(device)
            t0 = time.perf_counter()
            lr = state.optimizer.lr()
            with stage_marks(device) as marks:
                on_device = device_batch(batch, device)
                mark("copy")
                log_vars = train_step(state.model, state.optimizer,
                                      on_device,
                                      step_generator(seed, state.step,
                                                     device))
            log_vars = {k: float(v) for k, v in log_vars.items()}
            if cuda:
                torch.cuda.synchronize(device)
            state.step += 1
            rec = {"step": state.step, "epoch": state.epoch, "lr": lr,
                   "log_vars": log_vars,
                   "step_s": time.perf_counter() - t0,
                   "wait_s": batch["wait_s"], "load_s": batch["load_s"],
                   "stages_ms": marks.ms(),
                   "peak_gib": (torch.cuda.max_memory_allocated(device)
                                / 2 ** 30 if cuda else None)}
            records.append(rec)
            done = max_steps is not None and state.step >= max_steps
            logger(rec, force=done)
            if done:
                break
        name = f"iter_{state.step}.pt"
        if not done:
            state.epoch += 1
            name = f"epoch_{state.epoch}.pt"
        if done or state.epoch % checkpoint_interval == 0 \
                or state.epoch == epochs:
            path = save_checkpoint(os.path.join(work_dir, name), state)
    return records, path

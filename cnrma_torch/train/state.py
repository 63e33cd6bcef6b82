"""Train state and checkpoints (port of ``cnrma_tpu/train/state.py``,
``torch.save`` in place of orbax).

A checkpoint is one ``.pt`` file: ``{"step", "epoch", "model",
"optimizer"}``, the model's ``state_dict`` (parameters and batch-norm
statistics) and the optimizer's, and for the ``best`` checkpoint of the
mid-training evaluation its ``meta`` (the epoch and the val scores).  ``load_checkpoint`` is the reference's
``resume_from`` (everything); its ``load_from`` (weights and statistics
only) is ``tools/test.py:load_parameters``, which reads the ``"model"``
entry of such a file as the test CLI does.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch
from torch import nn

from cnrma_torch.train.optim import Optimizer


@dataclass
class TrainState:
    """Where training stands: optimizer steps and epochs done, the model
    and the optimizer."""
    model: nn.Module
    optimizer: Optimizer
    step: int = 0
    epoch: int = 0


def save_checkpoint(path: str, state: TrainState,
                    meta: Optional[Dict[str, Any]] = None) -> str:
    """Write ``state`` (and ``meta``, where given) to ``path`` atomically
    and return the path."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    payload = {"step": state.step, "epoch": state.epoch,
               "model": state.model.state_dict(),
               "optimizer": state.optimizer.state_dict()}
    if meta is not None:
        payload["meta"] = meta
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def read_checkpoint(path: str) -> Dict[str, Any]:
    return torch.load(path, map_location="cpu", weights_only=True)


def load_checkpoint(path: str, state: TrainState) -> TrainState:
    """Restore ``state`` from ``path`` in place and return it."""
    ckpt = read_checkpoint(path)
    state.model.load_state_dict(ckpt["model"])
    state.optimizer.load_state_dict(ckpt["optimizer"])
    state.step, state.epoch = int(ckpt["step"]), int(ckpt["epoch"])
    return state

"""What the entries share: the cell as the files describe it, the program
and reference models built from the configuration, the planted TSDF
handed to the march, and the copy of what the window produced to pinned
host memory for the check after it."""

from __future__ import annotations

import json
import os
import sys
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(ROOT)


def log(msg: str) -> None:
    """One line on standard error, with the seconds since the process
    imported this module."""
    print(f"[port_bench {time.perf_counter() - _T0:.2f}s] {msg}",
          file=sys.stderr, flush=True)


_T0 = time.perf_counter()


def load_json(*parts: str) -> Dict[str, Any]:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


@dataclass
class Cell:
    """One workload: its file, configuration, traffic mix and run
    arguments."""
    name: str
    workload: Dict[str, Any]
    config: Dict[str, Any]
    mix: Dict[str, Any]
    seed: int
    seconds: float
    trace: bool
    device: torch.device

    @classmethod
    def load(cls, name: str, seed: int, seconds: float, trace: bool,
             device: torch.device) -> "Cell":
        wl = load_json(ROOT, "workloads", f"{name}.json")
        cfg = load_json(ROOT, "configs", f"{wl['config']}.json")
        mix = load_json(ROOT, "traffic", f"{wl['traffic']}.json")
        return cls(name, wl, cfg, mix, int(seed), float(seconds), trace,
                   device)

    @property
    def limits(self) -> Dict[str, float]:
        return self.workload["limits"]

    def sample(self, k: int, n: int) -> List[int]:
        """``k`` of the pool's ``n`` scenes, drawn from the seed."""
        g = torch.Generator().manual_seed(self.seed ^ 0x5EED)
        return sorted(torch.randperm(n, generator=g)[:k].tolist())


def no_tf32() -> None:
    """fp32 means fp32, as the port's CLIs set it at their start."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def batch_of(scene: Dict[str, Any], keys) -> Dict[str, Any]:
    """The scene's ``keys`` (the workload's ``batch_keys``): the model's
    batch."""
    return {k: scene[k] for k in keys}


def plant(model, holder: Dict[str, torch.Tensor]) -> None:
    """Hand the march the planted TSDF of the scene in ``holder``:
    ``model.ray_march`` (the instance's) marches ``holder['planted']``
    in place of the TSDF its head computed; the head's TSDF and its
    losses are left as they are."""
    orig = model.ray_march

    def ray_march(feats, projections, view_valid, tsdf, generator=None,
                  uniform=None):
        return orig(feats, projections, view_valid, holder["planted"],
                    generator, uniform)
    model.ray_march = ray_march


class HostCopy:
    """Pinned host buffers of a fixed structure of tensors, filled without
    a host sync (the step's own sync covers the copy)."""

    def __init__(self, tensors: List[torch.Tensor]):
        self.bufs = [torch.empty(t.shape, dtype=t.dtype, pin_memory=(
            t.is_cuda)) for t in tensors]

    def fill(self, tensors: List[torch.Tensor]) -> None:
        for b, t in zip(self.bufs, tensors):
            b.copy_(t.detach(), non_blocking=True)


def free_cuda() -> None:
    import gc
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def leaf_norms(tensors: Dict[str, torch.Tensor], scale: float = 1.0,
               names: Optional[List[str]] = None) -> Dict[str, float]:
    names = names if names is not None else list(tensors)
    vals = torch.stack([tensors[n].double().norm() for n in names])
    return dict(zip(names, (vals * scale).tolist()))

"""What the entry points share: TF32 off for the CLIs that run the model;
for the probes, the device they run on, the index check of their kernel
wrappers, and the record of one kernel at its bench shape that
``chip_smoke.py`` holds against its plain version."""

from __future__ import annotations

import argparse
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from cnrma_torch.ops._build import LaunchCounter


def no_tf32() -> None:
    """fp32 means fp32: no TF32 in cuDNN's convolutions or cuBLAS's
    matmuls (torch turns it on for cuDNN by default).  Every fp32 parity
    check and time of the port is taken so; each CLI that runs the model
    sets it at its start."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def add_device_arg(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--device", default="cuda:0",
                        help="cuda:N runs the kernels (default cuda:0); cpu "
                             "runs their plain torch versions")


def device_of(name: str) -> torch.device:
    """The device a tool runs on; a CUDA device must exist."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{name}: no CUDA device; the tool runs on the "
                           "card (pass --device cpu for the plain torch "
                           "path on the host)")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"the tools run on cuda or cpu, not {name}")
    return dev


def describe(dev: torch.device) -> str:
    if dev.type == "cuda":
        return f"{dev}: {torch.cuda.get_device_name(dev)}"
    return "cpu (plain torch versions)"


def int32_index(t: torch.Tensor, dev: torch.device, what: str
                ) -> torch.Tensor:
    """``t`` as a contiguous index tensor on ``dev``.  The kernels read
    int32 indices; a wider one is refused rather than narrowed, since an
    out-of-range value would wrap into range where the plain version gives
    0."""
    if t.dtype != torch.int32:
        raise TypeError(f"{what} must be int32, got {t.dtype}")
    return t.to(dev).contiguous()


@dataclass
class KernelCase:
    """One kernel on its probe's bench inputs: the kernel, its plain torch
    version, the one PyTorch call that computes the same function where
    there is one, the name of its ``__global__`` function, and the bytes
    and operations the function needs on these inputs (each input byte
    read once, each output byte written once)."""
    name: str
    symbol: str
    source: str
    replaces: str
    counter: LaunchCounter
    kernel: Callable[[], torch.Tensor]
    plain: Callable[[], torch.Tensor]
    library: Optional[Callable[[], torch.Tensor]]
    bytes: int
    ops: float = 0.0
    ops_type: str = "fp32"          # "fp32" or "bf16_tensor"

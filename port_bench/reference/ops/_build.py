"""The reference's stand-in for the port's kernel binding: no kernel is
built or launched here, so every dispatch takes the plain torch version,
on the CPU and on the card alike."""

from __future__ import annotations

from typing import Callable

import torch


class LaunchCounter:
    def __init__(self):
        self.launches = 0


def launch(fn: str, *args) -> None:
    raise RuntimeError(f"the reference launches no kernel ({fn})")


def dispatch(t: torch.Tensor, cuda_fn: Callable, plain_fn: Callable, *args):
    """``plain_fn(*args)`` on any device."""
    return plain_fn(*args)

"""Timing of one call, shared by ``chip_smoke.py`` and the probe tools."""

from __future__ import annotations

import statistics
import time
from typing import Callable

import torch


def time_ms(fn: Callable, dev: torch.device, reps: int = 10) -> float:
    """Median time of ``fn`` over ``reps`` runs after one warm-up: CUDA
    events on the card, the host clock on the CPU."""
    fn()
    times = []
    for _ in range(reps):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)

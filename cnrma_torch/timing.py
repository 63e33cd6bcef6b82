"""Timing of one call, shared by ``chip_smoke.py`` and the probe tools,
and the stage marks of a training step."""

from __future__ import annotations

import contextlib
import statistics
import time
from typing import Callable, Dict, Iterator, List, Optional

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


class StageMarks:
    """Named marks through a step: a CUDA event each on the card, recorded
    in stream order without a sync, the host clock on the CPU.  ``ms()``
    gives each mark's stage, the milliseconds from the mark before it."""

    def __init__(self, dev: torch.device):
        self.cuda = dev.type == "cuda"
        self.marks: List = []

    def __call__(self, name: str) -> None:
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self.marks.append((name, e))
        else:
            self.marks.append((name, time.perf_counter()))

    def ms(self) -> Dict[str, float]:
        if self.cuda and self.marks:
            self.marks[-1][1].synchronize()
        out: Dict[str, float] = {}
        for (_, a), (name, b) in zip(self.marks, self.marks[1:]):
            out[name] = out.get(name, 0.0) + (
                a.elapsed_time(b) if self.cuda else (b - a) * 1e3)
        return out


_active: Optional[StageMarks] = None


def mark(name: str) -> None:
    """Ends the stage ``name`` of the step that ``stage_marks`` times; does
    nothing outside one."""
    if _active is not None:
        _active(name)


@contextlib.contextmanager
def stage_marks(dev: torch.device) -> Iterator[StageMarks]:
    """Times the stages that ``mark`` ends inside the block, from a first
    mark at its start."""
    global _active
    marks = StageMarks(dev)
    marks("start")
    _active = marks
    try:
        yield marks
    finally:
        _active = None

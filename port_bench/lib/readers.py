"""The arithmetic that the per-layer readers share."""

from __future__ import annotations

import statistics
from typing import Optional

from port_bench.lib.device import PEAK


def stage_ms(run, name: str) -> Optional[float]:
    """The window's total of one stage mark over its items, per item."""
    if run.n == 0 or name not in run.marks:
        return None
    return run.marks[name] / run.n


def mfu_pct(run, peak: str = "fp32") -> Optional[float]:
    """Model FLOPs of the window's items over its time, against the peak
    of the configuration's precision."""
    flops = run.work.get("flops")
    if not flops or run.window_s <= 0:
        return None
    return 100.0 * flops / run.window_s / PEAK[peak]


def roofline_pct(run, kernel: str) -> Optional[float]:
    """The kernel's least time over its device time in the trace, summed
    over its launches (one an item: the bound scales to the launches the
    trace holds)."""
    bound = run.work.get(kernel)
    if run.trace is None or not bound or run.n == 0:
        return None
    seconds, launches = run.trace.kernel_s(kernel)
    if launches == 0 or seconds <= 0:
        return None
    return 100.0 * bound * launches / run.n / seconds


def idle_pct(run) -> Optional[float]:
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)


def p80_ms(run) -> Optional[float]:
    if len(run.item_times) < 5:
        return None
    return 1e3 * statistics.quantiles(run.item_times, n=5)[3]

"""The card: its check, its peaks, and the reading of a profiler trace.

Peaks are the H100 SXM data sheet's (dense, 700 W): HBM 3.35 TB/s, fp32
outside the tensor cores 67 TFLOP/s, TF32 495, bf16 989.  A run states
the card's name and power limit beside them in its log.
"""

from __future__ import annotations

import re
import subprocess
from typing import Dict, List, Optional, Tuple

import torch

PEAK = {"bytes": 3.35e12, "fp32": 67e12, "tf32": 495e12,
        "bf16_tensor": 989e12}


def require_cards(n: int) -> torch.device:
    """The first card, or SystemExit where fewer than ``n`` are there."""
    if not torch.cuda.is_available():
        raise SystemExit("port_bench: no CUDA device "
                         "(torch.cuda.is_available() is False)")
    if torch.cuda.device_count() < n:
        raise SystemExit(f"port_bench: the cell needs {n} cards, "
                         f"{torch.cuda.device_count()} found")
    return torch.device("cuda", 0)


def power_limit() -> str:
    """``nvidia-smi``'s name and power limit of the card, or what failed."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout else \
            out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi not read ({e})"


def bound_s(nbytes: float, ops: float, ops_type: str = "fp32") -> float:
    """Least time the card could take: bytes over the memory rate or
    operations over the peak of their type, whichever is larger."""
    return max(nbytes / PEAK["bytes"], ops / PEAK[ops_type])


class Trace:
    """What the harness reads from one ``torch.profiler`` trace of the
    window, taken from the profiler's raw events (building its event tree
    would take minutes for a window): the device operations' intervals
    and names, and the host operations for naming the idle gaps."""

    def __init__(self, prof, window_s: float):
        import numpy as np
        from torch.autograd import DeviceType
        self.device: List[Tuple[float, float, str]] = []
        host_s, host_t, self._host = [], [], []
        for e in prof.profiler.kineto_results.events():
            kind = e.device_type()
            if kind == DeviceType.CUDA:
                if not e.is_user_annotation():
                    s = e.start_ns() / 1e3
                    self.device.append((s, s + e.duration_ns() / 1e3,
                                        e.name()))
            elif kind == DeviceType.CPU:
                s = e.start_ns() / 1e3
                host_s.append(s)
                host_t.append(s + e.duration_ns() / 1e3)
                self._host.append(e)
        self.device.sort()
        self._host_s = np.asarray(host_s)
        self._host_t = np.asarray(host_t)
        lo = min((s for s, _, _ in self.device), default=0.0)
        hi = max((t for _, t, _ in self.device), default=0.0)
        # the traced window: from the first to the last device operation,
        # or the harness's own clock where that is longer
        self.window_s = max((hi - lo) / 1e6, window_s)

    def busy_s(self) -> float:
        """Seconds in which some device operation ran: the union of
        their intervals."""
        busy, end = 0.0, None
        for s, t, _ in self.device:
            if end is None or s > end:
                busy += t - s
                end = t
            elif t > end:
                busy += t - end
                end = t
        return busy / 1e6

    def kernel_s(self, pattern: str) -> Tuple[float, int]:
        """Total device seconds and launches of the operations whose name
        holds ``pattern`` as a whole word (a ``__global__`` function)."""
        named = re.compile(rf"\b{pattern}\b")
        hits = [t - s for s, t, n in self.device if named.search(n)]
        return sum(hits) / 1e6, len(hits)

    def top_ops(self, k: int = 10) -> List[List]:
        by: Dict[str, float] = {}
        for s, t, n in self.device:
            by[n] = by.get(n, 0.0) + (t - s) / 1e6
        return [[n[:120], v] for n, v in
                sorted(by.items(), key=lambda x: -x[1])[:k]]

    def idle_gaps(self, k: int = 10) -> List[List]:
        """The ``k`` longest gaps between device operations, each named
        by the innermost host operation running at its middle."""
        import numpy as np
        gaps, end = [], None
        for s, t, _ in self.device:
            if end is not None and s > end:
                gaps.append((s - end, end, s))
            end = t if end is None else max(end, t)
        gaps.sort(reverse=True)
        out = []
        for length, a, b in gaps[:k]:
            mid = (a + b) / 2
            hit = np.nonzero((self._host_s <= mid) & (self._host_t >= mid))[0]
            if len(hit):
                inner = hit[np.argmin(self._host_t[hit] - self._host_s[hit])]
                name = self._host[inner].name()
            else:
                name = "no host operation"
            out.append([name[:120], length / 1e6])
        return out


def device_report(dev: torch.device, peak_bytes: int,
                  trace: Optional[Trace]) -> dict:
    rep = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
           "count": 1, "memory_peak_bytes": int(peak_bytes)}
    if trace is not None:
        rep["busy_s"] = trace.busy_s()
        rep["window_s"] = trace.window_s
    return rep

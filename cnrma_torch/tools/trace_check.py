"""Profiler trace check: how often a ``torch.profiler`` trace of a short
kernel comes back with no device activity, and how far apart the device
and host clocks of the trace sit.

``chip_smoke.py`` takes each kernel's device time (``device_ms``) from a
profiler trace of 10 calls.  Now and then such a trace holds the host's
launch events but no device event at all.  This tool takes traces of the
seven feature-probe kernels back to back for 60 s and prints, for each
trace that came back without device events, its time and the traces
around it, then a summary: traces taken, traces empty, and the spread of
(first kernel start - first launch start) over the other traces, which
is negative only where the two clocks disagree.

    python -m cnrma_torch.tools.trace_check       # needs a CUDA device
"""

from __future__ import annotations

import argparse
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from cnrma_torch.tools import feature_probe
from cnrma_torch.tools._common import describe, device_of

SECONDS = 60
CALLS = 10                # calls per trace, as chip_smoke's device_ms


def trace(fn):
    """One trace of ``CALLS`` calls: (device events, launch events,
    first kernel start - first launch start in us or None, host ms)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    launches = [e for e in events if "LaunchKernel" in e.name]
    offset = None
    if kernels and launches:
        offset = (min(e.time_range.start for e in kernels)
                  - min(e.time_range.start for e in launches))
    return len(kernels), len(launches), offset, host_ms


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m cnrma_torch.tools.trace_check",
        description=f"Profiler traces of the feature-probe kernels for "
                    f"{SECONDS} s: how many hold no device events.")
    ap.parse_args(argv)
    dev = device_of("cuda:0")
    print(f"device: {describe(dev)}", flush=True)
    cases = feature_probe.bench_cases(dev)
    t_start = time.perf_counter()
    rows = []
    while time.perf_counter() - t_start < SECONDS:
        for c in cases:
            rows.append((time.perf_counter() - t_start, c.name, *trace(
                c.kernel)))
    for i, row in enumerate(rows):
        if row[2] == 0:
            print("-- no device events:", flush=True)
            for r in rows[max(0, i - 2):i + 3]:
                print("  %.2f s %-16s device %2d launches %2d kernel - "
                      "launch %s us, host %.1f ms" % (
                          r[0], r[1], r[2], r[3],
                          "-" if r[4] is None else f"{r[4]:.1f}", r[5]),
                      flush=True)
    offsets = sorted(r[4] for r in rows if r[4] is not None)
    empty = [r for r in rows if r[2] == 0]
    host = sorted(r[5] for r in rows)
    print(f"traces {len(rows)}, without device events {len(empty)} (at "
          f"{', '.join(f'{r[0]:.1f}' for r in empty)} s); kernel - launch "
          f"min {offsets[0]:.1f} median {offsets[len(offsets) // 2]:.1f} "
          f"max {offsets[-1]:.1f} us; host ms per trace median "
          f"{host[len(host) // 2]:.1f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

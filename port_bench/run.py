#!/usr/bin/env python3
"""The port's benchmark: one cell a run.

    python3 port_bench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

The cell's files (``workloads/<name>.json`` and the configuration,
traffic mix and metric readers it names) say what runs; this file only
sets up, times the window, reads the trace, runs the check and prints.
A run needs the card; the last line of standard output is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` ``breakdown``, and ``checks`` last).
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
if REPO not in sys.path:
    sys.path.insert(0, REPO)
# every build and kernel cache inside the checkout, at fixed paths: the
# port's kernels build into build/cnrma_torch_kernels/ on their own
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton")):
    os.environ[_var] = os.path.join(REPO, "build", _sub)

import torch  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "cnrma_tpu")


def log(msg: str) -> None:
    print(f"[port_bench] {msg}", file=sys.stderr, flush=True)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Run:
    """What a per-layer reader reads: the traced window's items, their
    host times, the stage marks' totals, the trace and the work."""

    def __init__(self, cell, items, item_times, window_s, marks, trace,
                 work):
        self.cell, self.items, self.item_times = cell, items, item_times
        self.window_s, self.marks, self.trace = window_s, marks, trace
        self.work = work
        self.n = len(items)


def read_metric(name: str, run: Run):
    mod = importlib.import_module(
        "port_bench.metrics." + name.replace(".", "_"))
    return mod.UNIT, mod.read(run)


def end_to_end(name: str, n: int, window_s: float, peak: int,
               setup_s: float):
    if name == "setup_s":
        return "s", setup_s
    if name == "peak_mem_gib":
        return "GiB", peak / 2 ** 30
    if name.endswith("_per_s"):
        return "scenes/s", n / window_s
    raise KeyError(f"no end-to-end metric {name!r}")


def main(argv=None, device=None) -> dict:
    """One run; ``device`` (the tests' CPU) skips the look for a card."""
    from cnrma_torch.timing import stage_marks
    from port_bench.lib import device as dv
    from port_bench.lib import compare, harness

    args = parse_args(argv)
    if not os.path.isfile(os.path.join(HERE, "workloads",
                                       f"{args.workload}.json")):
        raise SystemExit(f"unknown workload {args.workload!r}")
    chips = harness.load_json(HERE, "workloads",
                              f"{args.workload}.json")["chips"]
    dev = device if device is not None else dv.require_cards(int(chips))
    if dev.type == "cuda":
        print(f"[card] {dv.power_limit()}; torch {torch.__version__}",
              flush=True)
    harness.no_tf32()
    torch.set_num_threads(min(4, torch.get_num_threads()))
    cell = harness.Cell.load(args.workload, args.seed, args.seconds,
                             bool(args.trace), dev)
    entry = importlib.import_module(
        f"port_bench.entries.{cell.workload['entry']}").Entry(cell)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - T0
    log(f"set-up {setup_s:.3f} s")

    prof = None
    if args.trace:
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CPU]
                       + ([ProfilerActivity.CUDA] if cuda else []))
        prof.__enter__()
    items, times, marks = [], [], {}
    i = entry.first_index
    start = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        if args.trace:
            with stage_marks(dev) as sm:
                items.append(entry.step(i))
            for k, v in sm.ms().items():
                marks[k] = marks.get(k, 0.0) + v
        else:
            items.append(entry.step(i))
        t1 = time.perf_counter()
        times.append(t1 - t0)
        i += 1
        if t1 - start >= args.seconds:
            break
    window_s = t1 - start
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    trace = None
    if prof is not None:
        t_trace = time.perf_counter()
        prof.__exit__(None, None, None)
        log(f"trace closed {time.perf_counter() - t_trace:.3f} s")
        trace = dv.Trace(prof, window_s) if cuda else None
        del prof
        log(f"trace read {time.perf_counter() - t_trace:.3f} s")

    metrics = {}
    for name in cell.workload["end_to_end"]:
        unit, value = end_to_end(name, len(items), window_s, peak, setup_s)
        metrics[name] = {"value": value, "unit": unit}
    entry.free()
    harness.free_cuda()
    t_judge = time.perf_counter()
    numbers = entry.judge()
    log(f"check {time.perf_counter() - t_judge:.3f} s")
    correct, rows = compare.verdict(numbers, cell.limits)
    result = {"correct": bool(correct), "attempted": len(items),
              "failed": 0}
    if args.trace:
        harness.free_cuda()
        t_work = time.perf_counter()
        run = Run(cell, items, times, window_s, marks, trace,
                  entry.work(items))
        log(f"work counted {time.perf_counter() - t_work:.3f} s")
        metrics = {}
        for name in cell.workload["per_layer"]:
            unit, value = read_metric(name, run)
            if value is not None:
                metrics[name] = {"value": value, "unit": unit}
    result["metrics"] = metrics
    result["device"] = (dv.device_report(dev, peak, trace) if cuda else
                        {"platform": "cpu", "kind": "cpu", "count": 0,
                         "memory_peak_bytes": 0})
    if trace is not None:
        result["breakdown"] = {"device_ops": trace.top_ops(),
                               "idle_gaps": trace.idle_gaps()}
    result["checks"] = {name: {"value": v, "limit": lim}
                        for name, v, lim in rows}
    bad = forbidden_modules()
    if bad:
        print(f"port_bench: the run loaded {bad}", file=sys.stderr)
        raise SystemExit(3)
    for name, v, lim in rows:
        print(f"check {name} {v!r} limit {lim!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()

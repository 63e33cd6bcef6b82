#!/usr/bin/env python3
"""The readings that a cell's limits are set from, at the cell's own size
on the card, many seeds in one process:

    python3 port_bench/calibrate.py --workload <name> --seeds 1 2 3 \
        [--control-seeds 1 2 3] [--out calib.jsonl]

For each seed the program's numbers (its set-up drives the timed path:
the test forward's sampled scenes, a training cell's first three steps)
against the reference; for each control seed the control's: the
reference itself with TF32 on in cuDNN and cuBLAS, the nearest precision
below the configuration's fp32, judged by the same numbers against the
fp32 reference.  One JSON line a reading.  The benchmark's runs do not
run this.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import torch  # noqa: E402


def tf32(on: bool) -> None:
    torch.backends.cudnn.allow_tf32 = on
    torch.backends.cuda.matmul.allow_tf32 = on


def control_numbers(entry, cell) -> dict:
    """The control's numbers: the reference in TF32 in the program's
    place."""
    from port_bench.lib import harness
    if cell.workload["entry"] == "train_step":
        tf32(True)
        got = entry.reference_steps()
        tf32(False)
        harness.free_cuda()
        want = entry.reference_steps()
        return entry.details(got, want)
    numbers = {}
    for s in entry.sampled:
        tf32(True)
        ref, holder = entry.reference()
        got = entry.reference_outputs(ref, holder, s)
        got = {k: ([[t.cpu() for t in lv] for lv in v] if k == "levels"
                   else [t.cpu() for t in v] if isinstance(v, list)
                   else v.cpu()) for k, v in got.items()}
        del ref
        tf32(False)
        harness.free_cuda()
        ref, holder = entry.reference()
        for k, v in entry.judge_scene(ref, holder, s, got).items():
            numbers[k] = max(numbers.get(k, 0.0), v)
        del ref
        harness.free_cuda()
    return numbers


def main(argv=None, device=None):
    import importlib
    from port_bench.lib import device as dv
    from port_bench.lib import harness
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[],
                   help="of --seeds, those that also read the control")
    p.add_argument("--repeat-seeds", type=int, nargs="*", default=[],
                   help="of --seeds, those whose training steps run twice")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    dev = device if device is not None else dv.require_cards(1)
    if dev.type == "cuda":
        print(f"[card] {dv.power_limit()}", flush=True)
    rows = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        tf32(False)
        cell = harness.Cell.load(args.workload, seed, 0, False, dev)
        entry = importlib.import_module(
            f"port_bench.entries.{cell.workload['entry']}").Entry(cell)
        entry.free()
        harness.free_cuda()
        if cell.workload["entry"] == "train_step":
            def program(entry=entry):
                return entry.details(entry.readings(),
                                     entry.reference_steps())
            kinds = [("program", program)]
        else:
            kinds = [("program", entry.judge)]
        if seed in args.repeat_seeds and cell.workload["entry"] == \
                "train_step":
            def again(entry=entry, cell=cell):
                # the program once more from the same seed, against its
                # first run: how far the program is from itself
                second = type(entry)(cell)
                second.free()
                harness.free_cuda()
                return entry.details(second.readings(), entry.readings())
            kinds.append(("program_again", again))
        if seed in args.control_seeds:
            kinds.append(("control", lambda: control_numbers(entry, cell)))
        for kind, fn in kinds:
            harness.free_cuda()
            row = {"workload": args.workload, "kind": kind, "seed": seed,
                   "numbers": fn(), "seconds": time.perf_counter() - t0}
            print(json.dumps(row), flush=True)
            rows.append(row)
        del entry
        harness.free_cuda()
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "a") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")
    return rows


if __name__ == "__main__":
    main()

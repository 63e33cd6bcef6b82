"""Forward and ray-march stage times of the full_ship scene on the card, for
one checkout or for two checkouts in turns.

    python cnrma_torch/tools/stage_times.py [--root DIR] [--runs N] [--profile]
    python cnrma_torch/tools/stage_times.py --compare OTHER_DIR [--rounds R]

One run imports ``cnrma_torch`` from ``--root`` (default: the checkout
holding this file) and takes the full_ship model, scene and stage timing
from this checkout's ``chip_smoke.py`` (bf16, bench.py's synthesized
parameters, one scene of 50 views), so every checkout is measured the same
way; it prints one JSON line:

- ``forward_ms``: the whole forward, host clock around a synchronised call,
  ``--runs`` runs after one warm-up;
- ``stage_ms``: ``CNRMA.ray_march`` alone on that forward's features and
  fine TSDF (median of ``--runs``, CUDA events);
- ``ball_stage_ms``: the same stage on a planted 0.5 m ball TSDF, where
  500,000 points come out;
- ``peak_gib``: peak device memory of the forward.

With ``--profile``, last (a profiler session slows later launches), one
``torch.profiler`` trace of the ball's stage adds ``ball_stage_ops``: its
device kernels' summed time and count and the ten largest, in ms.

``--compare`` runs ``OTHER_DIR`` and this checkout in separate processes,
``R`` rounds of (other, this, this, other), so both meet the same card and
host load, and prints each run's line, then the medians of each side.
Needs a CUDA device; each checkout builds its own kernels into its own
``build/``.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]


def top_device_ops(fn, n: int = 10) -> dict:
    """One call of ``fn`` in a profiler trace: its device kernels' summed
    time and count, and the ``n`` largest kernels by device time (names
    cut at 60 characters), in ms."""
    import collections

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name = collections.Counter()
    kernels = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
            name = e.name.replace("(anonymous namespace)::", "")
            by_name[name.split("(")[0][:60]] += e.self_device_time_total / 1e3
            kernels += 1
    return dict(device_ms=sum(by_name.values()), kernels=kernels,
                top=dict(by_name.most_common(n)))


def _chip_smoke():
    """This checkout's ``chip_smoke.py``; its lazy imports of
    ``cnrma_torch`` resolve through ``sys.path``, so to ``--root``."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def run_one(root: Path, runs: int, profile_ops: bool = False) -> dict:
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("stage_times: needs a CUDA device")
    cs = _chip_smoke()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    model = cs.full_ship_model(dev)
    batch = cs.full_ship_batch(dev)

    def gen():
        return torch.Generator(device=dev).manual_seed(0)

    with torch.no_grad():
        model(batch, generator=gen())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        forward_ms = []
        for _ in range(runs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model(batch, generator=gen())
            torch.cuda.synchronize()
            forward_ms.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        feats, fine = cs.features_and_fine_tsdf(model, batch)
        ball = cs.planted_ball(dev)[None]
        stage = {name: cs.time_ray_stage(dev, model, batch, feats, tsdf,
                                         reps=runs)
                 for name, tsdf in (("stage_ms", fine),
                                    ("ball_stage_ms", ball))}
        points = int(model.ray_march(feats, batch["projection"],
                                     batch["view_valid"], ball,
                                     gen()).valid.sum())
        if profile_ops:
            stage["ball_stage_ops"] = top_device_ops(lambda: model.ray_march(
                feats, batch["projection"], batch["view_valid"], ball,
                gen()))
    return dict(root=str(root), device=torch.cuda.get_device_name(0),
                forward_ms=forward_ms,
                forward_median_ms=statistics.median(forward_ms), **stage,
                ball_points=points, peak_gib=peak)


def compare(other: Path, rounds: int, runs: int) -> None:
    order = [other, HERE, HERE, other] * rounds
    results = {str(other): [], str(HERE): []}
    for root in order:
        out = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--root",
             str(root), "--runs", str(runs)], cwd=root, check=True,
            capture_output=True, text=True).stdout.strip().splitlines()[-1]
        print(out, flush=True)
        results[str(root)].append(json.loads(out))
    summary = {}
    for root, rows in results.items():
        summary[root] = {k: statistics.median(r[k] for r in rows)
                         for k in ("forward_median_ms", "stage_ms",
                                   "ball_stage_ms", "peak_gib")}
    print(json.dumps({"medians": summary}), flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", type=Path, default=HERE)
    parser.add_argument("--runs", type=int, default=5)
    parser.add_argument("--compare", type=Path, default=None,
                        help="another checkout, timed in turns with this one")
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("--profile", action="store_true",
                        help="add the ball stage's largest device ops")
    args = parser.parse_args(argv)
    if args.compare is not None:
        compare(args.compare.resolve(), args.rounds, args.runs)
    else:
        print(json.dumps(run_one(args.root.resolve(), args.runs,
                                 args.profile)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

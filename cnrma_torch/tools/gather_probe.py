"""Table gather probe (P2): port of ``tools/pallas_gather_probe.py``.

The TPU probe times gathers from a resident table at the shape of the ray
march's fine TSDF window lookup (``cnrma_torch/ops/ray_marching.py``,
``_sample_tsdf``): a 192x192x80 fp32 table (2,949,120 elements, 23,040
rows of 128) and 5,760,000 queries (19,200 rays x 300 samples).  Its two
Pallas kernels are the hand-written CUDA kernels of ``csrc/gather_probe.cu``
here, on a CUDA tensor; on a CPU tensor their plain versions run:

    lane_gather   (was pl_lane_true)   out[i, j] = T[idx[i, j], j]
    flat_gather   (was pl_lane_bcast)  out[q] = T.ravel()[idx[q]]

``flat_gather`` returns the ``[NQ]`` vector; the TPU kernel replicated each
result over 128 lanes, which was its layout.  The other candidates are the
plain torch calls that the probe's XLA candidates were, timed alike:

    take_flat     (was xla_flat)       torch.take on the flat table
    row128        (was xla_row128)     row gather, a 128-lane row per query
    row_sel       (was xla_row_sel)    row gather + lane select
    topk20        per-ray top-20 of [19200, 300]
    compact384k   cumsum + scatter compaction of 384,000 flags

The original's name list also holds ``pl_row``, which it never implemented;
it is left out.

    python -m cnrma_torch.tools.gather_probe [name ...] [--device cpu]
        [--rows 23040] [--rays 19200]

Each line gives the time (median of 5 runs after a warm-up, as the
original: CUDA events on the card, the host clock on the CPU) and the rate in elements of that candidate's
output; the two kernels are also held against the probe's numpy
references.  The exit code is 1 if any candidate failed or mismatched.
"""

from __future__ import annotations

import argparse
import sys
import traceback
from typing import List

import numpy as np
import torch

from cnrma_torch.ops import _build
from cnrma_torch.timing import time_ms
from cnrma_torch.tools._common import (KernelCase, add_device_arg, describe,
                                       device_of, int32_index)

HW = 120 * 160                    # rays per view (stride-4 pixels)
NS = 300                          # samples per ray
LANES = 128
TABLE = 192 * 192 * 80            # train-scale TSDF elements
ROWS = TABLE // LANES             # 23,040
NAMES = ("take_flat", "row128", "row_sel", "lane_gather", "flat_gather",
         "topk20", "compact384k")
REPS = 5

LANE_GATHER = _build.LaunchCounter()
FLAT_GATHER = _build.LaunchCounter()


def lane_gather_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain torch version of the lane gather kernel:
    ``out[i, j] = table[idx[i, j], j]``, 0 where idx is outside the
    table."""
    ok = (idx >= 0) & (idx < table.shape[0])
    out = torch.gather(table, 0, torch.where(ok, idx, 0).long())
    return out.masked_fill(~ok, 0.0)


def lane_gather_cuda(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The ``cnrma_lane_gather`` kernel; same contract as
    ``lane_gather_plain``."""
    if table.dtype != torch.float32 or table.dim() != 2:
        raise TypeError("table must be a 2-D fp32 tensor")
    if idx.dim() != 2 or idx.shape[1] != table.shape[1]:
        raise ValueError(f"idx must be [n, {table.shape[1]}], got "
                         f"{tuple(idx.shape)}")
    dev = table.device
    table = table.contiguous()
    idx = int32_index(idx, dev, "idx")
    out = torch.empty(idx.shape, dtype=torch.float32, device=dev)
    _build.launch("cnrma_lane_gather", LANE_GATHER, dev, table.data_ptr(),
                  idx.data_ptr(), out.data_ptr(), table.shape[0],
                  table.shape[1], idx.shape[0])
    return out


def lane_gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The kernel for a CUDA table, the plain version for a CPU one."""
    return _build.dispatch(table, lane_gather_cuda, lane_gather_plain,
                           table, idx)


def flat_gather_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain torch version of the flat gather kernel:
    ``out[q] = table.ravel()[idx[q]]``, 0 where idx is outside the table."""
    flat = table.reshape(-1)
    ok = (idx >= 0) & (idx < flat.numel())
    return flat[torch.where(ok, idx, 0).long()].masked_fill(~ok, 0.0)


def flat_gather_cuda(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The ``cnrma_flat_gather`` kernel; same contract as
    ``flat_gather_plain``."""
    if table.dtype != torch.float32:
        raise TypeError("table must be fp32")
    if table.numel() >= 2 ** 31 or idx.dim() != 1:
        raise ValueError("the kernel takes a table of < 2**31 elements and "
                         "a 1-D idx")
    dev = table.device
    table = table.contiguous()
    idx = int32_index(idx, dev, "idx")
    out = torch.empty(idx.shape, dtype=torch.float32, device=dev)
    _build.launch("cnrma_flat_gather", FLAT_GATHER, dev, table.data_ptr(),
                  idx.data_ptr(), out.data_ptr(), table.numel(), idx.numel())
    return out


def flat_gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The kernel for a CUDA table, the plain version for a CPU one."""
    return _build.dispatch(table, flat_gather_cuda, flat_gather_plain,
                           table, idx)


def tables(rng, dev, rows: int, n_queries: int):
    """The probe's table (flat and [rows, 128]) and flat queries, drawn in
    the original's order."""
    flat = torch.from_numpy(rng.rand(rows * LANES).astype(np.float32)).to(dev)
    idx = torch.from_numpy(rng.randint(0, rows * LANES, size=n_queries)
                           .astype(np.int32)).to(dev)
    return flat, flat.reshape(rows, LANES), idx


def lane_indices(rng, dev, rows: int) -> torch.Tensor:
    """``lane_gather``'s indices: one table-shaped [rows, 128] draw."""
    return torch.from_numpy(rng.randint(0, rows, size=(rows, LANES))
                            .astype(np.int32)).to(dev)


def bench_cases(dev: torch.device) -> List[KernelCase]:
    """Both kernels on the probe's inputs, with the bytes their functions
    need: indices, results, and the table elements the indices reach."""
    rng = np.random.RandomState(0)
    flat, table2d, idx = tables(rng, dev, ROWS, HW * NS)
    idx2d = lane_indices(rng, dev, ROWS)
    lanes = torch.arange(LANES, device=dev, dtype=torch.int64)
    lane_reached = torch.unique(idx2d.long() * LANES + lanes).numel()
    flat_reached = torch.unique(idx).numel()
    idx2d_64, idx_64 = idx2d.long(), idx.long()
    return [
        KernelCase(
            name="lane_gather", symbol="lane_gather_kernel",
            source="cnrma_torch/csrc/gather_probe.cu",
            replaces="tools/pallas_gather_probe.py:103", counter=LANE_GATHER,
            kernel=lambda: lane_gather_cuda(table2d, idx2d),
            plain=lambda: lane_gather_plain(table2d, idx2d),
            library=lambda: torch.gather(table2d, 0, idx2d_64),
            bytes=4 * (2 * idx2d.numel() + lane_reached)),
        KernelCase(
            name="flat_gather", symbol="flat_gather_kernel",
            source="cnrma_torch/csrc/gather_probe.cu",
            replaces="tools/pallas_gather_probe.py:143", counter=FLAT_GATHER,
            kernel=lambda: flat_gather_cuda(flat, idx),
            plain=lambda: flat_gather_plain(flat, idx),
            library=lambda: torch.take(flat, idx_64),
            bytes=4 * (2 * idx.numel() + flat_reached)),
    ]


def _compact(mask: torch.Tensor, cap: int) -> torch.Tensor:
    """Indices of the first ``cap`` set flags, -1 in empty slots."""
    n = mask.numel()
    pos = torch.cumsum(mask.int(), 0) - 1
    slot = torch.where(mask & (pos < cap), pos, cap).long()
    buf = torch.full((cap + 1,), -1, dtype=torch.int64, device=mask.device)
    buf.scatter_(0, slot, torch.arange(n, device=mask.device))
    return buf[:cap]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m cnrma_torch.tools.gather_probe",
        description="Table gathers at the ray march's fine-window shape.")
    ap.add_argument("names", nargs="*", metavar="name",
                    help=f"candidates to run (default all): {NAMES}")
    add_device_arg(ap)
    ap.add_argument("--rows", type=int, default=ROWS,
                    help="table rows of 128 fp32 (default 23040)")
    ap.add_argument("--rays", type=int, default=HW,
                    help=f"rays of {NS} samples each (default 19200)")
    args = ap.parse_args(argv)
    names = args.names or list(NAMES)
    unknown = sorted(set(names) - set(NAMES))
    if unknown:
        ap.error(f"unknown candidates {unknown}; choose from {NAMES}")
    dev = device_of(args.device)
    print(f"device: {describe(dev)}", flush=True)

    rng = np.random.RandomState(0)
    rows, nq = args.rows, args.rays * NS
    flat, table2d, idx = tables(rng, dev, rows, nq)
    hi, lo = idx // LANES, idx % LANES
    failed = False

    def attempt(name, build):
        """Run one candidate: ``build()`` gives (fn, elements, check)."""
        nonlocal failed
        if name not in names:
            return
        try:
            fn, n, check = build()
            dt = time_ms(fn, dev, REPS)
            print(f"{name:14s} {dt:9.3f} ms  {n / dt / 1e6:6.2f} Gelem/s",
                  flush=True)
            if check is not None:
                match = bool(np.array_equal(fn().cpu().numpy(), check()))
                print(f"  match: {match}", flush=True)
                failed |= not match
        except Exception as e:    # report it, go on to the next candidate
            traceback.print_exc()
            print(f"{name:14s} FAIL {type(e).__name__}: {str(e)[:300]}",
                  flush=True)
            failed = True

    def take_flat():
        idx_64 = idx.long()             # torch.take takes int64 indices
        return lambda: torch.take(flat, idx_64), nq, None
    attempt("take_flat", take_flat)
    attempt("row128", lambda: (
        lambda: torch.index_select(table2d, 0, hi), nq * LANES, None))
    attempt("row_sel", lambda: (
        lambda: torch.gather(torch.index_select(table2d, 0, hi), 1,
                             lo[:, None].long())[:, 0], nq, None))

    def lane():
        idx2d = lane_indices(rng, dev, rows)
        t_np, i_np = table2d.cpu().numpy(), idx2d.cpu().numpy()
        return (lambda: lane_gather(table2d, idx2d), rows * LANES,
                lambda: t_np[i_np, np.arange(LANES)[None, :]])
    attempt("lane_gather", lane)
    attempt("flat_gather", lambda: (
        lambda: flat_gather(flat, idx), nq,
        lambda: flat.cpu().numpy()[idx.cpu().numpy()]))

    def topk20():
        w = torch.from_numpy(rng.rand(args.rays, NS).astype(np.float32)
                             ).to(dev)
        return lambda: torch.topk(w, 20), nq, None
    attempt("topk20", topk20)

    def compact384k():
        n = args.rays * 20
        m = torch.from_numpy(rng.rand(n) > 0.9).to(dev)
        return lambda: _compact(m, 32768), n, None
    attempt("compact384k", compact384k)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())

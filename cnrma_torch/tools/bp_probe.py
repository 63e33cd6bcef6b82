"""Rect gather probe (P1): port of ``tools/pallas_bp_probe.py``.

The TPU probe prototypes and times the Pallas rect gather of the volume
stage (``cnrma_tpu/ops/pallas_bp.py:rect_gather``).  Its input is one
view's feature map packed as ``featq [Hq, W, 4*C]`` (four image rows share
the last axis) and, per tile ``k``, a rect of ``Rhq x Rw`` packed pixels at
``(ryq0[k], rx0[k])``.  ``code[k, v]`` names one pixel of the rect
(``p = code >> 2``, row-major) and its row phase (``ym = code & 3``).  The
output is ``[K1, C, t3]``, channel-major, and 0 where ``p`` falls outside
the rect.

On a CUDA tensor the gather is the kernel ``csrc/rect_gather_probe.cu``; on
a CPU tensor it is ``rect_gather_plain``.  The TPU kernel's one-hot MXU
product, its 16-column rect alignment and its tiles per grid step (``TB``)
are Mosaic's needs and are not ported: ``rx0`` may be any column.

    python -m cnrma_torch.tools.bp_probe check   # vs the numpy oracle
    python -m cnrma_torch.tools.bp_probe bench   # timing at the full shape
    ... --device cpu                             # the plain version

``bench`` takes the original's ``RHQ``, ``RW`` and ``K1`` as ``--rhq``,
``--rw`` and ``--k1`` (defaults 16, 64, 6144) and also times the probe's
own baseline, a ``K1*t3``-row gather, as ``torch.index_select``.  No single
torch call computes the rect gather itself.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Tuple

import numpy as np
import torch

from cnrma_torch.ops import _build
from cnrma_torch.timing import time_ms
from cnrma_torch.tools._common import (KernelCase, add_device_arg, describe,
                                       device_of, int32_index)

PACK = 4          # image rows sharing the last axis of featq
XALIGN = 16       # the TPU probe's rect x-start alignment (its draws only)
C = 32            # channels: the probe's and the model's
CHECK_SHAPE = dict(Hq=16, W=48, Rhq=8, Rw=16, C=C, t3=64, K1=8)
# full ScanNet view: 120x160x32 stride-4 features, 256x256x96 grid
BENCH_SHAPE = dict(Hq=30, W=160, Rhq=16, Rw=64, C=C, t3=512, K1=6144)
REPS = 10         # timed runs after one warm-up, as the original

RECT_GATHER = _build.LaunchCounter()


def ref_gather(featq, ryq0, rx0, code, Rhq, Rw, C, t3):
    """Numpy oracle of the TPU probe: exactly what the kernel must
    produce."""
    K1 = ryq0.shape[0]
    out = np.zeros((K1, C, t3), np.float32)
    rp = Rhq * Rw
    for k in range(K1):
        rect = featq[ryq0[k]:ryq0[k] + Rhq, rx0[k]:rx0[k] + Rw, :]
        rect = rect.reshape(rp, PACK * C).astype(np.float32)
        for v in range(t3):
            pcv = code[k, v]
            p, ym = pcv >> 2, pcv & 3
            if 0 <= p < rp:
                out[k, :, v] = rect[p, ym * C:(ym + 1) * C]
    return out


def synth(rng, Hq, W, Rhq, Rw, C, t3, K1, xalign=XALIGN):
    """The probe's random inputs as numpy arrays (featq in fp32): with the
    default ``xalign``, the TPU probe's own draws; ``xalign=1`` puts rects
    at any column.  About 30% of the codes are invalid."""
    featq = rng.randn(Hq, W, PACK * C).astype(np.float32)
    ryq0 = rng.randint(0, Hq - Rhq + 1, K1).astype(np.int32)
    rx0 = (rng.randint(0, (W - Rw) // xalign + 1, K1)
           * xalign).astype(np.int32)
    rp = Rhq * Rw
    code = rng.randint(0, rp * PACK, (K1, t3)).astype(np.int32)
    inv = rng.rand(K1, t3) < 0.3       # invalid -> zero columns
    code[inv] = rp * PACK
    return featq, ryq0, rx0, code


def to_device(dev, featq, ryq0, rx0, code):
    """``synth``'s arrays as tensors on ``dev``, featq in bf16."""
    return (torch.from_numpy(featq).to(dev, torch.bfloat16),
            *(torch.from_numpy(a).to(dev) for a in (ryq0, rx0, code)))


def source_rows(featq_shape, ryq0, rx0, code, Rhq: int, Rw: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per (k, v): the row of ``featq.reshape(-1, C)`` that the code names
    (0 where none) and whether it names one inside the rect and the map."""
    Hq, W, _ = featq_shape
    p = code >> 2
    y = ryq0[:, None] + torch.div(p, Rw, rounding_mode="floor")
    x = rx0[:, None] + p % Rw
    ok = ((p >= 0) & (p < Rhq * Rw) & (y >= 0) & (y < Hq) & (x >= 0)
          & (x < W))
    row = (y.long() * W + x) * PACK + (code & 3)
    return torch.where(ok, row, 0), ok


def rect_gather_plain(featq: torch.Tensor, ryq0: torch.Tensor,
                      rx0: torch.Tensor, code: torch.Tensor, Rhq: int,
                      Rw: int) -> torch.Tensor:
    """Plain torch version of the rect gather kernel, on any device:
    ``[K1, C, t3]`` in featq's dtype."""
    row, ok = source_rows(featq.shape, ryq0, rx0, code, Rhq, Rw)
    vals = featq.reshape(-1, featq.shape[-1] // PACK)[row]   # [K1, t3, C]
    return vals.masked_fill(~ok[..., None], 0).permute(0, 2, 1).contiguous()


def rect_gather_cuda(featq: torch.Tensor, ryq0: torch.Tensor,
                     rx0: torch.Tensor, code: torch.Tensor, Rhq: int,
                     Rw: int) -> torch.Tensor:
    """The ``csrc/rect_gather_probe.cu`` kernel; same contract as
    ``rect_gather_plain``.  Raises on inputs the kernel does not take."""
    if featq.dtype != torch.bfloat16:
        raise TypeError(f"rect gather kernel takes bf16, got {featq.dtype}")
    if featq.dim() != 3 or featq.shape[2] != PACK * C:
        raise ValueError(f"featq must be [Hq, W, {PACK * C}], got "
                         f"{tuple(featq.shape)}")
    if not featq.is_contiguous() or featq.data_ptr() % 16:
        raise ValueError("featq must be contiguous and 16-byte aligned")
    if code.dim() != 2:
        raise ValueError("code must be [K1, t3]")
    K1, t3 = code.shape
    if ryq0.shape != (K1,) or rx0.shape != (K1,):
        raise ValueError("ryq0 and rx0 must be [K1]")
    dev = featq.device
    ryq0, rx0, code = (int32_index(t, dev, what) for t, what in
                       ((ryq0, "ryq0"), (rx0, "rx0"), (code, "code")))
    out = torch.empty(K1, C, t3, dtype=torch.bfloat16, device=dev)
    _build.launch("cnrma_rect_gather", RECT_GATHER, dev, featq.data_ptr(),
                  ryq0.data_ptr(), rx0.data_ptr(), code.data_ptr(),
                  out.data_ptr(), featq.shape[0], featq.shape[1], Rhq, Rw, C,
                  t3, K1)
    return out


def rect_gather(featq, ryq0, rx0, code, Rhq: int, Rw: int) -> torch.Tensor:
    """The kernel for a CUDA featq, the plain version for a CPU one."""
    return _build.dispatch(featq, rect_gather_cuda, rect_gather_plain,
                           featq, ryq0, rx0, code, Rhq, Rw)


def bench_cases(dev: torch.device) -> List[KernelCase]:
    """The kernel on the bench inputs, with the bytes its function needs:
    codes, rect starts, the featq rows the valid codes reach, the output."""
    s = BENCH_SHAPE
    args = (*to_device(dev, *synth(np.random.RandomState(0), **s)),
            s["Rhq"], s["Rw"])
    featq, ryq0, rx0, code = args[:4]
    row, ok = source_rows(featq.shape, ryq0, rx0, code, s["Rhq"], s["Rw"])
    reached = int(torch.unique(row[ok]).numel())
    nbytes = (4 * (ryq0.numel() + rx0.numel() + code.numel())
              + reached * C * 2 + s["K1"] * C * s["t3"] * 2)
    return [KernelCase(
        name="rect_gather", symbol="rect_gather_kernel",
        source="cnrma_torch/csrc/rect_gather_probe.cu",
        replaces="tools/pallas_bp_probe.py:45", counter=RECT_GATHER,
        kernel=lambda: rect_gather_cuda(*args),
        plain=lambda: rect_gather_plain(*args), library=None, bytes=nbytes)]


def _check(dev: torch.device) -> int:
    s = CHECK_SHAPE
    rng = np.random.RandomState(0)
    ok = True
    for label, xalign in (("rx0 on the probe's 16-column lattice", XALIGN),
                          ("rx0 at any column", 1)):
        featq, ryq0, rx0, code = synth(rng, **s, xalign=xalign)
        fq, *rest = to_device(dev, featq, ryq0, rx0, code)
        got = rect_gather(fq, *rest, s["Rhq"], s["Rw"])
        want = ref_gather(fq.float().cpu().numpy(), ryq0, rx0, code,
                          s["Rhq"], s["Rw"], s["C"], s["t3"])
        err = float(np.max(np.abs(got.float().cpu().numpy() - want)))
        print(f"{label}: max err {err}", flush=True)
        ok &= err == 0.0
    print("CHECK OK" if ok else "CHECK FAIL", flush=True)
    return 0 if ok else 1


def _bench(dev: torch.device, Rhq: int, Rw: int, K1: int) -> int:
    s = dict(BENCH_SHAPE, Rhq=Rhq, Rw=Rw, K1=K1)
    Hq, W, t3 = s["Hq"], s["W"], s["t3"]
    print(f"Rhq={Rhq} Rw={Rw} K1={K1}", flush=True)
    rng = np.random.RandomState(0)
    args = (*to_device(dev, *synth(rng, **s)), Rhq, Rw)
    match = torch.equal(rect_gather(*args), rect_gather_plain(*args))
    dt = time_ms(lambda: rect_gather(*args), dev, REPS)
    rows = K1 * t3
    print(f"rect gather:             {dt:.3f} ms/view ({rows / dt / 1e6:.2f} "
          f"G rows/s)  match={match}", flush=True)
    # the probe's baseline at the same shapes: K1*t3 row gathers
    feat_rows = torch.from_numpy(rng.randn(Hq * PACK * W, C).astype(
        np.float32)).to(dev, torch.bfloat16)
    idx = torch.from_numpy(rng.randint(0, Hq * PACK * W, (rows,))).to(dev)
    dt2 = time_ms(lambda: torch.index_select(feat_rows, 0, idx), dev, REPS)
    print(f"index_select row gather: {dt2:.3f} ms/view "
          f"({rows / dt2 / 1e6:.2f} G rows/s)", flush=True)
    return 0 if match else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m cnrma_torch.tools.bp_probe",
        description="Rect gather probe: check against the numpy oracle, or "
                    "time at the full ScanNet view shape.")
    ap.add_argument("mode", nargs="?", default="check",
                    choices=("check", "bench"))
    add_device_arg(ap)
    ap.add_argument("--rhq", type=int, default=BENCH_SHAPE["Rhq"])
    ap.add_argument("--rw", type=int, default=BENCH_SHAPE["Rw"])
    ap.add_argument("--k1", type=int, default=BENCH_SHAPE["K1"])
    args = ap.parse_args(argv)
    dev = device_of(args.device)
    print(f"device: {describe(dev)}", flush=True)
    if args.mode == "check":
        return _check(dev)
    return _bench(dev, args.rhq, args.rw, args.k1)


if __name__ == "__main__":
    sys.exit(main())

"""Kernel feature probe (P3): port of ``tools/pallas_feature_probe.py``.

The TPU probe checks which Mosaic features its compile route accepts, each
with one tiny Pallas kernel and its expected output.  Here each is the
Hopper form of the same feature, a kernel of ``csrc/feature_probe.cu``
built through ``cnrma_torch/ops/_build.py`` (``sm_90a``, ``ctypes``), run
on the probe's inputs and compared exactly with the probe's ``want``:

    basic      x + 1 on [8, 128]
    dot        [128, 256] @ [256, 128], bf16 in, fp32 out, on the tensor
               cores (wgmma) from operands that TMA brings into shared memory
    dyn_slice  rows [s, s + 8) of [64, 128], s read on the device
    prefetch   block k of [4, 8, 128] doubled into block tids[k]
    alias      acc += x on [8, 128], in place (the result is acc itself)
    onehot     tab[idx] as fp32 from a bf16 table, a direct row gather
               (16-byte loads of 8 bf16); exact against the bf16-rounded
               table
    dma        rows 8-15 of [64, 128], each thread's 16 bytes copied into
               shared memory by cp.async, doubled

On a CPU tensor each runs its plain torch version instead.  ``empty_cuda``
launches an empty kernel, whose device time is the least a launch takes.

    python -m cnrma_torch.tools.feature_probe [name ...] [--device cpu]

One line per probe, ``name OK match=True`` or ``name FAIL ...``; the exit
code is 1 if any probe failed or mismatched.
"""

from __future__ import annotations

import argparse
import sys
import traceback
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from cnrma_torch.ops import _build
from cnrma_torch.tools._common import (KernelCase, add_device_arg, describe,
                                       device_of, int32_index)

NAMES = ("basic", "dot", "dyn_slice", "prefetch", "alias", "onehot", "dma")
LAUNCHES = {name: _build.LaunchCounter() for name in NAMES}
EMPTY = _build.LaunchCounter()
_TPU_LINE = dict(basic=57, dot=67, dyn_slice=77, prefetch=95, alias=110,
                 onehot=126, dma=143)


def _f32(x: torch.Tensor, what: str) -> torch.Tensor:
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"{what} must be contiguous fp32")
    return x


def _launch(name: str, dev: torch.device, *args) -> None:
    _build.launch(f"cnrma_probe_{name}", LAUNCHES[name], dev, *args)


def basic_plain(x):
    return x + 1.0


def basic_cuda(x):
    out = torch.empty_like(_f32(x, "x"))
    _launch("basic", x.device, x.data_ptr(), out.data_ptr(), x.numel())
    return out


def dot_plain(a, b):
    return a.float() @ b.float()


def dot_cuda(a, b):
    """``a @ b`` for bf16 ``a [M, K]``, ``b [K, N]`` with M, N, K multiples
    of 16, as fp32, on the tensor cores: wgmma on 64x64 tiles of the
    result, fed by TMA.  A tensor map that cannot be encoded or a launch
    that fails raises."""
    if a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16:
        raise TypeError("dot takes bf16 operands")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError("dot takes [M, K] @ [K, N]")
    (M, K), N = a.shape, b.shape[1]
    if M % 16 or N % 16 or K % 16:
        raise ValueError("dot takes M, N and K in multiples of 16")
    for t in (a, b):
        if not t.is_contiguous() or t.data_ptr() % 32:
            raise ValueError("dot operands must be contiguous and 32-byte "
                             "aligned")
    out = torch.empty(M, N, dtype=torch.float32, device=a.device)
    _launch("dot", a.device, a.data_ptr(), b.data_ptr(), out.data_ptr(), M,
            N, K)
    return out


def empty_cuda(dev: torch.device) -> None:
    """Launch the empty kernel (one block of 32 threads, no memory) on
    ``dev``: its device time is the least a launch takes."""
    _build.launch("cnrma_probe_empty", EMPTY, dev)


def dyn_slice_rows(start, x, rows: int):
    """The row numbers ``[s, s + rows)``, ``s = start[0]`` clamped into the
    table like ``lax.dynamic_slice``."""
    s = start.reshape(-1)[:1].clamp(0, x.shape[0] - rows)
    return s + torch.arange(rows, device=x.device, dtype=s.dtype)


def dyn_slice_plain(start, x, rows: int):
    """Rows ``[s, s + rows)`` of ``x`` (``dyn_slice_rows``)."""
    return x.index_select(0, dyn_slice_rows(start, x, rows))


def dyn_slice_cuda(start, x, rows: int):
    _f32(x, "x")
    if x.dim() != 2 or not 0 < rows <= x.shape[0]:
        raise ValueError("dyn_slice takes a 2-D x and 0 < rows <= x rows")
    start = int32_index(start, x.device, "start")
    out = torch.empty(rows, x.shape[1], dtype=torch.float32, device=x.device)
    _launch("dyn_slice", x.device, start.data_ptr(), x.data_ptr(),
            out.data_ptr(), x.shape[0], rows, x.shape[1])
    return out


def prefetch_plain(tids, x):
    """``out[tids[k]] = 2 x[k]`` for blocks ``k`` of ``x``; blocks no id
    names stay 0, ids outside the blocks are skipped."""
    keep = (tids >= 0) & (tids < x.shape[0])
    out = torch.zeros_like(x)
    return out.index_copy_(0, tids[keep].long(), x[keep] * 2.0)


def prefetch_cuda(tids, x):
    _f32(x, "x")
    if tids.shape != (x.shape[0],):
        raise ValueError("prefetch takes one block id per block of x")
    tids = int32_index(tids, x.device, "tids")
    out = torch.zeros_like(x)
    _launch("prefetch", x.device, tids.data_ptr(), x.data_ptr(),
            out.data_ptr(), x.shape[0], x[0].numel(), x.shape[0])
    return out


def alias_plain(acc, x):
    return acc.add_(x)


def alias_cuda(acc, x):
    """``acc += x`` in place; returns ``acc``."""
    _f32(acc, "acc")
    if x.shape != acc.shape:
        raise ValueError("alias takes x of acc's shape")
    x = _f32(x.to(acc.device), "x")
    _launch("alias", acc.device, acc.data_ptr(), x.data_ptr(), acc.numel())
    return acc


def onehot_plain(idx, tab):
    """``tab[idx]`` as fp32, 0 where idx is outside the table."""
    ok = (idx >= 0) & (idx < tab.shape[0])
    rows = tab[torch.where(ok, idx, 0).long()].float()
    return rows.masked_fill(~ok[:, None], 0.0)


def onehot_cuda(idx, tab):
    """Rows ``idx [M]`` of the bf16 table ``tab [R, D]``, of any size, read
    straight from device memory: 16-byte loads where D is a multiple of 8
    and the table 16-byte aligned, one element a thread otherwise."""
    if tab.dtype != torch.bfloat16 or tab.dim() != 2:
        raise TypeError("onehot takes a 2-D bf16 table")
    R, D = tab.shape
    if not tab.is_contiguous():
        raise ValueError("tab must be contiguous")
    if idx.dim() != 1 or tab.numel() >= 2 ** 31 \
            or idx.shape[0] * D >= 2 ** 31:
        raise ValueError("onehot takes a 1-D idx, and a table and result of "
                         "< 2**31 elements each")
    idx = int32_index(idx, tab.device, "idx")
    out = torch.empty(idx.shape[0], D, dtype=torch.float32,
                      device=tab.device)
    _launch("onehot", tab.device, idx.data_ptr(), tab.data_ptr(),
            out.data_ptr(), idx.shape[0], R, D)
    return out


def dma_plain(x, row0: int, rows: int):
    return x[row0:row0 + rows] * 2.0


def dma_cuda(x, row0: int, rows: int):
    """``2 x[row0 : row0 + rows]``, each 16-byte piece copied into shared
    memory by an asynchronous copy (``cp.async``) and doubled there: the
    slice must start on a 16-byte boundary and be a multiple of 16
    bytes."""
    _f32(x, "x")
    if x.dim() != 2 or row0 < 0 or rows < 0 or row0 + rows > x.shape[0]:
        raise ValueError("dma takes rows of a 2-D x")
    D = x.shape[1]
    if (x.data_ptr() + row0 * D * 4) % 16 or rows * D % 4 \
            or rows * D >= 2 ** 33:
        raise ValueError("dma copies a 16-byte aligned slice of a multiple "
                         "of 16 bytes, under 2**31 pieces")
    out = torch.empty(rows, D, dtype=torch.float32, device=x.device)
    _launch("dma", x.device, x.data_ptr(), out.data_ptr(), x.shape[0], row0,
            rows, D)
    return out


KERNELS: Dict[str, Tuple[Callable, Callable]] = {
    name: (globals()[f"{name}_cuda"], globals()[f"{name}_plain"])
    for name in NAMES}


def run(name: str, *args):
    """Probe ``name`` on ``args``: the kernel for CUDA inputs, the plain
    version for CPU inputs."""
    cuda_fn, plain_fn = KERNELS[name]
    return _build.dispatch(args[0], cuda_fn, plain_fn, *args)


def probe_inputs(name: str, dev: torch.device):
    """The original probe's inputs on ``dev`` and its ``want`` (numpy)."""
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    grid = np.arange(64 * 128, dtype=np.float32).reshape(64, 128)
    if name == "basic":
        x = grid[:8]
        return (t(x),), x + 1
    if name == "dot":
        a = torch.ones(128, 256, dtype=torch.bfloat16, device=dev)
        b = torch.ones(256, 128, dtype=torch.bfloat16, device=dev)
        return (a, b), np.full((128, 128), 256.0, np.float32)
    if name == "dyn_slice":
        return (t(np.array([16], np.int32)), t(grid), 8), grid[16:24]
    if name == "prefetch":
        x = np.arange(4 * 8 * 128, dtype=np.float32).reshape(4, 8, 128)
        tids = np.array([2, 0, 3, 1], np.int32)
        want = np.zeros_like(x)
        want[tids] = x * 2
        return (t(tids), t(x)), want
    if name == "alias":
        return ((t(np.ones((8, 128), np.float32)),
                 t(np.full((8, 128), 3.0, np.float32))),
                np.full((8, 128), 4.0, np.float32))
    if name == "onehot":
        rng = np.random.RandomState(0)
        idx = rng.randint(0, 256, (128, 1)).astype(np.int32)[:, 0]
        tab = torch.from_numpy(rng.randn(256, 128).astype(np.float32)
                               ).bfloat16()
        return (t(idx), tab.to(dev)), tab.float().numpy()[idx]
    if name == "dma":
        return (t(grid), 8, 8), grid[8:16] * 2
    raise ValueError(f"unknown probe {name!r}; choose from {NAMES}")


def check(name: str, dev: torch.device) -> bool:
    """Run probe ``name`` on the original's inputs and compare exactly."""
    args, want = probe_inputs(name, dev)
    out = run(name, *args)
    ok = bool(np.array_equal(out.cpu().numpy(), want))
    if name == "alias":           # accumulated in place
        ok &= out.data_ptr() == args[0].data_ptr()
    return ok


def _nbytes(*ts) -> int:
    return sum(x.numel() * x.element_size() for x in ts)


def _work(name: str, args, out_bytes: int):
    """(bytes, operations, their type) that probe ``name`` needs on
    ``args``: each input byte it reads once, each output byte once."""
    if name == "dot":
        a, b = args
        return (_nbytes(a, b) + out_bytes,
                2.0 * a.shape[0] * a.shape[1] * b.shape[1], "bf16_tensor")
    if name == "onehot":            # the table rows idx reaches
        idx, tab = args
        reached = torch.unique(idx).numel() * tab.shape[1] * 2
        return _nbytes(idx) + reached + out_bytes, 0.0, "fp32"
    if name == "dyn_slice":         # the start, the slice read and written
        return 4 + 2 * out_bytes, 0.0, "fp32"
    if name == "dma":
        return 2 * out_bytes, out_bytes / 4, "fp32"
    # basic, prefetch, alias: all inputs, one operation per output element
    return _nbytes(*args) + out_bytes, out_bytes / 4, "fp32"


# the one PyTorch call that computes a probe's function, where there is one
# (on the arguments of ``_library_args``)
_LIBRARY = {
    "basic": lambda x: torch.add(x, 1.0),
    "dot": lambda a, b: torch.mm(a, b, out_dtype=torch.float32),
    "dyn_slice": lambda x, rows: x.index_select(0, rows),
    "alias": lambda acc, x: acc.add_(x),
    "onehot": lambda idx, tab: tab.index_select(0, idx),
    "dma": lambda x, row0, rows: torch.mul(x[row0:row0 + rows], 2.0),
}


def _library_args(name: str, args):
    """The library call's arguments: ``dyn_slice``'s row numbers made
    beforehand, so that one ``index_select`` of 8 rows is the call;
    ``onehot``'s indices are all inside the table, so ``index_select`` on
    the bf16 table gives its rows (in bf16, exactly the fp32 values)."""
    if name == "dyn_slice":
        start, x, rows = args
        return x, dyn_slice_rows(start, x, rows)
    return args


def bench_cases(dev: torch.device) -> List[KernelCase]:
    """Every probe on its own inputs, with the work its function needs.
    Kernel, plain version and library call each get their own copy of the
    inputs, since ``alias`` updates in place."""
    cases = []
    for name in NAMES:
        args_k, want = probe_inputs(name, dev)
        args_p, _ = probe_inputs(name, dev)
        args_l, _ = probe_inputs(name, dev)
        nbytes, ops, ops_type = _work(name, args_k, want.size * 4)
        cuda_fn, plain_fn = KERNELS[name]
        library = _LIBRARY.get(name)
        cases.append(KernelCase(
            name=f"probe_{name}", symbol=f"{name}_kernel",
            source="cnrma_torch/csrc/feature_probe.cu",
            replaces=f"tools/pallas_feature_probe.py:{_TPU_LINE[name]}",
            counter=LAUNCHES[name],
            kernel=lambda f=cuda_fn, a=args_k: f(*a),
            plain=lambda f=plain_fn, a=args_p: f(*a),
            library=(None if library is None
                     else lambda f=library, a=_library_args(name, args_l):
                     f(*a)),
            bytes=int(nbytes), ops=ops, ops_type=ops_type))
    return cases


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m cnrma_torch.tools.feature_probe",
        description="Feature checks of the kernel toolchain.")
    ap.add_argument("names", nargs="*", metavar="name",
                    help=f"probes to run (default all): {NAMES}")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    names = args.names or list(NAMES)
    unknown = sorted(set(names) - set(NAMES))
    if unknown:
        ap.error(f"unknown probes {unknown}; choose from {NAMES}")
    dev = device_of(args.device)
    print(f"device: {describe(dev)}", flush=True)
    failed = False
    for name in names:
        try:
            ok = check(name, dev)
            print(f"{name:10s} OK match={ok}", flush=True)
            failed |= not ok
        except Exception as e:    # report it, go on to the next probe
            traceback.print_exc()
            msg = str(e).replace("\n", " ")[:160]
            print(f"{name:10s} FAIL {type(e).__name__}: {msg}", flush=True)
            failed = True
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())

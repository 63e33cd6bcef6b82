"""Builds the hand-written CUDA kernels under ``cnrma_torch/csrc`` and binds
them with ``ctypes``.

The sources are compiled with ``nvcc`` into one shared library with a plain
C interface, at first use, into
``build/cnrma_torch_kernels/<hash of sources and flags>/``: one ``nvcc -c``
per source, all started together, then one link.  The library is cached on
disk by that hash, so an unchanged checkout builds once.  Nothing here runs
at import time: the CPU tests import every module of the port on machines
without ``nvcc``.

There is no fallback: a missing ``nvcc``, a failed build or a kernel launch
that reports an error raises.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = (Path(__file__).resolve().parents[2] / "build"
              / "cnrma_torch_kernels")
LIB_NAME = "libcnrma_torch_kernels.so"

ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
# No --use_fast_math, and no FMA contraction: the kernels round pixel and
# voxel ids with the same operation order as the plain torch versions, and a
# contracted multiply-add flips ids that sit on a .5 boundary.
COMPILE_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "--fmad=false",
                 "-Xcompiler", "-fPIC")
LINK_FLAGS = (*ARCH_FLAGS, "-shared")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signature of every exported launcher; each returns cudaGetLastError().
_SIGNATURES = {
    "cnrma_volume_accum": [_P] * 6 + [_I] * 7 + [_F] * 4 + [_I, _P],
    "cnrma_volume_accum_bwd": [_P] * 5 + [_I] * 7 + [_F] * 4
    + [_I, _P, _P],
    "cnrma_ray_march": [_P] * 9 + [_I] * 13 + [_F] * 7 + [_P],
    "cnrma_rect_gather": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                          _P],
    "cnrma_lane_gather": [_P, _P, _P, _I, _I, _I, _P],
    "cnrma_flat_gather": [_P, _P, _P, _I, _I, _P],
    "cnrma_probe_basic": [_P, _P, _I, _P],
    "cnrma_probe_dot": [_P, _P, _P, _I, _I, _I, _P],
    "cnrma_probe_empty": [_P],
    "cnrma_probe_dyn_slice": [_P, _P, _P, _I, _I, _I, _P],
    "cnrma_probe_prefetch": [_P, _P, _P, _I, _I, _I, _P],
    "cnrma_probe_alias": [_P, _P, _I, _P],
    "cnrma_probe_onehot": [_P, _P, _P, _I, _I, _I, _P],
    "cnrma_probe_dma": [_P, _P, _I, _I, _I, _I, _P],
    "cnrma_error_string": [_I],
}

_lock = threading.Lock()
_lib = None
_launchers = {}           # name -> the library's function, bound once


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``/usr/local/cuda`` or
    the one on ``PATH``."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the cnrma_torch "
                           "CUDA kernels cannot be built")
    return found


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    """Hash of the flags, the sources and the headers they include."""
    h = hashlib.sha256(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds) -> None:
    """Run the commands in parallel; raise on the first that failed, after
    all have ended."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    outputs = [(cmd, proc.communicate()[0], proc.returncode)
               for cmd, proc in procs]
    for cmd, text, rc in outputs:
        if rc != 0:
            raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n"
                               f"{text}")


def _compile(out: Path) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    tag = os.getpid()
    nvcc = nvcc_path()
    objs = [out.with_name(f"{src.stem}.{tag}.o") for src in _sources()]
    _run_all([[nvcc, *COMPILE_FLAGS, "-c", "-o", str(obj), str(src)]
              for src, obj in zip(_sources(), objs)])
    tmp = out.with_name(f"{LIB_NAME}.{tag}.tmp")
    _run_all([[nvcc, *LINK_FLAGS, "-o", str(tmp), *map(str, objs)]])
    os.replace(tmp, out)          # atomic: a concurrent build never half-reads
    for obj in objs:
        obj.unlink()


def library_path() -> Path:
    """Where the kernel library of these sources and flags is built."""
    return BUILD_ROOT / _digest() / LIB_NAME


def library() -> ctypes.CDLL:
    """The kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            out = library_path()
            if not out.exists():
                _compile(out)
            lib = ctypes.CDLL(str(out))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_char_p if name == "cnrma_error_string" \
                    else ctypes.c_int
                _launchers[name] = fn
            _lib = lib
        return _lib


class LaunchCounter:
    """Number of launches of one kernel; its wrapper adds one per launch."""

    def __init__(self):
        self.launches = 0


def launch(fn: str, counter: LaunchCounter, device: torch.device,
           *args) -> None:
    """Call launcher ``fn`` with ``args`` and the current stream of
    ``device``, raise on the CUDA error it returns, and count the launch.
    The device guard is entered only when ``device`` is not the current
    device already."""
    lib = library()
    current = device.index is None \
        or device.index == torch.cuda.current_device()
    with contextlib.nullcontext() if current else torch.cuda.device(device):
        stream = ctypes.c_void_p(torch.cuda.current_stream(device)
                                 .cuda_stream)
        err = _launchers[fn](*args, stream)
    if err != 0:
        msg = lib.cnrma_error_string(err).decode()
        raise RuntimeError(f"{fn}: CUDA error {err} ({msg})")
    counter.launches += 1


def dispatch(t: torch.Tensor, cuda_fn: Callable, plain_fn: Callable, *args):
    """``cuda_fn(*args)`` (the kernel) where ``t`` is a CUDA tensor,
    ``plain_fn(*args)`` (its plain version) where it is a CPU tensor."""
    if t.is_cuda:
        return cuda_fn(*args)
    if t.device.type == "cpu":
        return plain_fn(*args)
    raise ValueError(f"no kernel for device {t.device}")

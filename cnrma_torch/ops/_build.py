"""Builds the hand-written CUDA kernels under ``cnrma_torch/csrc`` and binds
them with ``ctypes``.

The sources are compiled with ``nvcc`` into one shared library with a plain
C interface, at first use, into
``build/cnrma_torch_kernels/<hash of sources and flags>/``.  The library is
cached on disk by that hash, so an unchanged checkout builds once.  Nothing
here runs at import time: the CPU tests import every module of the port on
machines without ``nvcc``.

There is no fallback: a missing ``nvcc``, a failed build or a kernel launch
that reports an error raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = (Path(__file__).resolve().parents[2] / "build"
              / "cnrma_torch_kernels")
LIB_NAME = "libcnrma_torch_kernels.so"

# No --use_fast_math, and no FMA contraction: the kernels round pixel and
# voxel ids with the same operation order as the plain torch versions, and a
# contracted multiply-add flips ids that sit on a .5 boundary.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signature of every exported launcher; each returns cudaGetLastError().
_SIGNATURES = {
    "cnrma_volume_accum": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                           _I, _F, _F, _F, _F, _I, _P],
    "cnrma_coarse_march": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                           _F, _F, _P],
    "cnrma_error_string": [_I],
}

_lock = threading.Lock()
_lib = None


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
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _compile(out: Path) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{LIB_NAME}.{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(s) for s in _sources()]]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)          # atomic: a concurrent build never half-reads


def library() -> ctypes.CDLL:
    """The kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            out = BUILD_ROOT / _digest() / LIB_NAME
            if not out.exists():
                _compile(out)
            lib = ctypes.CDLL(str(out))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_char_p if name == "cnrma_error_string" \
                    else ctypes.c_int
            _lib = lib
        return _lib


class LaunchCounter:
    """Number of launches of one kernel; its wrapper adds one per launch."""

    def __init__(self):
        self.launches = 0


def check(err: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if err != 0:
        msg = library().cnrma_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")

"""Opt-in report of fixed-capacity fills (port of
``cnrma_tpu/utils/capacity_debug.py``).

The port keeps the JAX package's fixed capacities (the voxelize and dedup
buffers of ``DetectionCapacities``, ``rays_per_view_cap``, ``max_points``),
so a buffer that is too small clips in silence and shows only as lost mAP.
With ``CNRMA_CAPACITY_DEBUG=1`` every capacity site prints its fill against
its capacity, one line per call, in the JAX package's format::

    [capacity] <name>: <fill>/<cap> saturated=<0|1>

    CNRMA_CAPACITY_DEBUG=1 python -m cnrma_torch.tools.test CONFIG ...

Sites (the JAX site in brackets):

* ``voxelize(stride 1)``: ``ops/sparse.py:voxelize_points``
  (``cnrma_tpu/ops/sparse.py:128``);
* ``dedup(stride s)``: ``ops/sparse.py:downsample_coords``
  (``sparse.py:293-313``);
* ``ray-march kept samples/view``: ``ops/ray_marching.py:_points``, one
  line per view, only where the capacity is below the view's samples
  (``ray_marching.py:221-222``);
* ``scene points before max_points subsample``:
  ``models/cn_rma.py:_normalize_subsample`` (``cn_rma.py:140-146``).

The JAX package's frustum-tile, rect and derived-kernel-map sites have no
counterpart here: the port's volume kernel and kernel maps have no
capacity, so they get no report.

A fill is computed on the device, and only when the flag is set; it is then
read to the host, which syncs.  With the flag off nothing is computed or
read, so the forward stays free of host syncs.  ``LARGEST`` keeps each
site's largest fill reported in this process, for a caller that wants the
fills without reading the printed lines.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Tuple

import torch

# site name -> (largest fill reported, its capacity); cleared by the caller
LARGEST: Dict[str, Tuple[int, int]] = {}


def enabled() -> bool:
    return os.environ.get("CNRMA_CAPACITY_DEBUG", "") not in ("", "0")


def report(name: str, fill: Callable[[], torch.Tensor], capacity: int
           ) -> None:
    """Print ``[capacity] name: fill/capacity saturated=0|1`` when the flag
    is set, one line per element of ``fill()``: the pre-clip counts, a
    0-dim tensor or one count per view.  ``fill`` is called only then.  A
    fill at or above the capacity means the buffer clipped or sits at the
    brim.  Each fill also raises the site's entry of ``LARGEST``."""
    if not enabled():
        return
    for n in torch.as_tensor(fill()).reshape(-1).tolist():
        n = int(n)
        LARGEST[name] = max(LARGEST.get(name, (0, 0)), (n, capacity))
        print(f"[capacity] {name}: {n}/{capacity} "
              f"saturated={int(n >= capacity)}", flush=True)

"""The process group of a data-parallel run, and the few collectives the
port uses: the counterpart of ``cnrma_tpu/parallel/mesh.py``'s
``('data',)`` mesh, one process a rank as ``torchrun`` starts them.

``init_from_env`` reads ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR`` and ``MASTER_PORT`` and joins the group: NCCL on the card
(after ``torch.cuda.set_device(LOCAL_RANK)``), gloo on the CPU, or the
backend the caller names (gloo for several ranks on one card, which NCCL
refuses).  A failed init raises; nothing falls back.

Every function takes the group as an argument, and with ``group=None``
(no process group: a one-process run) is the identity: rank 0 of 1, the
mean of one tensor, no barrier.  ``flatten_bucket`` and
``unflatten_bucket`` are ``_flatten_bucket``/``_unflatten_bucket`` of
``cnrma_tpu/train/loop.py``: many tensors as one fp32 vector, so a step
all-reduces once.

``view_shards`` lays the world out as JAX's ``('data', 'view')`` mesh
(``tools/train.py --view-shards``): n ranks a scene, rank r the view
index ``r % n`` of data row ``r // n``, with a process group for each row
(a scene's ranks) and for each view index (the ranks that hold the same
part of different scenes).
"""

from __future__ import annotations

import os
from typing import Any, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


def init_from_env(device_type: str = "cuda", backend: Optional[str] = None
                  ) -> Tuple[Optional[Any], Optional[torch.device]]:
    """(the world group, this rank's device) from ``torchrun``'s
    environment, ``(None, None)`` where it sets no ``WORLD_SIZE``.  On
    CUDA the device is ``cuda:LOCAL_RANK``."""
    if "WORLD_SIZE" not in os.environ:
        return None, None
    rank_, world_ = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", rank_))
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA rank on a machine with no CUDA "
                               "device (pass --device cpu for gloo)")
        device = torch.device("cuda", local)
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    addr = os.environ.get("MASTER_ADDR", "localhost")
    port = os.environ["MASTER_PORT"]
    kwargs = {"device_id": device} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=f"tcp://{addr}:{port}",
                            rank=rank_, world_size=world_, **kwargs)
    return dist.group.WORLD, device


def shutdown(group) -> None:
    """Leave the group that ``init_from_env`` joined."""
    if group is not None:
        dist.destroy_process_group()


def rank(group=None) -> int:
    return 0 if group is None else dist.get_rank(group)


def world(group=None) -> int:
    return 1 if group is None else dist.get_world_size(group)


def is_main(group=None) -> bool:
    return rank(group) == 0


def barrier(group=None) -> None:
    if group is not None:
        dist.barrier(group)


def all_mean(tensor: torch.Tensor, group=None) -> torch.Tensor:
    """``tensor``'s mean over the group's ranks, in place (the sum, then a
    division by the world size; at world size 1 the tensor is
    unchanged)."""
    if group is not None:
        dist.all_reduce(tensor, op=dist.ReduceOp.SUM, group=group)
        tensor /= world(group)
    return tensor


def gather_to_main(obj: Any, group=None) -> Optional[List[Any]]:
    """Every rank's ``obj`` (picklable) as a list in rank order on the
    group's rank 0; ``None`` on the others.  ``[obj]`` without a group."""
    if group is None:
        return [obj]
    out = [None] * world(group) if is_main(group) else None
    dist.gather_object(obj, out, dst=dist.get_global_rank(group, 0),
                       group=group)
    return out


class ViewShards(NamedTuple):
    """A rank's place in a (data, view) layout of the world."""
    n: int          # ranks a scene: the size of a view group
    row: int        # this rank's data row (its scene): rank // n
    index: int      # this rank's view index in its row: rank % n
    rows: int       # data rows: world size // n
    view: Any       # the group of this rank's row
    data: Any       # the group of the ranks with this rank's view index


def view_shards(group, n: int) -> ViewShards:
    """The (data, view) layout of ``group``'s world with ``n`` ranks a
    scene (``n`` divides the world size).  Every rank makes every
    subgroup, in the same order, as ``torch.distributed.new_group``
    requires; they take the world's backend."""
    w, r = world(group), rank(group)
    if n < 1 or w % n:
        raise ValueError(f"--view-shards {n} must divide the {w} visible "
                         "devices")
    views = [dist.new_group(list(range(row * n, (row + 1) * n)))
             for row in range(w // n)]
    datas = [dist.new_group(list(range(j, w, n))) for j in range(n)]
    return ViewShards(n=n, row=r // n, index=r % n, rows=w // n,
                      view=views[r // n], data=datas[r % n])


def flatten_bucket(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """Ravel every tensor to one fp32 vector (a DDP gradient bucket)."""
    if not tensors:
        return torch.zeros((0,), dtype=torch.float32)
    return torch.cat([t.reshape(-1).float() for t in tensors])


def unflatten_bucket(flat: torch.Tensor, like: Sequence[torch.Tensor]
                     ) -> List[torch.Tensor]:
    """Inverse of ``flatten_bucket`` against the shapes and dtypes of
    ``like``."""
    out, off = [], 0
    for t in like:
        n = t.numel()
        out.append(flat[off:off + n].reshape(t.shape).to(t.dtype))
        off += n
    if off != flat.numel():
        raise ValueError(f"a bucket of {flat.numel()} values for tensors "
                         f"of {off}")
    return out

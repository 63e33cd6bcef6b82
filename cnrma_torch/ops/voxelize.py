"""Voxel key packing, sorting, dedup and lookup: the coordinate machinery
under the sparse convolutions.

Port of ``cnrma_tpu/ops/voxelize.py``.  Voxel coordinates pack into one
sortable int32 key; lookups search the sorted key array
(``torch.searchsorted``); dedup collapses sorted runs.  Everything has a
fixed capacity, and empty slots carry the sentinel key (int32 max), which
sorts last.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

SENTINEL_KEY = 2 ** 31 - 1


class VoxelGrid(NamedTuple):
    """Static coordinate domain for key packing (±10.24 m in x and y,
    -0.64..+4.46 m in z at 1 cm).  Coordinates outside it are invalid."""
    bounds: Tuple[int, int, int] = (2048, 2048, 510)
    shifts: Tuple[int, int, int] = (1024, 1024, 64)

    def pack(self, coords: torch.Tensor) -> torch.Tensor:
        """[..., 3] int voxel coords -> [...] int32 keys (outside ->
        SENTINEL_KEY)."""
        bx, by, bz = self.bounds
        sx, sy, sz = self.shifts
        c = coords.to(torch.int32)
        x, y, z = c[..., 0] + sx, c[..., 1] + sy, c[..., 2] + sz
        ok = ((x >= 0) & (x < bx) & (y >= 0) & (y < by)
              & (z >= 0) & (z < bz))
        key = (x * by + y) * bz + z
        return torch.where(ok, key, SENTINEL_KEY).to(torch.int32)

    def unpack(self, keys: torch.Tensor) -> torch.Tensor:
        """Inverse of ``pack``; sentinel keys map to ``bounds``."""
        bx, by, bz = self.bounds
        sx, sy, sz = self.shifts
        z = keys % bz
        xy = keys // bz
        coords = torch.stack([xy // by - sx, xy % by - sy, z - sz], dim=-1)
        oob = torch.tensor(self.bounds, dtype=torch.int32, device=keys.device)
        bad = (keys == SENTINEL_KEY)[..., None]
        return torch.where(bad, oob, coords).to(torch.int32)


def sort_by_key(keys: torch.Tensor, *arrays: torch.Tensor):
    """Stable ascending sort of ``keys``, applied to the payload arrays."""
    keys_sorted, perm = torch.sort(keys, stable=True)
    return (keys_sorted,) + tuple(a[perm] for a in arrays)


def unique_sorted(keys_sorted: torch.Tensor, capacity: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Collapse sorted keys to unique keys at a fixed capacity.

    Returns:
        out_keys: [capacity] unique keys, sorted, sentinel-padded.
        run_id: [N] slot of every input in out_keys (``capacity`` for
            sentinel inputs and for runs past the capacity).
    """
    valid = keys_sorted != SENTINEL_KEY
    prev = torch.cat([keys_sorted.new_full((1,), -1), keys_sorted[:-1]])
    firsts = valid & (keys_sorted != prev)
    run_id = torch.cumsum(firsts.long(), 0) - 1
    run_id = torch.where(valid & (run_id < capacity), run_id, capacity)
    slot = torch.where(firsts, run_id, capacity)
    out_keys = keys_sorted.new_full((capacity + 1,), SENTINEL_KEY)
    out_keys[slot] = keys_sorted          # slot `capacity` collects drops
    return out_keys[:capacity], run_id


def count_unique(keys_sorted: torch.Tensor) -> torch.Tensor:
    """Number of distinct non-sentinel keys in a sorted key array (0-dim):
    the fill of a ``unique_sorted`` buffer before it clips."""
    prev = torch.cat([keys_sorted.new_full((1,), -1), keys_sorted[:-1]])
    return ((keys_sorted != SENTINEL_KEY) & (keys_sorted != prev)).sum()


def lookup(keys_sorted: torch.Tensor, queries: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Search ``queries`` in a sorted key array.  Returns (index clipped to
    [0, N-1], found); sentinel queries are never found."""
    n = keys_sorted.shape[0]
    idx = torch.searchsorted(keys_sorted, queries).clamp(0, n - 1)
    found = (keys_sorted[idx] == queries) & (queries != SENTINEL_KEY)
    return idx, found

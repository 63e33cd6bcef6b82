"""Batches of scenes: collation and a loader whose worker threads read
ahead, on one rank or as one rank's shard of the epoch.

Port of ``cnrma_tpu/data/loader.py``'s ``collate_scenes`` (a copy) and of
``SceneLoader`` at one scene a batch (a training batch holds one scene a
rank here): the scenes of each epoch are shuffled by a
``np.random.RandomState`` seeded once, so consecutive epochs take
consecutive shuffles; with ``shuffle=False`` (the val and test splits)
every scene comes in the dataset's order.

A dataset with ``draw(i)`` and ``load(i, draws)`` (the three readers) is
read in two parts.  The iterating thread makes every scene's draws in the
epoch's order, so the dataset's ``RandomState`` turns as it would in one
thread; ``num_workers`` threads run ``load``, at most ``num_workers``
scenes ahead of the one the caller holds, and the batches come back in
order.  The JAX loader's threads share the ``RandomState`` instead, so its
draws follow the threads' timing.  A dataset without ``draw`` is read
with ``dataset[i]`` in the workers, and must not draw.

At ``world_size`` W > 1 every rank shuffles the same order from the same
seed and takes positions ``rank, rank + W, ...`` of it: the JAX batch of W
scenes split over the mesh.  With ``drop_last`` (training) the last
incomplete round is dropped; without it (the val and test splits) the
ranks' shares differ by at most one scene.  Each rank makes the draws of
every scene of the epoch and loads only its own, so its samples equal a
one-process run's for the same scenes.
"""

from __future__ import annotations

import time
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, Iterator, List, Optional, Sequence

import numpy as np

_STACK_KEYS = ("imgs", "projection", "view_valid", "offset", "gt_boxes",
               "gt_labels", "gt_valid", "tsdf_gt_004", "tsdf_gt_008",
               "tsdf_gt_016", "tsdf_origin", "points", "point_feats",
               "point_valid")


def collate_scenes(samples: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """Stack per-scene fixed-shape samples into a batch dict: array keys on
    a new leading scene axis, the TSDF scales grouped under ``tsdf_list``
    (the reference's ``data_converter`` layout), other values as lists."""
    out: Dict[str, Any] = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        out[key] = np.stack(vals) if key in _STACK_KEYS else vals
    out["tsdf_list"] = {
        k: out.pop(k) for k in
        ("tsdf_gt_004", "tsdf_gt_008", "tsdf_gt_016") if k in out}
    return out


class SceneLoader:
    """One scene a batch, in an order shuffled per epoch (``SceneLoader``
    with ``batch_size=1``), or in the dataset's order with
    ``shuffle=False``; this rank's positions of it (module docstring).
    Each batch also carries ``index`` (the scene's dataset index),
    ``load_s`` (the seconds its reading took) and ``wait_s`` (the seconds
    the caller waited for it)."""

    def __init__(self, dataset, seed: Optional[int] = None,
                 shuffle: bool = True, num_workers: int = 1, rank: int = 0,
                 world_size: int = 1, drop_last: bool = True):
        if not 0 <= rank < world_size:
            raise ValueError(f"rank {rank} of world size {world_size}")
        self.dataset = dataset
        self.shuffle = shuffle
        self.num_workers = max(1, int(num_workers))
        self.rank, self.world_size = rank, world_size
        self.drop_last = drop_last
        self.rng = np.random.RandomState(seed)

    def __len__(self) -> int:
        n, w = len(self.dataset), self.world_size
        return n // w if self.drop_last else len(range(self.rank, n, w))

    def order(self) -> List[int]:
        """The next epoch's scene indices, every rank's."""
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(idx)
        return idx.tolist()

    def _draw(self, index: int) -> Any:
        draw = getattr(self.dataset, "draw", None)
        return draw(index) if draw is not None else None

    def _read(self, index: int, draws: Any) -> Dict[str, Any]:
        t0 = time.perf_counter()
        sample = (self.dataset.load(index, draws)
                  if hasattr(self.dataset, "load") else self.dataset[index])
        batch = collate_scenes([sample])
        batch["index"] = index
        batch["load_s"] = time.perf_counter() - t0
        return batch

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        order = self.order()
        mine = len(self)
        pool = ThreadPoolExecutor(max_workers=self.num_workers)
        ahead: deque = deque()
        cursor = [0]           # the next epoch position to draw

        def submit(k: int) -> None:
            """Draw up to this rank's k-th position, then start its load;
            a draw that fails raises at that scene's place."""
            pos = self.rank + k * self.world_size
            try:
                while cursor[0] <= pos:
                    draws = self._draw(order[cursor[0]])
                    cursor[0] += 1
                ahead.append(pool.submit(self._read, order[pos], draws))
            except Exception as e:       # noqa: BLE001 - raised in order
                failed: Future = Future()
                failed.set_exception(e)
                ahead.append(failed)

        try:
            for k in range(min(self.num_workers, mine)):
                submit(k)
            for k in range(mine):
                t0 = time.perf_counter()
                batch = ahead.popleft().result()
                batch["wait_s"] = time.perf_counter() - t0
                if k + self.num_workers < mine:
                    submit(k + self.num_workers)
                yield batch
            for index in order[cursor[0]:]:      # the epoch's other draws
                self._draw(index)
        finally:
            pool.shutdown(wait=True, cancel_futures=True)

"""Batches of scenes: collation and a loader whose worker threads read
ahead, on one rank or as one rank's share of the epoch.

Port of ``cnrma_tpu/data/loader.py``'s ``collate_scenes`` (a copy) and
``SceneLoader``: the scenes of each epoch are shuffled by a
``np.random.RandomState`` seeded once, so consecutive epochs take
consecutive shuffles, and cut into batches of ``batch_size`` scenes in
that order (the last incomplete one dropped with ``drop_last``); with
``shuffle=False`` (the val and test splits) every scene comes in the
dataset's order.

A dataset with ``draw(i)`` and ``load(i, draws)`` (the three readers) is
read in two parts.  The iterating thread makes every scene's draws in the
epoch's order, so the dataset's ``RandomState`` turns as it would in one
thread; ``num_workers`` threads run ``load``, at most ``num_workers``
scenes ahead of the batch the caller holds, and the batches come back in
order.  The JAX loader's threads share the ``RandomState`` instead, so its
draws follow the threads' timing.  A dataset without ``draw`` is read
with ``dataset[i]`` in the workers, and must not draw.

At ``world_size`` W > 1 every rank shuffles the same order from the same
seed, and ``batch_size`` B (a multiple of W; W by default, one scene a
rank) counts the scenes of a step over all ranks: of each round of B
consecutive scenes, rank r takes the contiguous block ``[r * B / W, (r +
1) * B / W)``, the JAX batch split over the mesh's ``'data'`` axis.  At B
= W that is positions ``r, r + W, ...``.  Without ``drop_last`` (the val
and test splits) the last round is cut at the split's end, and a rank
whose block is empty there has no last batch.  Each rank makes the draws
of every scene of the epoch and loads only its own, so its samples equal
a one-process run's for the same scenes.
"""

from __future__ import annotations

import time
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

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
    """Batches of ``batch_size`` scenes a step (this rank's ``batch_size /
    world_size`` of them), in an order shuffled per epoch, or in the
    dataset's order with ``shuffle=False`` (module docstring).  Each batch
    is ``collate_scenes`` of its samples and also carries ``index`` (the
    scenes' dataset indices: a list, or the one index where a rank's
    batch holds one scene), ``load_s`` (the seconds its samples' reading
    took, summed) and ``wait_s`` (the seconds the caller waited for
    it)."""

    def __init__(self, dataset, seed: Optional[int] = None,
                 shuffle: bool = True, num_workers: int = 1, rank: int = 0,
                 world_size: int = 1, drop_last: bool = True,
                 batch_size: Optional[int] = None):
        if not 0 <= rank < world_size:
            raise ValueError(f"rank {rank} of world size {world_size}")
        batch_size = world_size if batch_size is None else int(batch_size)
        if batch_size < 1 or batch_size % world_size:
            raise ValueError(f"batch size {batch_size} is not a positive "
                             f"multiple of the world size {world_size}")
        self.dataset = dataset
        self.shuffle = shuffle
        self.num_workers = max(1, int(num_workers))
        self.rank, self.world_size = rank, world_size
        self.batch_size = batch_size
        self.per_rank = batch_size // world_size
        self.drop_last = drop_last
        self.rng = np.random.RandomState(seed)

    def __len__(self) -> int:
        return len(self.positions(len(self.dataset)))

    def order(self) -> List[int]:
        """The next epoch's scene indices, every rank's."""
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(idx)
        return idx.tolist()

    def positions(self, n: int) -> List[List[int]]:
        """This rank's batches as positions in an epoch of ``n`` scenes."""
        b, first = self.batch_size, self.rank * self.per_rank
        rounds = n // b if self.drop_last else -(-n // b)
        batches = [[p for p in range(k * b + first,
                                     k * b + first + self.per_rank) if p < n]
                   for k in range(rounds)]
        return [bt for bt in batches if bt]

    def _draw(self, index: int) -> Any:
        draw = getattr(self.dataset, "draw", None)
        return draw(index) if draw is not None else None

    def _read(self, index: int, draws: Any) -> Tuple[Dict[str, Any], float]:
        t0 = time.perf_counter()
        sample = (self.dataset.load(index, draws)
                  if hasattr(self.dataset, "load") else self.dataset[index])
        return sample, time.perf_counter() - t0

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        order = self.order()
        batches = self.positions(len(order))
        mine = [p for bt in batches for p in bt]
        pool = ThreadPoolExecutor(max_workers=self.num_workers)
        ahead: deque = deque()
        cursor = [0]           # the next epoch position to draw

        def submit(upto: int) -> None:
            """Draw and start the loads of this rank's samples until
            ``upto`` of them are started; a draw that fails raises at that
            scene's place."""
            while len(ahead) + taken[0] < min(upto, len(mine)):
                pos = mine[len(ahead) + taken[0]]
                try:
                    while cursor[0] <= pos:
                        draws = self._draw(order[cursor[0]])
                        cursor[0] += 1
                    ahead.append(pool.submit(self._read, order[pos], draws))
                except Exception as e:   # noqa: BLE001 - raised in order
                    failed: Future = Future()
                    failed.set_exception(e)
                    ahead.append(failed)

        taken = [0]            # samples handed to the caller
        try:
            submit(self.num_workers)
            for bt in batches:
                t0 = time.perf_counter()
                parts = []
                for _ in bt:
                    submit(taken[0] + 1)
                    parts.append(ahead.popleft().result())
                    taken[0] += 1
                wait_s = time.perf_counter() - t0
                submit(taken[0] + self.num_workers)
                batch = collate_scenes([sample for sample, _ in parts])
                indices = [order[p] for p in bt]
                batch["index"] = indices if self.per_rank > 1 else indices[0]
                batch["load_s"] = sum(s for _, s in parts)
                batch["wait_s"] = wait_s
                yield batch
            for index in order[cursor[0]:]:      # the epoch's other draws
                self._draw(index)
        finally:
            pool.shutdown(wait=True, cancel_futures=True)

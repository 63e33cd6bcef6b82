"""Batches of scenes: collation and a shuffled loader that reads one batch
ahead.

Port of ``cnrma_tpu/data/loader.py``'s ``collate_scenes`` (a copy) and of
``SceneLoader``'s order at one scene a batch (a training batch holds one
scene here): the scenes of each epoch are shuffled by a
``np.random.RandomState`` seeded once, so consecutive epochs take
consecutive shuffles.  One reader thread reads the next batch while the
caller trains on this one, and no more: at most two batches are alive.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
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
    with ``batch_size=1, shuffle=True``).  Each batch also carries
    ``load_s`` (the seconds its reading took) and ``wait_s`` (the seconds
    the caller waited for it)."""

    def __init__(self, dataset, seed: Optional[int] = None):
        self.dataset = dataset
        self.rng = np.random.RandomState(seed)

    def __len__(self) -> int:
        return len(self.dataset)

    def order(self) -> List[int]:
        """The next epoch's scene indices."""
        idx = np.arange(len(self.dataset))
        self.rng.shuffle(idx)
        return idx.tolist()

    def _read(self, index: int) -> Dict[str, Any]:
        t0 = time.perf_counter()
        batch = collate_scenes([self.dataset[index]])
        batch["load_s"] = time.perf_counter() - t0
        return batch

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        order = self.order()
        reader = ThreadPoolExecutor(max_workers=1)
        try:
            ahead = reader.submit(self._read, order[0]) if order else None
            for i in range(len(order)):
                t0 = time.perf_counter()
                batch = ahead.result()
                batch["wait_s"] = time.perf_counter() - t0
                ahead = (reader.submit(self._read, order[i + 1])
                         if i + 1 < len(order) else None)
                yield batch
        finally:
            reader.shutdown(wait=True, cancel_futures=True)

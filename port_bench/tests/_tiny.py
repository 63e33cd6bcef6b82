"""A cell cut to a size that a CPU test holds: the same files and code,
the grids, views, images, capacities and pool made small."""

from __future__ import annotations

import contextlib
from typing import Iterator
from unittest import mock

import torch

from port_bench.lib import harness

TINY_CAPS = dict(voxelize=4096, stride2=2048, stride4=1024,
                 levels=[512, 256, 128, 64], neck=[1024, 512, 256])


def shrink(cell: harness.Cell) -> harness.Cell:
    m = cell.config["model"]
    cell.config["image_hw"] = [64, 96]
    if "views" in cell.config:
        cell.config["views"] = {"train": 3, "test": 4}
    if "num_points" in cell.config:
        cell.config["num_points"] = 3000
    m["capacities"] = dict(TINY_CAPS)
    if m.get("type") == "RayMarching":
        m.update(voxel_size=0.4, voxel_dim_test=[32, 32, 16],
                 voxel_dim_train=[32, 32, 16], rays_per_view_cap=2048,
                 max_points=3000, voxel_size_fcaf3d=0.08,
                 ray_samples=120)
        m["tsdf_head"]["voxel_size"] = 0.4
    else:
        m.update(voxel_size=0.08)
    cell.mix["pool"] = 3
    cell.mix["boxes_per_scene"] = cell.mix["boxes_per_scene"][:3]
    return cell


@contextlib.contextmanager
def tiny_cells() -> Iterator[None]:
    """``harness.Cell.load`` gives shrunk cells inside the block."""
    orig = harness.Cell.load.__func__

    def load(cls, *a, **k):
        return shrink(orig(cls, *a, **k))
    with mock.patch.object(harness.Cell, "load", classmethod(load)):
        yield


def run_tiny(workload: str, seed: int = 2 ** 31 + 7, trace: int = 0):
    from port_bench import run
    with tiny_cells():
        return run.main(["--workload", workload, "--seed", str(seed),
                         "--seconds", "0.01", "--trace", str(trace)],
                        device=torch.device("cpu"))

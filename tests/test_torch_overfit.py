"""The port's whole-model learning check (``python -m
cnrma_torch.tools.overfit_full``) on the CPU: its synthetic rooms against
the JAX tool's (``tools/overfit_full.py``, whose scene builder is numpy
only) on one ``RandomState`` seed, equal to the last bit; and a 2-step run
of the port's tool, its two rooms as one batch, that ends with finite
losses."""

import math

import numpy as np
import pytest
import torch

from cnrma_torch.tools import overfit_full as port_tool
from tools import overfit_full as jax_tool
from _torch_threads import _few_threads  # noqa: F401


@pytest.mark.parametrize("yaw_max", [0.0, 0.6], ids=["axis", "yaw"])
def test_scene_builder_matches_the_jax_tool(yaw_max):
    """One scene, its GT TSDFs and two views at 16x24 from the same seed:
    boxes, labels, floor, every TSDF scale, images and projections equal,
    and the random state left where the JAX tool leaves it."""
    got, want = [], []
    for tool, out in ((port_tool, got), (jax_tool, want)):
        rng = np.random.RandomState(0)
        boxes, labels, floor_z = tool.make_scene(rng, 3, yaw_max=yaw_max)
        tsdf = tool.gt_tsdf(boxes, floor_z, (32, 32, 16), 0.1)
        imgs, projs = tool.make_views(rng, boxes, labels, floor_z, 2, 16, 24)
        out.extend([boxes, labels, floor_z, imgs, projs, rng.rand()])
        out.extend(tsdf[k] for k in sorted(tsdf))
    assert len(got) == len(want) == 9
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert (got[3] > 40).any(), "the views see the boxes or the floor"


def test_build_batch_matches_the_jax_tool():
    """The whole two-scene batch of the tool's run (fewer, smaller views)
    equals the JAX tool's, and so do the GT scenes it scores against."""
    kw = dict(n_scenes=2, n_views=2, h=16, w=24, voxel_dim=(32, 32, 16),
              voxel_size=0.1, n_classes=3, yaw_max=0.6)
    got, got_scenes = port_tool.build_batch(np.random.RandomState(0), **kw)
    want, want_scenes = jax_tool.build_batch(np.random.RandomState(0), **kw)
    assert set(got) == set(want)
    for k in want:
        if k == "tsdf_list":
            assert set(got[k]) == set(want[k])
            for s in want[k]:
                np.testing.assert_array_equal(got[k][s], want[k][s])
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for (gb, gl), (wb, wl) in zip(got_scenes, want_scenes):
        np.testing.assert_array_equal(gb, wb)
        np.testing.assert_array_equal(gl, wl)


def test_two_steps_on_the_cpu_end_with_finite_losses(capsys):
    """``--steps 2 --device cpu`` (two views a scene): two steps, each on
    both rooms as one batch, as the JAX tool trains them; finite losses,
    the PASS line printed, and the rule's inputs returned."""
    out = port_tool.run(["--steps", "2", "--views", "2", "--device", "cpu"])
    assert out["steps"] == 2
    for k in ("first", "final", "first_recon", "final_recon"):
        assert math.isfinite(out[k]) and out[k] > 0, k
    assert 0.0 <= out["mAP_0.25"] <= 1.0 and out["peak_gib"] is None
    assert out["ok"] == (out["final"] < 0.6 * out["first"]
                         and out["final_recon"] < 0.5 * out["first_recon"]
                         and out["mAP_0.25"] >= 0.5)
    assert "full overfit check:" in capsys.readouterr().out

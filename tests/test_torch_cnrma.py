"""The whole slice: the tiny ``CNRMA`` test-mode forward of the JAX package
(``tests/test_pipeline.py:tiny_model``) against the PyTorch port with the
same parameters (the port's default initialisation, as flax variables) and
the same subsample draw, fp32 on the CPU.

``ray_samples`` 24 takes the dense march; 64 turns on empty-space skipping,
whose coarse pass runs the JAX Pallas lookup kernel K2 in interpret mode.
Tolerances: 1e-4 on the TSDFs (tanh outputs of three U-Net scales), 1e-5
on point positions, 1e-4 of the scale on point features, and boxes and
scores (ordered by score, as sets) to 1e-4 of their scale.
"""

import jax
import numpy as np
import pytest
import torch

from cnrma_tpu.models import cn_rma as jcn
from test_pipeline import tiny_model
from test_torch_bridge import tiny_torch_cnrma, torch_module
from _torch_threads import _few_threads  # noqa: F401


@pytest.fixture(scope="module")
def tiny_init():
    """The tiny model's batch, and the port's default initialisation
    (``torch.manual_seed(0)``) as its flax variables: JAX's ``init`` of
    the whole model would be one more compile of its forward."""
    from test_torch_stages import _flax_tree
    _, batch = tiny_model()
    torch.manual_seed(0)
    return batch, _flax_tree(tiny_torch_cnrma().state_dict())


def _jax_forward(batch, variables, ray_samples):
    """JAX test forward; returns its outputs and the uniform draw of the
    subsample (read out of ``_normalize_subsample`` with a debug
    callback)."""
    model, _ = tiny_model()
    model = model.clone(ray_samples=ray_samples)
    draws = []
    orig = jcn._normalize_subsample

    def spy(flat, rng_b, max_points):
        r = jax.random.uniform(rng_b, (flat.weight.shape[0],))
        jax.debug.callback(lambda x: draws.append(np.asarray(x)), r)
        return orig(flat, rng_b, max_points)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcn, "_normalize_subsample", spy)
        mp.setenv("CNRMA_RAY_PALLAS", "interpret")
        out = jax.jit(lambda v, b: model.apply(
            v, b, train=False, rngs={"sample": jax.random.PRNGKey(0)}))(
                variables, batch)
        out = jax.device_get(out)
    assert len(draws) == 1
    return out, draws[0]


@pytest.fixture(scope="module", params=[24, 64], ids=["dense", "skip"])
def slice_outputs(request, tiny_init):
    batch, variables = tiny_init
    want, draw = _jax_forward(batch, variables, request.param)
    port = torch_module(tiny_torch_cnrma(ray_samples=request.param),
                        variables)
    tbatch = {k: torch.from_numpy(np.array(batch[k]))
              for k in ("imgs", "projection", "view_valid", "offset")}
    got = port(tbatch, uniform=torch.from_numpy(np.array(draw))[None])
    return want, got


def test_tsdf_scales(slice_outputs):
    want, got = slice_outputs
    assert set(got["tsdf"]) == set(want["tsdf"]) == {
        "scene_tsdf_040", "scene_tsdf_020", "scene_tsdf_010"}
    for k, w in want["tsdf"].items():
        np.testing.assert_allclose(got["tsdf"][k].numpy(), np.asarray(w),
                                   atol=1e-4, err_msg=k)


def test_point_cloud(slice_outputs):
    """Same kept points in the same slots (same draw, same slot order)."""
    want, got = slice_outputs
    wv = np.asarray(want["points"].valid)
    np.testing.assert_array_equal(got["points"].valid.numpy(), wv)
    assert wv.sum() > 50
    np.testing.assert_allclose(got["points"].xyz.numpy()[wv],
                               np.asarray(want["points"].xyz)[wv], atol=1e-5)
    wf = np.asarray(want["points"].feats)[wv]
    np.testing.assert_allclose(got["points"].feats.numpy()[wv], wf,
                               atol=1e-4 * np.abs(wf).max())


def test_boxes_and_scores(slice_outputs):
    want, got = slice_outputs

    def ordered(b, s, v):
        b, s, v = np.asarray(b[0]), np.asarray(s[0]), np.asarray(v[0])
        o = np.argsort(-s[v].max(1), kind="stable")
        return b[v][o], s[v][o]
    wb, ws = ordered(want["bboxes"], want["scores"], want["bbox_valid"])
    gb, gs = ordered(got["bboxes"], got["scores"], got["bbox_valid"])
    assert len(wb) == len(gb) > 0
    assert got["bboxes"].shape == want["bboxes"].shape
    np.testing.assert_allclose(gs, ws, atol=1e-4 * np.abs(ws).max())
    np.testing.assert_allclose(gb, wb, atol=1e-4 * np.abs(wb).max())

"""Parity of the port's volume accumulation (``cnrma_torch/ops/
backproject.py``, the plain version the CUDA kernel is held against on the
card) with the JAX package, on the CPU.

The dense JAX path (``tile=0``) sums chunks of four views before adding
them to the fp32 accumulator, the port sums view by view: the sums differ
in order only, so volumes agree to 1e-6 on features in [0, 1] and the
valid masks and view counts are equal.  The JAX rect path runs its Pallas
kernel K1 in interpret mode at an uncapped shape, where it equals the
dense path.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnrma_torch.ops import backproject as tbp
from cnrma_torch.synthetic import ring_projections
from cnrma_tpu.ops import backproject as jbp
from _torch_threads import _few_threads  # noqa: F401


def simple_projection():
    """The camera of ``tests/test_ops.py``."""
    K = np.array([[10.0, 0, 8.0], [0, 10.0, 6.0], [0, 0, 1]], np.float32)
    E = np.eye(4, dtype=np.float32)
    E[:3, 3] = [0.0, 0.0, -2.0]
    return (K @ np.linalg.inv(E)[:3]).astype(np.float32)


def _scene(seed, views, h, w, c, dim, vs):
    rng = np.random.RandomState(seed)
    feats = rng.rand(views, h, w, c).astype(np.float32)
    proj = ring_projections(views, 4 * h, 4 * w, dim, vs)
    proj[:, :2, :] /= 4
    proj[:, :, 3] += rng.randn(views, 3).astype(np.float32) * 0.3
    valid = np.ones(views, bool)
    valid[views // 2] = False
    return proj, feats, valid


@pytest.mark.parametrize("seed", [0, 1])
def test_project_indices_equal(seed):
    """Pixel ids and validity are computed in the same fp32 operation
    order, so they are equal."""
    proj, _, _ = _scene(seed, 3, 24, 32, 4, (20, 16, 12), 0.3)
    origin = (-0.4, 0.2, 0.1)
    for p in proj:
        jf, jv = jbp._project_indices(jnp.asarray(p), (20, 16, 12), 0.3,
                                      jnp.asarray(origin, jnp.float32),
                                      24, 32)
        tf, tv = tbp.project_voxels(torch.from_numpy(p), (20, 16, 12), 0.3,
                                    origin, 24, 32)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))


@pytest.mark.parametrize("views,h,w,c,dim", [(5, 24, 32, 32, (20, 16, 12)),
                                             (3, 12, 16, 4, (16, 16, 8))])
def test_accumulate_matches_dense(views, h, w, c, dim):
    proj, feats, valid = _scene(views, views, h, w, c, dim, 0.3)
    origin = (0.1, -0.2, 0.05)
    jvol, jok = jbp.accumulate_views(
        jnp.asarray(proj), jnp.asarray(feats), jnp.asarray(valid), dim, 0.3,
        jnp.asarray(origin, jnp.float32))
    tvol, tok = tbp.accumulate_views(
        torch.from_numpy(proj), torch.from_numpy(feats),
        torch.from_numpy(valid), dim, 0.3, origin)
    assert np.asarray(jok).any() and not np.asarray(jok).all()
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    np.testing.assert_allclose(tvol.numpy(), np.asarray(jvol), atol=1e-6)
    # the view counts behind the mean are equal too
    _, jcnt = jbp.accumulate_views_partial(
        jnp.asarray(proj), jnp.asarray(feats), jnp.asarray(valid), dim, 0.3,
        jnp.asarray(origin, jnp.float32))
    _, tcnt, _ = tbp.volume_accum_plain(
        torch.from_numpy(proj), torch.from_numpy(feats),
        torch.from_numpy(valid), dim, 0.3, origin)
    np.testing.assert_array_equal(tcnt.numpy(), np.asarray(jcnt))


def test_accumulate_bfloat16_within_one_ulp():
    """bf16 features, fp32 sums: the means agree to one bf16 ulp (the
    summation orders differ, the final rounding to bf16 may not)."""
    proj, feats, valid = _scene(7, 6, 24, 32, 32, (20, 16, 12), 0.3)
    jvol, _ = jbp.accumulate_views(
        jnp.asarray(proj), jnp.asarray(feats, jnp.bfloat16),
        jnp.asarray(valid), (20, 16, 12), 0.3, jnp.zeros(3, jnp.float32))
    tvol, _ = tbp.accumulate_views(
        torch.from_numpy(proj), torch.from_numpy(feats).bfloat16(),
        torch.from_numpy(valid), (20, 16, 12), 0.3, (0.0, 0.0, 0.0),
        accum_dtype="bfloat16")
    assert tvol.dtype == torch.bfloat16
    want = np.asarray(jvol.astype(jnp.float32))
    err = np.abs(tvol.float().numpy() - want)
    assert np.all(err <= 2.0 ** -7 * np.abs(want))


def test_accumulate_matches_rect_pallas_interpret(monkeypatch):
    """Against the JAX rect path with the Pallas rect kernel (K1) in
    interpret mode, at the uncapped shape of ``tests/test_ops.py``
    (``test_rect_pallas_matches_dense``): same volume to 1e-6, same mask."""
    monkeypatch.setenv("CNRMA_BP_PALLAS", "interpret")
    rng = np.random.RandomState(5)
    V, H, W, C = 2, 16, 32, 32
    dim = (16, 16, 8)
    feats = rng.rand(V, H, W, C).astype(np.float32)
    projs = np.stack([simple_projection()] * V).astype(np.float32)
    projs[1, :2, 3] += 1.0
    valid = np.array([True, True])
    origin = (-1.9, -0.1, 0.1)
    jvol, jok = jbp.accumulate_views(
        jnp.asarray(projs), jnp.asarray(feats), jnp.asarray(valid), dim,
        0.25, jnp.asarray(origin, jnp.float32), tile=8, tile_capacity=4,
        rect=(16, 32), rect_capacity=4)
    tvol, tok = tbp.accumulate_views(
        torch.from_numpy(projs), torch.from_numpy(feats),
        torch.from_numpy(valid), dim, 0.25, origin)
    assert np.asarray(jok).any()
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    np.testing.assert_allclose(tvol.numpy(), np.asarray(jvol), atol=1e-6)


def test_cpu_wrapper_uses_plain_and_counts_no_launch():
    """On CPU tensors the wrapper runs the plain version; the kernel's
    launch counter counts only kernel launches."""
    proj, feats, valid = _scene(3, 2, 12, 16, 32, (8, 8, 8), 0.3)
    before = tbp.VOLUME_ACCUM.launches
    got = tbp.volume_accum(torch.from_numpy(proj), torch.from_numpy(feats),
                           torch.from_numpy(valid), (8, 8, 8), 0.3,
                           (0.0, 0.0, 0.0))
    want = tbp.volume_accum_plain(torch.from_numpy(proj),
                                  torch.from_numpy(feats),
                                  torch.from_numpy(valid), (8, 8, 8), 0.3,
                                  (0.0, 0.0, 0.0))
    assert tbp.VOLUME_ACCUM.launches == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)

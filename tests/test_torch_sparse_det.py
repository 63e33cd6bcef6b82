"""Parity of the port's sparse stack and FCAF3D detector
(``cnrma_torch/ops/voxelize.py``, ``sparse.py``, ``models/fcaf3d.py``)
with the JAX package, fp32 on the CPU.

The JAX package takes its LUT and parent-derived kernel maps where they
are eligible; the port always searches sorted keys.  Both give the same
neighbour relations, so keys, coordinates and found masks are equal and
features agree to 1e-5 (sums in another order).  Tensors whose row order
may differ (the JAX decoder leaves pruned levels in score order) are
compared row by row per coordinate, sorted by key.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnrma_torch.models import fcaf3d as tdet
from cnrma_torch.ops import sparse as tsp
from cnrma_torch.ops.voxelize import SENTINEL_KEY
from cnrma_tpu.models import fcaf3d as jdet
from cnrma_tpu.ops import sparse as jsp
from test_torch_bridge import randomize_stats, torch_module
from test_torch_test_cli import _flax_tree_from_torch
from _torch_threads import _few_threads  # noqa: F401


def _t(x):
    return torch.from_numpy(np.array(x))


def _cloud(seed, n=600, c=8, extent=1.6):
    rng = np.random.RandomState(seed)
    pts = (rng.rand(n, 3) * extent).astype(np.float32)
    pts[: n // 4] = pts[n // 4: n // 2] + 0.004     # duplicate voxels
    feats = rng.randn(n, c).astype(np.float32)
    valid = rng.rand(n) > 0.1
    return pts, feats, valid


def _pair(seed, stride=1, capacity=2048, c=8):
    """The same stride-``stride`` tensor in both packages."""
    pts, feats, valid = _cloud(seed, c=c)
    jst = jsp.voxelize_points(jnp.asarray(pts), jnp.asarray(feats),
                              jnp.asarray(valid), 0.05 * stride, capacity)
    ok = np.asarray(jst.valid)
    coords = np.where(ok[:, None], np.asarray(jst.coords) * stride,
                      np.asarray(jst.coords))
    keys = np.asarray(jst.grid.pack(jnp.asarray(coords)))
    keys = np.where(ok, keys, SENTINEL_KEY).astype(np.int32)
    jst = jsp.SparseTensor(keys=jnp.asarray(keys), coords=jnp.asarray(coords),
                           feats=jst.feats, stride=stride)
    tst = tsp.SparseTensor(keys=_t(keys), coords=_t(coords),
                           feats=_t(jst.feats), stride=stride)
    return jst, tst


def _assert_same(jst, tst, atol=1e-5):
    np.testing.assert_array_equal(tst.keys.numpy(), np.asarray(jst.keys))
    ok = np.asarray(jst.valid)
    np.testing.assert_array_equal(tst.coords.numpy()[ok],
                                  np.asarray(jst.coords)[ok])
    np.testing.assert_allclose(tst.feats.detach().numpy()[ok],
                               np.asarray(jst.feats)[ok], atol=atol)
    assert tst.stride == jst.stride


@pytest.mark.parametrize("capacity", [2048, 256])
def test_voxelize_points(capacity):
    """Mean-reduced voxelization; at capacity 256 the lowest keys win in
    both packages."""
    pts, feats, valid = _cloud(0)
    jst = jsp.voxelize_points(jnp.asarray(pts), jnp.asarray(feats),
                              jnp.asarray(valid), 0.05, capacity)
    tst = tsp.voxelize_points(_t(pts), _t(feats), _t(valid), 0.05, capacity)
    _assert_same(jst, tst, atol=1e-6)
    assert 0 < int(tst.valid.sum()) <= capacity


@pytest.mark.parametrize("stride", [1, 4])
def test_kernel_map(stride):
    """Stride 1 takes the JAX search path, stride 4 its LUT path."""
    jst, tst = _pair(1, stride)
    offs = jsp.kernel_offsets(3)
    jidx, jfound = jsp.kernel_map(jst, offs)
    tidx, tfound = tsp.kernel_map(tst, offs)
    np.testing.assert_array_equal(tfound.numpy(), np.asarray(jfound))
    f = np.asarray(jfound)
    assert f.sum() > f[13].sum()                 # real neighbours found
    np.testing.assert_array_equal(tidx.numpy()[f], np.asarray(jidx)[f])


def test_subm_conv():
    jst, tst = _pair(2, 2)
    w = np.random.RandomState(0).randn(27, 8, 5).astype(np.float32)
    _assert_same(jsp.subm_conv(jst, jnp.asarray(w)), tsp.subm_conv(tst, _t(w)))


@pytest.mark.parametrize("k", [3, 1])
def test_strided_conv(k):
    """k3 s2 and k1 s2 (the JAX package's parent-derived kernel maps)."""
    jst, tst = _pair(3, 2)
    w = np.random.RandomState(k).randn(k ** 3, 8, 6).astype(np.float32)
    offs = jsp.kernel_offsets(3) if k == 3 else np.zeros((1, 3), np.int32)
    _assert_same(jsp.strided_conv(jst, jnp.asarray(w), 2, 600, offsets=offs),
                 tsp.strided_conv(tst, _t(w), 2, 600, offsets=offs))


def test_max_pool():
    jst, tst = _pair(4, 1)
    _assert_same(jsp.max_pool(jst, 2, 700), tsp.max_pool(tst, 2, 700),
                 atol=0)


@pytest.fixture(scope="module")
def decoder_level():
    """A stride-8 parent, its p-major children (stride 4), a stride-4 skip
    tensor and the parent's 27-neighbour map, in both packages."""
    jpar, tpar = _pair(5, 8, capacity=256)
    w = np.random.RandomState(5).randn(8, 8, 8).astype(np.float32)
    jch = jsp.generative_transpose_conv(jpar, jnp.asarray(w), sort=False)
    tch = tsp.generative_transpose_conv(tpar, _t(w))
    jskip, tskip = _pair(6, 4, capacity=512)
    offs = jsp.kernel_offsets(3)
    return (jpar, tpar, jch, tch, jskip, tskip, jsp.kernel_map(jpar, offs),
            tsp.kernel_map(tpar, offs))


def test_generative_transpose_conv(decoder_level):
    _, _, jch, tch, *_ = decoder_level
    assert tch.stride == 4 and tch.capacity == 8 * 256
    _assert_same(jch, tch)


def test_add_skip_into_children(decoder_level):
    jpar, tpar, jch, tch, jskip, tskip, _, _ = decoder_level
    got = tsp.add_skip_into_children(tch, tskip, tpar.keys)
    want = jsp.add_skip_into_children(jch, jskip, jpar.keys, parent=jpar)
    assert not np.allclose(np.asarray(want.feats), np.asarray(jch.feats))
    _assert_same(want, got)


def test_interpolate_children_scores(decoder_level):
    jpar, tpar, _, _, _, _, jkmap, tkmap = decoder_level
    s = np.random.RandomState(7).randn(256).astype(np.float32)
    want = jsp.interpolate_children_scores(jnp.asarray(s), jkmap, jpar.valid)
    got = tsp.interpolate_children_scores(_t(s), tkmap, tpar.valid)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("keep", [100, 2048])
def test_prune_topk(decoder_level, keep):
    _, _, jch, tch, *_ = decoder_level
    s = np.random.RandomState(keep).randn(8 * 256).astype(np.float32)
    _assert_same(jsp.prune_topk(jch, jnp.asarray(s), keep, sort=True),
                 tsp.prune_topk(tch, _t(s), keep), atol=0)


def test_interpolate_at():
    jst, tst = _pair(8, 4)
    rng = np.random.RandomState(8)
    pos = (rng.rand(300, 3) * 32).astype(np.float32)
    ok = rng.rand(300) > 0.2
    want = jsp.interpolate_at(jst, jnp.asarray(pos), jnp.asarray(ok))
    got = tsp.interpolate_at(tst, _t(pos), _t(ok))
    assert np.abs(np.asarray(want)).max() > 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_decode_bbox_yaw_guard():
    """All three yaw parametrizations, including the degenerate
    (sin, cos) == (0, 0) rows that the JAX guard handles."""
    rng = np.random.RandomState(9)
    pts = rng.randn(20, 3).astype(np.float32)
    pred = np.abs(rng.randn(20, 8)).astype(np.float32)
    pred[:5, 6:] = 0.0
    for mode in ("fcaf3d", "sin-cos", "naive"):
        want = jdet.decode_bbox(jnp.asarray(pts), jnp.asarray(pred), mode)
        got = tdet.decode_bbox(_t(pts), _t(pred), mode)
        assert np.isfinite(got.numpy()).all()
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_decode_bbox_overflow_rows():
    """Face distances past fp32 decode to the same infinite boxes in both
    packages; ``overflowed_rows`` counts exactly those rows and refuses any
    other value that is not finite."""
    from cnrma_torch.tools.overflow_survey import overflowed_rows
    rng = np.random.RandomState(10)
    pts = rng.randn(12, 3).astype(np.float32)
    reg = rng.randn(12, 6).astype(np.float32)
    reg[2, 0] = 90.0                    # one face of x: x is -inf
    reg[5, [2, 3]] = 95.0               # both faces of y: y is NaN
    reg[7, 5] = 200.0                   # one face of z: z is +inf
    with np.errstate(over="ignore"):
        pred = np.exp(reg)
    want = np.asarray(jdet.decode_bbox(jnp.asarray(pts), jnp.asarray(pred)))
    got = tdet.decode_bbox(_t(pts), _t(pred)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert overflowed_rows(got) == 3
    assert overflowed_rows(got[np.isfinite(got).all(axis=1)]) == 0
    for row, col, value in ((0, 4, np.nan), (1, 0, np.inf), (3, 5, -np.inf)):
        broken = got.copy()
        broken[row, col] = value
        assert overflowed_rows(broken) is None


@pytest.mark.parametrize("n_reg", [6, 8])
def test_head_overflow_rows(n_reg):
    """``head_overflow`` counts the head's valid rows whose face distances
    or (yaw) ``q`` pass fp32 in ``exp``, where the decoded box is not
    finite, apart from the rows not finite for another reason; invalid
    rows are not read."""
    from cnrma_torch.tools.overflow_survey import head_overflow
    rng = np.random.RandomState(11)
    reg = rng.randn(10, n_reg).astype(np.float32)
    reg[1, 0] = 95.0                    # a face distance past fp32
    reg[9, 3] = 95.0                    # the same in an invalid row
    if n_reg == 8:
        reg[2, 6:] = 70.0               # |(sin, cos)| 99: q past fp32
    dist = _t(reg[:, :6]).exp()
    pred = torch.cat([dist, _t(reg[:, 6:])], dim=1)
    pred[4, 2] = float("nan")           # not from exp's overflow
    pred[8, 1] = float("nan")           # invalid row
    cls = _t(rng.randn(10, 3).astype(np.float32))
    cls[6, 0] = float("inf")
    valid = torch.ones(10, dtype=torch.bool)
    valid[8:] = False
    lvl = tdet.LevelOut(_t(rng.randn(10).astype(np.float32)), pred, cls,
                        _t(rng.randn(10, 3).astype(np.float32)), valid)
    over = 2 if n_reg == 8 else 1
    assert head_overflow([lvl, lvl]) == (2 * over, 4)
    boxes = tdet.decode_bbox(lvl.points, pred)
    finite = torch.isfinite(boxes).all(dim=1)
    assert not finite[1] and (n_reg == 6 or not finite[2])
    assert finite[[0, 3, 5, 7]].all()


# DetectionCapacities.tiny(); the coarsest level holds one voxel, so levels
# 2, 1, 0 have 8, 64, 512 children, all within the neck capacities when the
# point threshold does not cut them
CAPS = jdet.DetectionCapacities.tiny()._asdict()
PTS_THRESHOLD = 2000


@pytest.fixture(scope="module")
def detector():
    pts, feats, valid = _cloud(10, n=600, c=32)
    args = (jnp.asarray(pts[None]), jnp.asarray(feats[None]),
            jnp.asarray(valid[None]))
    module = jdet.FCAF3DDetector(n_classes=3, voxel_size=0.05,
                                 pts_threshold=PTS_THRESHOLD, nms_pre=16,
                                 capacities=jdet.DetectionCapacities(**CAPS))
    torch.manual_seed(0)
    port = tdet.FCAF3DDetector(
        in_channels=32, n_classes=3, voxel_size=0.05,
        pts_threshold=PTS_THRESHOLD, nms_pre=16,
        capacities=tdet.DetectionCapacities(**CAPS))
    variables = randomize_stats(_flax_tree_from_torch(
        port.state_dict(), jax.eval_shape(lambda *a: module.init(
            jax.random.PRNGKey(0), *a, train=False), *args)), 11)

    def run(v, *a):
        outs = module.apply(v, *a, train=False)
        return outs, module.get_bboxes(outs)
    levels, boxes = jax.device_get(jax.jit(run)(variables, *args))
    port = torch_module(port, variables)
    with torch.no_grad():
        tlevels = port(_t(pts[None]), _t(feats[None]), _t(valid[None]))
        tboxes = port.get_bboxes(tlevels)
    return levels, boxes, tlevels, tboxes


def _rows(level):
    """Valid rows of one scene's level output keyed by coordinate."""
    valid = np.asarray(level.valid[0])
    pts = np.asarray(level.points[0])[valid]
    order = np.lexsort(pts.T[::-1])
    cat = np.concatenate([np.asarray(level.centerness[0])[valid, None],
                          np.asarray(level.bbox_pred[0])[valid],
                          np.asarray(level.cls_scores[0])[valid]], axis=1)
    return pts[order], cat[order]


def test_detector_levels(detector):
    """Per level: the same valid coordinates and head outputs (to 1e-4 of
    their scale).  Every pruned level kept all its children (8 per valid
    parent), so slot order cannot change the kept sets."""
    levels, _, tlevels, _ = detector
    n_valid = [int(t.valid.sum()) for t in tlevels]
    assert n_valid[:3] == [8 * n for n in n_valid[1:]]
    for jl, tl in zip(levels, tlevels):
        jp, jv = _rows(jl)
        tp, tv = _rows(tl)
        assert len(jp) > 0
        np.testing.assert_array_equal(tp, jp)
        np.testing.assert_allclose(tv, jv, atol=1e-4 * np.abs(jv).max())


def test_detector_get_bboxes(detector):
    """Boxes and scores as sets ordered by score."""
    _, (jb, js, jv), _, (tb, ts, tv) = detector

    def ordered(b, s, v):
        b, s, v = np.asarray(b[0]), np.asarray(s[0]), np.asarray(v[0])
        o = np.argsort(-s[v].max(1), kind="stable")
        return b[v][o], s[v][o]
    jb, js = ordered(jb, js, jv)
    tb, ts = ordered(tb, ts, tv)
    assert len(jb) == len(tb) > 0
    np.testing.assert_allclose(ts, js, atol=1e-5)
    np.testing.assert_allclose(tb, jb, atol=1e-4 * np.abs(jb).max())

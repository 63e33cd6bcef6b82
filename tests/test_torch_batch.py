"""Training batches of more than one scene in the port, against the JAX
package, fp32 on the CPU.

The batch's one new piece of arithmetic is the sparse batch norms'
statistics over every scene's valid rows (JAX ``MaskedBatchNorm`` over
[B, N, C]); the rest is the one-scene ops run scene by scene.  Held here:

* ``MaskedBatchNorm`` on [2, N, C]: outputs, gradients and running
  statistics within 1e-6 of the largest magnitude;
* the whole tiny ``CNRMA`` training step at B = 2 against JAX's
  ``value_and_grad`` on two scenes, with JAX's B subsample and
  augmentation draws and its kept points passed in, at
  ``test_torch_train.STEP_LIMITS``; the ``Atlas`` step at B = 2 at the same
  limits; the ``FCAF3DOnly`` step at B = 2: its losses within 1e-4
  relative, every gradient leaf within 1e-3 of its largest, the running
  statistics within 1e-5;
* the same steps with the old per-scene statistics planted in the sparse
  norms, which must break those limits;
* the loader: batches of B at world size 1 equal to JAX's ``SceneLoader``,
  contiguous blocks of B / W a rank at W = 2 (and in the train CLI on two
  ``gloo`` ranks, spawned);
* the train CLI at ``--batch-size 2`` (2 steps an epoch of 5 scenes, the
  val split scored in batches of 2) and ``--batch-size 3`` refused at
  W = 2;
* ``evaluate_val`` at B = 2 against JAX's, with a partial last batch, and
  a test forward at B = 2 equal to one scene at a time.
"""

import hashlib
import json
import math
import os
import pickle
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnrma_torch.core.builder import build_dataset, build_model
from cnrma_torch.core.config import Config
from cnrma_torch.data.loader import SceneLoader
from cnrma_torch.models import cn_rma as tcn
from cnrma_torch.models import layers as tl
from cnrma_torch.synthetic import (
    synthesize_parameters, write_point_dumps, write_scannet)
from cnrma_torch.train import loop as tloop
from _torch_spawn import spawn
from _torch_threads import _few_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAGE2 = os.path.join(REPO, "configs", "fcaf3d_middle_scannet.py")
CAPS = ("{'voxelize':256,'stride2':128,'stride4':64,"
        "'levels':(32,16,8,8),'neck':(64,32,16)}")
B = 2                       # scenes a batch
N_SCENES = 5                # the CLI's train split: 2 steps an epoch at B = 2
N_VAL = 3                   # its val split: batches of 2 and 1
TIME_LIMIT = 240            # seconds the spawned ranks may take
T = torch.from_numpy


def _close_scaled(got, want, tol=1e-6):
    want = np.asarray(want)
    np.testing.assert_allclose(
        np.asarray(got), want, rtol=0,
        atol=tol * max(1.0, float(np.abs(want).max())))


def _per_scene_statistics(monkeypatch):
    """The planted fault: the sparse batch norms take each scene's own
    statistics and update the running ones once a scene (the one-scene
    loop run over a batch)."""
    real = tl.MaskedBatchNorm.forward

    def per_scene(self, feats, mask):
        if feats.dim() == 2 or not self.training:
            return real(self, feats, mask)
        return torch.stack([real(self, f, m) for f, m in zip(feats, mask)])
    monkeypatch.setattr(tl.MaskedBatchNorm, "forward", per_scene)


# --- the sparse batch norm ---------------------------------------------------

def test_masked_batch_norm_pools_the_batch():
    """Training statistics over both scenes' valid rows: outputs, the
    gradients of the features and affine parameters, and the running
    statistics against JAX's ``MaskedBatchNorm`` on [2, N, C]; one scene
    alone gives other statistics."""
    from cnrma_tpu.models import layers as jl
    from test_torch_bridge import randomize_stats, torch_module
    rng = np.random.RandomState(4)
    x = (rng.randn(B, 40, 8) * 3 + 1).astype(np.float32)
    x[1] += 2.0                      # the scenes' means differ
    mask = rng.rand(B, 40) > 0.3
    module = jl.MaskedBatchNorm()
    variables = randomize_stats(module.init(
        jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(mask),
        train=False), 2)
    r = rng.randn(*x.shape).astype(np.float32)

    def f(xx, params):
        y, mutated = module.apply({**variables, "params": params}, xx,
                                  jnp.asarray(mask), train=True,
                                  mutable=["batch_stats"])
        return jnp.sum(y * r), (y, mutated["batch_stats"])
    (_, (want, stats)), (gx, gp) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(jnp.asarray(x), variables["params"])
    port = torch_module(tl.MaskedBatchNorm(8), variables).train()
    xt = T(x).requires_grad_()
    y = port(xt, T(mask))
    (y * T(r)).sum().backward()
    _close_scaled(y.detach(), want)
    _close_scaled(xt.grad, gx)
    _close_scaled(port.weight.grad, gp["scale"])
    _close_scaled(port.bias.grad, gp["bias"])
    _close_scaled(port.running_mean, stats["mean"])
    _close_scaled(port.running_var, stats["var"])
    alone = torch_module(tl.MaskedBatchNorm(8), variables).train()
    alone(T(x[0]), T(mask[0]))
    assert not torch.allclose(alone.running_mean, port.running_mean,
                              atol=1e-3)


# --- whole training steps against JAX ----------------------------------------

# The limits of a step on two scenes: ``test_torch_train.STEP_LIMITS``'
# numbers, with its treatment of the R-50 trunk (a group's cosine and
# relative L2 error, and each leaf's cosine) given to every part whose
# gradient the JAX package's own compiled step does not reproduce leaf by
# leaf at two scenes.  At two scenes the tiny dense path is chaotic in
# fp32: some of the 3D U-Net's norms see a variance under their epsilon,
# which ``E[x^2] - E[x]^2`` rounds, and a change of one ulp in JAX's own
# images moves its U-Net and 2D-tower leaves by up to 5.2% (seed 0), its
# leaf-by-leaf agreement with the port by as much; the port's own change
# for one ulp is 6e-5.  The detector's compiled graph in JAX rounds
# otherwise at two scenes than at one (ROADMAP F6): it moves one scene's
# eval class scores by 5e-3 between a batch of one and the same scene
# twice, where its ops run one by one agree within 3e-6.
BATCH_LIMITS = {"losses": 1e-4, "leaf": 1e-3, "group_cos": 0.999,
                "group_err": 0.02, "leaf_cos": 0.99, "stats": 1e-5}
DENSE_GROUPS = ("tower2d.resnet.", "tower2d.fpn.", "tower2d.fuse.",
                "backbone3d.")
DETECTOR_GROUPS = ("detector.backbone.", "detector.head.")


def _readings(port, losses, want, groups):
    """The readings of ``BATCH_LIMITS`` for ``port`` after one training
    forward (``losses``) and its backward, against JAX's ``want``: the
    losses (relative), the leaves outside ``groups`` (of each leaf's
    largest magnitude), each group (cosine, relative L2 error) and its
    leaves (cosine), the running statistics (absolute); each with its
    worst leaf or group."""
    from cnrma_torch.bridge import _convert
    from test_torch_train import _cosine, _path, _port_grads
    got = _port_grads(port)
    grads = {}
    for path, g in jax.tree_util.tree_leaves_with_path(want["grads"]):
        key, arr = _convert("params", _path(path), np.asarray(g))
        grads[key] = arr
    assert set(grads) == set(got)
    grouped = [k for k in got if k.startswith(groups)]
    r = {"losses": max((abs(float(losses[k].detach()) / float(w) - 1), k)
                       for k, w in want["losses"].items() if float(w)),
         "leaf": max([(float(np.abs(got[k] - grads[k]).max()
                             / max(float(np.abs(grads[k]).max()), 1e-30)),
                       k) for k in got if k not in grouped] or [(0.0, "")]),
         "leaf_cos": min((_cosine(got[k], grads[k]), k) for k in grouped)}
    sums = []
    for name in groups:
        keys = [k for k in got if k.startswith(name)]
        a = np.concatenate([got[k].ravel() for k in keys]).astype(np.float64)
        b = np.concatenate([grads[k].ravel() for k in keys]
                           ).astype(np.float64)
        sums.append((_cosine(a, b), float(np.linalg.norm(a - b)
                                          / np.linalg.norm(b)), name[:-1]))
    r["group_cos"] = min((c, n) for c, _, n in sums)
    r["group_err"] = max((e, n) for _, e, n in sums)
    buffers = dict(port.named_buffers())
    stats = []
    for path, st in jax.tree_util.tree_leaves_with_path(want["stats"]):
        key, _ = _convert("batch_stats", _path(path), np.asarray(st))
        stats.append((float(np.abs(buffers[key].numpy() - st).max()), key))
    r["stats"] = max(stats)
    return r


def _failures(r):
    """The limits of ``BATCH_LIMITS`` that the readings ``r`` break."""
    return sorted(k for k, lim in BATCH_LIMITS.items()
                  if (r[k][0] < lim if k.endswith("cos") else r[k][0] > lim))


def _step(port, tb, **kw):
    """One training forward and backward of ``port``: its losses."""
    from cnrma_torch.train.loop import total_loss
    port.train()
    losses = port.forward_train(tb, **kw)
    port.zero_grad(set_to_none=True)
    total_loss(losses).backward()
    return losses


def batch_views():
    """Two scenes of two 64x64 views (``test_torch_train.step_views``'s
    camera), random pixels (seed 0)."""
    rng = np.random.RandomState(0)
    intr = np.array([[60.0, 0, 32], [0, 60.0, 32], [0, 0, 1]], np.float32)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [0.8, 0.8, -0.4]
    proj = (intr @ np.linalg.inv(pose)[:3]).astype(np.float32)
    return {"imgs": jnp.asarray(rng.rand(B, 2, 64, 64, 3).astype(np.float32)
                                * 255),
            "projection": jnp.asarray(np.broadcast_to(proj, (B, 2, 3, 4)))}


def _torch_batch(batch):
    tb = {k: T(np.array(v)) for k, v in batch.items() if k != "tsdf_list"}
    tb["tsdf_list"] = {k: T(np.array(v))
                       for k, v in batch["tsdf_list"].items()}
    return tb


def _aug_spy(aug, draws):
    """``feature_transform_aug`` that reads out each scene's draws, in
    scene order."""
    def spy(r, points, boxes, with_yaw, **cfg):
        kf, kv, kr, ks, kt = jax.random.split(r, 5)
        u = (jax.random.uniform(kf), jax.random.uniform(kv),
             jax.random.uniform(kr, minval=-0.087266, maxval=0.087266),
             jax.random.uniform(ks, minval=0.9, maxval=1.1),
             jax.random.normal(kt, (3,)) * jnp.asarray([0.1, 0.1, 0.1]))
        jax.debug.callback(lambda *a: draws.append(
            [np.asarray(x) for x in a]), *u, ordered=True)
        return aug(r, points, boxes, with_yaw, **cfg)
    return spy


def _aug_draws(draws):
    return [{"flip_h": torch.tensor(bool(u_h < 0.5)),
             "flip_v": torch.tensor(bool(u_v < 0.5)),
             "angle": torch.tensor(float(angle)),
             "scale": torch.tensor(float(scale)), "trans": T(np.array(trans))}
            for u_h, u_v, angle, scale, trans in draws]


def _no_remat(monkeypatch):
    """JAX's ``CNRMA`` and ``Atlas`` build their U-Net without
    ``nn.remat``: the same gradients bit for bit, and a sixth less to
    trace at two scenes."""
    from cnrma_tpu.models import cn_rma as jcn
    unet = jcn.UNet3D
    monkeypatch.setattr(jcn, "UNet3D",
                        lambda **kw: unet(**dict(kw, remat=False)))


@pytest.fixture(scope="module")
def cnrma_step():
    """JAX's ``value_and_grad`` of the tiny CNRMA's training forward on two
    scenes (``tests/test_pipeline.py:tiny_model(batch=2)`` at 1 cm
    detector voxels, the views of ``batch_views``), with each scene's
    subsample draw, kept points and augmentation draw read out; the port's
    batch and draws on the same parameters (``synthesize_parameters``,
    seed 1).  JAX's U-Net runs without its recompute
    (``_no_remat``)."""
    from cnrma_tpu.models import cn_rma as jcn
    from test_pipeline import tiny_model
    from test_torch_bridge import tiny_torch_cnrma
    from test_torch_stages import _flax_tree
    from test_torch_train import STEP_FCAF3D_VOXEL
    model, batch = tiny_model(batch=B)
    model = model.clone(voxel_size_fcaf3d=STEP_FCAF3D_VOXEL)
    batch = dict(batch, **batch_views())
    port = tiny_torch_cnrma(voxel_size_fcaf3d=STEP_FCAF3D_VOXEL)
    synthesize_parameters(port, 1)
    variables = _flax_tree(port.state_dict())
    subs, augs = [], []
    sub = jcn._normalize_subsample

    def spy_sub(flat, rng_b, max_points):
        r = jax.random.uniform(rng_b, (flat.weight.shape[0],))
        out = sub(flat, rng_b, max_points)
        jax.debug.callback(lambda x, *sel: subs.append(
            (np.asarray(x), [np.asarray(a) for a in sel])), r, *out,
            ordered=True)
        return out

    def loss_fn(params):
        out, mutated = model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            batch, train=True, rngs={"sample": jax.random.PRNGKey(1),
                                     "aug": jax.random.PRNGKey(2)},
            mutable=["batch_stats"])
        return sum(out["losses"].values()), (out["losses"],
                                             mutated["batch_stats"],
                                             out["points"])
    with pytest.MonkeyPatch.context() as mp_:
        _no_remat(mp_)
        mp_.setattr(jcn, "_normalize_subsample", spy_sub)
        mp_.setattr(jcn, "feature_transform_aug",
                    _aug_spy(jcn.feature_transform_aug, augs))
        (loss, (losses, stats, points)), grads = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
        jax.device_get(loss)
    want = jax.device_get({"loss": loss, "losses": losses, "stats": stats,
                           "grads": grads, "points": points})
    assert len(subs) == len(augs) == B
    kw = dict(uniform=T(np.stack([u for u, _ in subs])),
              aug_draws=_aug_draws(augs))
    selections = [[T(a) for a in sel] for _, sel in subs]
    return want, port, _torch_batch(batch), kw, selections


def _jax_selections(monkeypatch, selections):
    """The port's subsample returns JAX's kept points, scene after scene
    (``test_torch_train._jax_selection`` for a batch)."""
    calls = [0]

    def kept(*args, **kw):
        calls[0] += 1
        return tuple(selections[(calls[0] - 1) % len(selections)])
    monkeypatch.setattr(tcn, "_normalize_subsample", kept)


def test_cnrma_step_at_two_scenes_matches_jax(cnrma_step, monkeypatch):
    """The whole tiny CNRMA step on a batch of two scenes against JAX's at
    ``STEP_LIMITS``: the losses (the TSDF losses pooled over the batch, the
    detector's over the mean positive count) within 1e-4 relative, the
    running statistics (the 2D and 3D norms over the batch, the sparse
    ones over both scenes' voxels) within 1e-5, every gradient leaf but
    the R-50 trunk's within 1e-3 of its largest, the trunk as a group and
    by leaf cosine; both scenes keep points, the batch assigns
    positives."""
    from test_torch_train import STEP_FCAF3D_VOXEL
    want, port, tb, kw, selections = cnrma_step
    _jax_selections(monkeypatch, selections)
    for b in range(B):
        v = np.asarray(want["points"].valid[b])
        assert v.sum() > 50
        cells = np.asarray(want["points"].xyz[b])[v] / STEP_FCAF3D_VOXEL
        assert np.abs(cells - np.round(cells)).min() > 1e-4
    assert float(want["losses"]["loss_bbox"]) > 0
    r = _readings(port, _step(port, tb, **kw), want, DENSE_GROUPS)
    print("B=2 step readings:", r)
    assert not _failures(r), r


def test_cnrma_step_check_catches_per_scene_statistics(cnrma_step,
                                                       monkeypatch):
    """The same limits fail the step whose sparse norms take each scene's
    own statistics, on a fresh port (seed 1): the running statistics'
    limit breaks, the place the batch's new arithmetic shows."""
    from test_torch_bridge import tiny_torch_cnrma
    from test_torch_train import STEP_FCAF3D_VOXEL
    want, _, tb, kw, selections = cnrma_step
    _jax_selections(monkeypatch, selections)
    _per_scene_statistics(monkeypatch)
    port = tiny_torch_cnrma(voxel_size_fcaf3d=STEP_FCAF3D_VOXEL)
    synthesize_parameters(port, 1)
    r = _readings(port, _step(port, tb, **kw), want, DENSE_GROUPS)
    failed = _failures(r)
    print(f"per-scene statistics: breaks {failed}; readings {r}")
    assert "stats" in failed and r["stats"][1].startswith("detector."), r


@pytest.fixture(scope="module")
def atlas_step():
    """JAX's ``value_and_grad`` of the tiny Atlas's training forward on
    the two scenes of ``batch_views`` (its U-Net without the recompute,
    ``_no_remat``), and the port's batch (the parameters of
    ``synthesize_parameters``, seed 1)."""
    from test_pipeline import tiny_model
    from test_torch_stages import _flax_tree
    model, batch = tiny_model(detection=False, batch=B)
    batch = dict(batch, **batch_views())
    port = tcn.Atlas(voxel_dim=(16, 16, 16), voxel_size=0.1)
    synthesize_parameters(port, 1)
    state = {k: v.clone() for k, v in port.state_dict().items()}
    variables = _flax_tree(state)

    def loss_fn(params):
        out, mutated = model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            batch, train=True, mutable=["batch_stats"])
        return sum(out["losses"].values()), (out["losses"],
                                             mutated["batch_stats"])
    with pytest.MonkeyPatch.context() as mp_:
        _no_remat(mp_)
        (loss, (losses, stats)), grads = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
        want = jax.device_get({"loss": loss, "losses": losses,
                               "stats": stats, "grads": grads})
    return want, state, _torch_batch(batch)


def test_atlas_step_at_two_scenes_matches_jax(atlas_step):
    """Stage 1's step on two scenes against JAX's at ``STEP_LIMITS``: the
    three TSDF losses pooled over the batch, every gradient (all of the
    tower's through the volume's backward, once a scene) and the running
    statistics of the tower's and the U-Net's norms over the batch."""
    want, state, tb = atlas_step
    port = tcn.Atlas(voxel_dim=(16, 16, 16), voxel_size=0.1)
    port.load_state_dict(state)
    r = _readings(port, _step(port, tb), want, DENSE_GROUPS)
    print("B=2 atlas step readings:", r)
    assert not _failures(r), r


@pytest.fixture(scope="module")
def points_step():
    """Two stage-2 scenes (1000 points on a room's surfaces each, 800 and
    700 valid, 32 feature columns, two GT boxes each), JAX's
    ``value_and_grad`` of the tiny ``FCAF3DOnly``'s training forward on
    them (compiled at XLA's lowest level, the full-LUT decoder off as in
    ``test_torch_stages``) with its augmentation draws read out, and the
    port's batch on the same parameters (default initialisation, seed 0,
    random norms)."""
    from cnrma_torch.synthetic import room_surface_points
    from cnrma_tpu.models import fcaf3d_only as jonly
    from cnrma_tpu.models.fcaf3d import DetectionCapacities as JCaps
    from cnrma_tpu.ops import sparse as j_sparse
    from test_torch_stages import _flax_tree, _randomize_norms
    rng = np.random.RandomState(8)
    rooms = [np.array([[0.5, 0.5, 0.3, 0.4, 0.3, 0.4],
                       [1.0, 1.1, 0.4, 0.3, 0.5, 0.6]], np.float32),
             np.array([[0.6, 1.0, 0.3, 0.5, 0.4, 0.4],
                       [1.1, 0.5, 0.3, 0.4, 0.4, 0.5]], np.float32)]
    pts = np.stack([room_surface_points((1.6, 1.6, 1.2), bx, 1000, rng)
                    for bx in rooms])
    valid = np.stack([np.arange(1000) < 800, np.arange(1000) < 700])
    batch = {"points": pts, "point_feats":
             rng.randn(B, 1000, 32).astype(np.float32),
             "point_valid": valid,
             "gt_boxes": np.stack([np.concatenate([bx, np.zeros((2, 1))], 1)
                                   for bx in rooms]).astype(np.float32),
             "gt_labels": np.array([[0, 2], [1, 2]], np.int32),
             "gt_valid": np.ones((B, 2), bool)}
    torch.manual_seed(0)
    port = _points_port(None)
    _randomize_norms(port, 11)
    state = {k: v.clone() for k, v in port.state_dict().items()}
    model = jonly.FCAF3DOnly(capacities=JCaps.tiny(), n_classes=3,
                             voxel_size=0.01, pts_threshold=2000,
                             assigner_limit=2, assigner_topk=4, nms_pre=16)
    variables = _flax_tree(state)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    augs = []

    def loss_fn(params):
        out, mutated = model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jb, train=True, rngs={"aug": jax.random.PRNGKey(2)},
            mutable=["batch_stats"])
        return sum(out["losses"].values()), (out["losses"],
                                             mutated["batch_stats"])
    with pytest.MonkeyPatch.context() as mp_:
        mp_.setattr(jonly, "feature_transform_aug",
                    _aug_spy(jonly.feature_transform_aug, augs))
        mp_.setattr(j_sparse, "LUT_CELL_BUDGET", 0)
        step = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
        compiled = step.lower(variables["params"]).compile(
            compiler_options={"xla_backend_optimization_level": 0})
        (loss, (losses, stats)), grads = compiled(variables["params"])
        want = jax.device_get({"loss": loss, "losses": losses,
                               "stats": stats, "grads": grads})
    assert len(augs) == B
    tb = {k: T(np.array(v)) for k, v in batch.items()}
    return want, state, tb, _aug_draws(augs)


def _points_port(state):
    """The tiny ``FCAF3DOnly`` of ``points_step`` (``state`` loaded where
    given)."""
    from cnrma_torch.models.fcaf3d import DetectionCapacities as TCaps
    from cnrma_torch.models.fcaf3d_only import FCAF3DOnly as TOnly
    port = TOnly(capacities=TCaps.tiny(), n_classes=3, voxel_size=0.01,
                 pts_threshold=2000, assigner_limit=2, assigner_topk=4,
                 nms_pre=16)
    if state is not None:
        port.load_state_dict(state)
    return port


def test_fcaf3d_only_step_at_two_scenes_matches_jax(points_step):
    """Stage 2's step on two scenes against JAX's: the detector's losses
    within 1e-4 relative, every gradient leaf within 1e-3 of its largest,
    the sparse norms' running statistics (over both scenes' voxels) within
    1e-5; positives assigned."""
    want, state, tb, aug_draws = points_step
    assert float(want["losses"]["loss_bbox"]) > 0
    port = _points_port(state)
    r = _readings(port, _step(port, tb, aug_draws=aug_draws), want,
                  DETECTOR_GROUPS)
    print("B=2 stage-2 step readings:", r)
    assert not _failures(r), r


def test_fcaf3d_only_step_check_catches_per_scene_statistics(points_step,
                                                             monkeypatch):
    """The stage-2 limits fail the step whose sparse norms take each
    scene's own statistics."""
    want, state, tb, aug_draws = points_step
    _per_scene_statistics(monkeypatch)
    port = _points_port(state)
    r = _readings(port, _step(port, tb, aug_draws=aug_draws), want,
                  DETECTOR_GROUPS)
    failed = _failures(r)
    print(f"per-scene statistics, stage 2: breaks {failed}; readings {r}")
    assert "stats" in failed, r


# --- the test forward of a batch -------------------------------------------------

# a scene's outputs in a batch against alone: the 2D tower's and U-Net's
# convolutions round otherwise over a batch of two (point features of up
# to 5 differ by 7.6e-6 on the CPU)
EVAL_TOL = 1e-5


def test_eval_batch_equals_one_scene_at_a_time():
    """In eval mode a scene's outputs do not depend on its batch: the tiny
    CNRMA's test forward of two scenes, each subsample from its own
    generator, gives each scene's TSDFs, kept points and scores as the
    scene alone does, within ``EVAL_TOL``, and the same kept set."""
    from test_torch_bridge import tiny_torch_cnrma
    from test_torch_stages import _randomize_norms
    torch.manual_seed(0)
    port = tiny_torch_cnrma().eval()
    _randomize_norms(port, 12)
    views = batch_views()
    rng = np.random.RandomState(3)
    batch = {"imgs": T(np.array(views["imgs"][:, :, ::2, ::2])),
             "projection": T(np.array(views["projection"])) / torch.tensor(
                 [[2.0], [2.0], [1.0]]),
             "view_valid": torch.ones(B, 2, dtype=torch.bool),
             "offset": T(rng.rand(B, 3).astype(np.float32) * 0.1)}

    def gens(seeds):
        return [torch.Generator().manual_seed(s) for s in seeds]
    both = port(batch, generator=gens([5, 6]))
    for b, seed in enumerate((5, 6)):
        one = port({k: v[b:b + 1] for k, v in batch.items()},
                   generator=gens([seed]))
        for k, t in one["tsdf"].items():
            torch.testing.assert_close(both["tsdf"][k][b:b + 1], t,
                                       rtol=0, atol=EVAL_TOL)
        v = one["points"].valid[0]
        assert v.sum() > 0
        assert torch.equal(both["points"].valid[b], v)
        for f in ("xyz", "feats"):
            torch.testing.assert_close(getattr(both["points"], f)[b][v],
                                       getattr(one["points"], f)[0][v],
                                       rtol=0, atol=EVAL_TOL)
        torch.testing.assert_close(both["scores"][b], one["scores"][0],
                                   rtol=0, atol=EVAL_TOL)


# --- evaluate_val in batches ---------------------------------------------------------

def test_evaluate_val_at_two_scenes_matches_jax():
    """Stage 1's val losses over three scenes in batches of two (the last
    one partial) against JAX's ``evaluate_val`` on the same batches
    within 1e-4 relative: each batch's TSDF losses pool its scenes, and
    the score is the mean over the batches, not over the scenes."""
    from cnrma_tpu.train import loop as jloop
    from test_pipeline import tiny_model
    from test_torch_eval import _close, _eval_step, _host, _state
    from test_torch_stages import _flax_tree, _randomize_norms
    model, batch = tiny_model(detection=False, batch=N_VAL)
    torch.manual_seed(0)
    port = tcn.Atlas(voxel_dim=(16, 16, 16), voxel_size=0.1).eval()
    _randomize_norms(port, 12)
    variables = _flax_tree(port.state_dict())
    host = _host(batch)

    def scenes(part):
        out = {k: v[part] for k, v in host.items() if k != "tsdf_list"}
        out["tsdf_list"] = {k: v[part] for k, v in host["tsdf_list"].items()}
        return out
    batches = [scenes(slice(0, 2)), scenes(slice(2, 3))]
    steps = [_eval_step(model, variables, b) for b in batches]
    state = _state(variables)
    want = jloop.evaluate_val(model, state, batches[:1], steps[0])
    last = jloop.evaluate_val(model, state, batches[1:], steps[1])
    want = {k: (w + last[k]) / 2 for k, w in want.items()}
    got = tloop.evaluate_val(port, batches, "cpu")
    print("B=2 val losses:", got)
    _close(got, want)
    per_scene = tloop.evaluate_val(
        port, [scenes(slice(i, i + 1)) for i in range(N_VAL)], "cpu")
    assert not math.isclose(got["val/total_loss"],
                            per_scene["val/total_loss"], rel_tol=1e-4)


# --- the loader ------------------------------------------------------------------------

def _scenes(n):
    return [{"scene": f"s{i}", "imgs": np.full((2, 3), i, np.float32),
             "tsdf_gt_004": np.full((2,), i, np.float32)} for i in range(n)]


def test_loader_batches_match_jax():
    """Batches of 3 of 8 scenes at world size 1, two epochs: the scenes
    and the collated arrays equal JAX's ``SceneLoader(batch_size=3,
    shuffle=True, seed, drop_last=True)`` batch for batch; ``index`` the
    batch's dataset indices."""
    from cnrma_tpu.data.loader import SceneLoader as JLoader
    data = _scenes(8)
    jl_ = JLoader(data, batch_size=3, shuffle=True, seed=5, drop_last=True,
                  num_workers=1)
    tl_ = SceneLoader(data, seed=5, batch_size=3, num_workers=2)
    assert len(tl_) == len(jl_) == 2
    epochs = []
    for _ in range(2):
        want, got = list(jl_), list(tl_)
        assert [b["scene"] for b in got] == [b["scene"] for b in want]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g["imgs"], w["imgs"])
            np.testing.assert_array_equal(g["tsdf_list"]["tsdf_gt_004"],
                                          w["tsdf_list"]["tsdf_gt_004"])
            assert g["index"] == [int(s[1:]) for s in g["scene"]]
        epochs.append([b["index"] for b in got])
    assert epochs[0] != epochs[1]


@pytest.mark.parametrize("drop_last", [True, False])
def test_ranks_take_contiguous_blocks(drop_last):
    """At world size 2 and batches of 4 scenes over the ranks, rank r's
    batch k is the block ``[2r, 2r + 2)`` of the one-process batch k (JAX's
    ``P('data')`` split); without ``drop_last`` the 7 scenes' last round
    is cut, rank 0 taking 2 of its 3 scenes and rank 1 the last one."""
    data = _scenes(7)
    whole = [b["index"] for b in SceneLoader(
        data, seed=5, batch_size=4, drop_last=drop_last)]
    assert [len(b) for b in whole] == ([4] if drop_last else [4, 3])
    for rank in range(2):
        loader = SceneLoader(data, seed=5, batch_size=4, rank=rank,
                             world_size=2, num_workers=3,
                             drop_last=drop_last)
        got = [b["index"] for b in loader]
        assert len(loader) == len(got)
        assert got == [w[2 * rank:2 * rank + 2] for w in whole
                       if w[2 * rank:2 * rank + 2]]
    order = SceneLoader(data, seed=5).order()
    one = SceneLoader(data, seed=5, rank=1, world_size=2)   # B = W
    assert [b["index"] for b in one] == order[1:6:2]
    with pytest.raises(ValueError, match="multiple of the world size"):
        SceneLoader(data, batch_size=3, rank=0, world_size=2)


# --- the train CLI -------------------------------------------------------------------------

@pytest.fixture(scope="module")
def split(tmp_path_factory):
    """5 tiny ScanNet scenes (the train split), the first 3 as a val split,
    and stage-2 dumps of 3000 points on each room."""
    root = str(tmp_path_factory.mktemp("batch"))
    ann = write_scannet(root, n_scenes=N_SCENES, n_frames=4,
                        tsdf_dim=(32, 32, 16), image_size=(64, 48),
                        ann_name="scannet_infos_train.pkl")
    with open(ann, "rb") as f:
        infos = sorted(pickle.load(f), key=lambda x: x["scene"])
    with open(os.path.join(root, "scannet_infos_val.pkl"), "wb") as f:
        pickle.dump(infos[:N_VAL], f)
    write_point_dumps(root, os.path.join(root, "mid"), n_points=3000)
    return root


def _options(root):
    val = ("{'type':'MiddlePointsDataset','data_root':'%s',"
           "'ann_file':'%s/scannet_infos_val.pkl','points_dir':'%s/mid',"
           "'test_mode':True,'num_points':2000}" % (root, root, root))
    return [f"data.train.data_root={root}",
            f"data.train.ann_file={root}/scannet_infos_train.pkl",
            f"data.train.points_dir={root}/mid", "data.train.repeat=1",
            "data.train.num_points=2000", f"model.capacities={CAPS}",
            f"data.val={val}", "total_epochs=1", "log_config.interval=1",
            "evaluation={'interval':1,'metric':'mAP'}"]


def _rank_cli(root, out):
    """A rank of two gloo ranks: the train CLI on stage 2 at
    ``--batch-size 4`` for one step, writing the dataset indices of the
    batches its loader gave and a hash of its trained model."""
    from cnrma_torch.tools import train as train_cli
    rank = int(os.environ["RANK"])
    seen, models = [], []
    real_iter, real_run = SceneLoader.__iter__, train_cli.run_training

    def iterate(self):
        for batch in real_iter(self):
            if self.shuffle:
                seen.append(batch["index"])
            yield batch

    def run(state, *args, **kw):
        models.append(state.model)
        return real_run(state, *args, **kw)
    SceneLoader.__iter__ = iterate
    train_cli.run_training = run
    train_cli.main([STAGE2, "--device", "cpu", "--batch-size", "4",
                    "--max-steps", "1", "--work-dir",
                    os.path.join(out, f"wd{rank}"), "--cfg-options",
                    *_options(root), "evaluation=None"])
    h = hashlib.sha256()
    for k, v in models[0].state_dict().items():
        h.update(k.encode() + v.detach().contiguous().numpy().tobytes())
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump({"seen": seen, "digest": h.hexdigest()}, f)


@pytest.fixture(scope="module")
def two_ranks(split, tmp_path_factory):
    """Two gloo ranks of the train CLI at ``--batch-size 4``, spawned at
    once, under one time limit: their reports."""
    out = str(tmp_path_factory.mktemp("ranks"))
    jobs = spawn({"ranks": (_rank_cli, 2, (split, out))}, TIME_LIMIT)
    for r in range(2):           # the checkpoints (850 MB each) go now
        shutil.rmtree(os.path.join(out, f"wd{r}"), ignore_errors=True)
    jobs.check("ranks")
    reports = []
    for r in range(2):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            reports.append(json.load(f))
    return reports


def test_train_cli_ranks_take_contiguous_blocks(two_ranks, split):
    """The train CLI on two gloo ranks at ``--batch-size 4``: rank 0 steps
    on the first two scenes of the epoch's shuffle, rank 1 on the next
    two, and both end with the same parameters and statistics."""
    cfg = Config.fromfile(STAGE2)
    cfg.merge_from_options(dict(kv.split("=", 1) for kv in _options(split)))
    order = SceneLoader(build_dataset(cfg, "train", seed=0), seed=0).order()
    assert [r["seen"][0] for r in two_ranks] == [order[:2], order[2:4]]
    assert two_ranks[0]["digest"] == two_ranks[1]["digest"]


def test_train_cli_at_batch_size_two(split, tmp_path, capsys):
    """``--batch-size 2`` on one process: an epoch of 5 scenes has 2 steps
    of 2 scenes, the lr schedule counts those, the losses are finite, and
    the val split is scored in batches of 2 (the last partial) as
    ``evaluate_split`` scores it over such a loader."""
    from cnrma_torch.tools import train as train_cli
    from cnrma_torch.tools.test import read_parameters
    wd = str(tmp_path / "wd")
    try:
        records, path = train_cli.main(
            [STAGE2, "--device", "cpu", "--batch-size", "2", "--work-dir",
             wd, "--cfg-options", *_options(split)])
        assert path == os.path.join(wd, "epoch_1.pt")
        parameters = read_parameters(path)
    finally:                     # the checkpoints hold 850 MB each
        shutil.rmtree(wd, ignore_errors=True)
    assert [r["step"] for r in records] == [1, 2]
    assert all(math.isfinite(v) for r in records
               for v in r["log_vars"].values())
    cfg = Config.fromfile(STAGE2)
    cfg.merge_from_options(dict(kv.split("=", 1) for kv in _options(split)))
    model = build_model(cfg, mode="test")
    model.load_state_dict(parameters)
    loader = SceneLoader(build_dataset(cfg, "val", seed=0), shuffle=False,
                         drop_last=False, batch_size=2)
    assert loader.positions(N_VAL) == [[0, 1], [2]]
    want = tloop.evaluate_split(model, loader, "cpu", "mAP")
    got = records[-1]["val"]
    assert set(got) == set(want) and "val/mAP_0.25" in got
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=1e-6, err_msg=k)


def test_train_cli_refuses_a_batch_that_does_not_split(split, monkeypatch):
    """``--batch-size 3`` at world size 2 (``torchrun``'s environment) is
    refused before the group is joined: a rank cannot take 1.5 scenes."""
    from cnrma_torch.tools import train as train_cli
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(SystemExit, match="multiple of the world size, 2"):
        train_cli.main([STAGE2, "--device", "cpu", "--batch-size", "3",
                        "--cfg-options", *_options(split)])


# --- TF32 -------------------------------------------------------------------------------

class _Stop(Exception):
    pass


@pytest.mark.parametrize("cli", ["train", "test", "overfit_full",
                                 "overflow_survey"])
def test_clis_turn_tf32_off(cli, monkeypatch):
    """Each CLI that runs the model turns off cuDNN's and cuBLAS's TF32
    before it builds anything (torch's default runs cuDNN's fp32
    convolutions in TF32), so that fp32 is fp32 in a fresh process."""
    import importlib
    mod = importlib.import_module(f"cnrma_torch.tools.{cli}")
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    seen = {}

    def stop(*args, **kw):
        seen["flags"] = (torch.backends.cudnn.allow_tf32,
                         torch.backends.cuda.matmul.allow_tf32)
        raise _Stop
    argv = {"train": [STAGE2, "--device", "cpu"],
            "test": [os.path.join(REPO, "configs", "ray_marching_scannet.py"),
                     "none.pt", "--device", "cpu"],
            "overfit_full": ["--device", "cpu"],
            "overflow_survey": ["--device", "cpu"]}[cli]
    target = {"train": (Config, "fromfile"), "test": (Config, "fromfile"),
              "overfit_full": (mod, "build_batch"),
              "overflow_survey": (os, "makedirs")}[cli]
    monkeypatch.setattr(*target, stop)
    with pytest.raises(_Stop):
        (mod.run if cli == "overfit_full" else mod.main)(argv)
    assert seen["flags"] == (False, False)

"""The port's learning checks on the CPU.

The whole-model check (``python -m cnrma_torch.tools.overfit_full``): its
synthetic rooms against the JAX tool's (``tools/overfit_full.py``, whose
scene builder is numpy only) on one ``RandomState`` seed, equal to the
last bit; and a 2-step run of the port's tool, its two rooms as one batch,
that ends with finite losses.

The detector-only check (``python -m cnrma_torch.tools.overfit_check``):
its box scenes and batch against the JAX tool's (``tools/overfit_check.py``)
bit for bit; its tiny ``FCAF3DOnly`` on parameters bridged to flax leaves
against JAX's: the first step's three losses within 1e-4 relative, then
three AdamW steps against ``optax.adamw(2e-3)`` at
``test_torch_batch.BATCH_LIMITS`` (the limits of the two-scene
``FCAF3DOnly`` step: losses, gradients, running statistics) each step and
the parameters after them; its 8 cm test forward against JAX's on
bridged parameters; a 2-step run of the tool that ends with finite losses,
a score after each step and the capacity fills.

The parity steps run the tool's model, scenes, batch and optimizer at
``PARITY_VOXEL`` (4 cm detector voxels), not the tool's 8 cm.  At 8 cm the
sparse ResNet's last stage and the head's coarsest level hold one voxel a
scene, so their batch norms see two rows whose variance is far under the
norm's epsilon: ``x - mean`` then cancels to a few ulps, and the step is
chaotic in fp32, in JAX as in the port.  One ulp of the point features
moves JAX's own first-step ``loss_centerness`` by 3.2e-3 and its backbone
gradients by 1.75-4.1 of their norm (the port against JAX: 7.8e-3 and
1.4-3.0).  At 4 cm both stay under 5e-6 (the port against JAX under 1e-7
on the losses), so the limits below mean something.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnrma_torch.tools import overfit_check as port_check
from cnrma_torch.tools import overfit_full as port_tool
from tools import overfit_check as jax_check
from tools import overfit_full as jax_tool
from _torch_spawn import call, tool_run
from _torch_threads import _few_threads  # noqa: F401

TIME_LIMIT = 480            # seconds a child's tool run may take


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


def test_two_steps_on_the_cpu_end_with_finite_losses(tmp_path):
    """``--steps 2 --device cpu`` (two views a scene): two steps, each on
    both rooms as one batch, as the JAX tool trains them; finite losses,
    the PASS line printed, and the rule's inputs returned.  The run takes
    a child process (``_torch_spawn.call``)."""
    out, printed = call("overfit_full", tool_run, (
        port_tool.__name__, ["--steps", "2", "--views", "2", "--device",
                             "cpu"]), TIME_LIMIT, tmp_path)
    assert out["steps"] == 2
    for k in ("first", "final", "first_recon", "final_recon"):
        assert math.isfinite(out[k]) and out[k] > 0, k
    assert 0.0 <= out["mAP_0.25"] <= 1.0 and out["peak_gib"] is None
    assert out["ok"] == (out["final"] < 0.6 * out["first"]
                         and out["final_recon"] < 0.5 * out["first_recon"]
                         and out["mAP_0.25"] >= 0.5)
    assert "full overfit check:" in printed


# --- the detector-only check -------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_make_scene_matches_the_jax_tool(seed):
    """Two scenes from one seed: points, features, boxes and labels equal
    to the last bit, and the random state left where the JAX tool leaves
    it."""
    got, want = [], []
    for tool, out in ((port_check, got), (jax_check, want)):
        rng = np.random.RandomState(seed)
        for _ in range(2):
            out.extend(tool.make_scene(rng, 3))
        out.append(rng.rand())
    assert len(got) == len(want) == 9
    for g, w in zip(got, want):
        assert np.asarray(g).dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g, w)


def _jax_batch(scenes):
    """The JAX tool's batch (``tools/overfit_check.py:81-95``), as it
    builds it."""
    B, M = len(scenes), 4
    batch = {
        "points": jnp.asarray(np.stack([s[0] for s in scenes])),
        "point_feats": jnp.asarray(np.stack([s[1] for s in scenes])),
        "point_valid": jnp.ones((B, scenes[0][0].shape[0]), bool),
        "gt_boxes": jnp.zeros((B, M, 7), jnp.float32),
        "gt_labels": jnp.zeros((B, M), jnp.int32),
        "gt_valid": jnp.zeros((B, M), bool),
    }
    for i, (_, _, bx, lb) in enumerate(scenes):
        k = len(bx)
        batch["gt_boxes"] = batch["gt_boxes"].at[i, :k].set(bx)
        batch["gt_labels"] = batch["gt_labels"].at[i, :k].set(lb)
        batch["gt_valid"] = batch["gt_valid"].at[i, :k].set(True)
    return batch


def _scenes():
    rng = np.random.RandomState(0)
    return [port_check.make_scene(rng, 3) for _ in range(2)]


def test_check_batch_matches_the_jax_tool():
    """The tool's two-scene batch equals the JAX tool's: keys, dtypes and
    values."""
    scenes = _scenes()
    got, want = port_check.build_batch(scenes), _jax_batch(scenes)
    assert set(got) == set(want)
    for k, w in want.items():
        w = np.asarray(w)
        assert got[k].dtype == w.dtype, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)


CHECK_STEPS = 3             # AdamW steps held against optax
PARITY_VOXEL = 0.04         # detector voxels of the parity steps (above)
# the port's AdamW on JAX's gradients against optax, of each leaf's largest
# magnitude (measured 3.4e-6 after three steps: a norm bias of about 6e-3,
# 2e-8 apart)
ADAMW_TOL = 1e-5


@pytest.fixture(scope="module")
def check_steps():
    """JAX's ``CHECK_STEPS`` steps of the tool's tiny ``FCAF3DOnly`` at
    ``PARITY_VOXEL`` (``value_and_grad`` compiled once at XLA's lowest
    level, the full-LUT decoder off as in ``test_torch_stages``, then
    ``optax.adamw(2e-3)``) from the port's initialisation
    (``torch.manual_seed(0)``) bridged to flax leaves: each step's starting
    variables, losses, gradients and new statistics, and the parameters
    after the last step."""
    import optax
    from cnrma_tpu.models import fcaf3d_only as jonly
    from cnrma_tpu.models.fcaf3d import DetectionCapacities as JCaps
    from cnrma_tpu.ops import sparse as j_sparse
    from test_torch_stages import _flax_tree
    torch.manual_seed(0)
    variables = _flax_tree(port_check.tiny_model(PARITY_VOXEL).state_dict())
    model = jonly.FCAF3DOnly(
        n_classes=3, voxel_size=PARITY_VOXEL, pts_threshold=2000,
        assigner_limit=8, assigner_topk=6, nms_pre=64,
        capacities=JCaps.tiny(), use_feature_transform=False)
    jb = _jax_batch(_scenes())

    def loss_fn(params, stats):
        out, mut = model.apply({"params": params, "batch_stats": stats},
                               jb, train=True, mutable=["batch_stats"])
        return sum(out["losses"].values()), (out["losses"],
                                             mut["batch_stats"])
    with pytest.MonkeyPatch.context() as mp_:
        mp_.setattr(j_sparse, "LUT_CELL_BUDGET", 0)
        params, stats = variables["params"], variables["batch_stats"]
        step = jax.jit(jax.value_and_grad(loss_fn, has_aux=True)).lower(
            params, stats).compile(
                compiler_options={"xla_backend_optimization_level": 0})
        tx = optax.adamw(2e-3)
        opt = tx.init(params)
        steps = []
        for _ in range(CHECK_STEPS):
            (_, (losses, new_stats)), grads = step(params, stats)
            steps.append(jax.device_get({
                "start": {"params": params, "batch_stats": stats},
                "losses": losses, "grads": grads, "stats": new_stats}))
            updates, opt = tx.update(grads, opt, params)
            params, stats = optax.apply_updates(params, updates), new_stats
    return steps, jax.device_get(params)


def _check_port(variables):
    """The tool's model at ``PARITY_VOXEL`` on flax ``variables``."""
    from cnrma_torch.bridge import from_flax
    port = port_check.tiny_model(PARITY_VOXEL)
    port.load_state_dict(from_flax(variables, port))
    return port


def test_check_first_step_losses_match_jax(check_steps):
    """The first step's three losses within 1e-4 relative of JAX's, with
    positives assigned."""
    from cnrma_torch.train.loop import device_batch
    steps, _ = check_steps
    port = _check_port(steps[0]["start"]).train()
    got = port.forward_train(device_batch(
        port_check.build_batch(_scenes()), "cpu"))
    want = steps[0]["losses"]
    assert set(got) == set(want) == {"loss_centerness", "loss_bbox",
                                     "loss_cls"}
    assert float(want["loss_bbox"]) > 0
    rel = {k: abs(float(got[k].detach()) / float(w) - 1)
           for k, w in want.items()}
    print("overfit_check step-1 losses, relative errors:", rel)
    assert max(rel.values()) < 1e-4, rel


def _leaf_errors(got, want_params):
    """Each parameter of the port's ``got`` against JAX's leaf, of the
    leaf's largest magnitude; the worst (error, name)."""
    from cnrma_torch.bridge import _convert
    from test_torch_train import _path
    errs = []
    for path, p in jax.tree_util.tree_leaves_with_path(want_params):
        key, arr = _convert("params", _path(path), np.asarray(p))
        g = got[key].detach().numpy()
        errs.append((float(np.abs(g - arr).max()
                           / max(float(np.abs(arr).max()), 1e-30)), key))
    assert len(errs) == len(got)
    return max(errs)


def test_check_adamw_steps_match_optax(check_steps):
    """``CHECK_STEPS`` steps of the tool's optimizer (AdamW, lr 2e-3,
    weight decay 1e-4, no clip) against ``optax.adamw(2e-3)``.  Each step
    starts from JAX's variables of that step: the port's losses, gradients
    and running statistics at ``BATCH_LIMITS`` (the detector's groups as
    groups); then the port's optimizer, its moments carried over the
    steps, takes JAX's gradients, and its parameters must be optax's
    within ``ADAMW_TOL`` (1e-5) of each leaf's largest magnitude.  (From its own gradients
    the port's second step moves a running variance by 2e-3: AdamW's first
    update is about ``lr`` times the gradient's sign, also where a
    gradient is a few ulps from 0.)"""
    from cnrma_torch.bridge import _convert, from_flax
    from cnrma_torch.train.loop import device_batch
    from cnrma_torch.train.optim import build_optimizer
    from test_torch_batch import DETECTOR_GROUPS, _failures, _readings, _step
    from test_torch_train import _path
    steps, final = check_steps
    batch = device_batch(port_check.build_batch(_scenes()), "cpu")
    port = _check_port(steps[0]["start"])
    opt = build_optimizer(dict(type="AdamW", lr=port_check.LR,
                               weight_decay=port_check.WEIGHT_DECAY), port,
                          lambda step: port_check.LR)
    for i, want in enumerate(steps):
        port.load_state_dict(from_flax(want["start"], port))
        r = _readings(port, _step(port, batch), want, DETECTOR_GROUPS)
        print(f"overfit_check step {i + 1} readings:", r)
        assert not _failures(r), (i, r)
        grads = {}
        for path, g in jax.tree_util.tree_leaves_with_path(want["grads"]):
            key, arr = _convert("params", _path(path), np.asarray(g))
            grads[key] = torch.from_numpy(np.array(arr))
        opt.step(grads)
        after = steps[i + 1]["start"]["params"] if i + 1 < len(steps) \
            else final
        worst = _leaf_errors(dict(port.named_parameters()), after)
        print(f"overfit_check parameters after step {i + 1}, worst leaf:",
              worst)
        assert worst[0] < ADAMW_TOL, (i, worst)


def test_check_two_steps_on_the_cpu(monkeypatch, tmp_path):
    """``--steps 2 --score-every 1 --device cpu`` with
    ``CNRMA_CAPACITY_DEBUG=1``: two steps on both scenes as one batch,
    finite losses, the PASS line printed, the rule's inputs returned, a
    reading after each step whose last is the final score, and each
    capacity site's largest fill within its capacity.  The run takes a
    child process (``_torch_spawn.call``)."""
    monkeypatch.setenv("CNRMA_CAPACITY_DEBUG", "1")
    out, printed = call("overfit_check", tool_run, (
        port_check.__name__, ["--steps", "2", "--score-every", "1",
                              "--device", "cpu"]), TIME_LIMIT, tmp_path)
    assert out["steps"] == 2 and len(out["losses"]) == 2
    for k in ("first", "final"):
        assert math.isfinite(out[k]) and out[k] > 0, k
    assert 0.0 <= out["mAP_0.25"] <= 1.0 and out["peak_gib"] is None
    assert out["ok"] == (out["final"] < 0.5 * out["first"]
                         and out["mAP_0.25"] >= 0.5)
    assert [r["step"] for r in out["scores"]] == [1, 2]
    last = out["scores"][-1]
    assert (last["loss"], last["mAP_0.25"], last["mAP_0.50"], last["ok"]) \
        == (out["final"], out["mAP_0.25"], out["mAP_0.50"], out["ok"])
    assert "voxelize(stride 1)" in out["fills"], out["fills"]
    assert all(0 < n <= cap for n, cap in out["fills"].values()), \
        out["fills"]
    assert "overfit check:" in printed


def test_check_eval_forward_at_8cm_matches_jax(monkeypatch):
    """The tool's own 8 cm model (the parity steps above run at 4 cm) in
    its test forward, which the final score reads: the port's
    initialisation (``torch.manual_seed(0)``) with random eval statistics
    bridged to flax leaves, on the tool's two-scene batch; each scene's
    valid raw boxes and scores, as sets ordered by score, within 1e-4 of
    their scale (scores 1e-5), as ``test_torch_stages`` holds stage 2's
    test forward.  Eval-mode norms use fixed statistics, so the one-voxel
    levels that make the 8 cm training step chaotic do not enter."""
    from cnrma_torch.train.loop import device_batch
    from cnrma_tpu.models import fcaf3d_only as jonly
    from cnrma_tpu.models.fcaf3d import DetectionCapacities as JCaps
    from cnrma_tpu.ops import sparse as j_sparse
    from test_torch_stages import _flax_tree, _randomize_norms, _run_jax
    torch.manual_seed(0)
    port = port_check.tiny_model()
    _randomize_norms(port, 11)
    variables = _flax_tree(port.state_dict())
    model = jonly.FCAF3DOnly(
        n_classes=3, voxel_size=port_check.VOXEL_SIZE, pts_threshold=2000,
        assigner_limit=8, assigner_topk=6, nms_pre=64,
        capacities=JCaps.tiny(), use_feature_transform=False)
    monkeypatch.setattr(j_sparse, "LUT_CELL_BUDGET", 0)
    want = _run_jax(lambda v: model.apply(v, _jax_batch(_scenes()),
                                          train=False), variables)
    with torch.no_grad():
        got = port.eval()(device_batch(port_check.build_batch(_scenes()),
                                       "cpu"))

    def ordered(out, i):
        b, s, v = (np.asarray(out[k][i]) for k in ("bboxes", "scores",
                                                   "bbox_valid"))
        o = np.argsort(-s[v].max(1), kind="stable")
        return b[v][o], s[v][o]
    for i in range(2):
        jbx, js = ordered(want, i)
        tbx, ts = ordered(got, i)
        assert len(jbx) == len(tbx) > 0, i
        print(f"overfit_check 8 cm scene {i}: {len(jbx)} boxes, score "
              f"error {np.abs(ts - js).max()}, box error "
              f"{np.abs(tbx - jbx).max() / np.abs(jbx).max()} of scale")
        np.testing.assert_allclose(ts, js, atol=1e-5)
        np.testing.assert_allclose(tbx, jbx, atol=1e-4 * np.abs(jbx).max())

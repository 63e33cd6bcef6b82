"""The mid-training evaluation of the port (``cnrma_torch/train/loop.py``:
``evaluate_val``, ``evaluate_val_map``, the val hook of ``run_training`` and
its ``best.pt``; the train CLI's val reader) against the JAX package, fp32
on the CPU.

Parity: the tiny ``CNRMA`` (``tests/test_pipeline.py:tiny_model``, on the
port's default initialisation, seed 0, with random norms, so that boxes
clear the NMS's score threshold) on two one-scene val batches whose GT holds one box
planted on a box the model predicts, with JAX's subsample draw injected;
the tiny ``FCAF3DOnly`` and ``Atlas`` of ``tests/test_torch_stages.py`` on
the port's parameters.  Tolerances: the mean losses within 1e-4 relative;
the mAP, mAR and the empty dict of a model without boxes equal.  JAX's
``evaluate_val`` and ``evaluate_val_map`` run as they are, with their
``eval_step`` (``make_eval_step``'s function) compiled at XLA's lowest
optimisation level, as ``test_torch_stages._run_jax`` compiles.  For
stage 2 the step is compiled with its batch as a constant, so that XLA
folds the arithmetic on the points and GT on the host, one operation at a
time: on this batch JAX's step compiled with the batch as an argument
gives losses that differ from its own op-by-op run (``jax.disable_jit``,
two minutes here) by up to 8e-4 relative (``loss_centerness``); the
op-by-op run and the folded one are the port's within 1e-6.

Torch only: which epoch ``best.pt`` holds under a loss and under an mAP,
and when the hook runs; and F14: the train CLI's evaluator scores the val
split at the config's test grid with the training model's parameters.
"""

import math
import os
import shutil
import types

import jax
import numpy as np
import pytest
import torch
from torch import nn

from cnrma_torch.core.builder import build_dataset, build_model
from cnrma_torch.core.config import Config
from cnrma_torch.data.loader import SceneLoader
from cnrma_torch.models import cn_rma as tcn
from cnrma_torch.synthetic import write_scannet
from cnrma_torch.tools import train as train_cli
from cnrma_torch.train import loop as tloop
from cnrma_torch.train.optim import build_optimizer
from cnrma_torch.train.state import TrainState, load_checkpoint
from cnrma_tpu.models import cn_rma as jcn
from cnrma_tpu.train import loop as jloop
from cnrma_tpu.utils.batching import vmap_batch_mode
from test_pipeline import tiny_model
from test_torch_bridge import tiny_torch_cnrma
from test_torch_stages import (
    _flax_tree, _randomize_norms, points_case)  # noqa: F401
from _torch_threads import _few_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "ray_marching_scannet.py")


def _eval_step(model, variables, batch):
    """``jloop.make_eval_step(model)``'s function compiled at XLA's lowest
    optimisation level for ``variables`` and the device batch of
    ``batch``."""
    def step(v, b):
        with vmap_batch_mode(True):
            return model.apply(v, b, train=False)
    v = {"params": variables["params"],
         "batch_stats": variables["batch_stats"]}
    return jax.jit(step).lower(v, jloop.device_batch(batch)).compile(
        compiler_options={"xla_backend_optimization_level": 0})


def _state(variables):
    return types.SimpleNamespace(params=variables["params"],
                                 batch_stats=variables["batch_stats"])


def _host(batch):
    """A batch's arrays as numpy (the loaders' collated layout)."""
    out = {k: np.array(v) for k, v in batch.items() if k != "tsdf_list"}
    out["tsdf_list"] = {k: np.array(v) for k, v in batch["tsdf_list"].items()}
    return out


def _second_scene(batch):
    """``tiny_model``'s batch with other pixels and TSDF targets."""
    rng = np.random.RandomState(1)
    out = dict(batch, imgs=(rng.rand(*batch["imgs"].shape) * 255
                            ).astype(np.float32))
    out["tsdf_list"] = {k: (rng.rand(*v.shape) * 2 - 1).astype(np.float32)
                        for k, v in batch["tsdf_list"].items()}
    return out


def _plant_gt(batch, out):
    """GT box 0 on the best-scoring raw box of ``out`` (its best class),
    box 1 the batch's own: so that the mAP is above 0 on both sides."""
    v = np.asarray(out["bbox_valid"][0])
    boxes, scores = np.asarray(out["bboxes"][0])[v], np.asarray(
        out["scores"][0])[v]
    top = int(np.argmax(scores.max(1)))
    gt = np.array(batch["gt_boxes"])
    gt[0, 0, :6] = boxes[top, :6]
    labels = np.array(batch["gt_labels"])
    labels[0, 0] = int(np.argmax(scores[top]))
    return dict(batch, gt_boxes=gt, gt_labels=labels)


@pytest.fixture(scope="module")
def cnrma_val():
    """JAX's val losses and mAP of the tiny CNRMA on two scenes, the draw
    its subsample made, the scenes and the flax variables."""
    model, batch = tiny_model()
    torch.manual_seed(0)
    port = tiny_torch_cnrma().eval()
    _randomize_norms(port, 12)
    variables = _flax_tree(port.state_dict())
    draws = []
    orig = jcn._normalize_subsample

    def spy(flat, rng_b, max_points):
        r = jax.random.uniform(rng_b, (flat.weight.shape[0],))
        jax.debug.callback(lambda x: draws.append(np.asarray(x)), r)
        return orig(flat, rng_b, max_points)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcn, "_normalize_subsample", spy)
        scenes = [_host(batch), _host(_second_scene(_host(batch)))]
        step = _eval_step(model, variables, scenes[0])
        state = _state(variables)
        scenes = [_plant_gt(s, jax.device_get(step(
            {"params": state.params, "batch_stats": state.batch_stats},
            jloop.device_batch(s)))) for s in scenes]
        want = jloop.evaluate_val(model, state, scenes, step)
        want_map = jloop.evaluate_val_map(model, state, scenes, step)
    return want, want_map, draws[-2:], scenes, port


def _close(got, want, rtol=1e-4):
    assert set(got) == set(want)
    for k, w in want.items():
        assert math.isfinite(w), k
        np.testing.assert_allclose(got[k], w, rtol=rtol, atol=1e-7,
                                   err_msg=k)


def test_cnrma_val_losses_and_map_match_jax(cnrma_val):
    """``evaluate_val`` (the mean losses and ``val/total_loss``) within
    1e-4 relative, ``evaluate_val_map`` (mAP@0.25/0.50, mAR@0.25) equal;
    the planted box is found on both sides."""
    want, want_map, draws, scenes, port = cnrma_val
    uniforms = [torch.from_numpy(np.array(d))[None] for d in draws]
    got = tloop.evaluate_val(port, scenes, "cpu", uniforms=uniforms)
    print("val losses:", got)
    _close(got, want)
    assert {"val/total_loss", "val/tsdf_loss_010", "val/loss_cls"} <= set(got)
    got_map = tloop.evaluate_val_map(port, scenes, "cpu", uniforms=uniforms)
    print("val mAP:", got_map, "JAX:", want_map)
    assert got_map == {k: float(v) for k, v in want_map.items()}
    assert got_map["val/mAP_0.25"] > 0
    both = tloop.evaluate_split(port, scenes, "cpu", "mAP")
    assert set(both) == set(got) | set(got_map)


def test_fcaf3d_only_val_losses_match_jax(points_case, monkeypatch):
    """Stage 2's val losses (the test forward on eval-mode norms, no
    augmentation) against JAX's ``evaluate_val``, within 1e-4 relative."""
    from cnrma_tpu.ops import sparse as j_sparse
    tb, port, jb, model, variables = points_case
    monkeypatch.setattr(j_sparse, "LUT_CELL_BUDGET", 0)
    batch = {k: v.numpy() for k, v in tb.items()}
    folded = jax.jit(lambda v: model.apply(v, jb, train=False)).lower(
        variables).compile(
            compiler_options={"xla_backend_optimization_level": 0})
    want = jloop.evaluate_val(model, _state(variables), [jb],
                              lambda v, b: folded(v))
    got = tloop.evaluate_val(port, [batch], "cpu")
    print("stage-2 val losses:", got)
    _close(got, want)
    assert want["val/loss_bbox"] > 0


def test_atlas_val_losses_match_jax():
    """Stage 1's val losses (the three TSDF scales) against JAX's
    ``evaluate_val`` within 1e-4 relative, on two scenes; its mAP is the
    empty dict on both sides."""
    model, batch = tiny_model(detection=False)
    torch.manual_seed(0)
    port = tcn.Atlas(voxel_dim=(16, 16, 16), voxel_size=0.1).eval()
    _randomize_norms(port, 12)
    variables = _flax_tree(port.state_dict())
    scenes = [_host(batch), _host(_second_scene(_host(batch)))]
    state = _state(variables)
    step = _eval_step(model, variables, scenes[0])
    want = jloop.evaluate_val(model, state, scenes, step)
    got = tloop.evaluate_val(port, scenes, "cpu")
    print("stage-1 val losses:", got)
    _close(got, want)
    assert set(got) == {"val/tsdf_loss_010", "val/tsdf_loss_020",
                        "val/tsdf_loss_040", "val/total_loss"}
    assert tloop.evaluate_val_map(port, scenes, "cpu") == {} == \
        jloop.evaluate_val_map(model, state, scenes, step)


# --- the val hook and best.pt ---------------------------------------------------------

class _Quadratic(nn.Module):
    """A one-tensor model that ``train_step`` can train."""

    def __init__(self):
        super().__init__()
        self.w = nn.Parameter(torch.ones(3))

    def forward_train(self, batch, generator=None):
        return {"loss_w": (self.w ** 2).sum()}


def _hook_run(tmp_path, scores, metric, epochs, interval, max_steps=None):
    """``run_training`` of ``_Quadratic`` over two steps an epoch with a
    stub evaluator that returns ``scores`` in turn (a loss or an mAP) and
    notes the parameter it saw: (records, best.pt, the evaluations)."""
    model = _Quadratic()
    opt = build_optimizer(dict(type="AdamW", lr=0.1), model, lambda s: 0.1)
    state = TrainState(model=model, optimizer=opt)
    seen = []

    def evaluate():
        s = scores[len(seen)]
        seen.append((state.step, model.w.detach().clone()))
        return ({"val/total_loss": s} if metric == "loss"
                else {"val/total_loss": 1.0, "val/mAP_0.25": s})
    loader = [{"wait_s": 0.0, "load_s": 0.0}] * 2
    records, _ = tloop.run_training(
        state, loader, epochs=epochs, work_dir=str(tmp_path), device="cpu",
        checkpoint_interval=100, max_steps=max_steps, evaluate=evaluate,
        eval_interval=interval, eval_metric=metric)
    best = torch.load(tmp_path / "best.pt", weights_only=True)
    return records, best, seen


@pytest.mark.parametrize("metric,scores,best_epoch", [
    ("loss", [3.0, 2.0, 1.0, 2.0, 3.0], 3),
    ("mAP", [0.1, 0.4, 0.3, 0.2, 0.4], 2)])
def test_best_checkpoint_follows_the_metric(tmp_path, metric, scores,
                                            best_epoch):
    """Scores that fall and then rise: ``best.pt`` holds the epoch of the
    lowest loss, or of the first highest mAP, with that epoch's
    parameters and its meta; every epoch's last record holds its scores;
    ``best.pt`` resumes."""
    records, best, seen = _hook_run(tmp_path, scores, metric, epochs=5,
                                    interval=1)
    assert len(seen) == 5 and len(records) == 10
    assert [r.get("val", {}).get("val/total_loss") is not None
            for r in records] == [False, True] * 5
    meta = best["meta"]
    assert meta["epoch"] == best_epoch and meta["eval_metric"] == metric
    key = "val/total_loss" if metric == "loss" else "val/mAP_0.25"
    assert records[2 * best_epoch - 1]["val"][key] == scores[best_epoch - 1]
    assert meta["val_total_loss"] == records[2 * best_epoch - 1]["val"][
        "val/total_loss"]
    step, w = seen[best_epoch - 1]
    assert best["step"] == step == 2 * best_epoch
    torch.testing.assert_close(best["model"]["w"], w, rtol=0, atol=0)
    fresh = _Quadratic()
    state = TrainState(model=fresh, optimizer=build_optimizer(
        dict(type="AdamW", lr=0.1), fresh, lambda s: 0.1))
    load_checkpoint(str(tmp_path / "best.pt"), state)
    assert state.step == step and state.epoch == best_epoch
    log = (tmp_path / "train.log").read_text()
    assert log.count(f"{key} ") == 5


def test_hook_runs_at_interval_last_epoch_and_max_steps(tmp_path):
    """Every ``eval_interval``-th epoch and the last (interval 2 of 5
    epochs: after epochs 2, 4 and 5); a stop by ``max_steps`` inside an
    epoch scores it too (interval 4, stop at step 5 in epoch 3)."""
    records, _, seen = _hook_run(tmp_path / "a", [5.0, 4.0, 3.0], "loss",
                                 epochs=5, interval=2)
    assert [s for s, _ in seen] == [4, 8, 10]
    assert [r["step"] for r in records if "val" in r] == [4, 8, 10]
    records, best, seen = _hook_run(tmp_path / "b", [5.0], "loss",
                                    epochs=10, interval=4, max_steps=5)
    assert [s for s, _ in seen] == [5] and len(records) == 5
    assert best["meta"]["epoch"] == 3 and best["step"] == 5
    assert "eval_s" in records[-1]


# --- the train CLI: F14 -----------------------------------------------------------------

TRAIN_GRID, TEST_GRID = "(16,16,16)", "(32,32,16)"
SMALL = ["model.ray_samples=32", "model.rays_per_view_cap=64",
         "model.max_points=128",
         "model.capacities={'voxelize':256,'stride2':128,'stride4':64,"
         "'levels':(32,16,8,8),'neck':(64,32,16)}"]


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    """The train CLI's options for two tiny synthetic ScanNet scenes as a
    training and a val split: the training grid 16x16x16, the test grid
    (the val samples' and the test twin's) 32x32x16."""
    root = str(tmp_path_factory.mktemp("split"))
    ann = write_scannet(root, n_scenes=2, n_frames=3, tsdf_dim=(32, 32, 16),
                        image_size=(128, 96),
                        ann_name="scannet_infos_train.pkl")
    val = os.path.join(root, "scannet_infos_val.pkl")
    shutil.copy(ann, val)
    views = ["num_frames=2", "image_size=(64,32)", f"data_root={root}"]
    opts = ([f"data.train.{o}" for o in views]
            + [f"data.val.{o}" for o in views]
            + [f"data.train.ann_file={ann}", f"data.val.ann_file={val}",
               f"model.voxel_dim_train={TRAIN_GRID}",
               f"data.train.voxel_dim={TRAIN_GRID}",
               f"model.voxel_dim_test={TEST_GRID}",
               f"data.val.voxel_dim={TEST_GRID}", *SMALL])
    return opts


def _options(opts):
    cfg = Config.fromfile(CONFIG)
    cfg.merge_from_options(dict(kv.split("=", 1) for kv in opts))
    return cfg


def test_train_cli_scores_val_at_the_test_grid(split):
    """F14: the train CLI's evaluator (``val_evaluator``: the config's val
    split, interval and metric, scored through ``test_twin``) scores at
    ``voxel_dim_test`` with the training model's parameters: its scores
    equal those of a test-mode model built at that grid with the same
    state, and a model at the training grid cannot take those samples
    (the JAX tool's fault).  Nothing is written to disk: a checkpoint of
    the full-width model holds its optimizer's moments, 1.4 GB."""
    cfg = _options(split)
    torch.manual_seed(0)
    model = build_model(cfg, mode="train")
    evaluate, interval, metric = train_cli.val_evaluator(cfg, model, 0,
                                                         "cpu")
    assert (interval, metric) == (10, "mAP") and model.training
    got = evaluate()
    print("val scores:", got)
    assert model.training and model.voxel_dim == (16, 16, 16)
    test_model = build_model(cfg, mode="test")
    test_model.load_state_dict(model.state_dict())
    assert test_model.voxel_dim == (32, 32, 16)
    loader = SceneLoader(build_dataset(cfg, "val", seed=0), shuffle=False)
    want = tloop.evaluate_split(test_model, loader, "cpu", "mAP")
    assert set(want) == set(got) and "val/mAP_0.25" in got
    for k, w in want.items():
        assert math.isfinite(w), k
        np.testing.assert_allclose(got[k], w, rtol=1e-6, atol=1e-7,
                                   err_msg=k)
    with pytest.raises(RuntimeError):
        tloop.evaluate_val(model, loader, "cpu")


def test_train_cli_trains_on_without_a_val_split(split, capsys):
    """A config whose val split cannot be read gets no evaluator and a
    warning, as the JAX tool; a config without ``evaluation`` gets none
    and no warning."""
    cfg = _options([*split, "data.val.ann_file=/nonexistent/infos.pkl"])
    model = build_model(cfg, mode="train")
    assert train_cli.val_evaluator(cfg, model, 0, "cpu")[0] is None
    assert "WARNING: val split unavailable" in capsys.readouterr().out
    cfg = _options([*split, "evaluation=None"])
    assert train_cli.val_evaluator(cfg, model, 0, "cpu")[0] is None
    assert "WARNING" not in capsys.readouterr().out


def test_test_twin_shares_the_training_tensors():
    """The twin's parameters and buffers are the training model's tensors
    (no copy), on the test grid, in eval mode."""
    cfg = _options([f"model.voxel_dim_train={TRAIN_GRID}",
                    f"model.voxel_dim_test={TEST_GRID}", *SMALL])
    model = build_model(cfg, mode="train")
    twin = train_cli.test_twin(cfg, model)
    assert twin.voxel_dim == (32, 32, 16) and not twin.training
    assert model.training
    for (n, a), (m, b) in zip(model.state_dict(keep_vars=True).items(),
                              twin.state_dict(keep_vars=True).items()):
        assert n == m and a is b, n

"""The three-stage ScanNet recipe of the port against the JAX package, fp32 on
the CPU: the stage-1 reader modes and ``Atlas``, the stage-2 point reader
and ``FCAF3DOnly``, Adam, the reference-checkpoint converter, the merge of
the stages' checkpoints and the mesh metrics.

Tolerances: exact for the readers' arrays and the converter's tensors (the
same numpy operations on both sides); 1e-6 for one Adam step (the same fp32
operations); 1e-6 relative for the mesh metrics (sums of fp64 distances in
another order); ``test_torch_train.STEP_LIMITS`` for the stage-1 training
step (chaotic in fp32 at random weights, ROADMAP F6); 1e-4 of the TSDF
scale for the Atlas test forward; 1e-4 relative for the stage-2 losses and
1e-4 of their scale for its boxes and scores.  The JAX side's training
step compiles at XLA's default level, as ``test_torch_train``'s does (its
limits are set for that rounding); its other graphs at the lowest level,
which halves their compile time (``_run_jax``).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cnrma_torch.models import cn_rma as tcn
from cnrma_torch.synthetic import (
    synthesize_parameters, write_point_dumps, write_scannet)
from test_pipeline import tiny_model
from test_torch_train import (
    _drop_view_gradient, _step_failures, _step_readings, step_views)

T = torch.from_numpy
_STATS = {"running_mean": "mean", "running_var": "var"}


def _run_jax(fn, *args):
    """``jax.jit(fn)(*args)`` compiled at XLA's lowest backend
    optimisation level (half the compile time of these graphs on the CPU;
    the same function, rounded in another order), on the host."""
    compiled = jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})
    return jax.device_get(compiled(*args))


def _flax_tree(state):
    """The flax variable tree of a port state dict, without the flax module
    (the inverse of ``bridge.from_flax``): a dense conv's ``weight`` [Cout,
    Cin, k...] becomes ``kernel`` [k..., Cin, Cout], a norm's ``weight``
    (rank 1) ``scale``, the running statistics ``batch_stats``' ``mean``
    and ``var``; every other tensor keeps its name."""
    tree = {"params": {}, "batch_stats": {}}
    for key, t in state.items():
        *mods, name = key.split(".")
        w = t.detach().numpy()
        col = "params"
        if name in _STATS:
            col, name = "batch_stats", _STATS[name]
        elif name == "weight" and w.ndim >= 4:
            name = "kernel"
            w = np.transpose(w, tuple(range(2, w.ndim)) + (1, 0))
        elif name == "weight":
            name = "scale"
        node = tree[col]
        for m in mods:
            node = node.setdefault(m, {})
        node[name] = np.array(w)
    return tree


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """Two tiny synthetic ScanNet scenes (6 frames of 128x96, a room TSDF
    over 64x64x32 voxels) as a training and a validation split."""
    root = str(tmp_path_factory.mktemp("stages"))
    ann = write_scannet(root, n_scenes=2, n_frames=6, tsdf_dim=(64, 64, 32),
                        image_size=(128, 96),
                        ann_name="scannet_infos_train.pkl")
    val = os.path.join(root, "scannet_infos_val.pkl")
    with open(ann, "rb") as src, open(val, "wb") as dst:
        dst.write(src.read())
    return root, ann, val


# --- the stage models' knobs ----------------------------------------------------

@pytest.mark.parametrize("config", ["configs/atlas_recon_scannet.py",
                                    "configs/fcaf3d_middle_scannet.py"])
def test_builder_knobs_of_the_stage_models(config, monkeypatch):
    """Every knob the torch builder reads for ``Atlas`` and ``FCAF3DOnly``
    equals the JAX builder's (flax dataclasses, built without init), and
    the models are the ones the configs name."""
    from cnrma_torch.core import builder as t_builder
    from cnrma_torch.core.config import Config as TConfig
    from cnrma_torch.models.fcaf3d_only import FCAF3DOnly
    from cnrma_tpu.core import builder as j_builder
    from cnrma_tpu.core.config import Config as JConfig
    from cnrma_tpu.ops import sparse as j_sparse
    # the JAX builder sets this module global; keep it for later tests
    monkeypatch.setattr(j_sparse, "LUT_CELL_BUDGET", j_sparse.LUT_CELL_BUDGET)
    jm = j_builder.build_model(JConfig.fromfile(config), mode="train")
    tcfg = TConfig.fromfile(config)
    model = t_builder.build_model(tcfg, mode="train")
    assert type(model).__name__ == type(jm).__name__ and model.training
    kw = (t_builder.fcaf3d_only_kwargs(tcfg) if isinstance(model, FCAF3DOnly)
          else t_builder.cnrma_kwargs(tcfg, "train"))
    for name, value in kw.items():
        want = getattr(jm, name)
        if name == "compute_dtype":
            assert value == getattr(torch, jnp.dtype(want).name), name
        elif name == "capacities":
            assert tuple(value) == tuple(want), name
        else:
            assert value == want, (name, value, want)


# --- stage 1: the recon reader modes -------------------------------------------

@pytest.mark.parametrize("split", ["train", "test"])
def test_recon_reader_matches_jax(scenes, split, monkeypatch):
    """``configs/atlas_recon_scannet.py``'s reader (``recon_random`` with
    the config's ``recon_pipeline`` in training, ``recon_test`` in test)
    through each package's builder: the same frames, crop, projections,
    offset and GT TSDFs for the same seed, exactly.  The JAX reader
    resamples the TSDFs with its numpy path, the one the port copies: its
    optional native library rounds otherwise, and under a rotation that
    picks other nearest voxels."""
    from cnrma_torch.core.builder import build_dataset as t_dataset
    from cnrma_torch.core.config import Config as TConfig
    from cnrma_tpu.core.builder import build_dataset as j_dataset
    from cnrma_tpu.core.config import Config as JConfig
    from cnrma_tpu.utils import native
    monkeypatch.setattr(native, "available", lambda: False)
    root, ann, val = scenes
    opts = {f"data.{split}.data_root": root,
            f"data.{split}.ann_file": ann if split == "train" else val,
            f"data.{split}.num_frames": "4",
            f"data.{split}.image_size": "(64,48)",
            f"data.{split}.voxel_dim": "(32,32,16)"}
    cfgs = []
    for Config in (JConfig, TConfig):
        cfg = Config.fromfile("configs/atlas_recon_scannet.py")
        cfg.merge_from_options(dict(opts))
        cfgs.append(cfg)
    jr, tr = j_dataset(cfgs[0], split, seed=3), t_dataset(cfgs[1], split,
                                                           seed=3)
    assert tr.space_mode == ("recon_random" if split == "train"
                             else "recon_test")
    for i in range(2):
        want, got = jr[i], tr[i]
        assert set(got) == set(want)
        assert list(got["image_ids"]) == list(want["image_ids"])
        for k, w in want.items():
            if k in ("scene", "image_ids"):
                continue
            assert got[k].dtype == w.dtype, k
            np.testing.assert_array_equal(got[k], w, err_msg=k)
        assert (want["tsdf_gt_004"] < 1).any()          # the crop sees the room


# --- stage 2: the point reader ---------------------------------------------------

def test_points_reader_matches_jax(scenes, tmp_path):
    """``MiddlePointsDataset`` of each package on the same dumps: a scene
    with more points than ``num_points`` (the subsample draw) and one with
    fewer (padding), exactly equal samples for the same seed; a scene
    without a dump is left out."""
    from cnrma_torch.core.builder import build_dataset as t_dataset
    from cnrma_torch.core.config import Config as TConfig
    from cnrma_tpu.data.points_dataset import MiddlePointsDataset as JReader
    root, ann, _ = scenes
    dumps = str(tmp_path / "mid")
    write_point_dumps(root, dumps, n_points=700, seed=4)
    short = os.path.join(dumps, "scene0001_00_vert.npy")
    np.save(short, np.load(short)[:300])
    cfg = TConfig.fromfile("configs/fcaf3d_middle_scannet.py")
    cfg.merge_from_options({"data.train.data_root": root,
                            "data.train.ann_file": ann,
                            "data.train.points_dir": dumps,
                            "data.train.num_points": "500",
                            "data.train.repeat": "2"})
    tr = t_dataset(cfg, "train", seed=5)
    jr = JReader(root, ann, dumps, num_points=500, repeat=2, seed=5)
    assert len(tr) == len(jr) == 4
    for i in range(4):
        want, got = jr[i], tr[i]
        assert set(got) == set(want)
        for k, w in want.items():
            if k == "scene":
                assert got[k] == w
                continue
            assert got[k].dtype == w.dtype, k
            np.testing.assert_array_equal(got[k], w, err_msg=k)
    assert tr[0]["point_valid"].all() and tr[1]["point_valid"].sum() == 300
    os.remove(short)
    assert [i["scene"] for i in t_dataset(cfg, "train").data_infos] == [
        "scene0000_00"]


# --- Adam ------------------------------------------------------------------------

def _named_module(shapes):
    """An ``nn.Module`` whose parameters carry the given dotted names."""
    root = torch.nn.Module()
    for name, shape in shapes.items():
        *mods, leaf = name.split(".")
        node = root
        for m in mods:
            if not hasattr(node, m):
                node.add_module(m, torch.nn.Module())
            node = getattr(node, m)
        node.register_parameter(leaf, torch.nn.Parameter(torch.zeros(shape)))
    return root


def test_adam_step_matches_optax():
    """``type='Adam'`` (the stage-1 config's): three steps against optax's
    ``clip_by_global_norm`` + ``adam`` through the JAX package's
    ``build_optimizer``, within 1e-6; the clip is active in steps 1 and 3,
    the config's ``weight_decay`` is ignored as optax's ``adam`` ignores
    it, and the frozen stem is unchanged."""
    from cnrma_torch.train import optim as topt
    from cnrma_tpu.train import optim as jopt
    rng = np.random.RandomState(6)
    shapes = {"tower2d/resnet/stem/conv/kernel": (3, 4),
              "tower2d/fuse/p2_head0/conv/kernel": (5,),
              "backbone3d/up1_conv/kernel": (2, 3)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}

    def tree(flat):
        out = {}
        for k, v in flat.items():
            node = out
            *mods, leaf = k.split("/")
            for m in mods:
                node = node.setdefault(m, {})
            node[leaf] = jnp.asarray(v)
        return out
    cfg = {"type": "Adam", "lr": 1e-2, "weight_decay": 0.5}
    schedule = {"policy": "step", "step": [1], "gamma": 0.5}
    jtx = jopt.build_optimizer(cfg, jopt.build_lr_schedule(schedule, 1e-2, 2),
                               grad_clip=0.5, params=tree(params),
                               frozen_prefixes=jopt.FROZEN_PREFIXES_FREEZE_AT_2)
    jparams = tree(params)
    jstate = jtx.init(jparams)
    model = _named_module({k.replace("/", "."): s for k, s in shapes.items()})
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(T(params[n.replace(".", "/")]))
    opt = topt.build_optimizer(cfg, model,
                               topt.build_lr_schedule(schedule, 1e-2, 2),
                               grad_clip=0.5,
                               frozen_prefixes=topt.FROZEN_PREFIXES_FREEZE_AT_2)
    assert opt.weight_decay == 0.0 and len(opt.frozen) == 1
    for scale in (3.0, 0.01, 2.0):
        grads = {k: (rng.randn(*s) * scale).astype(np.float32)
                 for k, s in shapes.items()}
        upd, jstate = jtx.update(tree(grads), jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        opt.step({k.replace("/", "."): T(v) for k, v in grads.items()})
        for path, v in jax.tree_util.tree_leaves_with_path(jparams):
            name = ".".join(str(getattr(p, "key", p)) for p in path)
            np.testing.assert_allclose(
                dict(model.named_parameters())[name].detach().numpy(),
                np.asarray(v), atol=1e-6, rtol=0, err_msg=name)
    np.testing.assert_array_equal(
        model.tower2d.resnet.stem.conv.kernel.detach().numpy(),
        params["tower2d/resnet/stem/conv/kernel"])


# --- loading a stage-1 checkpoint for the dump -------------------------------------

def test_stage1_checkpoint_loads_for_the_dump(tmp_path):
    """The test CLI's loading for the stage-2.1 dump: an Atlas checkpoint
    loads into CNRMA, its tensors as they are and the detector's as
    ``synthesize_parameters(seed)`` draws them, their count returned; a
    missing reconstruction key or an unexpected key fails the load."""
    from cnrma_torch.tools.test import load_parameters
    from test_torch_bridge import tiny_torch_cnrma
    torch.manual_seed(0)
    atlas = tcn.Atlas(voxel_dim=(16, 16, 16), voxel_size=0.1)
    ckpt = str(tmp_path / "s1.pt")
    torch.save({"step": 1, "epoch": 0, "model": atlas.state_dict(),
                "optimizer": {}}, ckpt)
    model = tiny_torch_cnrma()
    n = load_parameters(model, ckpt, 3, keep_missing=("detector.",))
    synth = tiny_torch_cnrma()
    synthesize_parameters(synth, 3)
    want = {**synth.state_dict(), **atlas.state_dict()}
    got = model.state_dict()
    assert n == len([k for k in got if k.startswith("detector.")]) > 200
    for k, v in got.items():
        assert torch.equal(v, want[k]), k
    with pytest.raises(KeyError):           # the train CLI's strict load
        load_parameters(synth, ckpt, 3)
    for bad in ({k: v for k, v in atlas.state_dict().items()
                 if k != "tsdf_head.decoder0.weight"},
                {**atlas.state_dict(), "tower2d.stray": torch.zeros(1)}):
        torch.save(bad, ckpt)
        with pytest.raises(KeyError):
            load_parameters(synth, ckpt, 3, keep_missing=("detector.",))


# --- the merge ----------------------------------------------------------------------

def _stage_states():
    """Stage 1's and stage 2's state dicts with CNRMA's names, a small
    random tensor each: the merge reads names, not shapes."""
    from cnrma_torch.tools.combine_models import DETECTOR, cnrma_keys
    names = sorted(cnrma_keys())
    g = torch.Generator().manual_seed(0)
    state = {k: torch.randn(3, generator=g) for k in names}
    a = {k: v for k, v in state.items() if not k.startswith(DETECTOR)}
    b = {k: v for k, v in state.items() if k.startswith(DETECTOR)}
    return a, b


def test_combine_models(tmp_path):
    """An Atlas train checkpoint and an FCAF3DOnly state dict merge into a
    state dict with exactly CNRMA's names, every tensor bit for bit; an
    overlapping, an unknown or a missing key fails the merge and writes
    nothing.  (The stage-3 model loading a merged file of real stage
    checkpoints: ``tests/test_torch_no_jax.py``.)"""
    from cnrma_torch.tools import combine_models
    a, b = _stage_states()
    pa, pb = str(tmp_path / "a.pt"), str(tmp_path / "b.pt")
    torch.save({"step": 3, "epoch": 0, "model": a, "optimizer": {}}, pa)
    torch.save(b, pb)
    out = str(tmp_path / "merged.pt")
    combine_models.main(["--recon", pa, "--detector", pb, "--output", out])
    merged = torch.load(out, weights_only=True)
    assert len(a) > 500 and len(b) > 200
    assert set(merged) == set(a) | set(b) and not set(a) & set(b)
    for k, v in {**a, **b}.items():
        assert merged[k].dtype == v.dtype and torch.equal(
            merged[k].reshape(-1).view(torch.uint8),
            v.reshape(-1).view(torch.uint8)), k
    stray = {"tower2d.resnet.stem.conv.weight":
             a["tower2d.resnet.stem.conv.weight"]}
    bad = {"overlapping": (a, {**b, **stray}),
           "keys of no CN-RMA submodule": ({**a, "head.w": torch.ones(1)},
                                           b),
           "CNRMA keys missing": ({k: v for k, v in a.items()
                                   if not k.startswith("tsdf_head.")}, b)}
    for what, (ra, rb) in bad.items():
        torch.save(ra, pa)
        torch.save(rb, pb)
        bad_out = str(tmp_path / "bad.pt")
        with pytest.raises(KeyError, match=what):
            combine_models.main(["--recon", pa, "--detector", pb,
                                 "--output", bad_out])
        assert not os.path.exists(bad_out)


# --- mesh metrics --------------------------------------------------------------------

def test_mesh_metrics_match_jax(tmp_path):
    """``eval_mesh_metrics`` against the JAX package's on random meshes
    (a GT and a noisy prediction of it), and ``evaluate_mesh``'s CLI files
    on the same meshes written as PLY, within 1e-6 relative."""
    from cnrma_torch.eval.mesh_eval import eval_mesh_metrics as t_metrics
    from cnrma_torch.tools import evaluate_mesh
    from cnrma_torch.utils.ply import write_ply_mesh
    from cnrma_tpu.eval.mesh_eval import eval_mesh_metrics as j_metrics
    rng = np.random.RandomState(7)
    gt = (rng.rand(3000, 3) * 2).astype(np.float32)
    pred = (gt[:2000] + rng.randn(2000, 3).astype(np.float32) * 0.03)
    want = j_metrics(pred, gt)
    got = t_metrics(pred, gt)
    assert set(got) == set(want) and 0 < want["fscore"] < 1
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
    faces = rng.randint(0, 2000, (100, 3))
    res, gts = tmp_path / "res", tmp_path / "gt"
    (res / "scene0000_00").mkdir(parents=True)
    gts.mkdir()
    write_ply_mesh(str(res / "scene0000_00" / "scene0000_00.ply"), pred,
                   faces)
    write_ply_mesh(str(gts / "scene0000_00.ply"), gt, faces)
    mean = evaluate_mesh.main(["--data_path", str(tmp_path), "--result_path",
                               str(res), "--gt_path", str(gts)])
    assert (res / "scene0000_00" / "metrics.json").is_file()
    assert (res / "metrics_mean.json").is_file()
    for k in want:
        np.testing.assert_allclose(mean[k], want[k], rtol=1e-6, err_msg=k)


# --- stage 1: Atlas ----------------------------------------------------------------

@pytest.fixture(scope="module")
def atlas_step():
    """JAX's ``value_and_grad`` of the tiny Atlas's training forward
    (``tiny_model(detection=False)`` on the 64x64 views of
    ``test_torch_train.step_views``) on the port's synthesized parameters
    (seed 1), and the same batch for the port."""
    model, batch = tiny_model(detection=False)
    batch = dict(batch, **step_views())
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
    # the step at XLA's default optimisation level, as test_torch_train's:
    # the chaotic step's limits are set for that rounding
    (loss, (losses, stats)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
    want = jax.device_get({"loss": loss, "losses": losses, "stats": stats,
                           "grads": grads})
    tb = {k: T(np.array(v)) for k, v in batch.items() if k != "tsdf_list"}
    tb["tsdf_list"] = {k: T(np.array(v))
                       for k, v in batch["tsdf_list"].items()}
    return want, state, tb, model, batch


def _fresh_atlas(state):
    port = tcn.Atlas(voxel_dim=(16, 16, 16), voxel_size=0.1)
    port.load_state_dict(state)
    return port.train()


def test_atlas_train_step_matches_jax(atlas_step):
    """Stage 1's training step: the three TSDF losses and every gradient
    against JAX's ``Atlas`` at ``test_torch_train``'s ``STEP_LIMITS`` (the
    R-50 trunk as a group and by leaf cosine, every other leaf within 1e-3
    of its largest; the trunk's train-mode norms are chaotic in fp32 at
    random weights, ROADMAP F6), the new running statistics within 1e-5.
    The whole gradient of the tower comes through the volume (K1b's
    function), so the step holds the volume's backward too."""
    want, state, tb, *_ = atlas_step
    assert set(want["losses"]) == {"tsdf_loss_040", "tsdf_loss_020",
                                   "tsdf_loss_010"}
    r = _step_readings(_fresh_atlas(state), tb, {}, want)
    print("atlas step readings:", r)
    assert not _step_failures(r), r


def test_atlas_step_check_catches_planted_fault(atlas_step, monkeypatch):
    """The same limits fail a step whose volume backward loses view 1's
    gradient: a limit of the trunk's breaks."""
    want, state, tb, *_ = atlas_step
    _drop_view_gradient(monkeypatch)
    r = _step_readings(_fresh_atlas(state), tb, {}, want)
    failed = _step_failures(r)
    print(f"k1b_drops_view: breaks {failed}; readings {r}")
    assert {"trunk_cos", "trunk_err", "trunk_leaf_cos"} & set(failed), r


def test_atlas_test_forward_matches_jax(atlas_step):
    """The Atlas test forward (running statistics, no detector) on the
    port's default initialisation (seed 0) with random norms: each scale's
    TSDF within 1e-4 of its scale, and no other output."""
    _, state, tb, model, batch = atlas_step
    torch.manual_seed(0)
    port = tcn.Atlas(voxel_dim=(16, 16, 16), voxel_size=0.1).eval()
    _randomize_norms(port, 12)
    variables = _flax_tree(port.state_dict())
    want = _run_jax(lambda v: model.apply(v, batch, train=False)["tsdf"],
                    variables)
    out = port(tb)
    assert set(out) == {"tsdf"} and set(out["tsdf"]) == set(want)
    for k, w in want.items():
        w = np.asarray(w)
        assert w.std() > 1e-3, k
        np.testing.assert_allclose(out["tsdf"][k].numpy(), w,
                                   atol=1e-4 * np.abs(w).max(), err_msg=k)
    assert not hasattr(port, "detector")
    assert set(state) < set(tcn.CNRMA(voxel_dim=(16, 16, 16)).state_dict())


# --- stage 2: FCAF3DOnly ------------------------------------------------------------

def _randomize_norms(module, seed):
    """Random eval statistics and affine parameters of every batch norm
    (``test_torch_bridge.randomize_stats``'s draws), so eval-mode norms
    are not identities."""
    g = np.random.RandomState(seed)
    with torch.no_grad():
        for name, t in module.state_dict().items():
            if name.endswith(("running_mean", "norm.bias", "norm1.bias")):
                t.copy_(T((g.randn(*t.shape) * 0.1).astype(np.float32)))
            elif name.endswith("running_var"):
                t.copy_(T((g.rand(*t.shape) + 0.5).astype(np.float32)))
            elif name.endswith(("norm.weight", "norm1.weight")):
                t.copy_(T((1 + g.randn(*t.shape) * 0.1).astype(np.float32)))


@pytest.fixture(scope="module")
def points_case():
    """A stage-2 batch (1000 points on a room's surfaces, 800 valid, 32
    feature columns, two GT boxes), and the tiny ``FCAF3DOnly`` of each
    package on the same parameters: the port's default initialisation
    (seed 0) with random norms, bridged to flax leaves."""
    from cnrma_torch.models.fcaf3d import DetectionCapacities as TCaps
    from cnrma_torch.models.fcaf3d_only import FCAF3DOnly as TOnly
    from cnrma_torch.synthetic import room_surface_points
    from cnrma_tpu.models import fcaf3d_only as jonly
    from cnrma_tpu.models.fcaf3d import DetectionCapacities as JCaps
    rng = np.random.RandomState(8)
    boxes = np.array([[0.5, 0.5, 0.3, 0.4, 0.3, 0.4],
                      [1.0, 1.1, 0.4, 0.3, 0.5, 0.6]], np.float32)
    pts = room_surface_points((1.6, 1.6, 1.2), boxes, 1000, rng)
    valid = np.arange(1000) < 800
    batch = {"points": pts[None], "point_feats":
             rng.randn(1, 1000, 32).astype(np.float32),
             "point_valid": valid[None],
             "gt_boxes": np.concatenate([boxes, np.zeros((2, 1))], 1)
             [None].astype(np.float32),
             "gt_labels": np.array([[0, 2]], np.int32),
             "gt_valid": np.ones((1, 2), bool)}
    kw = dict(n_classes=3, voxel_size=0.01, pts_threshold=2000,
              assigner_limit=2, assigner_topk=4, nms_pre=16)
    torch.manual_seed(0)
    port = TOnly(capacities=TCaps.tiny(), **kw)
    _randomize_norms(port, 11)
    model = jonly.FCAF3DOnly(capacities=JCaps.tiny(), **kw)
    variables = _flax_tree(port.state_dict())
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: T(np.array(v)) for k, v in batch.items()}
    return tb, port, jb, model, variables


def test_fcaf3d_only_losses_match_jax(points_case, monkeypatch):
    """Stage 2's training forward: the three detection losses against JAX's
    ``FCAF3DOnly`` with the augmentation's draws that JAX made, read out
    and injected into the port, within 1e-4 relative; positives are
    assigned (``loss_bbox`` > 0)."""
    from cnrma_tpu.models import fcaf3d_only as jonly
    from cnrma_tpu.ops import sparse as j_sparse
    tb, port, jb, model, variables = points_case
    draws = {}
    aug = jonly.feature_transform_aug

    def spy_aug(r, points, boxes, with_yaw, **cfg):
        kf, kv, kr, ks, kt = jax.random.split(r, 5)
        u = (jax.random.uniform(kf), jax.random.uniform(kv),
             jax.random.uniform(kr, minval=-0.087266, maxval=0.087266),
             jax.random.uniform(ks, minval=0.9, maxval=1.1),
             jax.random.normal(kt, (3,)) * jnp.asarray([0.1, 0.1, 0.1]))
        jax.debug.callback(lambda *a: draws.__setitem__(
            "aug", [np.asarray(x) for x in a]), *u)
        return aug(r, points, boxes, with_yaw, **cfg)
    monkeypatch.setattr(jonly, "feature_transform_aug", spy_aug)
    monkeypatch.setattr(j_sparse, "LUT_CELL_BUDGET", 0)
    want = _run_jax(lambda v: model.apply(
        v, jb, train=True, rngs={"aug": jax.random.PRNGKey(2)},
        mutable=["batch_stats"])[0]["losses"], variables)
    u_h, u_v, angle, scale, trans = draws["aug"]
    aug_draws = [{"flip_h": torch.tensor(bool(u_h < 0.5)),
                  "flip_v": torch.tensor(bool(u_v < 0.5)),
                  "angle": torch.tensor(float(angle)),
                  "scale": torch.tensor(float(scale)),
                  "trans": T(np.array(trans))}]
    state = {k: v.clone() for k, v in port.state_dict().items()}
    got = port.train().forward_train(tb, aug_draws=aug_draws)
    port.load_state_dict(state)         # the running statistics as before
    assert set(got) == set(want) == {"loss_centerness", "loss_bbox",
                                     "loss_cls"}
    assert float(want["loss_bbox"]) > 0
    print("stage-2 losses, relative errors:", {
        k: abs(float(got[k].detach()) / float(w) - 1) for k, w in want.items()})
    for k, w in want.items():
        np.testing.assert_allclose(float(got[k].detach()), float(w),
                                   rtol=1e-4, err_msg=k)


def test_fcaf3d_only_boxes_match_jax(points_case, monkeypatch):
    """Stage 2's test forward: the valid raw boxes and scores as sets
    ordered by score, within 1e-4 of their scale (scores 1e-5)."""
    from cnrma_tpu.ops import sparse as j_sparse
    tb, port, jb, model, variables = points_case
    monkeypatch.setattr(j_sparse, "LUT_CELL_BUDGET", 0)
    out = _run_jax(lambda v: model.apply(v, jb, train=False), variables)
    got = port.eval()(tb)
    assert set(got) == {"bboxes", "scores", "bbox_valid"}

    def ordered(b, s, v):
        b, s, v = np.asarray(b[0]), np.asarray(s[0]), np.asarray(v[0])
        o = np.argsort(-s[v].max(1), kind="stable")
        return b[v][o], s[v][o]
    jbx, js = ordered(out["bboxes"], out["scores"], out["bbox_valid"])
    tbx, ts = ordered(got["bboxes"], got["scores"], got["bbox_valid"])
    assert len(jbx) == len(tbx) > 0
    print(f"stage-2 boxes: {len(jbx)}, score error {np.abs(ts - js).max()}, "
          f"box error {np.abs(tbx - jbx).max() / np.abs(jbx).max()} of "
          f"their scale")
    np.testing.assert_allclose(ts, js, atol=1e-5)
    np.testing.assert_allclose(tbx, jbx, atol=1e-4 * np.abs(jbx).max())


# --- reference checkpoints ------------------------------------------------------------

def _reference_name(key):
    """The reference state-dict name of a port tensor (the inverse of
    ``tools/convert_checkpoint.py``'s mapping composed with
    ``bridge.from_flax``), or None for a tensor the reference does not
    store."""
    import re
    rules = [
        (r"tower2d\.resnet\.stem\.conv\.weight", "fpn.bottom_up.stem.conv1.weight"),
        (r"tower2d\.resnet\.stem\.norm\.(\w+)", r"fpn.bottom_up.stem.conv1.norm.\1"),
        (r"tower2d\.resnet\.res(\d)_block(\d+)\.(\w+)\.conv\.weight",
         r"fpn.bottom_up.res\1.\2.\3.weight"),
        (r"tower2d\.resnet\.res(\d)_block(\d+)\.(\w+)\.norm\.(\w+)",
         r"fpn.bottom_up.res\1.\2.\3.norm.\4"),
        (r"tower2d\.fpn\.(lateral|output)(\d)\.conv\.weight",
         r"fpn.fpn_\1\2.weight"),
        (r"tower2d\.fpn\.(lateral|output)(\d)\.norm\.(\w+)",
         r"fpn.fpn_\1\2.norm.\3"),
        (r"tower2d\.fuse\.(p\d)_head(\d)\.conv\.weight",
         lambda m: f"feature_2d.{m[1]}.{2 * int(m[2])}.weight"),
        (r"tower2d\.fuse\.(p\d)_head(\d)\.norm\.(\w+)",
         lambda m: f"feature_2d.{m[1]}.{2 * int(m[2])}.norm.{m[3]}"),
        (r"backbone3d\.down(\d)_stride\.conv\.weight",
         r"backbone3d.layers_down.\1.0.weight"),
        (r"backbone3d\.down(\d)_stride\.norm\.(\w+)",
         r"backbone3d.layers_down.\1.1.\2"),
        (r"backbone3d\.down(\d)_block(\d)\.(.*)",
         lambda m: f"backbone3d.layers_down.{m[1]}."
                   f"{int(m[2]) + (4 if int(m[1]) else 0)}.{_block(m[3])}"),
        (r"backbone3d\.up(\d)_conv\.weight",
         lambda m: f"backbone3d.layers_up_conv.{int(m[1]) - 1}.weight"),
        (r"backbone3d\.up(\d)_proj\.weight",
         lambda m: f"backbone3d.proj.{int(m[1]) - 1}.conv.weight"),
        (r"backbone3d\.up(\d)_proj_norm\.(\w+)",
         lambda m: f"backbone3d.proj.{int(m[1]) - 1}.norm.{m[2]}"),
        (r"backbone3d\.up(\d)_block(\d)\.(.*)",
         lambda m: f"backbone3d.layers_up_res.{int(m[1]) - 1}.{m[2]}."
                   f"{_block(m[3])}"),
        (r"tsdf_head\.decoder(\d)\.weight", r"tsdf_head.decoders.\1.weight"),
        (r"detector\.backbone\.stem\.kernel",
         "detection_backbone.conv1.0.kernel"),
        (r"detector\.backbone\.stem\.norm\.(\w+)",
         r"detection_backbone.conv1.1.\1"),
        (r"detector\.backbone\.layer(\d)_block(\d)\.conv(\d)\.kernel",
         r"detection_backbone.layer\1.\2.conv\3.kernel"),
        (r"detector\.backbone\.layer(\d)_block(\d)\.conv(\d)\.norm\.(\w+)",
         r"detection_backbone.layer\1.\2.norm\3.\4"),
        (r"detector\.backbone\.layer(\d)_block(\d)\.downsample\.kernel",
         r"detection_backbone.layer\1.\2.downsample.0.kernel"),
        (r"detector\.backbone\.layer(\d)_block(\d)\.downsample\.norm\.(\w+)",
         r"detection_backbone.layer\1.\2.downsample.1.bn.\3"),
        (r"detector\.head\.up_block_(\d)\.up_kernel",
         r"detection_head.up_block_\1.0.kernel"),
        (r"detector\.head\.up_block_(\d)\.norm1\.(\w+)",
         r"detection_head.up_block_\1.1.bn.\2"),
        (r"detector\.head\.up_block_(\d)\.conv\.kernel",
         r"detection_head.up_block_\1.3.kernel"),
        (r"detector\.head\.up_block_(\d)\.conv\.norm\.(\w+)",
         r"detection_head.up_block_\1.4.bn.\2"),
        (r"detector\.head\.out_block_(\d)\.kernel",
         r"detection_head.out_block_\1.0.kernel"),
        (r"detector\.head\.out_block_(\d)\.norm\.(\w+)",
         r"detection_head.out_block_\1.1.bn.\2"),
        (r"detector\.head\.(centerness|reg|cls)_conv",
         r"detection_head.\1_conv.kernel"),
        (r"detector\.head\.cls_bias", "detection_head.cls_conv.bias"),
        (r"detector\.head\.scale_(\d)", r"detection_head.scales.\1.scale"),
    ]
    for pattern, repl in rules:
        m = re.fullmatch(pattern, key)
        if m:
            return repl(m) if callable(repl) else m.expand(repl)
    raise KeyError(key)


def _block(rest):
    """A U-Net residual block's tensor: ``conv1.conv`` / ``conv1.norm`` /
    ``conv2`` / ``bn2`` -> ``conv1`` / ``bn1`` / ``conv2`` / ``bn2``."""
    return (rest.replace("conv1.conv.", "conv1.")
            .replace("conv1.norm.", "bn1."))


def _reference_state(state):
    """A port state dict in the reference's layout: its names, ME's
    [Cin, Cout] for 1x1 sparse kernels, shape [1] for the head's scales
    (dense weights are torch's [Cout, Cin, k...] on both sides)."""
    out = {}
    for k, t in state.items():
        v = t.numpy().copy()
        if k.endswith(("kernel", "_conv")) and v.shape[0] == 1:
            v = v[0]
        if ".scale_" in k:
            v = v.reshape(1)
        out[_reference_name(k)] = v
    return out


def _small_state(state, seed):
    """Random tensors with ``state``'s names and ranks but at most 3 wide a
    dimension (an ME kernel keeps its 27, 8 or 1 offsets, so the 1x1 ones
    still take the reference's [Cin, Cout]): the mapping reads names and
    ranks, not widths."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for k, t in state.items():
        shape = [min(n, 3) for n in t.shape]
        if k.startswith("detector.") and t.dim() == 3:
            shape[0] = t.shape[0]
        out[k] = torch.randn(shape, generator=g)
    return out


@pytest.fixture(scope="module")
def reference_case():
    """The JAX package's ``tools/convert_checkpoint.py`` (numpy only), and
    the tiny CNRMA's default initialisation (seed 0) with random norms."""
    import importlib.util
    from test_torch_bridge import tiny_torch_cnrma
    spec = importlib.util.spec_from_file_location(
        "convert_checkpoint", "tools/convert_checkpoint.py")
    jconv = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jconv)
    torch.manual_seed(0)
    model = tiny_torch_cnrma()
    _randomize_norms(model, 13)
    return jconv, model


@pytest.mark.parametrize("layout", ["full", "r50"])
def test_converter_matches_jax_mapping(layout, reference_case, tmp_path):
    """A reference-layout state dict made with numpy from the tiny CNRMA's
    default initialisation (seed 0) with random norms: the port's
    ``convert.reference_state_dict`` gives exactly the tensors of
    ``bridge.from_flax(convert_state_dict(sd))`` with the JAX package's
    ``tools/convert_checkpoint.py``, and they are the original tensors.
    ``full``: every CN-RMA key, at small widths (``_small_state``), all of
    the tiny CNRMA's names and no other.  ``r50``: the bare detectron R-50
    (``bottom_up.*``) at its widths, as a ``.pth`` that
    ``load_pretrained_2d`` reads into a fresh model's tower, every trunk
    tensor and nothing else."""
    from cnrma_torch import convert
    from cnrma_torch.bridge import from_flax
    from test_torch_bridge import tiny_torch_cnrma
    jconv, model = reference_case
    state = model.state_dict()
    if layout == "r50":
        state = {k: v.clone() for k, v in state.items()
                 if k.startswith("tower2d.resnet.")}
    else:
        state = _small_state(state, 14)
    sd = _reference_state(state)
    if layout == "r50":
        sd = {k[len("fpn."):]: v for k, v in sd.items()}
        assert all(k.startswith("bottom_up.") for k in sd)
    params, stats = jconv.convert_state_dict(sd)
    want = from_flax({"params": params, "batch_stats": stats})
    got = convert.reference_state_dict(sd)
    assert set(got) == set(want) == set(state)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(),
                                      err_msg=k)
        np.testing.assert_array_equal(got[k].numpy(), state[k].numpy(),
                                      err_msg=k)
    if layout == "full":
        assert set(got) == set(model.state_dict())
        return
    path = str(tmp_path / "R-50.pth")
    torch.save({"state_dict": {k: T(v) for k, v in sd.items()}}, path)
    torch.manual_seed(1)
    fresh = tiny_torch_cnrma()
    before = {k: v.clone() for k, v in fresh.state_dict().items()}
    assert convert.load_pretrained_2d(fresh, path) == len(state)
    for k, v in fresh.state_dict().items():
        np.testing.assert_array_equal(
            v.numpy(), (state[k] if k in state else before[k]).numpy(),
            err_msg=k)

"""The port's data-parallel path on the CPU, ranks of ``gloo`` in spawned
processes (two torch threads each; every job of the file is started at
once, under one time limit):

(a) the detector loss with a process group equals JAX's
    ``FCAF3DDetector.loss(axis_name='data')`` under ``shard_map`` over two
    CPU devices, at 1e-6 relative, on two scenes whose positive counts
    differ and one of which has none (where the order of the mean and the
    clamp decides);
(b) the data-parallel step of ``FCAF3DOnly`` and ``CNRMA``, two steps on
    two ranks: the ranks' parameters and running statistics are equal bit
    for bit after each step, and after step 1 equal a one-process step on
    the mean of the two scenes' gradients and running statistics
    (``STEP_TOL``), the detector's
    positive count and centerness sum as the group averaged them equal to
    the mean of the two scenes' own; at world size 1 a step with a group
    is bit for bit a step without;
(c) the train CLI on two ranks: only rank 0 writes, an epoch has
    ``len // 2`` steps, and the sharded val scores equal a one-process
    ``evaluate_split`` of the same checkpoint (``EVAL_RTOL``).
"""

import json
import os
import pickle
import types

import numpy as np
import pytest
import torch

from cnrma_torch.core.builder import build_dataset, build_model
from cnrma_torch.core.config import Config
from cnrma_torch.data.loader import SceneLoader
from cnrma_torch.models import fcaf3d as tdet
from cnrma_torch.parallel import dist
from cnrma_torch.synthetic import write_point_dumps, write_scannet
from cnrma_torch.train import loop as tloop
from cnrma_torch.train.optim import (
    FROZEN_PREFIXES_FREEZE_AT_2, build_lr_schedule, build_optimizer)
from _torch_spawn import spawn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = {"stage2": os.path.join(REPO, "configs", "fcaf3d_middle_scannet.py"),
           "stage3": os.path.join(REPO, "configs", "ray_marching_scannet.py")}
CAPS = ("{'voxelize':256,'stride2':128,'stride4':64,"
        "'levels':(32,16,8,8),'neck':(64,32,16)}")
N_SCENES = 5                # train scenes: 2 steps an epoch on 2 ranks
N_VAL = 3
TIME_LIMIT = 450            # seconds the spawned jobs may take
LOSS_RTOL = 1e-6
# The one-process step against the ranks': the same arithmetic on the
# same inputs in another process, two threads each; stated as 1e-6 of
# each tensor's largest magnitude (the CPU runs have shown 0).
STEP_TOL = 1e-6
EVAL_RTOL = 1e-6


def _save(path, obj):
    with open(path, "w") as f:
        json.dump(obj, f)


def _read(path):
    with open(path) as f:
        return json.load(f)


# --- the synthetic split -----------------------------------------------------

@pytest.fixture(scope="module")
def split(tmp_path_factory):
    """5 tiny ScanNet scenes (the train split), the first 3 as a val split,
    and stage-2 dumps of 3000 points on each room."""
    root = str(tmp_path_factory.mktemp("ddp"))
    ann = write_scannet(root, n_scenes=N_SCENES, n_frames=4,
                        tsdf_dim=(32, 32, 16), image_size=(64, 48),
                        ann_name="scannet_infos_train.pkl")
    with open(ann, "rb") as f:
        infos = sorted(pickle.load(f), key=lambda x: x["scene"])
    with open(os.path.join(root, "scannet_infos_val.pkl"), "wb") as f:
        pickle.dump(infos[:N_VAL], f)
    write_point_dumps(root, os.path.join(root, "mid"), n_points=3000)
    return root


@pytest.fixture(scope="module")
def runs(split, tmp_path_factory):
    """Every spawned job of this file, started at once (the loss on two
    ranks; each stage's two data-parallel ranks and its world-size-1
    run; the train CLI on two ranks) while JAX's loss is computed here:
    the output directory, the jobs (their exit codes and seconds) and
    JAX's losses."""
    out = str(tmp_path_factory.mktemp("ranks"))
    groups = {"loss": (_loss_rank, 2, (out,)),
              "cli": (_cli_rank, 2, (out, split))}
    for stage in ("stage2", "stage3"):
        groups[stage] = (_ddp_steps, 2, (out, stage, split))
        groups[stage + "_world1"] = (_world_one, 1, (out, stage, split))
    jobs = spawn(groups, TIME_LIMIT, _jax_loss)
    return out, jobs, jobs.found


def _options(stage, root):
    train = os.path.join(root, "scannet_infos_train.pkl")
    if stage == "stage2":
        val = ("{'type':'MiddlePointsDataset','data_root':'%s',"
               "'ann_file':'%s/scannet_infos_val.pkl','points_dir':'%s/mid',"
               "'test_mode':True,'num_points':2000}" % (root, root, root))
        return [f"data.train.data_root={root}", f"data.train.ann_file={train}",
                f"data.train.points_dir={root}/mid", "data.train.repeat=1",
                "data.train.num_points=2000", f"model.capacities={CAPS}",
                f"data.val={val}", "total_epochs=1", "log_config.interval=1",
                "evaluation={'interval':1,'metric':'mAP'}"]
    return [f"data.train.data_root={root}", f"data.train.ann_file={train}",
            "data.train.num_frames=2", "data.train.image_size=(64,32)",
            "model.voxel_dim_train=(16,16,16)",
            "data.train.voxel_dim=(16,16,16)", "model.ray_samples=32",
            "model.rays_per_view_cap=64", "model.max_points=128",
            f"model.capacities={CAPS}"]


def _cfg(stage, root):
    cfg = Config.fromfile(CONFIGS[stage])
    cfg.merge_from_options(dict(kv.split("=", 1)
                                for kv in _options(stage, root)))
    return cfg


# The step tests' optimizer: the data-parallel step hands the optimizer
# its mean gradients, whatever the optimizer; SGD keeps the CPU time of
# the full-width models' steps (two models on rank 0) low, where AdamW's
# per-parameter moments take seconds a step.
STEP_OPTIMIZER = {"type": "SGD", "lr": 0.01, "momentum": 0.9}


def _trainer(cfg):
    """The train CLI's model (seed 0), with ``STEP_OPTIMIZER`` and the
    config's clip and frozen stem."""
    torch.manual_seed(0)
    model = build_model(cfg, mode="train")
    clip = ((cfg.get("optimizer_config", {}) or {}).get("grad_clip")
            or {}).get("max_norm")
    opt = build_optimizer(STEP_OPTIMIZER, model,
                          build_lr_schedule(cfg.get("lr_config", {}),
                                            STEP_OPTIMIZER["lr"], 2),
                          grad_clip=clip,
                          frozen_prefixes=FROZEN_PREFIXES_FREEZE_AT_2)
    return model, opt


def _batches(cfg, rank, world):
    loader = SceneLoader(build_dataset(cfg, "train", seed=0), shuffle=False,
                         rank=rank, world_size=world)
    return [tloop.device_batch(b, "cpu") for b in loader]


def _digest(model):
    """The bytes of every parameter and buffer, as one hash."""
    import hashlib
    h = hashlib.sha256()
    for k, v in model.state_dict().items():
        h.update(k.encode() + v.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def _max_rel(a, b):
    scale = max(float(b.abs().max()), 1e-30)
    return float((a - b).abs().max()) / scale


# --- (a) the loss ------------------------------------------------------------

LOSS_KW = dict(n_classes=18, n_reg_outs=6, assigner_limit=2, assigner_topk=6)


def _loss_case():
    """Head outputs of four levels for two scenes in a 3 m room (numpy,
    [2, N_level, ...]): scene 0 has six GT boxes, scene 1 the same boxes
    marked invalid, so no positive."""
    rng = np.random.RandomState(11)
    sizes = (400, 200, 100, 50)
    levels = []
    for n in sizes:
        points = np.concatenate([rng.rand(2, n, 2) * 3,
                                 rng.rand(2, n, 1) * 1.2], 2)
        levels.append([rng.randn(2, n).astype(np.float32),
                       (np.exp(rng.randn(2, n, 6) * 0.3) * 0.3
                        ).astype(np.float32),
                       (rng.randn(2, n, 18) * 2).astype(np.float32),
                       points.astype(np.float32), rng.rand(2, n) > 0.1])
    boxes = np.array([[0.8, 0.8, 0.5, 1.0, 0.6, 0.6, 0],
                      [2.2, 0.8, 0.5, 0.9, 0.8, 0.8, 0],
                      [0.8, 2.2, 0.4, 1.2, 1.0, 0.5, 0],
                      [2.2, 2.2, 0.6, 0.7, 0.6, 0.9, 0],
                      [1.5, 1.5, 0.3, 0.6, 0.5, 0.4, 0],
                      [1.5, 0.4, 0.3, 0.5, 0.6, 0.4, 0]], np.float32)
    gt = dict(gt_boxes=np.stack([boxes, boxes]),
              gt_labels=np.tile(np.arange(6, dtype=np.int32), (2, 1)),
              gt_valid=np.array([[True] * 6, [False] * 6]))
    return levels, gt


def _torch_loss(levels, gt, r, group):
    with torch.device("meta"):
        model = tdet.FCAF3DDetector(**LOSS_KW)
    outs = [tdet.LevelOut(*(torch.from_numpy(np.ascontiguousarray(x[r:r + 1]))
                            for x in lvl)) for lvl in levels]
    losses = model.loss(outs, *(torch.from_numpy(gt[k][r:r + 1])
                                for k in ("gt_boxes", "gt_labels",
                                          "gt_valid")), group=group)
    return {k: float(v) for k, v in losses.items()}


def _loss_rank(out):
    group, _ = dist.init_from_env("cpu")
    r = dist.rank(group)
    levels, gt = _loss_case()
    _save(os.path.join(out, f"loss{r}.json"),
          {"group": _torch_loss(levels, gt, r, group),
           "alone": _torch_loss(levels, gt, r, None)})
    dist.shutdown(group)


def _jax_loss():
    """JAX's ``loss(axis_name='data')`` of ``_loss_case`` under
    ``shard_map`` over two CPU devices: each loss, a value a device."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P
    from cnrma_tpu.models import fcaf3d as jdet
    levels, gt = _loss_case()
    jm = jdet.FCAF3DDetector(**LOSS_KW)
    mesh = Mesh(np.array(jax.devices()[:2]), ("data",))

    def per_device(outs, boxes, labels, valid):
        losses = jm.loss(outs, boxes, labels, valid, axis_name="data")
        return {k: v[None] for k, v in losses.items()}
    outs = [jdet.LevelOut(*map(jnp.asarray, lvl)) for lvl in levels]
    want = jax.jit(jax.shard_map(
        per_device, mesh=mesh, in_specs=(P("data"),) * 4,
        out_specs=P("data"), check_vma=False))(
        outs, *(jnp.asarray(gt[k]) for k in ("gt_boxes", "gt_labels",
                                             "gt_valid")))
    return {k: np.asarray(v).tolist() for k, v in want.items()}


def test_loss_with_a_group_matches_jax_pmean(runs):
    out, jobs, want = runs
    jobs.check("loss")
    for r in range(2):
        got = _read(os.path.join(out, f"loss{r}.json"))
        for k, w in want.items():
            np.testing.assert_allclose(got["group"][k], w[r],
                                       rtol=LOSS_RTOL, err_msg=(r, k))
    # the case decides: rank 1 alone clamps its count at 1, the group's
    # mean is rank 0's half; rank 0 alone divides by its own count
    alone = [_read(os.path.join(out, f"loss{r}.json"))["alone"]
             for r in range(2)]
    assert alone[0]["loss_cls"] != pytest.approx(want["loss_cls"][0])
    assert alone[1]["loss_cls"] != pytest.approx(want["loss_cls"][1])
    assert alone[1]["loss_bbox"] == 0.0


# --- (b) the step ------------------------------------------------------------

def _ddp_steps(out, stage, root):
    """A rank of two: two data-parallel steps; rank 0 also steps a
    one-process twin on the mean of the two scenes' gradients and running
    statistics and holds it against its own model after step 1."""
    group, _ = dist.init_from_env("cpu")
    r = dist.rank(group)
    cfg = _cfg(stage, root)
    model, opt = _trainer(cfg)
    seen = []
    real = tdet.dist

    def recording(t, g):
        seen.append(real.all_mean(t, g).clone())
        return t
    tdet.dist = types.SimpleNamespace(all_mean=recording)
    report = {"digests": [], "errors": []}
    if r == 0:
        ref, ref_opt = _trainer(cfg)
        scenes = [_batches(cfg, k, 2) for k in range(2)]
    for step, batch in enumerate(_batches(cfg, r, 2)):
        tloop.train_step(model, opt, batch,
                         tloop.step_generator(0, step, "cpu", r),
                         group=group)
        report["digests"].append(_digest(model))
        if r == 0 and step == 0:
            report["errors"].append(_reference_step(
                model, ref, ref_opt, [s[step] for s in scenes], step,
                seen[-1]))
    tdet.dist = real
    report["n_pos_denorm"] = [t.tolist() for t in seen]
    _save(os.path.join(out, f"{stage}_rank{r}.json"), report)
    dist.shutdown(group)


def _reference_step(model, ref, ref_opt, batches, step, group_mean):
    """One step of ``ref`` on the mean of ``batches``' gradients and
    running statistics.  Each scene's detector loss is normalised by the
    mean of the two scenes' own [positive count, centerness sum], read
    from a forward of each without a gradient, not from the group.
    Returns the largest differences from ``model``, relative to each
    tensor's largest magnitude, and that of ``group_mean`` (what the
    ranks' collective gave) from the scenes' own mean."""
    params = dict(ref.named_parameters())
    start = [b.clone() for b in tloop.running_stats(ref)]
    ours, own = tdet.dist, []

    def forward(r, batch):
        for b, s in zip(tloop.running_stats(ref), start):
            b.copy_(s)
        ref.train()
        return ref.forward_train(
            batch, generator=tloop.step_generator(0, step, "cpu", r),
            group="reference")
    try:
        tdet.dist = types.SimpleNamespace(
            all_mean=lambda t, g: own.append(t.clone()) or t)
        with torch.no_grad():
            for r, batch in enumerate(batches):
                forward(r, batch)
        mean = (own[0] + own[1]) / 2
        tdet.dist = types.SimpleNamespace(all_mean=lambda t, g: mean.clone())
        grads, stats = [], []
        for r, batch in enumerate(batches):
            losses = forward(r, batch)
            ref.zero_grad(set_to_none=True)
            tloop.total_loss(losses).backward()
            grads.append({n: p.grad if p.grad is not None
                          else torch.zeros_like(p)
                          for n, p in params.items()})
            stats.append([b.clone() for b in tloop.running_stats(ref)])
    finally:
        tdet.dist = ours
    mean_grads = {n: (grads[0][n] + grads[1][n]) / 2 for n in params}
    with torch.no_grad():
        for b, s0, s1 in zip(tloop.running_stats(ref), *stats):
            b.copy_((s0 + s1) / 2)
    ref_opt.step(mean_grads)
    mine = dict(model.named_parameters())
    return {
        "grads": max(_max_rel(mine[n].grad, g) for n, g in
                     mean_grads.items()),
        "params": max(_max_rel(mine[n].detach(), p.detach())
                      for n, p in params.items()),
        "stats": max(_max_rel(a, b) for a, b in zip(
            tloop.running_stats(model), tloop.running_stats(ref))),
        "counts": _max_rel(group_mean, mean),
    }


def _world_one(out, stage, root):
    """A step at world size 1 with a group, then one without, from the
    same start: every log var and every tensor after it."""
    runs = {}
    for mode in ("group", "alone"):
        group = dist.init_from_env("cpu")[0] if mode == "group" else None
        cfg = _cfg(stage, root)
        model, opt = _trainer(cfg)
        runs[mode] = []
        for step, batch in enumerate(_batches(cfg, 0, 1)[:1]):
            logs = tloop.train_step(model, opt, batch,
                                    tloop.step_generator(0, step, "cpu"),
                                    group=group)
            runs[mode].append({"logs": {k: float(v) for k, v in
                                        logs.items()},
                               "digest": _digest(model)})
        dist.shutdown(group)
    _save(os.path.join(out, f"{stage}_world1.json"), runs)


@pytest.mark.parametrize("stage", ["stage2", "stage3"])
def test_data_parallel_step(runs, stage):
    out, jobs, _ = runs
    jobs.check(stage, stage + "_world1")
    ranks = [_read(os.path.join(out, f"{stage}_rank{r}.json"))
             for r in range(2)]
    assert len(ranks[0]["digests"]) == 2
    assert ranks[0]["digests"] == ranks[1]["digests"]
    [err] = ranks[0]["errors"]
    for what, e in err.items():
        assert e <= STEP_TOL, (what, e)
    assert len(ranks[0]["n_pos_denorm"]) == 2
    assert ranks[0]["n_pos_denorm"] == ranks[1]["n_pos_denorm"]
    one = _read(os.path.join(out, f"{stage}_world1.json"))
    assert one["group"] == one["alone"]
    assert all(np.isfinite(list(s["logs"].values())).all()
               for s in one["group"])


# --- (c) the train CLI -------------------------------------------------------

def _cli_rank(out, root):
    from cnrma_torch.tools import train as train_cli
    r = int(os.environ["RANK"])
    records, path = train_cli.main(
        [CONFIGS["stage2"], "--device", "cpu", "--batch-size", "2",
         "--work-dir", os.path.join(out, f"wd{r}"),
         "--cfg-options", *_options("stage2", root)])
    _save(os.path.join(out, f"cli{r}.json"),
          {"steps": [rec["step"] for rec in records],
           "val": records[-1].get("val"), "path": path})
    if r == 1:              # the group is gone: one process from here
        _one_process_eval(out, root)


def _one_process_eval(out, root):
    """``evaluate_split`` of rank 0's ``epoch_1.pt`` over the whole val
    split in this process."""
    from cnrma_torch.tools.test import read_parameters
    cfg = _cfg("stage2", root)
    model = build_model(cfg, mode="test")
    model.load_state_dict(read_parameters(os.path.join(out, "wd0",
                                                       "epoch_1.pt")))
    loader = SceneLoader(build_dataset(cfg, "val", seed=0), shuffle=False)
    _save(os.path.join(out, "eval.json"),
          tloop.evaluate_split(model, loader, "cpu", "mAP"))


def test_train_cli_on_two_ranks(runs):
    out, jobs, _ = runs
    jobs.check("cli")
    ranks = [_read(os.path.join(out, f"cli{r}.json")) for r in range(2)]
    assert [r["steps"] for r in ranks] == [[1, 2], [1, 2]]  # 5 // 2 a rank
    assert sorted(os.listdir(os.path.join(out, "wd0"))) == [
        "best.pt", "config_dump.py", "epoch_1.pt", "train.log"]
    assert os.listdir(os.path.join(out, "wd1")) == []
    with open(os.path.join(out, "wd0", "train.log")) as f:
        lines = f.read().splitlines()
    assert [ln.split("  ")[1] for ln in lines] == ["iter 1", "iter 2",
                                                     "iter 2"]
    assert ranks[1]["val"] == {}
    got, want = ranks[0]["val"], _read(os.path.join(out, "eval.json"))
    assert set(got) == set(want) and "val/mAP_0.25" in got
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=EVAL_RTOL, err_msg=k)

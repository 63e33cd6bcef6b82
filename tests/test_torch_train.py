"""The training path of the port against the JAX package, fp32 on the CPU:
losses, the assigner, train-mode batch norms, the augmentation, the TSDF
losses, the optimizer, the reader's training split, the loader, and one
whole tiny train step (``tests/test_pipeline.py:tiny_model``) against
JAX's ``value_and_grad``.

Tolerances: 1e-6 where both sides run the same fp32 operations (assigner
targets, augmentation, three optimizer steps, the norms' running
statistics); 1e-6 of the largest magnitude (at least 1) where a sum's
order differs (the losses, the norms' outputs and gradients, whose batch
mean is such a sum); exact for labels, indices and the reader's arrays.
The whole step: ``test_train_step_matches_jax``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cnrma_torch import timing
from cnrma_torch.bridge import _convert
from cnrma_torch.models import assigner as tas
from cnrma_torch.models import cn_rma as tcn
from cnrma_torch.models import layers as tl
from cnrma_torch.models.tsdf_head import tsdf_losses as t_tsdf_losses
from cnrma_torch.ops import backproject as bp
from cnrma_torch.ops import losses as tloss
from cnrma_torch.synthetic import synthesize_parameters
from cnrma_torch.train import optim as topt
from cnrma_torch.train.loop import total_loss, train_step
from cnrma_tpu.models import assigner as jas
from cnrma_tpu.models import cn_rma as jcn
from cnrma_tpu.models import layers as jl
from cnrma_tpu.models.tsdf_head import tsdf_losses as j_tsdf_losses
from cnrma_tpu.ops import losses as jloss
from cnrma_tpu.train import optim as jopt
from test_pipeline import tiny_model
from test_torch_bridge import randomize_stats, tiny_torch_cnrma, torch_module
from test_torch_layers_tower import to_cf, to_cl
from test_torch_test_cli import _flax_tree_from_torch

T = torch.from_numpy


def close(got, want, tol=1e-6):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=tol, rtol=0)


def close_sum(got, want):
    """Sums in another order: 1e-6 of the largest magnitude, at least
    1e-6."""
    close(got, want, 1e-6 * max(1.0, float(np.abs(np.asarray(want)).max())))


# --- losses -----------------------------------------------------------------

def test_losses_match():
    rng = np.random.RandomState(0)
    n, c = 200, 5
    logits = (rng.randn(n, c) * 3).astype(np.float32)
    labels = np.where(rng.rand(n) < 0.2, rng.randint(0, c, n), -1)
    valid = rng.rand(n) > 0.1
    assert (labels >= 0).sum() > 10             # planted positives
    avg = np.float32(37.0)
    j = jnp.asarray
    close_sum(tloss.sigmoid_focal_loss(T(logits), T(labels), T(valid),
                                       torch.tensor(avg)),
              jloss.sigmoid_focal_loss(j(logits), j(labels), j(valid), avg))
    targets = rng.rand(n).astype(np.float32)
    close_sum(tloss.bce_loss(T(logits[:, 0]), T(targets), T(valid),
                             torch.tensor(avg)),
              jloss.bce_loss(j(logits[:, 0]), j(targets), j(valid), avg))
    boxes = np.concatenate([rng.randn(n, 3), rng.rand(n, 3) + 0.2,
                            rng.randn(n, 1)], 1).astype(np.float32)
    pred = boxes + (rng.randn(n, 7) * 0.1).astype(np.float32)
    pred[~valid] = 0.0                 # degenerate padding rows
    for yaw, k in ((False, 6), (True, 7)):
        close_sum(tloss.iou3d_loss(T(pred[:, :k]), T(boxes[:, :k]),
                                   T(targets), T(valid), torch.tensor(avg),
                                   with_yaw=yaw),
                  jloss.iou3d_loss(j(pred[:, :k]), j(boxes[:, :k]),
                                   j(targets), j(valid), avg, with_yaw=yaw))
    x = (rng.randn(50) * 2).astype(np.float32)
    close(tloss.log_transform(T(x)), jloss.log_transform(j(x)))


def test_rotated_iou_loss_gradient_is_finite_on_padding():
    """The unit-box substitution keeps the rotated backward free of NaN on
    degenerate padding rows."""
    pred = torch.zeros(4, 7, requires_grad=True)
    target = torch.zeros(4, 7)
    valid = torch.tensor([False, False, False, False])
    loss = tloss.iou3d_loss(pred, target, torch.ones(4), valid,
                            torch.tensor(1.0), with_yaw=True)
    loss.backward()
    assert torch.isfinite(pred.grad).all()


# --- assigner ---------------------------------------------------------------

def test_assigner_matches():
    rng = np.random.RandomState(1)
    p, m, n_scales = 2000, 6, 4
    points = (rng.rand(p, 3) * 3).astype(np.float32)
    scale_ids = rng.randint(0, n_scales, p).astype(np.int32)
    point_valid = rng.rand(p) > 0.1
    boxes = np.concatenate([rng.rand(m, 3) * 3, rng.rand(m, 3) + 0.5,
                            rng.randn(m, 1)], 1).astype(np.float32)
    boxes[1] = boxes[0]                 # two identical boxes: argmin ties
    boxes[5, 6] = 0.0
    labels = np.arange(m, dtype=np.int32)       # a label names its box
    gt_valid = np.ones(m, bool)
    gt_valid[4] = False
    args = (points, scale_ids, point_valid, boxes, labels, gt_valid)
    want = jas.fcaf3d_assign(*map(jnp.asarray, args), n_scales=n_scales,
                             limit=5, topk=8)
    got = tas.fcaf3d_assign(*map(T, args), n_scales=n_scales, limit=5,
                            topk=8)
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    assert (got.labels >= 0).sum() > 10
    # the tie went to the first of the two identical boxes
    assert (got.labels == 0).any() and not (got.labels == 1).any()
    close(got.centerness_targets, want.centerness_targets)
    close(got.bbox_targets, want.bbox_targets)
    d = [T(rng.rand(30).astype(np.float32)) for _ in range(6)]
    close(tas.compute_centerness(*d),
          jas.compute_centerness(*[jnp.asarray(x.numpy()) for x in d]))


# --- train-mode norms -------------------------------------------------------

def _flax_train(module, variables, x, *rest):
    """flax train-mode apply: output, new statistics, and the gradients of
    ``sum(out * r)`` (r from seed 9) by x and by the params."""
    out, mutated = module.apply(variables, x, *rest, train=True,
                                mutable=["batch_stats"])
    r = jnp.asarray(np.random.RandomState(9).randn(*out.shape)
                    .astype(np.float32))

    def f(x, params):
        y = module.apply({**variables, "params": params}, x, *rest,
                         train=True, mutable=["batch_stats"])[0]
        return jnp.sum(y * r)
    gx, gp = jax.grad(f, argnums=(0, 1))(x, variables["params"])
    return (np.asarray(out), jax.device_get(mutated["batch_stats"]),
            np.asarray(r), np.asarray(gx), jax.device_get(gp))


def _check_norm(port, x_t, want, r, gx, gp, stats, *rest):
    """The port's norm in training against ``_flax_train``'s results."""
    x_t = x_t.detach().requires_grad_()
    y = port(x_t, *rest)
    close_sum(y.detach().numpy() if y.dim() == 2 else to_cl(y), want)
    rr = T(r) if y.dim() == 2 else to_cf(r)
    (y * rr).sum().backward()
    grad_x = x_t.grad.numpy() if y.dim() == 2 else to_cl(x_t.grad)
    close_sum(grad_x, gx)
    close_sum(port.weight.grad, gp["scale"])
    close_sum(port.bias.grad, gp["bias"])
    close(port.running_mean, stats["mean"])
    close(port.running_var, stats["var"])


@pytest.mark.parametrize("ndim,frozen", [(2, False), (3, False), (2, True)])
def test_batchnorm_train(ndim, frozen):
    x = (np.random.RandomState(ndim).randn(2, *(5,) * ndim, 6) * 3 + 1) \
        .astype(np.float32)
    module = jl.BatchNorm(frozen=frozen)
    variables = randomize_stats(module.init(jax.random.PRNGKey(0),
                                            jnp.asarray(x), train=False), 1)
    want, stats, r, gx, gp = _flax_train(module, variables, jnp.asarray(x))
    port = torch_module(tl.BatchNorm(6, frozen=frozen), variables).train()
    _check_norm(port, to_cf(x), want, r, gx, gp, stats)


def test_masked_batchnorm_train():
    rng = np.random.RandomState(3)
    x = (rng.randn(40, 8) * 3 + 1).astype(np.float32)
    mask = rng.rand(40) > 0.3
    module = jl.MaskedBatchNorm()
    variables = randomize_stats(module.init(
        jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(mask),
        train=False), 2)
    want, stats, r, gx, gp = _flax_train(module, variables, jnp.asarray(x),
                                         jnp.asarray(mask))
    port = torch_module(tl.MaskedBatchNorm(8), variables).train()
    _check_norm(port, T(x), want, r, gx, gp, stats, T(mask))


def test_remat_updates_running_stats_once():
    """The U-Net trains under checkpointing: a forward and backward leave
    the running statistics of one forward, not of its recompute too."""
    from cnrma_torch.models.unet3d import UNet3D
    torch.manual_seed(0)
    a = UNet3D(channels=(8, 8, 8, 8)).train()
    b = UNet3D(channels=(8, 8, 8, 8)).train()
    b.load_state_dict(a.state_dict())
    x = torch.randn(1, 8, 8, 8, 8)
    sum(o.sum() for o in a(x.clone().requires_grad_())).backward()
    with torch.no_grad():
        b(x)
    for (name, s1), s2 in zip(a.state_dict().items(),
                              b.state_dict().values()):
        if "running" in name:
            torch.testing.assert_close(s1, s2, rtol=0, atol=1e-7, msg=name)
    assert not torch.equal(a.down0_block0.conv1.norm.running_var,
                           torch.ones(8))


# --- augmentation, TSDF losses -----------------------------------------------

@pytest.mark.parametrize("with_yaw", [False, True])
def test_feature_transform_matches(with_yaw):
    rng = np.random.RandomState(4)
    pts = rng.randn(100, 3).astype(np.float32)
    boxes = np.concatenate([rng.randn(5, 3), rng.rand(5, 3) + 0.2,
                            rng.randn(5, 1)], 1).astype(np.float32)
    for key in range(4):                       # flips on and off
        k = jax.random.PRNGKey(key)
        kf, kv, kr, ks, kt = jax.random.split(k, 5)
        cfg = tcn.FEATURE_TRANSFORM
        draws = {"flip_h": torch.tensor(bool(jax.random.uniform(kf) < 0.5)),
                 "flip_v": torch.tensor(bool(jax.random.uniform(kv) < 0.5)),
                 "angle": torch.tensor(float(jax.random.uniform(
                     kr, minval=cfg["rot_range"][0],
                     maxval=cfg["rot_range"][1]))),
                 "scale": torch.tensor(float(jax.random.uniform(
                     ks, minval=0.9, maxval=1.1))),
                 "trans": T(np.asarray(jax.random.normal(kt, (3,))
                                       * jnp.asarray([0.1, 0.1, 0.1])))}
        wp, wb = jcn.feature_transform_aug(k, jnp.asarray(pts),
                                           jnp.asarray(boxes), with_yaw)
        gp, gb = tcn.feature_transform_aug(T(pts), T(boxes), with_yaw,
                                           draws)
        close(gp, wp)
        close(gb, wb)


def test_draws_follow_the_config():
    g = torch.Generator().manual_seed(0)
    d = tcn.draw_feature_transform(g, "cpu", rot_range=(0.1, 0.2),
                                   scale_ratio_range=(2.0, 3.0),
                                   flip_ratio_horizontal=0.0,
                                   flip_ratio_vertical=1.0)
    assert not d["flip_h"] and d["flip_v"]
    assert 0.1 <= d["angle"] < 0.2 and 2.0 <= d["scale"] < 3.0
    assert d["trans"].shape == (3,)


def test_tsdf_losses_match():
    rng = np.random.RandomState(5)
    keys = ("040", "020", "010")
    out, tgt = {}, {}
    for i, k in enumerate(keys):
        n = 4 * 2 ** i
        out[f"scene_tsdf_{k}"] = (rng.rand(1, n, n, n) * 2.1 - 1.05) \
            .astype(np.float32)
        t = (rng.rand(1, n, n, n) * 2 - 1).astype(np.float32)
        t[0, :2] = 1.0                  # free columns, all along z
        t[0, 2, :, : n // 2] = 1.0      # free voxels in seen columns
        tgt[f"tsdf_gt_{k}"] = t
    want = j_tsdf_losses({k: jnp.asarray(v) for k, v in out.items()},
                         {k: jnp.asarray(v) for k, v in tgt.items()}, keys)
    got = t_tsdf_losses({k: T(v) for k, v in out.items()},
                        {k: T(v) for k, v in tgt.items()}, keys)
    assert set(got) == set(want)
    for k in want:
        close_sum(got[k], want[k])


# --- optimizer ----------------------------------------------------------------

def test_lr_schedule_matches():
    cfg = {"policy": "step", "step": [2, 3], "gamma": 0.1}
    want = jopt.build_lr_schedule(cfg, 1e-3, 4)
    got = topt.build_lr_schedule(cfg, 1e-3, 4)
    for count in range(16):
        np.testing.assert_allclose(got(count), float(want(count)), rtol=1e-6)


def test_optimizer_matches_optax_chain():
    """Three steps on the same gradients: the clip is active in steps 1 and
    3, the stem is frozen (no update, no decay, but its gradient counts in
    the norm), and the step schedule drops the rate for step 3."""
    rng = np.random.RandomState(6)
    shapes = {"tower2d/resnet/stem/conv/kernel": (3, 4),
              "tower2d/fuse/p2_head0/conv/kernel": (5,),
              "detector/head/cls_bias": (2, 3)}
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
    schedule = {"policy": "step", "step": [1]}
    jtx = jopt.build_optimizer(
        {"type": "AdamW", "weight_decay": 1e-2},
        jopt.build_lr_schedule(schedule, 1e-2, 2), grad_clip=0.5,
        params=tree(params), frozen_prefixes=jopt.FROZEN_PREFIXES_FREEZE_AT_2)
    jparams = tree(params)
    jstate = jtx.init(jparams)
    tparams = {k.replace("/", "."): torch.nn.Parameter(T(v.copy()))
               for k, v in params.items()}
    opt = topt.Optimizer(
        tparams, topt.build_lr_schedule(schedule, 1e-2, 2),
        weight_decay=1e-2, max_norm=0.5,
        frozen={n for n in tparams
                if n.startswith(topt.FROZEN_PREFIXES_FREEZE_AT_2)})
    assert len(opt.frozen) == 1
    for step, scale in enumerate((3.0, 0.01, 2.0)):
        grads = {k: (rng.randn(*s) * scale).astype(np.float32)
                 for k, s in shapes.items()}
        upd, jstate = jtx.update(tree(grads), jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        norm = opt.step({k.replace("/", "."): T(v) for k, v in grads.items()})
        np.testing.assert_allclose(
            float(norm), np.sqrt(sum((g ** 2).sum() for g in grads.values())),
            rtol=1e-6)
        flat = {"/".join(str(getattr(p, "key", p)) for p in path): v
                for path, v in jax.tree_util.tree_leaves_with_path(jparams)}
        for k, v in flat.items():
            close(tparams[k.replace("/", ".")], v)
    stem = "tower2d.resnet.stem.conv.kernel"
    np.testing.assert_array_equal(
        tparams[stem].detach().numpy(),
        params["tower2d/resnet/stem/conv/kernel"])
    assert opt.count == 3


# --- data: the training split, the loader --------------------------------------

def test_train_reader_matches_jax(tmp_path):
    from cnrma_tpu.data.scannet import AtlasScanNetDataset as JReader
    from cnrma_torch.data.scannet import AtlasScanNetDataset as TReader
    from test_data import make_synthetic_scannet
    ann = make_synthetic_scannet(str(tmp_path), n_scenes=2, n_frames=6)
    kw = dict(data_root=str(tmp_path), ann_file=ann, test_mode=False,
              num_frames=4, voxel_dim=(48, 48, 32), space_mode="middle",
              select_type="random", seed=3)
    jr, tr = JReader(**kw), TReader(**kw)
    for i in range(2):
        want, got = jr[i], tr[i]
        assert set(got) == set(want)
        assert list(got["image_ids"]) == list(want["image_ids"])
        assert want["gt_valid"].any()
        for k, w in want.items():
            if k in ("scene", "image_ids"):
                continue
            if k.startswith("tsdf_gt"):
                np.testing.assert_allclose(got[k], w, atol=1e-6, err_msg=k)
            else:
                assert got[k].dtype == w.dtype, k
                np.testing.assert_array_equal(got[k], w, err_msg=k)


def test_loader_order_and_collation_match_jax():
    from cnrma_tpu.data.loader import SceneLoader as JLoader
    from cnrma_tpu.data.loader import collate_scenes as j_collate
    from cnrma_torch.data.loader import SceneLoader, collate_scenes
    data = [{"scene": f"s{i}", "imgs": np.full((2, 3), i, np.float32),
             "tsdf_gt_004": np.full((2,), i, np.float32)} for i in range(7)]
    jl_ = JLoader(data, batch_size=1, shuffle=True, seed=5)
    tl_ = SceneLoader(data, seed=5)
    for _ in range(2):                       # two epochs, two shuffles
        assert [[i] for i in tl_.order()] == jl_._batches()
    got = [b["scene"] for b in tl_]
    assert len(got) == len(tl_) == 7
    assert sorted(s for b in got for s in b) == sorted(d["scene"]
                                                       for d in data)
    want, mine = j_collate(data[:2]), collate_scenes(data[:2])
    assert mine.keys() == want.keys()
    np.testing.assert_array_equal(mine["imgs"], want["imgs"])
    np.testing.assert_array_equal(mine["tsdf_list"]["tsdf_gt_004"],
                                  want["tsdf_list"]["tsdf_gt_004"])


# --- one whole tiny train step --------------------------------------------------

def _path(path):
    return [str(getattr(p, "key", p)) for p in path]


# The whole step runs ``tiny_model`` with two changes.  At its own sizes
# the training forward is chaotic in fp32, in JAX as in the port: batch
# norms over two or three samples (the res5 pixels of two 32x32 views; the
# detector's coarse levels at 5 cm voxels) divide by a variance that
# rounding decides, and a relative change of 1e-6 in the input moves JAX's
# own tower features by 3.0 of 6.8 (flax's initialisation) and its coarse
# class scores by 1.7.  Views of 64x64 (``step_views``) and the config's
# 1 cm detector voxels bring both to 2e-3 and 1e-5.
STEP_FCAF3D_VOXEL = 0.01


def step_views():
    """The tiny model's two views at 64x64: ``tiny_model``'s camera with
    its focal length and centre doubled, random pixels (seed 0)."""
    rng = np.random.RandomState(0)
    intr = np.array([[60.0, 0, 32], [0, 60.0, 32], [0, 0, 1]], np.float32)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [0.8, 0.8, -0.4]
    proj = (intr @ np.linalg.inv(pose)[:3]).astype(np.float32)
    return {"imgs": jnp.asarray(rng.rand(1, 2, 64, 64, 3).astype(np.float32)
                                * 255),
            "projection": jnp.asarray(np.broadcast_to(proj, (1, 2, 3, 4)))}


@pytest.fixture(scope="module")
def tiny_step():
    """JAX's ``value_and_grad`` of the tiny CNRMA's training forward (the
    loss of ``tests/test_pipeline.py:test_forward_train_losses_and_grads``,
    on the views of ``step_views``) with the draws it made read out by
    debug callbacks, and the port's ``train_step`` pieces on the same
    parameters, batch and draws."""
    model, batch = tiny_model()
    model = model.clone(voxel_size_fcaf3d=STEP_FCAF3D_VOXEL)
    batch = dict(batch, **step_views())
    port = tiny_torch_cnrma(voxel_size_fcaf3d=STEP_FCAF3D_VOXEL)
    synthesize_parameters(port, 1)
    rng = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: model.init(
        {"params": rng, "sample": rng, "aug": rng}, batch, train=False))
    variables = _flax_tree_from_torch(port.state_dict(), shapes)
    draws = {}
    sub, aug = jcn._normalize_subsample, jcn.feature_transform_aug

    def spy_sub(flat, rng_b, max_points):
        r = jax.random.uniform(rng_b, (flat.weight.shape[0],))
        out = sub(flat, rng_b, max_points)
        jax.debug.callback(lambda x, *sel: draws.update(
            uniform=np.asarray(x), selection=[np.asarray(a) for a in sel]),
            r, *out)
        return out

    def spy_aug(r, points, boxes, with_yaw, **cfg):
        kf, kv, kr, ks, kt = jax.random.split(r, 5)
        u = (jax.random.uniform(kf), jax.random.uniform(kv),
             jax.random.uniform(kr, minval=-0.087266, maxval=0.087266),
             jax.random.uniform(ks, minval=0.9, maxval=1.1),
             jax.random.normal(kt, (3,)) * jnp.asarray([0.1, 0.1, 0.1]))
        jax.debug.callback(lambda *a: draws.__setitem__(
            "aug", [np.asarray(x) for x in a]), *u)
        return aug(r, points, boxes, with_yaw, **cfg)

    def loss_fn(params):
        out, mutated = model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            batch, train=True, rngs={"sample": jax.random.PRNGKey(1),
                                     "aug": jax.random.PRNGKey(2)},
            mutable=["batch_stats"])
        return sum(out["losses"].values()), (out["losses"],
                                             mutated["batch_stats"],
                                             out["points"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcn, "_normalize_subsample", spy_sub)
        mp.setattr(jcn, "feature_transform_aug", spy_aug)
        (loss, (losses, stats, points)), grads = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
        jax.device_get(loss)
    want = jax.device_get({"loss": loss, "losses": losses, "stats": stats,
                           "grads": grads, "points": points})

    port.train()
    tb = {k: T(np.array(v)) for k, v in batch.items() if k != "tsdf_list"}
    tb["tsdf_list"] = {k: T(np.array(v))
                       for k, v in batch["tsdf_list"].items()}
    u_h, u_v, angle, scale, trans = draws["aug"]
    aug_draws = [{"flip_h": torch.tensor(bool(u_h < 0.5)),
                  "flip_v": torch.tensor(bool(u_v < 0.5)),
                  "angle": torch.tensor(float(angle)),
                  "scale": torch.tensor(float(scale)), "trans": T(trans)}]
    kw = dict(uniform=T(draws["uniform"])[None], aug_draws=aug_draws)
    return want, port, tb, kw, [T(a) for a in draws["selection"]]


def _jax_selection(monkeypatch, selection):
    """The port's subsample returns JAX's kept points.  The selection sorts
    ray-march weights, which fp32 rounding reorders near ties and near the
    threshold (ROADMAP F6), and carries no gradient: what follows it (the
    feature gather, the augmentation, the detector) runs on the same
    points on both sides.  Its own parity is ``test_torch_cnrma.py``'s."""
    monkeypatch.setattr(tcn, "_normalize_subsample",
                        lambda *args, **kw: tuple(selection))


def _port_grads(port):
    return {n: (p.grad if p.grad is not None else torch.zeros_like(p))
            .detach().numpy() for n, p in port.named_parameters()}


def _cosine(a, b):
    """Cosine of two gradients (fp64); 1 where both are zero, 0 where one
    is."""
    a, b = a.ravel().astype(np.float64), b.ravel().astype(np.float64)
    na, nb = np.sqrt(a @ a), np.sqrt(b @ b)
    if na == 0 or nb == 0:
        return float(na == nb)
    return float(a @ b / (na * nb))


# The step's limits: losses (relative), every gradient leaf but the R-50
# trunk's (of the leaf's largest magnitude), the trunk as a group (cosine,
# relative L2 error), each trunk leaf (cosine), the running statistics
# (absolute).
STEP_LIMITS = {"losses": 1e-4, "leaf": 1e-3, "trunk_cos": 0.999,
               "trunk_err": 0.02, "trunk_leaf_cos": 0.99, "stats": 1e-5}


def _step_readings(port, tb, kw, want, fault=None):
    """One training forward and backward of ``port`` against JAX's
    ``want``; ``fault`` (a function of the port's gradients) plants a fault
    after the backward.  Returns the readings held against
    ``STEP_LIMITS``, each with the worst leaf's name."""
    losses = port.forward_train(tb, **kw)
    assert set(losses) == set(want["losses"])
    port.zero_grad(set_to_none=True)
    total_loss(losses).backward()
    got = _port_grads(port)
    if fault is not None:
        fault(got)
    grads = {}
    for path, g in jax.tree_util.tree_leaves_with_path(want["grads"]):
        key, arr = _convert("params", _path(path), np.asarray(g))
        grads[key] = arr
    assert set(grads) == set(got)
    trunk = [k for k in got if k.startswith("tower2d.resnet.")]
    r = {"losses": max((abs(float(losses[k].detach()) - float(w))
                        / abs(float(w)), k)
                       for k, w in want["losses"].items() if float(w)),
         "leaf": max((float(np.abs(got[k] - grads[k]).max()
                            / max(float(np.abs(grads[k]).max()), 1e-30)), k)
                     for k in got if k not in trunk),
         "trunk_leaf_cos": min((_cosine(got[k], grads[k]), k)
                               for k in trunk)}
    a = np.concatenate([got[k].ravel() for k in trunk]).astype(np.float64)
    b = np.concatenate([grads[k].ravel() for k in trunk]).astype(np.float64)
    r["trunk_cos"] = (_cosine(a, b), "tower2d.resnet")
    r["trunk_err"] = (float(np.linalg.norm(a - b) / np.linalg.norm(b)),
                      "tower2d.resnet")
    buffers = dict(port.named_buffers())
    stats = []
    for path, s in jax.tree_util.tree_leaves_with_path(want["stats"]):
        key, _ = _convert("batch_stats", _path(path), np.asarray(s))
        stats.append((float(np.abs(buffers[key].numpy() - s).max()), key))
    r["stats"] = max(stats)
    return r


def _step_failures(r):
    """The limits that the readings ``r`` break."""
    return sorted(k for k, lim in STEP_LIMITS.items()
                  if (r[k][0] < lim if k.endswith("cos") else r[k][0] > lim))


def test_train_step_matches_jax(tiny_step, monkeypatch):
    """One training step against JAX's ``value_and_grad`` on the same
    parameters (``synthesize_parameters``, seed 1), batch, draws and kept
    points, at ``STEP_LIMITS``: the losses within 1e-4 relative, the new
    running statistics within 1e-5, and every gradient leaf within 1e-3 of
    the leaf's largest magnitude, but those of the R-50 trunk.

    The trunk's backward in training is chaotic in fp32 at random weights,
    in JAX as in the port: its batch norms see 8 to 32 samples at res4
    and res5, and a relative change of 1e-7 in the images (one ulp) moves
    the port's own trunk gradients by 4e-3 (relative L2).  Its leaves are
    held as one group (cosine at least 0.999, relative L2 error at most
    0.02) and each leaf at a cosine of at least 0.99, so that a fault in
    one leaf does not hide in the group's norm;
    ``test_train_step_check_catches_planted_faults`` shows these limits
    failing planted faults.  Measured errors are in PERF.md."""
    want, port, tb, kw, selection = tiny_step
    _jax_selection(monkeypatch, selection)
    # the detector floors positions to its voxels: the comparison holds
    # for data with no point within fp32 rounding of a boundary
    v = np.asarray(want["points"].valid)
    assert v.sum() > 50
    cells = np.asarray(want["points"].xyz)[v] / STEP_FCAF3D_VOXEL
    assert np.abs(cells - np.round(cells)).min() > 1e-4
    assert float(want["losses"]["loss_bbox"]) > 0      # positives assigned
    r = _step_readings(port, tb, kw, want)
    print("step readings:", r)
    assert not _step_failures(r), r


def _drop_view_gradient(monkeypatch):
    """The volume's backward loses view 1's gradient."""
    real = bp.volume_accum_bwd

    def bwd(*args):
        g = real(*args).clone()
        g[1] = 0
        return g
    monkeypatch.setattr(bp, "volume_accum_bwd", bwd)


def _trunk_norms_on_running_stats(port):
    """The trunk's train-mode norms normalize with the running statistics
    (and leave them alone)."""
    for m in port.tower2d.resnet.modules():
        if isinstance(m, tl.BatchNorm):
            m.eval()


# The trunk leaf whose gradient the one-leaf fault loses: res5's last
# norm's shift, under 1% of the trunk's gradient by L2 norm, so that the
# group's cosine and relative error stay within their limits without it.
ONE_TRUNK_LEAF = "tower2d.resnet.res5_block2.conv3.norm.bias"


@pytest.mark.parametrize("fault", ["k1b_drops_view", "trunk_norms_eval",
                                   "one_trunk_leaf"])
def test_train_step_check_catches_planted_faults(tiny_step, monkeypatch,
                                                 fault):
    """The limits of ``test_train_step_matches_jax`` fail a step with a
    planted fault, on a fresh port (``synthesize_parameters``, seed 1):
    the volume's backward dropping one view's gradient, the trunk's norms
    running on their running statistics in training, and one trunk leaf's
    gradient lost.  Each fault breaks a limit of the trunk's, the place
    its group norm could hide it."""
    want, _, tb, kw, selection = tiny_step
    _jax_selection(monkeypatch, selection)
    port = tiny_torch_cnrma(voxel_size_fcaf3d=STEP_FCAF3D_VOXEL)
    synthesize_parameters(port, 1)
    port.train()
    plant = None
    if fault == "k1b_drops_view":
        _drop_view_gradient(monkeypatch)
    elif fault == "trunk_norms_eval":
        _trunk_norms_on_running_stats(port)
    else:
        def plant(grads):
            grads[ONE_TRUNK_LEAF][...] = 0
    r = _step_readings(port, tb, kw, want, plant)
    failed = _step_failures(r)
    print(f"{fault}: breaks {failed}; readings {r}")
    assert {"trunk_cos", "trunk_err", "trunk_leaf_cos"} & set(failed), r
    if fault == "one_trunk_leaf":
        assert "trunk_leaf_cos" in failed, r


def test_march_passes_no_gradient_to_the_tsdf(tiny_step):
    """The detection losses alone reach the 2D tower (through the gathered
    point features) but not the TSDF head (the march takes the TSDF
    detached); the reconstruction losses alone reach the tower through the
    volume."""
    _, port, tb, kw, _ = tiny_step
    port.zero_grad(set_to_none=True)
    losses = port.forward_train(tb, **kw)
    sum(v for k, v in losses.items() if k.startswith("loss_")).backward()
    heads = [p.grad for p in port.tsdf_head.parameters()]
    assert all(g is None or not g.any() for g in heads)
    assert any(p.grad is not None and p.grad.any()
               for p in port.tower2d.fuse.parameters())
    port.zero_grad(set_to_none=True)
    losses = port.forward_train(tb, **kw)
    sum(v for k, v in losses.items() if k.startswith("tsdf_")).backward()
    assert any(p.grad is not None and p.grad.any()
               for p in port.tower2d.fuse.parameters())
    assert all(p.grad is None or not p.grad.any()
               for p in port.detector.parameters())


def test_train_step_updates_parameters(tiny_step):
    """``train_step``: the log vars, a finite pre-clip norm, an update of
    the trained parameters and none of the frozen stem."""
    _, port, tb, kw, _ = tiny_step
    model = tiny_torch_cnrma(voxel_size_fcaf3d=STEP_FCAF3D_VOXEL)
    model.load_state_dict(port.state_dict())
    opt = topt.build_optimizer(
        {"type": "AdamW", "lr": 1e-3, "weight_decay": 1e-4}, model,
        topt.build_lr_schedule({"policy": "step"}, 1e-3, 1), grad_clip=10,
        frozen_prefixes=topt.FROZEN_PREFIXES_FREEZE_AT_2)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    log_vars = train_step(model, opt, tb, **kw)
    assert {"total_loss", "grad_norm", "loss_cls"} <= set(log_vars)
    assert all(torch.isfinite(v) for v in log_vars.values())
    after = dict(model.named_parameters())
    stem = [n for n in before if n.startswith("tower2d.resnet.stem.")]
    assert stem and all(torch.equal(before[n], after[n]) for n in stem)
    assert not torch.equal(before["detector.head.cls_bias"],
                           after["detector.head.cls_bias"])


def test_stage_marks_cover_the_step(tiny_step):
    """``timing.stage_marks`` around ``train_step`` times every stage of
    the step, in order, and ``timing.mark`` does nothing outside it."""
    _, port, tb, kw, _ = tiny_step
    model = tiny_torch_cnrma(voxel_size_fcaf3d=STEP_FCAF3D_VOXEL)
    model.load_state_dict(port.state_dict())
    opt = topt.build_optimizer(
        {"type": "AdamW", "lr": 1e-3, "weight_decay": 1e-4}, model,
        topt.build_lr_schedule({"policy": "step"}, 1e-3, 1), grad_clip=10)
    timing.mark("outside")
    with timing.stage_marks(torch.device("cpu")) as marks:
        train_step(model, opt, tb, **kw)
    stages = marks.ms()
    assert list(stages) == ["tower", "volume", "unet_head", "tsdf_loss",
                            "march", "augment", "detector", "det_loss",
                            "backward", "optimizer"]
    assert all(v >= 0 for v in stages.values())
    assert stages["backward"] > 0 and timing._active is None

"""One scene split across ranks, on the CPU: ranks of ``gloo`` in spawned
processes (two torch threads each; every job of the file is started at
once, under one time limit, while JAX's references are computed here).

(a) the 3D U-Net and TSDF head on two X-slabs in training (halo
    convolutions, the halo x2 upsample, synced batch norms) against JAX's
    unsharded forward on the same parameters (JAX's ``TestUNetSlabParity``
    set-up at the port's layer counts, on a 16^3 volume): outputs and
    TSDFs within ``JAX_UNET_TOL`` of their scale (the U-Net's tolerance of
    ``test_torch_unet_tsdf.py``: thirty 3D convolutions summed in another
    order), running statistics within ``SLAB_TOL``, and outputs and TSDFs
    within ``SLAB_TOL`` (JAX's own 2e-5, absolute and relative) of the
    port's unsharded forward;
(b) the halo ``upsample_linear`` on two slabs against JAX's unsharded one,
    within 1e-6 (JAX's);
(c) the miniature of JAX's ``TestBoundaryGradParity``: a tower, a volume
    summed over the ranks, a slab "U-Net" with halos, a replicated
    "detector"; the ranks' gradients (summed over the group, the
    detector's averaged) against JAX's ``jax.grad`` of the unsharded
    miniature, within ``GRAD_RTOL`` relative and ``GRAD_ATOL`` absolute
    (JAX's own): this carries the exactness claim of the boundary;
(d) the partial volume (K1's plain sum mode, the sum and count summed over
    two ranks) against JAX ``accumulate_views_view_sharded`` on two CPU
    devices, within 1e-6;
(e) the tiny CNRMA's view-sharded step on two ranks against the port's
    one-process step on the same parameters and draws, at
    ``STEP_LIMITS``: the untrained tower is chaotic in fp32 (ROADMAP F6),
    so the 2D tower's gradients are held as groups (relative L2 error) and
    every leaf by its cosine, as ``test_torch_train.py`` does; the same
    step with depth marching and with ARKit's 7-DoF head
    (``STEP_VARIANTS``);
(e') the tiny ``Atlas`` step (stage 1) with ``--view-shards 2``'s split on
    two ranks against the one-process ``Atlas`` step (itself held against
    JAX in ``test_torch_stages.py``) at ``ATLAS_LIMITS``, the limits of
    a recon-only step on the card: the TSDF losses, the U-Net's and TSDF head's
    gradients as groups, the 2D tower's groups;
(f) ``tools/test.py --view-shard`` on two ranks writes the files of the
    one-rank run within ``CLI_TOL``; ``tools/train.py --view-shards 2``
    takes a step and scores the val split (the test forward's view
    sharding) within ``CLI_LOSS_RTOL`` of the one-process CLI; both CLIs
    refuse what JAX's refuse.

Planted faults break (a), (c), (e), its two variants (one fault each)
and (e'): batch norms that do not sync their statistics, and a boundary
whose backward sums the n copies of the replicated cotangent (the
collective's plain transpose).
"""

import json
import os
import sys
import time

import numpy as np
import pytest
import torch
from torch import nn

from cnrma_torch.models import layers as tl
from cnrma_torch.parallel import dist, shard
from _torch_spawn import free_port, spawn
from _torch_threads import _few_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "ray_marching_scannet.py")
TIME_LIMIT = 720            # seconds the spawned jobs may take
FAULTS = ("no_bn_sync", "sum_copies")
SLAB_TOL = 2e-5
JAX_UNET_TOL = 1e-4
UPSAMPLE_TOL = 1e-6
GRAD_RTOL, GRAD_ATOL = 2e-4, 1e-6
VOLUME_TOL = 1e-6
# the sharded step against the one-process step (port against port, fp32;
# the sums of the volume and of the synced statistics are split in two):
# the losses (relative), the TSDFs and running statistics (absolute), each
# module group's gradient as one vector (relative L2 error), every
# gradient leaf (cosine).  Measured: losses equal, groups within 9e-4,
# leaves above 0.99999.
STEP_LIMITS = {"losses": 1e-5, "tsdf": 1e-5, "stats": 1e-5,
               "group_err": 0.01, "leaf_cos": 0.999}
STEP_GROUPS = ("tower2d.resnet.", "tower2d.fpn.", "tower2d.fuse.",
               "backbone3d.", "tsdf_head.", "detector.")
# the view-sharded Atlas step against the one-process one: the TSDF losses
# (relative), the U-Net's and head's gradients and the 2D tower's, each
# group as one vector (relative L2 error); the limits of the recon-only step
# on the card (``chip_smoke.py``'s VIEW_TSDF_TOL, VIEW_GROUP_TOL,
# VIEW_TOWER_TOL)
ATLAS_LIMITS = {"tsdf_losses": 1e-5, "unet_head": 3e-3, "tower": 0.05}
ATLAS_GROUPS = {"unet_head": ("backbone3d.", "tsdf_head."),
                "tower": ("tower2d.resnet.", "tower2d.fpn.", "tower2d.fuse.")}
CLI_TOL = 1e-4              # the CLI's TSDF and boxes, of their scale
CLI_LOSS_RTOL = 1e-4


# --- spawning ranks ----------------------------------------------------------

def _join():
    """This rank's world group from the environment
    ``_torch_spawn._entry`` set."""
    group, _ = dist.init_from_env("cpu")
    return group


def _plant(fault):
    """Plant ``fault`` in this process (``FAULTS``, or None); returns what
    takes it out again."""
    saved = (shard.sync_batch_stats, shard.gather_replicated)

    def restore():
        shard.sync_batch_stats, shard.gather_replicated = saved
    if fault == "no_bn_sync":
        shard.sync_batch_stats = lambda mean, meansq: (mean, meansq)
    elif fault == "sum_copies":
        class SumCopies(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x, dim, group):
                ctx.meta = (dim, dist.rank(group), x.shape[dim], group)
                return shard.gather_cat(x, dim, group)

            @staticmethod
            def backward(ctx, g):
                dim, r, size, group = ctx.meta
                g = shard.all_reduce_sum(g.contiguous().clone(), group)
                return g.narrow(dim, r * size, size), None, None
        shard.gather_replicated = lambda x, dim, group: SumCopies.apply(
            x, dim, group)
    return restore


# --- (a) the slab U-Net and head ---------------------------------------------

UNET_CHANNELS = (4, 8, 12, 16)


def unet_case():
    """The port's U-Net (channels 4..16) and TSDF head from seed 0, their
    norms' affine parameters drawn (so the zero-initialised residual
    norms are not zero), and the input [1, 16, 16, 16, 4]."""
    from cnrma_torch.models.tsdf_head import TSDFHead
    from cnrma_torch.models.unet3d import UNet3D
    torch.manual_seed(0)
    unet = UNet3D(channels=UNET_CHANNELS)
    head = TSDFHead(input_channels=UNET_CHANNELS[:3], voxel_size=0.1)
    rng = np.random.RandomState(3)
    with torch.no_grad():
        for m in unet.modules():
            if isinstance(m, tl.BatchNorm):
                m.weight.copy_(torch.from_numpy(
                    1 + rng.randn(*m.weight.shape).astype(np.float32) * 0.1))
                m.bias.copy_(torch.from_numpy(
                    rng.randn(*m.bias.shape).astype(np.float32) * 0.1))
    x = np.random.RandomState(0).rand(1, 16, 16, 16, 4).astype(np.float32)
    return unet.train(), head, x


def _unet_full():
    """The port's unsharded train-mode forward of ``unet_case``."""
    unet, head, x = unet_case()
    with torch.no_grad():
        outs = unet(torch.from_numpy(x))
        preds = head(outs)
    return {"outs": [o.numpy() for o in outs],
            "preds": {k: v.numpy() for k, v in preds.items()}}


def _unet_slab(group):
    """Rank's slab through the U-Net and head under both contexts, the
    outputs and TSDFs gathered, the running statistics."""
    unet, head, x = unet_case()
    r, n = dist.rank(group), dist.world(group)
    xs = x.shape[1] // n
    slab = torch.from_numpy(x[:, r * xs:(r + 1) * xs])
    with torch.no_grad(), shard.bn_sync_group(group), \
            shard.halo_group(group):
        outs = unet(slab)
        preds = head(outs)
    return {"outs": [shard.gather_cat(o, 1, group).numpy() for o in outs],
            "preds": {k: shard.gather_cat(v, 1, group).numpy()
                      for k, v in preds.items()},
            "stats": {k: v.numpy() for k, v in unet.state_dict().items()
                      if k.endswith(("running_mean", "running_var"))}}


def _jax_unet():
    """JAX's unsharded train-mode U-Net and head on ``unet_case``."""
    import jax
    import jax.numpy as jnp
    from cnrma_torch.bridge import _convert
    from cnrma_tpu.models.tsdf_head import TSDFHead
    from cnrma_tpu.models.unet3d import UNet3D
    from test_torch_test_cli import _flax_tree_from_torch
    unet, head, x = unet_case()
    ju, jh, xj = UNet3D(channels=UNET_CHANNELS), TSDFHead(voxel_size=0.1), \
        jnp.asarray(x)
    uvars = _flax_tree_from_torch(unet.state_dict(), jax.eval_shape(
        lambda: ju.init(jax.random.PRNGKey(0), xj, train=False)))
    outs, mut = jax.jit(lambda v, a: ju.apply(v, a, train=True,
                                              mutable=["batch_stats"]))(
        uvars, xj)
    hvars = _flax_tree_from_torch(head.state_dict(), jax.eval_shape(
        lambda: jh.init(jax.random.PRNGKey(0), outs, None)))
    preds, _ = jh.apply(hvars, outs, None)
    stats = {}
    for path, v in jax.tree_util.tree_leaves_with_path(mut["batch_stats"]):
        key, arr = _convert("batch_stats",
                            [str(getattr(q, "key", q)) for q in path],
                            np.asarray(v))
        stats[key] = arr
    return {"outs": [np.asarray(o) for o in outs],
            "preds": {k: np.asarray(v) for k, v in preds.items()},
            "stats": stats}


# --- (b) the halo upsample ---------------------------------------------------

def upsample_case():
    return np.random.RandomState(1).rand(1, 8, 4, 4, 3).astype(np.float32)


def _upsample_slab(group):
    x = upsample_case()
    r, n = dist.rank(group), dist.world(group)
    xs = x.shape[1] // n
    slab = torch.from_numpy(x[:, r * xs:(r + 1) * xs]).permute(0, 4, 1, 2, 3)
    with shard.halo_group(group):
        up = tl.upsample_linear(slab, 2)
    return shard.gather_cat(up, 2, group).permute(0, 2, 3, 4, 1).numpy()


# --- (c) the miniature -------------------------------------------------------

MINI_V, MINI_H, MINI_W, MINI_C, MINI_X, MINI_Y = 4, 8, 8, 4, 8, 4


class _SumSharded(torch.autograd.Function):
    """JAX's ``psum`` of the miniature's volume: the sum over the group,
    each rank then consuming its own slab of it, so the backward sums the
    cotangents (as ``PartialVolume`` does for the model's volume)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return shard.all_reduce_sum(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return shard.all_reduce_sum(g.contiguous().clone(), ctx.group), None


class Mini(nn.Module):
    """``TestBoundaryGradParity``'s miniature of CNRMA: a per-view tower
    (ConvBN), a volume summed over views, an X-slab U-Net (ConvBN with a
    halo, the halo x2 upsample, a head), a replicated detector (Dense)."""

    def __init__(self):
        super().__init__()
        c = MINI_C
        self.tower = tl.ConvBN(3, c, 3, 1, ndim=2, act=torch.relu)
        self.unet = tl.ConvBN(c, c, 3, 1, ndim=3, act=torch.relu)
        self.head = nn.Linear(c, 1)
        self.det = nn.Linear(c, 3)

    def volume_of(self, feats, v0=0):
        """Per-view lift of the pooled features into [1, C, X, Y, 1]:
        view v (global index ``v0 + v``) lands on X = 2 (v0 + v)."""
        nv = feats.shape[0]
        pooled = feats.mean(dim=(2, 3))                        # [nv, C]
        vids = v0 + torch.arange(nv)
        basis = (torch.arange(MINI_X)[:, None] == vids[None, :] * 2).float()
        vol = basis @ pooled                                   # [X, C]
        return vol.t()[None, :, :, None, None].expand(
            1, MINI_C, MINI_X, MINI_Y, 1) / MINI_V

    def trunk(self, vol):
        u = tl.upsample_linear(self.unet(vol), 2)              # [1,C,2X,2Y,2]
        return self.head(u.permute(0, 2, 3, 4, 1))[..., 0]     # [1,2X,2Y,2]

    def tail(self, preds, feats_all, target):
        loss1 = ((preds - target) ** 2).mean()
        z = self.det(feats_all.mean(dim=(0, 2, 3)))
        return loss1 + (z ** 2).mean() + preds.mean() * z.sum() * 1e-2

    def single(self, imgs, target):
        feats = self.tower(imgs)
        return self.tail(self.trunk(self.volume_of(feats)), feats, target)

    def sharded(self, imgs, target, group):
        n, r = dist.world(group), dist.rank(group)
        vs, xs = MINI_V // n, MINI_X // n
        with shard.bn_sync_group(group):
            feats_s = self.tower(imgs[r * vs:(r + 1) * vs])
        vol = _SumSharded.apply(self.volume_of(feats_s, r * vs), group)
        with shard.bn_sync_group(group), shard.halo_group(group):
            preds_s = self.trunk(vol[:, :, r * xs:(r + 1) * xs])
        preds = shard.gather_replicated(preds_s, 1, group)
        feats_all = shard.gather_replicated(feats_s, 0, group)
        return self.tail(preds, feats_all, target)


def mini_case():
    """The miniature from seed 0, its images [V, 3, H, W] and target."""
    torch.manual_seed(0)
    model = Mini().train()
    rng = np.random.RandomState(0)
    imgs = rng.rand(MINI_V, MINI_H, MINI_W, 3).astype(np.float32)
    target = rng.rand(1, 2 * MINI_X, 2 * MINI_Y, 2).astype(np.float32)
    return model, imgs, target


def _mini_grads(model):
    return {k: p.grad.numpy().copy() for k, p in model.named_parameters()}


def _mini_sharded(group):
    """The rank's miniature gradients, reduced as ``make_train_step(
    view_axis=...)`` reduces them: the detector's averaged over the
    group, the rest summed."""
    model, imgs, target = mini_case()
    loss = model.sharded(torch.from_numpy(imgs).permute(0, 3, 1, 2),
                         torch.from_numpy(target), group)
    loss.backward()
    out = {}
    for k, p in model.named_parameters():
        g = shard.all_reduce_sum(p.grad.clone(), group)
        out[k] = (g / dist.world(group) if k.startswith("det.")
                  else g).numpy()
    return out


def _mini_flax(model):
    """The miniature's parameters as JAX's ``Mini``'s flax tree."""
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    conv = lambda w: np.transpose(w, tuple(range(2, w.ndim)) + (1, 0))
    params = {
        "tower": {"conv": {"kernel": conv(sd["tower.conv.weight"])},
                  "norm": {"scale": sd["tower.norm.weight"],
                           "bias": sd["tower.norm.bias"]}},
        "unet": {"conv": {"kernel": conv(sd["unet.conv.weight"])},
                 "norm": {"scale": sd["unet.norm.weight"],
                          "bias": sd["unet.norm.bias"]}},
        "head": {"kernel": sd["head.weight"].T, "bias": sd["head.bias"]},
        "det": {"kernel": sd["det.weight"].T, "bias": sd["det.bias"]}}
    stats = {m: {"norm": {"mean": sd[f"{m}.norm.running_mean"],
                          "var": sd[f"{m}.norm.running_var"]}}
             for m in ("tower", "unet")}
    return params, stats


def _jax_mini():
    """``jax.grad`` of JAX's unsharded miniature on the same parameters,
    as the port's names."""
    import flax.linen as fnn
    import jax
    import jax.numpy as jnp
    from cnrma_tpu.models.layers import ConvBN, upsample_linear
    V, X, Y, C = MINI_V, MINI_X, MINI_Y, MINI_C
    relu = jax.nn.relu

    class JMini(fnn.Module):
        def setup(self):
            self.tower = ConvBN(C, 3, 1, norm="BN", act=relu, name="tower")
            self.unet = ConvBN(C, 3, 1, norm="BN", act=relu, name="unet")
            self.head = fnn.Dense(1, name="head")
            self.det = fnn.Dense(3, name="det")

        def __call__(self, imgs, target):
            feats = self.tower(imgs, train=True)
            pooled = jnp.mean(feats, axis=(1, 2))
            basis = (jnp.arange(X)[:, None]
                     == jnp.arange(V)[None, :] * 2).astype(jnp.float32)
            vol = jnp.broadcast_to(
                jnp.einsum("xv,vc->xc", basis, pooled)[None, :, None, None],
                (1, X, Y, 1, C)) / V
            u = upsample_linear(self.unet(vol, train=True), 2)
            preds = self.head(u)[..., 0]
            loss1 = jnp.mean(jnp.square(preds - target))
            z = self.det(jnp.mean(feats, axis=(0, 1, 2)))
            return loss1 + jnp.mean(jnp.square(z)) \
                + jnp.mean(preds) * jnp.sum(z) * 1e-2

    model, imgs, target = mini_case()
    params, stats = _mini_flax(model)
    jm = JMini()

    def loss(p):
        out, _ = jm.apply({"params": p, "batch_stats": stats},
                          jnp.asarray(imgs), jnp.asarray(target),
                          mutable=["batch_stats"])
        return out
    g = jax.device_get(jax.jit(jax.grad(loss))(params))
    unconv = lambda w: np.transpose(w, (w.ndim - 1, w.ndim - 2)
                                    + tuple(range(w.ndim - 2)))
    return {"tower.conv.weight": unconv(g["tower"]["conv"]["kernel"]),
            "tower.norm.weight": g["tower"]["norm"]["scale"],
            "tower.norm.bias": g["tower"]["norm"]["bias"],
            "unet.conv.weight": unconv(g["unet"]["conv"]["kernel"]),
            "unet.norm.weight": g["unet"]["norm"]["scale"],
            "unet.norm.bias": g["unet"]["norm"]["bias"],
            "head.weight": g["head"]["kernel"].T,
            "head.bias": g["head"]["bias"],
            "det.weight": g["det"]["kernel"].T, "det.bias": g["det"]["bias"]}


def _mini_failures(got, want):
    """The leaves whose gradients miss JAX's by more than ``GRAD_RTOL`` of
    their value plus ``GRAD_ATOL``."""
    return sorted(k for k, w in want.items()
                  if not np.allclose(got[k], w, rtol=GRAD_RTOL,
                                     atol=GRAD_ATOL))


# --- (d) the partial volume --------------------------------------------------

def volume_case():
    """Four views of [12, 16, 8] features looking into an 8x8x8 grid."""
    rng = np.random.RandomState(2)
    intr = np.array([[10.0, 0, 8], [0, 10.0, 6], [0, 0, 1]], np.float32)
    projs = []
    for k in range(4):
        pose = np.eye(4, dtype=np.float32)
        pose[:3, 3] = [0.3 + 0.1 * k, 0.35, -0.6 - 0.05 * k]
        projs.append(intr @ np.linalg.inv(pose)[:3])
    feats = rng.randn(4, 12, 16, 8).astype(np.float32)
    valid = np.array([True, True, False, True])
    return np.stack(projs).astype(np.float32), feats, valid


VOLUME_GRID = dict(voxel_dim=(8, 8, 8), voxel_size=0.2,
                   origin=(0.0, 0.0, 0.0))


def _volume_partial(group):
    from cnrma_torch.ops.backproject import partial_volume
    projs, feats, valid = volume_case()
    r, n = dist.rank(group), dist.world(group)
    vs = projs.shape[0] // n
    mine = slice(r * vs, (r + 1) * vs)
    vol, seen = partial_volume(torch.from_numpy(projs[mine]),
                               torch.from_numpy(feats[mine]),
                               torch.from_numpy(valid[mine]),
                               group=group, **VOLUME_GRID)
    return {"volume": vol.numpy(), "valid": seen.numpy()}


def _jax_volume():
    import jax
    import jax.numpy as jnp
    from cnrma_tpu.ops.backproject import accumulate_views_view_sharded
    from cnrma_tpu.parallel.mesh import make_mesh
    projs, feats, valid = volume_case()
    mesh = make_mesh(2, axis_names=("view",))
    vol, seen = accumulate_views_view_sharded(
        mesh, jnp.asarray(projs), jnp.asarray(feats), jnp.asarray(valid),
        VOLUME_GRID["voxel_dim"], VOLUME_GRID["voxel_size"],
        jnp.asarray(VOLUME_GRID["origin"], jnp.float32), view_chunk=1)
    return {"volume": np.asarray(vol), "valid": np.asarray(seen)}


# --- the jobs ----------------------------------------------------------------

def _small_rank(out):
    """(a)-(d) on a rank of two, then (a) and (c) with each planted
    fault."""
    group = _join()
    res = {None: {"unet": _unet_slab(group), "mini": _mini_sharded(group),
                  "upsample": _upsample_slab(group),
                  "volume": _volume_partial(group)}}
    for fault in FAULTS:
        restore = _plant(fault)
        res[fault] = {"unet": _unet_slab(group),
                      "mini": _mini_sharded(group)}
        restore()
    torch.save(res, os.path.join(out, f"small_{dist.rank(group)}.pt"))
    dist.shutdown(group)


def tiny_cnrma(**kw):
    """``test_torch_bridge.tiny_torch_cnrma`` at 1 cm detector voxels
    (``kw`` overriding its arguments), made here: that module imports JAX,
    which the ranks do not need."""
    from cnrma_torch.models.cn_rma import CNRMA
    from cnrma_torch.models.fcaf3d import DetectionCapacities
    return CNRMA(**{**dict(
        voxel_dim=(16, 16, 16), voxel_size=0.1, n_classes=3,
        ray_samples=24, rays_per_view_cap=512, max_points=1024,
        pts_threshold=500, assigner_limit=2, assigner_topk=4, nms_pre=16,
        voxel_size_fcaf3d=0.01, capacities=DetectionCapacities.tiny()),
        **kw})


# The tiny CNRMA's other marches and heads under view shards: the model's
# arguments, the GT boxes' centre and the planted fault each must fail.
# Depth marching (the march's dispatch in ``forward_view_sharded``) keeps
# points within 0.15 of z = 0, the first surface its rays cross, so its
# boxes sit at z = 0.2, where the batch assigns positives; ARKit's 7-DoF
# head (``configs/ray_marching_arkit.py``: 17 classes, 8 regression
# outputs, the yaw in the IoU loss) takes GT boxes turned by 0.3 rad.
STEP_VARIANTS = {"depth": (dict(ray_marching_type="depth"), (0.8, 0.8, 0.2),
                           "no_bn_sync"),
                 "arkit": (dict(n_classes=17, n_reg_outs=8, with_yaw=True),
                           (0.8, 0.8, 0.8), "sum_copies")}
# The steps' jobs, a pair of ranks each, so that neither runs all four
# models one after another: the CNRMA step with both planted faults and the
# Atlas step, and the two variants.
STEP_JOBS = {"step": ("cnrma", "atlas"), "variants": tuple(STEP_VARIANTS)}


def _step_case(centre=(0.8, 0.8, 0.8), **kw):
    """The tiny CNRMA of ``test_torch_train.py`` (64x64 views, 1 cm
    detector voxels, ``synthesize_parameters`` seed 1; ``kw`` as
    ``tiny_cnrma``'s) and its batch: two GT boxes at ``centre``, turned by
    0.3 rad for a yaw head."""
    from cnrma_torch.synthetic import synthesize_parameters
    model = tiny_cnrma(**kw)
    synthesize_parameters(model, 1)
    rng = np.random.RandomState(0)
    intr = np.array([[60.0, 0, 32], [0, 60.0, 32], [0, 0, 1]], np.float32)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [0.8, 0.8, -0.4]
    proj = (intr @ np.linalg.inv(pose)[:3]).astype(np.float32)
    T = torch.from_numpy
    batch = {"imgs": T(rng.rand(1, 2, 64, 64, 3).astype(np.float32) * 255),
             "projection": T(np.ascontiguousarray(
                 np.broadcast_to(proj, (1, 2, 3, 4)))),
             "view_valid": torch.ones(1, 2, dtype=torch.bool),
             "offset": torch.zeros(1, 3),
             "gt_boxes": torch.tensor([[[*centre, 0.6, 0.6, 0.6,
                                         0.3 if model.with_yaw else 0.]]
                                       * 2]),
             "gt_labels": torch.ones(1, 2, dtype=torch.int32),
             "gt_valid": torch.ones(1, 2, dtype=torch.bool),
             "tsdf_list": {f"tsdf_gt_{k}": T(rng.rand(1, d, d, d).astype(
                 np.float32) * 2 - 1) for k, d in (("010", 16), ("020", 8),
                                                   ("040", 4))}}
    return model.train(), batch


def _atlas_case():
    """The tiny ``Atlas`` of ``test_torch_stages.py`` (16^3 grid at 10 cm,
    ``synthesize_parameters`` seed 1) on ``_step_case``'s two 64x64 views
    and TSDF targets."""
    from cnrma_torch.models.cn_rma import Atlas
    from cnrma_torch.synthetic import synthesize_parameters
    model = Atlas(voxel_dim=(16, 16, 16), voxel_size=0.1)
    synthesize_parameters(model, 1)
    _, batch = _step_case()
    return model.train(), {k: v for k, v in batch.items()
                           if not k.startswith("gt_")}


def _step(case, group, fault=None):
    """One training forward and backward of ``case`` (``_step_case``, its
    parameters and statistics restored first): view-sharded under a
    ``group`` (its gradients reduced as the step reduces them), the
    one-process one without.  The losses, the TSDFs the losses saw, the
    gradients and the running statistics."""
    from cnrma_torch.train.loop import mean_over_ranks, total_loss
    model, batch, start = case
    model.load_state_dict(start)
    restore = _plant(fault)
    seen = {}
    real = model.recon_losses

    def recon(tsdf, b):
        seen.update({k: v.detach().numpy().copy() for k, v in tsdf.items()})
        return real(tsdf, b)
    model.recon_losses = recon
    gen = torch.Generator().manual_seed(7)
    if group is None:
        losses = model.forward_train(batch, generator=gen)
    else:
        shards = dist.view_shards(group, 2)
        losses = model.forward_view_sharded(batch, shards, generator=gen)
    model.zero_grad(set_to_none=True)
    total_loss(losses).backward()
    logs = {k: v.detach() for k, v in losses.items()}
    if group is not None:
        mean_over_ranks(model, logs, group, view_shards=2)
    restore()
    del model.recon_losses
    return {"losses": {k: float(v) for k, v in logs.items()}, "tsdf": seen,
            "grads": {k: (p.grad if p.grad is not None
                          else torch.zeros_like(p)).numpy()
                      for k, p in model.named_parameters()},
            "stats": {k: v.numpy() for k, v in model.named_buffers()}}


def _digest(res):
    """A hash of a step's gradients and statistics."""
    import hashlib
    h = hashlib.sha256()
    for part in ("grads", "stats"):
        for k, v in sorted(res[part].items()):
            h.update(k.encode() + np.ascontiguousarray(v).tobytes())
    return h.hexdigest()


def _step_kind(kind):
    """A kind of step (``STEP_JOBS``): its case, its planted faults and
    the readings that hold it."""
    if kind == "cnrma":
        return _step_case(), FAULTS, _step_readings
    if kind == "atlas":
        return _atlas_case(), ("sum_copies",), _atlas_readings
    kw, centre, planted = STEP_VARIANTS[kind]
    return _step_case(centre, **kw), (planted,), _step_readings


def _step_rank(out, job):
    """A rank of two, for each kind of step of ``job``: on rank 0 the
    one-process step; then the view-sharded step, clean and with each
    planted fault, held against the one-process step on rank 0; writes
    rank 0's readings and one-process losses, and each rank's hash of the
    clean step's gradients and statistics."""
    group = _join()
    rank = dist.rank(group)
    report = {}
    for kind in STEP_JOBS[job]:
        (model, batch), faults, readings = _step_kind(kind)
        case = (model, batch, {k: v.clone() for k, v in
                               model.state_dict().items()})
        want = _step(case, None) if rank == 0 else None
        report[kind] = {}
        for fault in (None,) + faults:
            got = _step(case, group, fault)
            if fault is None:
                report[kind + "_digest"] = _digest(got)
            if want is not None:
                report[kind][str(fault)] = readings(got, want)
            del got
        if want is not None:
            report[kind + "_losses"] = want["losses"]
        del case, want
    with open(os.path.join(out, f"{job}_{rank}.json"), "w") as f:
        json.dump(report, f)
    dist.shutdown(group)


def _atlas_readings(got, want):
    """``ATLAS_LIMITS``' readings of ``got`` against ``want``: the largest
    relative TSDF loss difference, and each kind's worst group (relative
    L2 error), each with its name."""
    r = {"tsdf_losses": max((abs(got["losses"][k] - w) / max(abs(w), 1e-30),
                             k) for k, w in want["losses"].items()
                            if k.startswith("tsdf_loss"))}
    for kind, prefixes in ATLAS_GROUPS.items():
        errs = []
        for prefix in prefixes:
            keys = [k for k in want["grads"] if k.startswith(prefix)]
            a = np.concatenate([got["grads"][k].ravel() for k in keys])
            b = np.concatenate([want["grads"][k].ravel() for k in keys])
            errs.append((float(np.linalg.norm(a - b)
                               / max(np.linalg.norm(b), 1e-30)), prefix))
        r[kind] = max(errs)
    return r


def _atlas_failures(r):
    return sorted(k for k, lim in ATLAS_LIMITS.items() if r[k][0] > lim)


def _step_readings(got, want):
    """``STEP_LIMITS``' readings of ``got`` against ``want``, each with the
    worst place's name."""
    def cos(a, b):
        a, b = a.ravel().astype(np.float64), b.ravel().astype(np.float64)
        na, nb = np.sqrt(a @ a), np.sqrt(b @ b)
        return float(na == nb) if na == 0 or nb == 0 \
            else float(a @ b / (na * nb))
    r = {"losses": max((abs(got["losses"][k] - w) / max(abs(w), 1e-30), k)
                       for k, w in want["losses"].items()),
         "tsdf": max((float(np.abs(got["tsdf"][k] - w).max()), k)
                     for k, w in want["tsdf"].items()),
         "stats": max((float(np.abs(got["stats"][k].astype(np.float64)
                                    - w).max()), k)
                      for k, w in want["stats"].items()),
         "leaf_cos": min((cos(got["grads"][k], w), k)
                         for k, w in want["grads"].items())}
    errs = []
    for prefix in STEP_GROUPS:
        keys = [k for k in want["grads"] if k.startswith(prefix)]
        a = np.concatenate([got["grads"][k].ravel() for k in keys])
        b = np.concatenate([want["grads"][k].ravel() for k in keys])
        errs.append((float(np.linalg.norm(a - b)
                           / max(np.linalg.norm(b), 1e-30)), prefix))
    r["group_err"] = max(errs)
    return r


def _step_failures(r):
    return sorted(k for k, lim in STEP_LIMITS.items()
                  if (r[k][0] < lim if k.endswith("cos") else r[k][0] > lim))


def _cli_case(root):
    """Two tiny synthetic ScanNet scenes as the val and the train split
    (the test CLI's 16^3 grid and five views; the train CLI's two views
    of 64x32), and a default-initialised checkpoint with boxes."""
    import shutil
    from cnrma_torch.core.builder import build_model
    from cnrma_torch.core.config import Config
    from cnrma_torch.synthetic import write_scannet
    from test_torch_test_cli import TARGET, tiny_options
    ann = write_scannet(root, n_scenes=2, n_frames=5, tsdf_dim=(32, 32, 16),
                        target=TARGET, radius=1.0)
    train = os.path.join(root, "scannet_infos_train.pkl")
    shutil.copy(ann, train)
    options = tiny_options(root, ann, frames=5)
    cfg = Config.fromfile(CONFIG)
    cfg.merge_from_options(dict(kv.split("=", 1) for kv in options))
    torch.manual_seed(0)
    ckpt = os.path.join(root, "init.pt")
    torch.save(build_model(cfg).state_dict(), ckpt)
    caps = ("{'voxelize':256,'stride2':128,'stride4':64,"
            "'levels':(32,16,8,8),'neck':(64,32,16)}")
    train_opts = [f"data.train.data_root={root}",
                  f"data.train.ann_file={train}",
                  "data.train.num_frames=2", "data.train.image_size=(64,32)",
                  "model.voxel_dim_train=(16,16,16)",
                  "data.train.voxel_dim=(16,16,16)", "model.ray_samples=32",
                  "model.rays_per_view_cap=64", "model.max_points=128",
                  f"model.capacities={caps}",
                  "evaluation={'interval':1,'metric':'mAP'}",
                  f"data.val.data_root={root}", f"data.val.ann_file={ann}",
                  "data.val.num_frames=2", "data.val.image_size=(64,32)",
                  "model.voxel_dim_test=(32,32,16)",
                  "data.val.voxel_dim=(32,32,16)", "log_config.interval=1",
                  "optimizer={'type':'SGD','lr':0.01,'momentum':0.9}"]
    return ckpt, options, train_opts


def _clis(out, root, tag, port2=None):
    """The test CLI with ``--view-shard`` (``tag`` 'sharded', a rank of
    two) or alone, then the train CLI for one step with ``--view-shards
    2`` (its group on ``port2``) or alone.  Writes the scenes rank 0's
    test CLI wrote and the train step's log vars."""
    from cnrma_torch.tools import test as test_cli
    from cnrma_torch.tools import train as train_cli
    ckpt, options, train_opts = _cli_case_paths(root)
    sharded = tag == "sharded"
    records = test_cli.main([CONFIG, ckpt, "--device", "cpu",
                             "--save-path", os.path.join(out, f"cli_{tag}"),
                             "--cfg-options", *options]
                            + (["--view-shard"] if sharded else []))
    if sharded:
        os.environ["MASTER_PORT"] = str(port2)
    work = os.path.join(out, f"train_{tag}")
    recs, _ = train_cli.main(
        [CONFIG, "--device", "cpu", "--max-steps", "1", "--work-dir", work,
         "--cfg-options", *train_opts]
        + (["--view-shards", "2"] if sharded else []))
    rank = os.environ.get("RANK", "0")
    if rank == "0":     # the checkpoints (about 1 GB each) once listed
        written = sorted(os.listdir(work))
        for name in written:
            if name.endswith(".pt"):
                os.remove(os.path.join(work, name))
    with open(os.path.join(out, f"cli_{tag}_{rank}.json"), "w") as f:
        json.dump({"test": [r["scene"] for r in records],
                   "train": recs[0]["log_vars"],
                   "val": recs[-1].get("val"),
                   "written": written if rank == "0" else None}, f)


def _cli_case_paths(root):
    """The CLI case the fixture writes meanwhile, once it is there."""
    path = os.path.join(root, "cli_case.json")
    deadline = time.monotonic() + TIME_LIMIT
    while not os.path.exists(path) and time.monotonic() < deadline:
        time.sleep(0.1)
    with open(path) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every spawned job of this file, started at once, while JAX's
    references are computed here: the output directory, the jobs (their
    exit codes and seconds) and JAX's results."""
    out = str(tmp_path_factory.mktemp("view_shard"))
    root = str(tmp_path_factory.mktemp("scenes"))
    groups = {"small": (_small_rank, 2, (out,)),
              "cli": (_clis, 2, (out, root, "sharded", free_port())),
              "alone": (_clis, 0, (out, root, "alone"))}
    for job in STEP_JOBS:
        groups[job] = (_step_rank, 2, (out, job))

    def jax_side():
        case = os.path.join(root, "cli_case.json")
        with open(case + ".tmp", "w") as f:
            json.dump(_cli_case(root), f)
        os.replace(case + ".tmp", case)         # the CLI jobs wait for it
        return {"unet": _jax_unet(), "upsample": _jax_upsample(),
                "mini": _jax_mini(), "volume": _jax_volume(),
                "unet_port": _unet_full()}
    jobs = spawn(groups, TIME_LIMIT, jax_side)
    return out, jobs, jobs.found


def _jax_upsample():
    import jax.numpy as jnp
    from cnrma_tpu.models.layers import upsample_linear
    return np.asarray(upsample_linear(jnp.asarray(upsample_case()), 2))


def _small(out, fault=None):
    return [torch.load(os.path.join(out, f"small_{r}.pt"),
                       weights_only=False)[fault] for r in range(2)]


def _slab_failures(got, want, port):
    """The slab U-Net's outputs and TSDFs that miss JAX's by more than
    ``JAX_UNET_TOL`` of their scale or the port's unsharded ones by more
    than ``SLAB_TOL``, and its statistics that miss JAX's by more than
    ``SLAB_TOL`` (absolute and relative)."""
    bad = []
    slab = lambda a, b: np.allclose(a, b, atol=SLAB_TOL, rtol=SLAB_TOL)
    scaled = lambda a, b: np.allclose(
        a, b, atol=JAX_UNET_TOL * float(np.abs(b).max()), rtol=0)
    pairs = [(f"out{i}", a, b, c) for i, (a, b, c) in enumerate(
        zip(got["outs"], want["outs"], port["outs"]))]
    pairs += [(k, got["preds"][k], w, port["preds"][k])
              for k, w in want["preds"].items()]
    for name, a, b, c in pairs:
        if a.shape != b.shape or not scaled(a, b):
            bad.append(name + " against JAX")
        if not slab(a, c):
            bad.append(name + " against the port unsharded")
    bad += [k for k, w in want["stats"].items()
            if not slab(got["stats"][k], w)]
    return bad


def test_slab_unet_and_head_match_jax(runs):
    out, jobs, want = runs
    jobs.check("small")
    for rank in _small(out):
        assert not _slab_failures(rank["unet"], want["unet"],
                                  want["unet_port"])


def test_halo_upsample_matches_jax(runs):
    out, jobs, want = runs
    jobs.check("small")
    for rank in _small(out):
        np.testing.assert_allclose(rank["upsample"], want["upsample"],
                                   atol=UPSAMPLE_TOL, rtol=0)


def test_boundary_gradients_match_jax(runs):
    """The miniature's reduced gradients on each rank equal JAX's
    unsharded ``jax.grad`` (and the port's one-process gradients)."""
    out, jobs, want = runs
    jobs.check("small")
    model, imgs, target = mini_case()
    model.single(torch.from_numpy(imgs).permute(0, 3, 1, 2),
                 torch.from_numpy(target)).backward()
    assert not _mini_failures(_mini_grads(model), want["mini"])
    for rank in _small(out):
        assert not _mini_failures(rank["mini"], want["mini"])


def test_partial_volume_matches_jax(runs):
    from cnrma_torch.ops.backproject import volume_accum_plain
    out, jobs, want = runs
    jobs.check("small")
    projs, feats, valid = volume_case()
    alone, _, seen = volume_accum_plain(
        torch.from_numpy(projs), torch.from_numpy(feats),
        torch.from_numpy(valid), **VOLUME_GRID)
    assert seen.any() and not seen.all()
    for rank in _small(out):
        np.testing.assert_allclose(rank["volume"]["volume"],
                                   want["volume"]["volume"], atol=VOLUME_TOL)
        np.testing.assert_array_equal(rank["volume"]["valid"],
                                      want["volume"]["valid"])
        np.testing.assert_allclose(rank["volume"]["volume"], alone.numpy(),
                                   atol=VOLUME_TOL)


def test_volume_sum_mode_is_the_undivided_sum():
    """The plain version's sum mode: the count times the mean."""
    from cnrma_torch.ops.backproject import volume_accum_plain
    projs, feats, valid = (torch.from_numpy(a) for a in volume_case())
    mean, cnt, seen = volume_accum_plain(projs, feats, valid, **VOLUME_GRID)
    total, cnt2, seen2 = volume_accum_plain(projs, feats, valid,
                                            write_sum=True, **VOLUME_GRID)
    assert total.dtype == torch.float32 and torch.equal(cnt, cnt2)
    assert torch.equal(seen, seen2)
    torch.testing.assert_close(total, mean * cnt[..., None], rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("fault", FAULTS)
def test_planted_faults_break_the_boundary_checks(runs, fault):
    """Unsynced norms break the slab U-Net's parity and the miniature's
    gradients; a boundary that sums the n copies breaks the gradients."""
    out, jobs, want = runs
    jobs.check("small")
    for rank in _small(out, fault):
        assert _mini_failures(rank["mini"], want["mini"])
        if fault == "no_bn_sync":
            assert _slab_failures(rank["unet"], want["unet"],
                                  want["unet_port"])


def _step_reports(runs, job):
    """Both ranks' reports of a ``STEP_JOBS`` job, once it ended well."""
    out, jobs, _ = runs
    jobs.check(job)
    reports = []
    for r in range(2):
        with open(os.path.join(out, f"{job}_{r}.json")) as f:
            reports.append(json.load(f))
    return reports


def test_view_sharded_step_matches_one_process(runs):
    """The tiny CNRMA's view-sharded step (2 ranks, 1 view each, X-slabs
    of 8) against the one-process step at ``STEP_LIMITS``; both ranks
    end with the same gradients and statistics."""
    ranks = _step_reports(runs, "step")
    assert ranks[0]["cnrma_losses"]["loss_cls"] > 0
    assert not ranks[1]["cnrma"]
    r = ranks[0]["cnrma"]["None"]
    print("view-sharded step readings:", r)
    assert not _step_failures(r), r
    assert ranks[0]["cnrma_digest"] == ranks[1]["cnrma_digest"]


@pytest.mark.parametrize("fault", FAULTS)
def test_planted_faults_break_the_step_limits(runs, fault):
    r = _step_reports(runs, "step")[0]["cnrma"][fault]
    print(f"{fault}: breaks {_step_failures(r)}; readings {r}")
    assert _step_failures(r), r


def test_view_sharded_atlas_step_matches_one_process(runs):
    """Stage 1's step split over two ranks (1 view each, X-slabs of 8)
    against the one-process ``Atlas`` step at ``ATLAS_LIMITS``; both ranks
    end with the same gradients and statistics."""
    ranks = _step_reports(runs, "step")
    assert not ranks[1]["atlas"]
    r = ranks[0]["atlas"]["None"]
    print("view-sharded Atlas step readings:", r)
    assert not _atlas_failures(r), r
    assert ranks[0]["atlas_digest"] == ranks[1]["atlas_digest"]


def test_planted_boundary_fault_breaks_the_atlas_limits(runs):
    """The boundary that sums the n copies of the replicated cotangent
    breaks the Atlas step's gradient limits."""
    r = _step_reports(runs, "step")[0]["atlas"]["sum_copies"]
    print(f"sum_copies, Atlas: breaks {_atlas_failures(r)}; readings {r}")
    assert {"unet_head", "tower"} <= set(_atlas_failures(r)), r


@pytest.mark.parametrize("kind", list(STEP_VARIANTS))
def test_view_sharded_variant_step_matches_one_process(runs, kind):
    """The tiny CNRMA's view-sharded step with depth marching, and with
    ARKit's 7-DoF head (``STEP_VARIANTS``), on two ranks against the
    one-process step at ``STEP_LIMITS``; the batch assigns positives;
    both ranks end with the same gradients and statistics."""
    ranks = _step_reports(runs, "variants")
    assert not ranks[1][kind]
    losses = ranks[0][kind + "_losses"]
    assert losses["loss_cls"] > 0 and losses["loss_bbox"] > 0
    r = ranks[0][kind]["None"]
    print(f"view-sharded {kind} step readings:", r)
    assert not _step_failures(r), r
    assert ranks[0][kind + "_digest"] == ranks[1][kind + "_digest"]


@pytest.mark.parametrize("kind", list(STEP_VARIANTS))
def test_planted_fault_breaks_the_variant_step_limits(runs, kind):
    """Unsynced batch norms break the depth-marching step's limits, the
    boundary that sums the copies of the replicated cotangent the ARKit
    step's."""
    fault = STEP_VARIANTS[kind][2]
    r = _step_reports(runs, "variants")[0][kind][fault]
    print(f"{fault}, {kind}: breaks {_step_failures(r)}; readings {r}")
    assert _step_failures(r), r


def _load_all(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def test_cli_view_shard_writes_the_one_rank_files(runs):
    """``--view-shard`` on two ranks: rank 0 writes every scene and rank 1
    none; each scene's TSDF and raw boxes are the one-rank run's within
    ``CLI_TOL`` of their scale (the volume's sum is split in two)."""
    out, jobs, _ = runs
    jobs.check("cli", "alone")
    with open(os.path.join(out, "cli_sharded_0.json")) as f:
        rank0 = json.load(f)
    with open(os.path.join(out, "cli_sharded_1.json")) as f:
        rank1 = json.load(f)
    scenes = ["scene0000_00", "scene0001_00"]
    assert rank0["test"] == scenes and rank1["test"] == []
    boxes = 0
    for s in scenes:
        for f, key in ((s + ".npz", "tsdf"), (s + "_bbox_raw.npz",
                                               "bboxes")):
            a = _load_all(os.path.join(out, "cli_alone", s, f))
            b = _load_all(os.path.join(out, "cli_sharded", s, f))
            assert a.keys() == b.keys()
            for k in a:
                scale = max(float(np.abs(a[k]).max()), 1.0) if a[k].size \
                    else 1.0
                np.testing.assert_allclose(b[k], a[k], atol=CLI_TOL * scale,
                                           err_msg=f + ":" + k)
            boxes += len(a.get("bboxes", ()))
    assert boxes > 0


def test_train_cli_view_shards_step_matches_one_process(runs):
    """``--view-shards 2`` on two ranks: one step whose losses are the
    one-process CLI's within ``CLI_LOSS_RTOL``, the same on both ranks;
    the val split scored after it (each scene through the test forward's
    view sharding, the rows' results gathered over each view index's data
    group, so both ranks here score the split alike) within
    ``CLI_LOSS_RTOL`` of the one-process scores; rank 0 writes the step's
    checkpoint and ``best.pt``."""
    out, jobs, _ = runs
    jobs.check("cli", "alone")
    got = []
    for name in ("cli_sharded_0", "cli_sharded_1", "cli_alone_0"):
        with open(os.path.join(out, name + ".json")) as f:
            got.append(json.load(f))
    assert got[0]["train"] == got[1]["train"]
    assert got[0]["val"] == got[1]["val"]       # each view index scores
    for part in ("train", "val"):
        want = got[2][part]
        assert want and set(got[0][part]) == set(want)
        for k, w in want.items():
            if "loss" in k:
                assert abs(got[0][part][k] - w) <= CLI_LOSS_RTOL * max(
                    abs(w), 1e-6), (part, k)
    assert {"iter_1.pt", "best.pt"} <= set(got[0]["written"])


def test_clis_refuse_what_jax_refuses(tmp_path, monkeypatch):
    """``--view-shard`` with ``--n-devices``; ``--view-shards`` that does
    not divide the world; a batch that is not one scene a data row."""
    from cnrma_torch.tools import test as test_cli
    from cnrma_torch.tools import train as train_cli
    with pytest.raises(SystemExit, match="mutually exclusive"):
        test_cli.main([CONFIG, "--device", "cpu", "--view-shard",
                       "--n-devices", "2"])
    monkeypatch.setenv("WORLD_SIZE", "4")
    with pytest.raises(SystemExit, match="must divide the 4 visible"):
        train_cli.main([CONFIG, "--device", "cpu", "--view-shards", "3"])
    with pytest.raises(SystemExit, match="per-device batch must be 1 scene"):
        train_cli.main([CONFIG, "--device", "cpu", "--view-shards", "2",
                        "--batch-size", "4"])


def test_forward_view_sharded_checks_its_shapes():
    """One scene a rank, views and slabs that split evenly (JAX's
    checks), before any collective."""
    model = tiny_cnrma()
    shards = dist.ViewShards(n=2, row=0, index=0, rows=1, view=None,
                             data=None)
    imgs = torch.zeros(1, 3, 8, 8, 3)
    with pytest.raises(ValueError, match="must divide the view axis"):
        model.forward_view_sharded({"imgs": imgs}, shards)
    with pytest.raises(ValueError, match="per-device batch must be 1"):
        model.forward_view_sharded({"imgs": torch.zeros(2, 2, 8, 8, 3)},
                                   shards)
    wide = dist.ViewShards(n=4, row=0, index=0, rows=1, view=None,
                           data=None)
    with pytest.raises(ValueError, match="slabs divisible by 8"):
        model.forward_view_sharded({"imgs": torch.zeros(1, 4, 8, 8, 3)},
                                   wide)

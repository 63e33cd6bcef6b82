"""The whole-model learning check: overfit ``CNRMA`` on synthetic rooms.

    python -m cnrma_torch.tools.overfit_full [--steps 400] [--scenes 2]
        [--views 8] [--map-target 0.5] [--yaw] [--device cpu]

Port of ``tools/overfit_full.py``.  Procedural box rooms with analytic
ground truth (multi-scale TSDFs from the scene's SDF, posed RGB views
ray-cast from that SDF with class-coded colours; the numpy scene builder is
a copy) train the whole tiny ``CNRMA`` (2D tower -> volume -> 3D U-Net ->
TSDF head -> NeuS ray march -> sparse FCAF3D detection) with the joint loss,
AdamW (lr 1e-3, weight decay 1e-4) after a global-norm clip at 10.0, from
the model's default initialisation under ``torch.manual_seed(0)``.  The
trained model's test forward is then scored through the per-class NMS
(``score_thr`` 0.05) and ``indoor_eval``, as real scenes are.  ``--yaw``
draws yawed, elongated boxes and trains the 7-DoF detector (the rotated IoU
loss, the yaw decoding, rotated NMS and rotated mAP).

The ``--scenes`` rooms train as one batch for ``--steps`` steps, as in
the JAX tool: every step takes all of them, and the batch norms (the
detector's sparse ones too) take their statistics over the batch.

PASS, the JAX tool's rule: the last step's total loss under 0.6 of the
first step's, its reconstruction loss under 0.5 of the first's, and
mAP@0.25 on the training rooms at least ``--map-target``.

The run is on ``cuda:0`` unless ``--device cpu``, with TF32 off; it
returns 0 on PASS.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from cnrma_torch.eval.indoor_eval import indoor_eval
from cnrma_torch.models.cn_rma import CNRMA
from cnrma_torch.models.fcaf3d import DetectionCapacities
from cnrma_torch.ops.nms import multiclass_nms_np
from cnrma_torch.tools._common import no_tf32
from cnrma_torch.train.loop import device_batch, step_generator, train_step
from cnrma_torch.train.optim import build_optimizer

# ---------------------------------------------------------------------------
# Analytic scene (a copy of ``tools/overfit_full.py``'s numpy builder):
# axis-aligned or yawed boxes on a floor inside the voxel volume.

CLASS_COLORS = np.array([[220, 60, 60], [60, 200, 60], [60, 80, 220]],
                        np.float32)
FLOOR_COLOR = np.array([150, 150, 150], np.float32)
SKY_COLOR = np.array([30, 30, 30], np.float32)


def _box_frame(pts, box):
    """Rotate [N,3] points into the (possibly yawed) box frame."""
    cx, cy, cz, sx, sy, sz = box[:6]
    yaw = box[6] if len(box) > 6 else 0.0
    q = pts - np.array([cx, cy, cz])
    if yaw:
        c, s = np.cos(-yaw), np.sin(-yaw)
        q = np.stack([q[:, 0] * c - q[:, 1] * s,
                      q[:, 0] * s + q[:, 1] * c, q[:, 2]], axis=1)
    return np.abs(q) - np.array([sx, sy, sz]) / 2


def scene_sdf(pts, boxes, floor_z):
    """Signed distance of [N,3] points to floor plane + box union
    (boxes [M, 6|7], optional yaw around +z — the ARKit 7-DoF case)."""
    d = pts[:, 2] - floor_z
    for box in boxes:
        q = _box_frame(pts, box)
        outside = np.linalg.norm(np.maximum(q, 0.0), axis=1)
        inside = np.minimum(np.max(q, axis=1), 0.0)
        d = np.minimum(d, outside + inside)
    return d


def nearest_box(pts, boxes):
    """Index of the closest box per point (for hit coloring)."""
    ds = []
    for box in boxes:
        q = _box_frame(pts, box)
        ds.append(np.linalg.norm(np.maximum(q, 0.0), axis=1)
                  + np.minimum(np.max(q, axis=1), 0.0))
    return np.argmin(np.stack(ds), axis=0), np.min(np.stack(ds), axis=0)


def make_scene(rng, n_classes=3, n_boxes=2, extent=(3.2, 3.2, 1.6),
               floor_z=0.1, yaw_max=0.0):
    """Boxes are [cx,cy,cz,sx,sy,sz,yaw]; ``yaw_max > 0`` draws a
    rotation (the ARKit 7-DoF regime, ``ray_marching_arkit.py:193-201``),
    elongating x vs y so the yaw is observable."""
    boxes, labels = [], []
    for _ in range(n_boxes):
        size = rng.rand(3) * 0.5 + np.array([0.5, 0.5, 0.5])
        if yaw_max > 0:
            size[0] *= 1.8                    # distinct principal axis
        center = np.array([
            rng.rand() * (extent[0] - 1.6) + 0.8,
            rng.rand() * (extent[1] - 1.6) + 0.8,
            floor_z + size[2] / 2])
        yaw = (rng.rand() * 2 - 1) * yaw_max
        boxes.append([*center, *size, yaw])
        labels.append(rng.randint(n_classes))
    return (np.asarray(boxes, np.float32),
            np.asarray(labels, np.int32), floor_z)


def gt_tsdf(boxes, floor_z, voxel_dim, voxel_size, n_scales=3,
            trunc_ratio=3.0):
    """Analytic multi-scale GT TSDF dict keyed like the data layer."""
    out = {}
    for s in range(n_scales):
        vs = voxel_size * (2 ** s)
        dims = tuple(d // (2 ** s) for d in voxel_dim)
        ii = np.stack(np.meshgrid(*[np.arange(d) for d in dims],
                                  indexing="ij"), -1).reshape(-1, 3)
        pts = ii.astype(np.float32) * vs          # origin at 0
        d = scene_sdf(pts, boxes, floor_z)
        tsdf = np.clip(d / (trunc_ratio * vs), -1.0, 1.0)
        out[f"tsdf_gt_{int(round(vs * 100)):03d}"] = \
            tsdf.reshape(dims).astype(np.float32)
    return out


def look_at(eye, target, up=(0.0, 0.0, 1.0)):
    """Camera-to-world 4x4: camera +z looks at ``target``."""
    fwd = np.asarray(target, np.float32) - np.asarray(eye, np.float32)
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray(up, np.float32))
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    E = np.eye(4, dtype=np.float32)
    E[:3, 0], E[:3, 1], E[:3, 2], E[:3, 3] = right, down, fwd, eye
    return E


def render_view(E, K, h, w, boxes, labels, floor_z, n_steps=192,
                t_max=5.0):
    """Ray-cast the analytic SDF: class-coded colors, depth shading."""
    uv = np.stack(np.meshgrid(np.arange(w) + 0.5, np.arange(h) + 0.5),
                  -1).reshape(-1, 2)
    ray_cam = np.concatenate(
        [(uv - K[:2, 2]) / np.array([K[0, 0], K[1, 1]]),
         np.ones((len(uv), 1))], axis=1)
    dirs = ray_cam @ E[:3, :3].T
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    o = E[:3, 3]

    ts = np.linspace(0.05, t_max, n_steps).astype(np.float32)
    hit_t = np.full(len(uv), np.inf, np.float32)
    # coarse-to-exact: fixed-step march, keep first sign change
    prev = None
    for t in ts:
        d = scene_sdf(o[None] + dirs * t, boxes, floor_z)
        if prev is not None:
            crossed = (prev > 0) & (d <= 0) & (hit_t == np.inf)
            hit_t[crossed] = t
        prev = d
    img = np.broadcast_to(SKY_COLOR, (len(uv), 3)).copy()
    hit = hit_t < np.inf
    if hit.any():
        p = o[None] + dirs[hit] * hit_t[hit, None]
        bi, bd = nearest_box(p, boxes)
        floor_d = np.abs(p[:, 2] - floor_z)
        col = np.where((bd < floor_d)[:, None],
                       CLASS_COLORS[labels[bi]], FLOOR_COLOR[None])
        shade = np.clip(1.2 - hit_t[hit] / t_max, 0.35, 1.0)
        img[hit] = col * shade[:, None]
    return img.reshape(h, w, 3).astype(np.float32)


def make_views(rng, boxes, labels, floor_z, n_views, h, w,
               extent=(3.2, 3.2, 1.6)):
    center = np.array([extent[0] / 2, extent[1] / 2, 0.5], np.float32)
    K = np.array([[0.9 * w, 0, w / 2], [0, 0.9 * w, h / 2], [0, 0, 1]],
                 np.float32)
    imgs, projs = [], []
    for i in range(n_views):
        ang = 2 * np.pi * i / n_views + rng.rand() * 0.3
        r = 2.6 + rng.rand() * 0.4
        eye = center + np.array([r * np.cos(ang), r * np.sin(ang),
                                 0.9 + rng.rand() * 0.6])
        E = look_at(eye, center)
        imgs.append(render_view(E, K, h, w, boxes, labels, floor_z))
        projs.append((K @ np.linalg.inv(E)[:3]).astype(np.float32))
    return np.stack(imgs), np.stack(projs)


def build_batch(rng, n_scenes, n_views, h, w, voxel_dim, voxel_size,
                n_classes, max_boxes=4, yaw_max=0.0):
    imgs, projs, tsdfs, gtb, gtl, gtv = [], [], [], [], [], []
    scenes = []
    for _ in range(n_scenes):
        boxes, labels, floor_z = make_scene(rng, n_classes,
                                            yaw_max=yaw_max)
        scenes.append((boxes, labels))
        im, pr = make_views(rng, boxes, labels, floor_z, n_views, h, w)
        imgs.append(im)
        projs.append(pr)
        tsdfs.append(gt_tsdf(boxes, floor_z, voxel_dim, voxel_size))
        b7 = np.zeros((max_boxes, 7), np.float32)
        b7[:len(boxes)] = boxes
        gtb.append(b7)
        lb = np.zeros(max_boxes, np.int32)
        lb[:len(labels)] = labels
        gtl.append(lb)
        v = np.zeros(max_boxes, bool)
        v[:len(boxes)] = True
        gtv.append(v)
    batch = {
        "imgs": np.stack(imgs),
        "projection": np.stack(projs),
        "view_valid": np.ones((n_scenes, n_views), bool),
        "offset": np.zeros((n_scenes, 3), np.float32),
        "gt_boxes": np.stack(gtb),
        "gt_labels": np.stack(gtl),
        "gt_valid": np.stack(gtv),
        "tsdf_list": {k: np.stack([t[k] for t in tsdfs])
                      for k in tsdfs[0]},
    }
    return batch, scenes


# ---------------------------------------------------------------------------

N_CLASSES = 3
VOXEL_DIM, VOXEL_SIZE = (32, 32, 16), 0.1
HEIGHT, WIDTH = 64, 96


def tiny_model(yaw: bool) -> CNRMA:
    """The JAX tool's tiny ``CNRMA`` (``tools/overfit_full.py:244-255``)."""
    return CNRMA(
        voxel_dim=VOXEL_DIM, voxel_size=VOXEL_SIZE, n_classes=N_CLASSES,
        ray_samples=64, rays_per_view_cap=2048, max_points=8192,
        voxel_size_fcaf3d=0.05, pts_threshold=6000,
        assigner_limit=8, assigner_topk=6, nms_pre=128,
        with_yaw=yaw, n_reg_outs=8 if yaw else 6,
        capacities=DetectionCapacities(
            voxelize=8192, stride2=6144, stride4=4096,
            levels=(2048, 1024, 512, 256), neck=(6144, 4096, 2048)),
        use_feature_transform=False)


def _recon(losses: Dict[str, float]) -> float:
    return sum(v for k, v in losses.items() if "tsdf" in k)


def parse_args(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser(description="Overfit the whole CNRMA on "
                                             "synthetic rooms")
    ap.add_argument("--steps", type=int, default=400,
                    help="optimizer steps, each on every room")
    ap.add_argument("--scenes", type=int, default=2)
    ap.add_argument("--views", type=int, default=8)
    ap.add_argument("--map-target", type=float, default=0.5)
    ap.add_argument("--yaw", action="store_true",
                    help="7-DoF yawed boxes end to end: rotated-IoU "
                         "loss + fcaf3d yaw decode + rotated NMS + "
                         "rotated mAP (the ARKit regime)")
    ap.add_argument("--device", default="cuda:0",
                    help="cuda:0 (default) or cpu")
    return ap.parse_args(argv)


def run(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Train and score; returns the first and last total and
    reconstruction losses, the mAPs, the seconds a step, the peak device
    memory (GiB, on a GPU) and ``ok``, the PASS rule."""
    args = parse_args(argv)
    no_tf32()
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device here "
                         "(pass --device cpu to run on the CPU)")
    rng_np = np.random.RandomState(0)
    t0 = time.time()
    yaw_max = 0.6 if args.yaw else 0.0
    batch_np, scenes = build_batch(rng_np, args.scenes, args.views, HEIGHT,
                                   WIDTH, VOXEL_DIM, VOXEL_SIZE, N_CLASSES,
                                   yaw_max=yaw_max)
    print(f"scene gen: {time.time() - t0:.0f}s", flush=True)
    batch = device_batch(batch_np, dev)

    torch.manual_seed(0)
    model = tiny_model(args.yaw).to(dev)
    optimizer = build_optimizer(dict(type="AdamW", lr=1e-3,
                                     weight_decay=1e-4), model,
                                lambda step: 1e-3, grad_clip=10.0)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    totals, recons = [], []
    t0 = time.perf_counter()
    for i in range(args.steps):
        log_vars = train_step(model, optimizer, batch,
                              step_generator(0, i, dev))
        losses = {k: float(v) for k, v in log_vars.items()}
        totals.append(losses["total_loss"])
        recons.append(_recon(losses))
        if i % 20 == 0 or i == args.steps - 1:
            print(f"step {i:4d}  total {totals[-1]:.4f}  "
                  f"recon {recons[-1]:.4f}  "
                  f"({time.perf_counter() - t0:.0f}s)", flush=True)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    step_s = (time.perf_counter() - t0) / max(1, len(totals))
    first, final = totals[0], totals[-1]
    first_recon, final_recon = recons[0], recons[-1]

    model.eval()
    n = args.scenes
    out = model(batch, generator=[torch.Generator(dev).manual_seed(i)
                                  for i in range(n)])
    results, gts = [], []
    for i in range(n):
        v = out["bbox_valid"][i].cpu().numpy()
        bb, sc, lb = multiclass_nms_np(
            out["bboxes"][i].cpu().numpy()[v],
            out["scores"][i].cpu().numpy()[v],
            score_thr=0.05, iou_thr=0.5, device=dev)
        bb = bb.copy()
        if len(bb):
            bb[:, 2] -= bb[:, 5] / 2               # gravity -> bottom z
        results.append({"boxes": bb, "scores": sc, "labels": lb})
        gb = np.array(scenes[i][0], np.float32, copy=True)
        gb[:, 2] -= gb[:, 5] / 2
        gts.append({"gt_boxes": gb, "labels": scenes[i][1]})
    order = np.argsort(-results[0]["scores"])[:4]
    for j in order:
        print("  pred", np.round(results[0]["boxes"][j], 2),
              f"s={results[0]['scores'][j]:.3f} "
              f"l={results[0]['labels'][j]}")
    for gb, gl in zip(gts[0]["gt_boxes"], gts[0]["labels"]):
        print("  gt  ", np.round(gb, 2), f"l={gl}")
    metrics = indoor_eval(gts, results, iou_thrs=(0.25, 0.5),
                          label2cat={i: f"c{i}" for i in range(N_CLASSES)},
                          rotated=args.yaw, device=dev)
    ok = (final < 0.6 * first and final_recon < 0.5 * first_recon
          and metrics["mAP_0.25"] >= args.map_target)
    peak = (torch.cuda.max_memory_allocated(dev) / 2 ** 30
            if dev.type == "cuda" else None)
    print(f"total {first:.3f} -> {final:.3f};  "
          f"recon {first_recon:.3f} -> {final_recon:.3f};  "
          f"mAP@0.25 {metrics['mAP_0.25']:.3f}  "
          f"mAP@0.50 {metrics['mAP_0.50']:.3f};  "
          f"{step_s:.4f} s a step"
          + ("" if peak is None else f", peak {peak:.2f} GiB"), flush=True)
    print("full overfit check:", "PASS" if ok else "FAIL", flush=True)
    return {"first": first, "final": final, "first_recon": first_recon,
            "final_recon": final_recon, "mAP_0.25": metrics["mAP_0.25"],
            "mAP_0.50": metrics["mAP_0.50"], "steps": len(totals),
            "step_s": step_s, "peak_gib": peak, "ok": ok}


def main(argv: Optional[Sequence[str]] = None) -> int:
    return 0 if run(argv)["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())

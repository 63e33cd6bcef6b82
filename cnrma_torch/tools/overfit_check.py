"""The detector-only learning check: overfit ``FCAF3DOnly`` on synthetic
box scenes.

    python -m cnrma_torch.tools.overfit_check [--steps 1000] [--scenes 2]
        [--device cpu]

Port of ``tools/overfit_check.py``.  Procedural scenes (1024 points on the
faces of two axis-aligned boxes and a cluttered floor, 8 feature columns
that carry the box's class; the numpy scene builder is a copy) train a
tiny ``FCAF3DOnly`` (3 classes, 0.08 m voxels, ``DetectionCapacities.tiny()``,
no feature transform) with AdamW (lr 2e-3, weight decay 1e-4: optax's
default, on every parameter; no clip), from the model's default
initialisation under ``torch.manual_seed(0)``.  Every step takes all the
scenes as one batch, so the sparse batch norms take their statistics over
the batch.  The trained model's test forward on the SAME scenes is then
scored through the per-class NMS (``score_thr`` 0.05, ``iou_thr`` 0.5) and
``indoor_eval`` at IoU 0.25 and 0.5, axis-aligned.

PASS, the JAX tool's rule: the last step's loss under half the first
step's, and mAP@0.25 at least 0.5.

The run is on ``cuda:0`` unless ``--device cpu``, with TF32 off; it
returns 0 on PASS.  On the card it runs with PyTorch's deterministic
algorithms, and an operation that has no deterministic version raises:
``index_add_``'s atomics otherwise sum in another order each run, and at
these sizes that moves the step at which the detector leaves its early
loss plateau (about 1.34, no box scored) by a hundred steps and more, so
a run of a few hundred steps would pass or fail by chance.  A change of
summation order (a new PyTorch, or another sparse convolution) moves that
step as well, so the step count that passes is to be read again then.
``--score-every K`` also scores the model (its boxes and table not
printed) after every K-th step and returns each reading under ``scores``.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from cnrma_torch import capacity
from cnrma_torch.eval.indoor_eval import indoor_eval
from cnrma_torch.models.fcaf3d import DetectionCapacities
from cnrma_torch.models.fcaf3d_only import FCAF3DOnly
from cnrma_torch.tools._common import device_of, no_tf32
from cnrma_torch.train.loop import device_batch, scene_boxes, train_step
from cnrma_torch.train.optim import build_optimizer

N_CLASSES = 3
VOXEL_SIZE = 0.08
MAX_BOXES = 4                   # GT slots a scene
LR, WEIGHT_DECAY = 2e-3, 1e-4   # optax.adamw(2e-3) and its default decay


def make_scene(rng, n_classes=3, n_pts=1024, n_boxes=2):
    """Points on the surfaces of axis-aligned boxes + uniform clutter."""
    boxes, labels = [], []
    pts, feats = [], []
    for b in range(n_boxes):
        cls = rng.randint(n_classes)
        center = rng.rand(3) * 2.4 + np.array([0.8, 0.8, 0.4])
        size = rng.rand(3) * 0.5 + np.array([0.4, 0.4, 0.3])
        boxes.append([*center, *size, 0.0])
        labels.append(cls)
        n = n_pts // (n_boxes + 1)
        # sample on the box surface: pick a face per point
        u = rng.rand(n, 3) - 0.5
        face = rng.randint(3, size=n)
        sign = rng.choice([-0.5, 0.5], size=n)
        u[np.arange(n), face] = sign
        p = center[None] + u * size[None]
        pts.append(p)
        f = np.zeros((n, 8), np.float32)
        f[:, cls] = 1.0                      # class-correlated feature
        f[:, 3:] = rng.rand(n, 5) * 0.1
        feats.append(f)
    n_bg = n_pts - sum(len(p) for p in pts)
    bg = rng.rand(n_bg, 3) * 4.0
    bg[:, 2] *= 0.05                          # floor
    pts.append(bg)
    feats.append(rng.rand(n_bg, 8).astype(np.float32) * 0.1)
    return (np.concatenate(pts).astype(np.float32),
            np.concatenate(feats).astype(np.float32),
            np.asarray(boxes, np.float32), np.asarray(labels, np.int32))


def build_batch(scenes: List[Tuple[np.ndarray, ...]]) -> Dict[str, Any]:
    """The scenes stacked as one batch (``tools/overfit_check.py:81-95``):
    every point valid, ``MAX_BOXES`` GT slots a scene, the first of them
    filled and valid."""
    b, m = len(scenes), MAX_BOXES
    batch = {"points": np.stack([s[0] for s in scenes]),
             "point_feats": np.stack([s[1] for s in scenes]),
             "point_valid": np.ones((b, scenes[0][0].shape[0]), bool),
             "gt_boxes": np.zeros((b, m, 7), np.float32),
             "gt_labels": np.zeros((b, m), np.int32),
             "gt_valid": np.zeros((b, m), bool)}
    for i, (_, _, bx, lb) in enumerate(scenes):
        k = len(bx)
        batch["gt_boxes"][i, :k] = bx
        batch["gt_labels"][i, :k] = lb
        batch["gt_valid"][i, :k] = True
    return batch


def tiny_model(voxel_size: float = VOXEL_SIZE) -> FCAF3DOnly:
    """The JAX tool's tiny ``FCAF3DOnly`` (``tools/overfit_check.py:96-100``),
    on the scenes' 8 feature columns (JAX infers them from the data)."""
    return FCAF3DOnly(
        in_channels=8, n_classes=N_CLASSES, voxel_size=voxel_size,
        pts_threshold=2000, assigner_limit=8, assigner_topk=6, nms_pre=64,
        capacities=DetectionCapacities.tiny(), use_feature_transform=False)


def score(model: FCAF3DOnly, batch: Dict[str, torch.Tensor],
          host_batch: Dict[str, np.ndarray], dev: torch.device,
          show: bool = True) -> Dict[str, float]:
    """The model's test forward on ``batch`` (``host_batch`` on the host)
    through the per-class NMS and the axis-aligned ``indoor_eval``; prints
    the top predictions of scene 0 against its GT and the mAP table if
    ``show``.  Leaves the model in eval mode."""
    model.eval()
    with torch.no_grad():
        out = model(batch)
    results, gts = zip(*[scene_boxes(out, host_batch, i, False, 0.05, 0.5,
                                     dev)
                         for i in range(len(host_batch["points"]))])
    if show:
        order = np.argsort(-results[0]["scores"])[:4]
        for j in order:
            print("  pred", np.round(results[0]["boxes"][j], 2),
                  f"s={results[0]['scores'][j]:.3f} "
                  f"l={results[0]['labels'][j]}")
        for gb, gl in zip(gts[0]["gt_boxes"], gts[0]["labels"]):
            print("  gt  ", np.round(gb, 2), f"l={gl}")
    return indoor_eval(list(gts), list(results), iou_thrs=(0.25, 0.5),
                       label2cat={i: f"c{i}" for i in range(N_CLASSES)},
                       rotated=False, device=dev,
                       logger=print if show else lambda *_: None)


def parse_args(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser(description="Overfit FCAF3DOnly on "
                                             "synthetic box scenes")
    ap.add_argument("--steps", type=int, default=1000,
                    help="optimizer steps, each on every scene")
    ap.add_argument("--scenes", type=int, default=2)
    ap.add_argument("--device", default="cuda:0",
                    help="cuda:0 (default) or cpu")
    ap.add_argument("--score-every", type=int, default=0, metavar="K",
                    help="also score after every K-th step (0: only at "
                         "the end)")
    return ap.parse_args(argv)


def run(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Train and score; returns the loss of every step (``losses``), the
    first and final loss, the mAPs, the seconds a step (scoring left out),
    the peak device memory (GiB, on a GPU), ``ok`` (the PASS rule), each
    ``--score-every`` reading (``scores``: step, loss, mAPs, the rule) and,
    with ``CNRMA_CAPACITY_DEBUG=1``, each capacity site's largest fill and
    its capacity (``fills``)."""
    args = parse_args(argv)
    no_tf32()
    dev = device_of(args.device)
    before = (torch.are_deterministic_algorithms_enabled(),
              torch.is_deterministic_algorithms_warn_only_enabled())
    if dev.type == "cuda":
        # cuBLAS's own condition for deterministic results; read when this
        # process first uses cuBLAS
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True)
    try:
        return _run(args, dev)
    finally:
        torch.use_deterministic_algorithms(before[0], warn_only=before[1])


def _run(args, dev: torch.device) -> Dict[str, Any]:
    capacity.LARGEST.clear()
    rng_np = np.random.RandomState(0)
    host_batch = build_batch([make_scene(rng_np, N_CLASSES)
                              for _ in range(args.scenes)])
    batch = device_batch(host_batch, dev)

    torch.manual_seed(0)
    model = tiny_model().to(dev)
    optimizer = build_optimizer(dict(type="AdamW", lr=LR,
                                     weight_decay=WEIGHT_DECAY), model,
                                lambda step: LR)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    losses: List[float] = []
    scores: List[Dict[str, Any]] = []
    t0, t_score = time.perf_counter(), 0.0
    for i in range(args.steps):
        log_vars = train_step(model, optimizer, batch)
        losses.append(float(log_vars["total_loss"]))
        if i % 10 == 0 or i == args.steps - 1:
            print(f"step {i:3d}  loss {losses[-1]:.4f}  "
                  f"({time.perf_counter() - t0:.0f}s)", flush=True)
        if args.score_every and (i + 1) % args.score_every == 0:
            t1 = time.perf_counter()
            m = score(model, batch, host_batch, dev, show=False)
            ok = losses[-1] < 0.5 * losses[0] and m["mAP_0.25"] >= 0.5
            scores.append({"step": i + 1, "loss": losses[-1],
                           "mAP_0.25": m["mAP_0.25"],
                           "mAP_0.50": m["mAP_0.50"], "ok": ok})
            print(f"score after step {i + 1}: loss {losses[-1]:.4f}  "
                  f"mAP@0.25 {m['mAP_0.25']:.3f}  PASS {ok}", flush=True)
            t_score += time.perf_counter() - t1
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    step_s = (time.perf_counter() - t0 - t_score) / max(1, len(losses))
    first, final = losses[0], losses[-1]

    metrics = score(model, batch, host_batch, dev)
    ok = final < 0.5 * first and metrics["mAP_0.25"] >= 0.5
    peak = (torch.cuda.max_memory_allocated(dev) / 2 ** 30
            if dev.type == "cuda" else None)
    print(f"loss {first:.3f} -> {final:.3f};  "
          f"mAP@0.25 {metrics['mAP_0.25']:.3f}  "
          f"mAP@0.50 {metrics['mAP_0.50']:.3f}", flush=True)
    print(f"{step_s:.4f} s a step"
          + ("" if peak is None else f", peak {peak:.2f} GiB"), flush=True)
    print("overfit check:", "PASS" if ok else "FAIL", flush=True)
    return {"losses": losses, "first": first, "final": final,
            "mAP_0.25": metrics["mAP_0.25"],
            "mAP_0.50": metrics["mAP_0.50"], "steps": len(losses),
            "step_s": step_s, "peak_gib": peak, "ok": ok, "scores": scores,
            "fills": dict(capacity.LARGEST)}


def main(argv: Optional[Sequence[str]] = None) -> int:
    return 0 if run(argv)["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())

"""The training step, the validation scores and the epoch loop (port of
``cnrma_tpu/train/loop.py``: ``total_loss``, ``make_train_step``'s step on
one device, ``evaluate_val``, ``evaluate_val_map`` and ``run_training`` with
its mid-training evaluation and ``best`` checkpoint).  The step runs any of
the three stages' models (``CNRMA``, ``Atlas``, ``FCAF3DOnly``) through its
``forward_train``, on the batch keys it takes; the validation runs their
test forward, which returns the losses where the batch holds ground truth.

A step: the training forward (batch statistics in the norms, which update
their running statistics once), the backward, the optimizer's clip and
update.  Its draws come from a generator seeded by the run's seed and the
step number, so a resumed run draws what an unbroken one would.  The
loop times each step's stages (``timing.stage_marks``: the batch's copy
to the device, the forward's stages, the backward, the optimizer).
"""

from __future__ import annotations

import os
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from cnrma_torch.eval.indoor_eval import indoor_eval
from cnrma_torch.models.layers import BatchNorm
from cnrma_torch.ops.nms import multiclass_nms_np
from cnrma_torch.parallel import dist
from cnrma_torch.timing import mark, stage_marks
from cnrma_torch.train.optim import Optimizer
from cnrma_torch.train.state import TrainState, save_checkpoint

# the views of a scene (CNRMA, Atlas) or its dumped points (FCAF3DOnly),
# and the GT boxes (``cnrma_tpu/train/loop.py:33``)
BATCH_KEYS = ("imgs", "projection", "view_valid", "offset", "gt_boxes",
              "gt_labels", "gt_valid", "points", "point_feats",
              "point_valid")


def device_batch(batch: Dict[str, Any], device) -> Dict[str, Any]:
    """The arrays of a collated batch as tensors on ``device``; the TSDF
    targets, where the batch has them, stay grouped under ``tsdf_list``."""
    out = {k: torch.from_numpy(np.asarray(batch[k])).to(device)
           for k in BATCH_KEYS if k in batch}
    if batch.get("tsdf_list"):
        out["tsdf_list"] = {k: torch.from_numpy(np.asarray(v)).to(device)
                            for k, v in batch["tsdf_list"].items()}
    return out


def total_loss(losses: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Sum of the entries whose key contains 'loss' (reference
    ``parse_losses``)."""
    return sum(v for k, v in losses.items() if "loss" in k)


def step_generator(seed: int, step: int, device, rank: int = 0
                   ) -> torch.Generator:
    """The draws of step ``step`` of a run seeded ``seed``, on data rank
    ``rank`` (the rank, or with view shards its data row, so that the
    ranks of one scene draw alike): rank 0's seed is ``(seed << 32) +
    step``, and another rank folds its number into it (JAX's
    ``fold_in(rng, axis_index('data'))``), so a one-process run draws what
    rank 0 does."""
    base = (int(seed) << 32) + int(step)
    if rank:
        base = int(np.random.SeedSequence([base, int(rank)]).generate_state(
            1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(base)


def running_stats(model: torch.nn.Module) -> List[torch.Tensor]:
    """The running statistics a training step moves: those of every batch
    norm that is not frozen, in module order."""
    return [b for m in model.modules()
            if isinstance(m, BatchNorm) and not m.frozen
            for b in (m.running_mean, m.running_var)]


# the module whose gradient every rank of a view group computes whole;
# the others' are partials (JAX ``reduce_view``)
REPLICATED_PREFIX = "detector."


def mean_over_ranks(model: torch.nn.Module, log_vars: Dict[str, Any],
                    group, view_shards: int = 1) -> None:
    """The data-parallel part of a step, after each rank's backward: one
    fp32 bucket of every parameter's gradient (zeros for ``None``, the
    frozen ones too, whose norm the clip counts as optax's does), every
    moved running statistic and the log vars, all-reduced once and
    divided by the world size.  The means replace the gradients (as DDP
    leaves them), the statistics (averaged as the JAX step's ``pmean``
    does, where DDP would broadcast rank 0's) and the log vars.

    With ``view_shards`` n > 1 ranks a scene (``forward_view_sharded``)
    the gradients of the sharded modules (all but the detector) are
    partials: they enter the bucket times n, so that the world's mean is
    the data rows' mean of their sums over each view group, and the
    detector's (whole on every rank) the data rows' mean of their view
    groups' mean, as JAX's ``reduce_view`` then ``pmean``."""
    named = list(model.named_parameters())
    params = [p for _, p in named]
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in params]
    if view_shards > 1:
        grads = [g if name.startswith(REPLICATED_PREFIX) else g * view_shards
                 for (name, _), g in zip(named, grads)]
    stats = running_stats(model)
    logs = list(log_vars.values())
    parts = grads + stats + logs
    flat = dist.all_mean(dist.flatten_bucket(parts), group)
    means = dist.unflatten_bucket(flat, parts)
    for p, g in zip(params, means):
        p.grad = g
    with torch.no_grad():
        for b, m in zip(stats, means[len(grads):]):
            b.copy_(m)
    for k, v in zip(log_vars, means[len(grads) + len(stats):]):
        log_vars[k] = v


def train_step(model: torch.nn.Module, optimizer: Optimizer,
               batch: Dict[str, Any],
               generator: Optional[torch.Generator] = None,
               group=None, shards: Optional[dist.ViewShards] = None,
               **draws) -> Dict[str, torch.Tensor]:
    """One optimizer step on ``batch`` (tensors on the model's device).
    ``draws`` (``uniform``, ``aug_draws``) replace the generator's, as in
    ``CNRMA.forward_train``.  With a process ``group`` each rank steps on
    its own scene, and ``mean_over_ranks`` averages the gradients, the
    running statistics and the log vars before the clip, so every rank
    takes the same step.  With ``shards`` (a layout of the world ``group``
    with ``shards.n`` ranks a scene) the ranks of a view group step on one
    scene through ``forward_view_sharded`` (JAX's ``make_train_step(
    view_axis='view')``).  Returns the log vars as 0-dim tensors: each
    loss, ``total_loss`` and ``grad_norm`` (the global norm of the
    gradients before the clip)."""
    model.train()
    if shards is not None:
        losses = model.forward_view_sharded(batch, shards,
                                            generator=generator, **draws)
    else:
        if group is not None:
            draws["group"] = group
        losses = model.forward_train(batch, generator=generator, **draws)
    loss = total_loss(losses)
    model.zero_grad(set_to_none=True)
    loss.backward()
    mark("backward")
    log_vars = {k: v.detach() for k, v in losses.items()}
    log_vars["total_loss"] = loss.detach()
    if group is not None:
        mean_over_ranks(model, log_vars, group,
                        shards.n if shards is not None else 1)
        mark("all_reduce")
    grad_norm = optimizer.step({n: p.grad for n, p in
                                model.named_parameters()})
    mark("optimizer")
    log_vars["grad_norm"] = grad_norm
    return log_vars


def scene_boxes(out: Dict[str, Any], batch: Dict[str, Any], i: int,
                with_yaw: bool, score_thr: float, iou_thr: float,
                device) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Scene ``i``'s NMS-kept predictions and its GT, bottom-z, as
    ``indoor_eval`` takes them.  The GT keeps its yaw on a yaw model (the
    JAX function drops it: ROADMAP F15)."""
    bv = out["bbox_valid"][i].cpu().numpy()
    boxes, scores, labels = multiclass_nms_np(
        out["bboxes"][i].float().cpu().numpy()[bv],
        out["scores"][i].float().cpu().numpy()[bv],
        score_thr=score_thr, iou_thr=iou_thr, device=device)
    # model boxes and GT carry gravity-center z; indoor_eval takes bottom z
    b = np.array(boxes, np.float32, copy=True)
    if len(b):
        b[:, 2] -= b[:, 5] / 2
    gv = np.asarray(batch["gt_valid"][i], bool)
    g = np.array(np.asarray(batch["gt_boxes"][i])[gv], np.float32, copy=True)
    if len(g):
        g[:, 2] -= g[:, 5] / 2
    return ({"boxes": b, "scores": scores, "labels": labels},
            {"gt_boxes": g[:, :7 if with_yaw else 6],
             "labels": np.asarray(batch["gt_labels"][i])[gv]})


@torch.no_grad()
def _score_val(model: torch.nn.Module, val_loader, device, losses: bool,
               boxes: bool, score_thr: float = 0.01, iou_thr: float = 0.5,
               uniforms: Optional[Sequence[torch.Tensor]] = None,
               group=None, view_group=None) -> Dict[str, float]:
    """One pass of ``model``'s test forward (eval-mode norms) over
    ``val_loader``: the mean over its batches of each batch's losses
    (``losses``; a batch of several scenes pools them, as the JAX
    package's ``evaluate_val`` does) and the mAP over its scenes
    (``boxes``).  Each scene's subsample draws from a generator seeded by
    its ``index`` (the test CLI's per-scene seed; its position in the
    split where the batch has none), so its points do not depend on its
    batch; ``uniforms[i]`` replaces batch ``i``'s draws where given.  With
    a process ``group`` each rank runs its share of the split (a
    ``SceneLoader`` with its rank), the batches' results gather to rank 0,
    which scores them in scene order as one process would; the other
    ranks return ``{}``.  A ``view_group`` splits each scene's views over
    its ranks (the test forward's view sharding)."""
    device = torch.device(device)
    was_training = model.training
    model.eval()
    scenes: List[Tuple[int, Dict[str, float], List[Tuple]]] = []
    seen = 0
    try:
        for i, batch in enumerate(val_loader):
            on_device = device_batch(batch, device)
            b = next(v for v in on_device.values()
                     if torch.is_tensor(v)).shape[0]
            index = batch.get("index", list(range(seen, seen + b)))
            indices = list(index) if isinstance(index, (list, tuple)) \
                else [index]
            seen += b
            draw = ({"uniform": uniforms[i].to(device)} if uniforms
                    is not None else {"generator": [torch.Generator(
                        device=device).manual_seed(int(j))
                        for j in indices]})
            if view_group is not None:
                draw["view_group"] = view_group
            out = model(on_device, **draw)
            found = {}
            if losses:
                found = {k: float(v) for k, v in out["losses"].items()}
                found["total_loss"] = sum(v for k, v in found.items()
                                          if "loss" in k)
            pairs = [scene_boxes(out, batch, b, model.with_yaw, score_thr,
                                 iou_thr, device)
                     for b in range(out["bboxes"].shape[0])] if boxes else []
            scenes.append((indices[0], found, pairs))
    finally:
        model.train(was_training)
    gathered = dist.gather_to_main(scenes, group)
    if gathered is None:
        return {}
    scenes = sorted((s for part in gathered for s in part),
                    key=lambda s: s[0])
    sums: Dict[str, float] = {}
    for _, found, _ in scenes:
        for k, v in found.items():
            sums[k] = sums.get(k, 0.0) + v
    n = len(scenes) if losses else 0
    preds = [p for _, _, pairs in scenes for p, _ in pairs]
    gts = [g for _, _, pairs in scenes for _, g in pairs]
    scores = {f"val/{k}": v / max(n, 1) for k, v in sums.items()}
    if boxes:
        m = indoor_eval(gts, preds, iou_thrs=(0.25, 0.5),
                        rotated=bool(model.with_yaw), logger=None,
                        device=device)
        scores.update({"val/mAP_0.25": m.get("mAP_0.25", 0.0),
                       "val/mAP_0.50": m.get("mAP_0.50", 0.0),
                       "val/mAR_0.25": m.get("mAR_0.25", 0.0)})
    return scores


def evaluate_val(model: torch.nn.Module, val_loader, device,
                 uniforms: Optional[Sequence[torch.Tensor]] = None
                 ) -> Dict[str, float]:
    """The mean over the batches of ``val_loader`` of each loss of the
    test forward, and ``val/total_loss`` (JAX ``evaluate_val``): the
    reference's mid-training ``evaluation`` scored by loss."""
    return _score_val(model, val_loader, device, losses=True, boxes=False,
                      uniforms=uniforms)


def evaluate_val_map(model: torch.nn.Module, val_loader, device,
                     score_thr: float = 0.01, iou_thr: float = 0.5,
                     uniforms: Optional[Sequence[torch.Tensor]] = None
                     ) -> Dict[str, float]:
    """``val/mAP_0.25``, ``val/mAP_0.50`` and ``val/mAR_0.25`` over
    ``val_loader`` (JAX ``evaluate_val_map``): per scene the test forward,
    the per-class NMS on ``device``, then ``indoor_eval`` (rotated for a
    yaw model); ``{}`` for a model without boxes (``Atlas``)."""
    if not hasattr(model, "detector"):
        return {}
    return _score_val(model, val_loader, device, losses=False, boxes=True,
                      score_thr=score_thr, iou_thr=iou_thr,
                      uniforms=uniforms)


def evaluate_split(model: torch.nn.Module, val_loader, device,
                   metric: str = "loss", group=None,
                   view_group=None) -> Dict[str, float]:
    """``evaluate_val`` and, for ``metric='mAP'``, ``evaluate_val_map`` in
    one pass of the test forward over ``val_loader``; with a process
    ``group``, over each rank's shard, scored on rank 0 (``{}`` on the
    others); with a ``view_group``, each scene's views split over it."""
    return _score_val(model, val_loader, device, losses=True,
                      boxes=metric == "mAP" and hasattr(model, "detector"),
                      group=group, view_group=view_group)


class TextLogger:
    """A line every ``interval`` steps, to stdout and ``train.log``.  A
    logger that is not ``enabled`` (a rank other than 0) writes
    nothing."""

    def __init__(self, work_dir: Optional[str], interval: int = 10,
                 enabled: bool = True):
        self.interval = max(1, interval)
        self.enabled = enabled
        self.path = None
        if work_dir and enabled:
            os.makedirs(work_dir, exist_ok=True)
            self.path = os.path.join(work_dir, "train.log")

    def __call__(self, rec: Dict[str, Any], force: bool = False) -> None:
        if rec["step"] % self.interval and not force:
            return
        parts = [f"epoch {rec['epoch']}", f"iter {rec['step']}",
                 f"lr {rec['lr']:.2e}", f"step {rec['step_s']:.3f}s",
                 f"waited {rec['wait_s']:.3f}s"]
        parts += [f"{k} {v:.4f}" for k, v in rec["log_vars"].items()]
        if rec.get("peak_gib") is not None:
            parts.append(f"peak {rec['peak_gib']:.2f} GiB")
        if rec.get("stages_ms"):
            parts.append("stages ms " + " ".join(
                f"{k} {v:.1f}" for k, v in rec["stages_ms"].items()))
        self._write("  ".join(parts))

    def val(self, epoch: int, step: int, scores: Dict[str, float],
            seconds: float) -> None:
        """The line of one evaluation of the val split, always written."""
        self._write("  ".join([f"epoch {epoch}", f"iter {step}",
                               f"eval {seconds:.3f}s"]
                              + [f"{k} {v:.4f}" for k, v in scores.items()]))

    def _write(self, line: str) -> None:
        if not self.enabled:
            return
        print(line, flush=True)
        if self.path:
            with open(self.path, "a") as f:
                f.write(line + "\n")


def run_training(state: TrainState, loader, *, epochs: int, work_dir: str,
                 device, seed: int = 0, log_interval: int = 10,
                 checkpoint_interval: int = 10,
                 max_steps: Optional[int] = None,
                 evaluate: Optional[Callable[[], Dict[str, float]]] = None,
                 eval_interval: int = 1, eval_metric: str = "loss",
                 group=None, shards: Optional[dist.ViewShards] = None
                 ) -> Tuple[List[Dict[str, Any]], Optional[str]]:
    """Epochs ``state.epoch`` .. ``epochs - 1`` over ``loader``; stops after
    ``max_steps`` optimizer steps in all.  Checkpoints
    ``{work_dir}/epoch_{n}.pt`` after every ``checkpoint_interval``-th
    epoch and the last, and ``{work_dir}/iter_{step}.pt`` where
    ``max_steps`` stops it.  Returns the path of the last checkpoint and
    one record a step: ``step``,
    ``epoch``, ``lr``, ``log_vars`` (floats), ``step_s`` (the step's
    seconds, synchronised), ``wait_s`` and ``load_s`` (the reader's),
    ``stages_ms`` (each stage's milliseconds: CUDA events on a GPU, so
    device time in stream order, the host clock on the CPU) and, on a
    GPU, ``peak_gib`` (the step's peak device memory).

    With ``evaluate`` (the val split's scores of the model as it stands,
    e.g. ``evaluate_split``), after every ``eval_interval``-th epoch (the
    interval counts epochs, as the JAX package's does), the last, and a
    stop by ``max_steps``: the scores are logged, added to that epoch's
    last record as ``val`` with the seconds they took (``eval_s``), and
    ``{work_dir}/best.pt`` keeps the state with the lowest
    ``val/total_loss``, or with ``eval_metric='mAP'`` the highest
    ``val/mAP_0.25`` (its ``meta``: ``epoch``, ``val_total_loss``,
    ``val_mAP_0.25``, ``eval_metric``).

    With a process ``group`` every rank runs the loop on its shard of the
    epoch (``loader`` a ``SceneLoader`` with its rank) through the
    data-parallel ``train_step``, its draws from ``step_generator`` with
    its rank; ``evaluate`` runs on every rank (each scores its shard and
    rank 0 the whole split).  Only rank 0 logs and writes checkpoints,
    between two barriers; every rank returns its records and the path.
    With ``shards`` the ranks of a view group step on one scene
    (``train_step``), their draws from their data row."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    main = dist.is_main(group)
    logger = TextLogger(work_dir, log_interval, enabled=main)
    records: List[Dict[str, Any]] = []
    path = None
    best = float("inf")
    done = max_steps is not None and state.step >= max_steps
    while state.epoch < epochs and not done:
        for batch in loader:
            if cuda:
                torch.cuda.reset_peak_memory_stats(device)
            t0 = time.perf_counter()
            lr = state.optimizer.lr()
            with stage_marks(device) as marks:
                on_device = device_batch(batch, device)
                mark("copy")
                row = (shards.row if shards is not None
                       else dist.rank(group))
                log_vars = train_step(
                    state.model, state.optimizer, on_device,
                    step_generator(seed, state.step, device, row),
                    group=group, shards=shards)
            log_vars = {k: float(v) for k, v in log_vars.items()}
            if cuda:
                torch.cuda.synchronize(device)
            state.step += 1
            rec = {"step": state.step, "epoch": state.epoch, "lr": lr,
                   "log_vars": log_vars,
                   "step_s": time.perf_counter() - t0,
                   "wait_s": batch["wait_s"], "load_s": batch["load_s"],
                   "stages_ms": marks.ms(),
                   "peak_gib": (torch.cuda.max_memory_allocated(device)
                                / 2 ** 30 if cuda else None)}
            records.append(rec)
            done = max_steps is not None and state.step >= max_steps
            logger(rec, force=done)
            if done:
                break
        name = f"iter_{state.step}.pt"
        if not done:
            state.epoch += 1
            name = f"epoch_{state.epoch}.pt"
        epoch = state.epoch + 1 if done else state.epoch
        if evaluate is not None and records and (
                done or epoch % eval_interval == 0 or epoch == epochs):
            best = _evaluate(state, evaluate, logger, records[-1], epoch,
                             eval_metric, best, work_dir, device, group)
        if done or state.epoch % checkpoint_interval == 0 \
                or state.epoch == epochs:
            path = os.path.join(work_dir, name)
            _on_main(group, lambda: save_checkpoint(path, state))
    return records, path


def _on_main(group, write: Callable[[], Any]) -> None:
    """``write()`` on rank 0 alone, between barriers: no rank reads or
    goes past a checkpoint that is half written."""
    dist.barrier(group)
    if dist.is_main(group):
        write()
    dist.barrier(group)


def _evaluate(state: TrainState, evaluate, logger: TextLogger,
              rec: Dict[str, Any], epoch: int, metric: str, best: float,
              work_dir: str, device: torch.device, group=None) -> float:
    """One evaluation of the val split after epoch ``epoch`` (1-based):
    logged, kept in ``rec``, and ``best.pt`` written where it beats
    ``best`` (a loss minimises, an mAP maximises; the scores are rank
    0's, the others' ``{}``).  Returns the best score."""
    t0 = time.perf_counter()
    scores = evaluate()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    rec["eval_s"] = time.perf_counter() - t0
    rec["val"] = scores
    logger.val(epoch, state.step, scores, rec["eval_s"])
    score = (-scores.get("val/mAP_0.25", 0.0) if metric == "mAP"
             else scores.get("val/total_loss", float("inf")))
    better = dist.is_main(group) and score < best
    if group is not None:                 # rank 0's scores decide
        flag = torch.tensor([float(better)], device=device)
        better = bool(dist.all_mean(flag, group).item() > 0)
    if better:
        best = min(best, score)
        _on_main(group, lambda: save_checkpoint(
            os.path.join(work_dir, "best.pt"), state, meta={
                "epoch": epoch,
                "val_total_loss": scores.get("val/total_loss"),
                "val_mAP_0.25": scores.get("val/mAP_0.25"),
                "eval_metric": metric}))
    return best

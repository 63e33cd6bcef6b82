"""How often the test forward of a checkpoint a few AdamW steps from its
initialisation overflows fp32.

    python -m cnrma_torch.tools.overflow_survey [--runs 24] [--steps 3]
        [--seconds S] [--device cuda:0]

The train CLI takes ``--steps`` steps of ``configs/ray_marching_scannet.py``
at its full width on two synthetic ScanNet scenes, from one
default-initialised checkpoint and, at its stop, scores the same two
scenes as its val split at the config's test grid; the test CLI then
runs the first scene from the checkpoint it wrote.  The runs differ only
by the order of the card's atomic sums; their scratch files go under
``build/`` and are removed.  Each run prints one JSON line: the kept
points, the raw boxes, the rows whose face distances overflowed
(``overflowed_rows``), the largest output of the detector's sparse ResNet
at test time, and the val evaluation's total loss, mAP@0.25, the val
scores that are not finite and its head rows past fp32
(``head_overflow``).  A checkpoint this young still holds most of its
batch norms' initial running statistics, so on a dense cloud the
eval-mode ResNet's outputs grow with its depth and the head's ``exp`` can
pass fp32's range, as in the reference head, which has no clamp either.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

CONFIG = "configs/ray_marching_scannet.py"


def overflowed_rows(boxes: np.ndarray) -> Optional[int]:
    """The rows of decoded axis-aligned boxes [N, 6] that are not finite
    because a face distance (``exp`` of the head's regression) overflowed
    fp32, or None if a value is not finite for another reason.  A size is
    the sum of two distances, so it is +inf there and never NaN or -inf;
    a centre coordinate is the half difference of two, so it is not
    finite only where its size is +inf."""
    bad = ~np.isfinite(boxes)
    size = boxes[:, 3:6]
    if np.isnan(size).any() or np.isneginf(size).any():
        return None
    if (bad[:, :3] & ~np.isposinf(size)).any():
        return None
    return int(bad.any(axis=1).sum())


def head_overflow(outs) -> Tuple[int, int]:
    """Of the valid rows of the detector head's per-level outputs
    (``LevelOut``), those whose face distances or whose yaw ratio ``q``
    (``decode_bbox``'s ``exp`` of the (sin, cos) pair's norm) pass fp32's
    range in ``exp``, and those not finite for any other reason."""
    overflowed = unexplained = 0
    for lvl in outs:
        bp = lvl.bbox_pred[lvl.valid].float()
        over = torch.isposinf(bp[:, :6]).any(dim=1)
        if bp.shape[1] == 8:
            over |= torch.isposinf(torch.exp(torch.sqrt(
                bp[:, 6] ** 2 + bp[:, 7] ** 2)))
        bad = ((torch.isnan(bp) | torch.isneginf(bp)).any(dim=1)
               | ~torch.isfinite(lvl.cls_scores[lvl.valid]).all(dim=1)
               | ~torch.isfinite(lvl.centerness[lvl.valid]))
        overflowed += int(over.sum())
        unexplained += int((bad & ~over).sum())
    return overflowed, unexplained


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--runs", type=int, default=24)
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--seconds", type=float, default=None,
                   help="start no run after this many seconds")
    p.add_argument("--device", default="cuda:0")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> list:
    from cnrma_torch.core.builder import build_model
    from cnrma_torch.core.config import Config
    from cnrma_torch.models.fcaf3d import FCAF3DBackboneNet, FCAF3DHeadNet
    from cnrma_torch.synthetic import write_scannet
    from cnrma_torch.tools import test as test_cli
    from cnrma_torch.tools import train as train_cli
    from cnrma_torch.tools._common import no_tf32
    args = parse_args(argv)
    no_tf32()
    start = time.perf_counter()
    os.makedirs("build", exist_ok=True)
    root = tempfile.mkdtemp(prefix="overflow_survey_", dir="build")
    largest = {"value": 0.0}
    head = {"overflowed": 0, "unexplained": 0}

    def backbone_hook(module, inputs, outs):
        if isinstance(module, FCAF3DHeadNet) and not module.training:
            over, bad = head_overflow(outs)
            head["overflowed"] += over
            head["unexplained"] += bad
        if isinstance(module, FCAF3DBackboneNet) and not module.training:
            for st in (st for level in outs for st in level):
                f = st.feats[st.valid]
                if f.numel():
                    largest["value"] = max(largest["value"],
                                           float(f.abs().max()))

    handle = torch.nn.modules.module.register_module_forward_hook(
        backbone_hook)
    records = []
    try:
        data = os.path.join(root, "data")
        ann = write_scannet(data, n_scenes=2, n_frames=40,
                            ann_name="scannet_infos_train.pkl")
        val = os.path.join(data, "scannet_infos_val.pkl")
        shutil.copy(ann, val)
        torch.manual_seed(0)
        init = os.path.join(root, "init.pt")
        torch.save(build_model(Config.fromfile(CONFIG),
                               mode="train").state_dict(), init)
        for run in range(args.runs):
            if (args.seconds is not None
                    and time.perf_counter() - start > args.seconds):
                break
            wd, save, mid = (os.path.join(root, f"{k}{run}")
                             for k in ("wd", "res", "mid"))
            head.update(overflowed=0, unexplained=0)
            steps, ckpt = train_cli.main(
                [CONFIG, "--work-dir", wd, "--load-from", init,
                 "--max-steps", str(args.steps), "--device", args.device,
                 "--cfg-options", f"data.train.data_root={data}",
                 f"data.train.ann_file={ann}", f"data.val.data_root={data}",
                 f"data.val.ann_file={val}"])
            val_scores = [r["val"] for r in steps if "val" in r][-1]
            val_rows = dict(head)
            largest["value"] = 0.0
            rec = test_cli.main(
                [CONFIG, ckpt, "--max-scenes", "1", "--save-path", save,
                 "--middle-save-path", mid, "--device", args.device,
                 "--cfg-options", f"data.test.data_root={data}",
                 f"data.test.ann_file={val}"])[0]
            scene = rec["scene"]
            with np.load(os.path.join(save, scene,
                                      scene + "_bbox_raw.npz")) as z:
                boxes, scores = z["bboxes"], z["scores"]
            points = len(np.load(os.path.join(mid, scene + "_vert.npy")))
            record = {"run": run, "points": points, "raw_boxes": len(boxes),
                      "overflowed_rows": overflowed_rows(boxes),
                      "scores_finite": bool(np.isfinite(scores).all()),
                      "backbone_max": largest["value"],
                      "val_total_loss": val_scores["val/total_loss"],
                      "val_mAP_0.25": val_scores["val/mAP_0.25"],
                      "val_not_finite": sorted(
                          k for k, v in val_scores.items()
                          if not np.isfinite(v)),
                      "val_overflowed_rows": val_rows["overflowed"],
                      "val_unexplained_rows": val_rows["unexplained"]}
            print(json.dumps(record), flush=True)
            records.append(record)
            for d in (wd, save, mid):
                shutil.rmtree(d, ignore_errors=True)
    finally:
        handle.remove()
        shutil.rmtree(root, ignore_errors=True)
    return records


if __name__ == "__main__":
    main()

"""A training step: ``train/loop.py:train_step`` on the configuration's
training model (``CNRMA`` for stage 3, ``FCAF3DOnly`` for stage 2) with
the configuration's AdamW, gradient clip and frozen layers, one scene a
step as ``samples_per_gpu=1``; a marching model's march given the
scene's planted room.

Set-up builds one model and optimizer, drives them through their first
three steps on three different scenes through the window's own call,
and hands the same objects to the window.  Those steps are what
``judge`` holds against the reference, which takes the same weights,
scenes and draws through three steps of its own:

* ``loss1_gap`` and ``loss_gap``: the first step's total loss and the
  worst of the three steps', relative gaps;
* ``grad_gap`` and ``grad_median``: each leaf's gradient as the
  optimizer took it in step 1 (its first moment over 1 - b1), the worst
  leaf's norm gap (over the larger of its reference norm and the median
  leaf's) and the median leaf's (over its own);
* ``change_gap`` and ``change_median``: each leaf's change over the three
  steps, the same two ways.

The workload's ``limits`` name the numbers that are held; the others are
readings.  Leaves whose reference gradient is under a thousandth of the
median leaf's move by round-off alone and are left out
(``compare.moved_leaves``).
"""

from __future__ import annotations

from typing import Dict, List

import torch

from cnrma_torch.timing import mark
from port_bench.lib import compare, harness, weights, work
from port_bench.reference import build as ref_build
from port_bench.reference.train import optim as ref_optim
from port_bench.traffic import rooms

CHECKED_STEPS = 3
FROZEN = ("tower2d.resnet.stem.", "tower2d.resnet.res2_")


class Entry:
    first_index = CHECKED_STEPS

    def __init__(self, cell: harness.Cell):
        from cnrma_torch.core.builder import build_model
        from cnrma_torch.train.loop import train_step
        from cnrma_torch.train.optim import (
            FROZEN_PREFIXES_FREEZE_AT_2, build_lr_schedule, build_optimizer)
        self.cell, self.train_step = cell, train_step
        dev = cell.device
        self.keys = cell.workload["batch_keys"]
        self.marches = cell.config["model"].get("type") == "RayMarching"
        model = build_model(cell.config, mode="train").to(dev)
        weights.load(model, weights.make_state(model, cell.seed, dev))
        self.holder: Dict[str, torch.Tensor] = {}
        self.kept: List[int] = []
        if self.marches:
            harness.plant(model, self.holder)
            orig_march = model._march

            def _march(*a, **k):
                out = orig_march(*a, **k)
                if len(self.kept) < CHECKED_STEPS:
                    self.kept.append(int((out.weight > 0).sum()))
                return out
            model._march = _march
        cfg = cell.config
        schedule = build_lr_schedule(cfg["lr_config"],
                                     cfg["optimizer"]["lr"],
                                     int(cfg["scenes_per_epoch"]))
        self.optimizer = build_optimizer(
            cfg["optimizer"], model, schedule, grad_clip=self._clip(),
            frozen_prefixes=FROZEN_PREFIXES_FREEZE_AT_2)
        self.model = model
        harness.log("model built")
        self.pool = rooms.make_pool(cell.mix, cell.config, "train",
                                    cell.seed, dev, pin=dev.type == "cuda")
        harness.log("pool made")
        opt = self.optimizer
        self.losses: List[float] = []
        for i in range(CHECKED_STEPS):
            self.step(i)
            self.losses.append(float(self._log["total_loss"]))
            if i == 0:
                self.grad1 = harness.leaf_norms(opt.mu, 1.0 / (1 - opt.b1),
                                                opt.trained)
        harness.log("three steps taken")
        p0 = weights.make_state(model, cell.seed, dev)
        params = dict(model.named_parameters())
        self.change = harness.leaf_norms(
            {n: params[n].detach() - p0[n] for n in opt.trained})
        del p0
        if self.marches:
            del model._march
        print(f"[steps 1-3] losses {self.losses}, kept march points "
              f"{self.kept}, GT boxes "
              f"{[self.pool[i]['n_boxes'] for i in range(CHECKED_STEPS)]}",
              flush=True)
        if self.marches and min(self.kept) == 0:
            raise SystemExit("the march kept no point: the traffic would "
                             "bypass the march and the detector")

    def _clip(self):
        return ((self.cell.config.get("optimizer_config") or {}).get(
            "grad_clip") or {}).get("max_norm")

    def _draws(self, b) -> dict:
        draws = {"aug_draws": b["aug_draws"]}
        if self.marches:
            draws["uniform"] = b["uniform"]
            self.holder["planted"] = b["planted"][None]
        return draws

    def step(self, i: int) -> int:
        dev = self.cell.device
        s = i % len(self.pool)
        b = rooms.to_device(self.pool[s], dev)
        mark("copy")
        self._log = self.train_step(self.model, self.optimizer,
                                    harness.batch_of(b, self.keys),
                                    **self._draws(b))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return s

    def free(self) -> None:
        self.model = self.optimizer = self._log = None
        self.holder.clear()

    # -- the reference ----------------------------------------------------
    def reference(self):
        dev = self.cell.device
        ref = ref_build.build_model(self.cell.config, mode="train").to(dev)
        weights.load(ref, weights.make_state(ref, self.cell.seed, dev))
        if self.marches:
            harness.plant(ref, self.holder)
        return ref

    def reference_steps(self) -> Dict[str, object]:
        """The reference's three steps from the same weights, scenes and
        draws: each step's total loss, the leaves' step-1 gradient norms
        and their changes over the three steps."""
        dev, cfg = self.cell.device, self.cell.config
        ref = self.reference()
        schedule = ref_optim.build_lr_schedule(
            cfg["lr_config"], cfg["optimizer"]["lr"],
            int(cfg["scenes_per_epoch"]))
        opt = ref_optim.build_optimizer(cfg["optimizer"], ref, schedule,
                                        grad_clip=self._clip(),
                                        frozen_prefixes=FROZEN)
        losses = []
        for i in range(CHECKED_STEPS):
            b = rooms.to_device(self.pool[i], dev)
            ref.train()
            out = ref.forward_train(harness.batch_of(b, self.keys),
                                    **self._draws(b))
            loss = sum(v for k, v in out.items() if "loss" in k)
            ref.zero_grad(set_to_none=True)
            loss.backward()
            opt.step({n: p.grad for n, p in ref.named_parameters()})
            losses.append(float(loss.detach()))
            if i == 0:
                grad1 = harness.leaf_norms(opt.mu, 1.0 / (1 - opt.b1),
                                           opt.trained)
            del out, loss, b
        p0 = weights.make_state(ref, self.cell.seed, dev)
        params = dict(ref.named_parameters())
        change = harness.leaf_norms(
            {n: params[n].detach() - p0[n] for n in opt.trained})
        return {"losses": losses, "grad1": grad1, "change": change}

    def readings(self) -> Dict[str, object]:
        return {"losses": self.losses, "grad1": self.grad1,
                "change": self.change}

    def judge(self) -> Dict[str, float]:
        return self.numbers(self.readings(), self.reference_steps())

    @staticmethod
    def numbers(p: Dict[str, object], r: Dict[str, object]
                ) -> Dict[str, float]:
        return {k: v for k, v in Entry.details(p, r).items()
                if isinstance(v, float)}

    @staticmethod
    def details(p: Dict[str, object], r: Dict[str, object]
                ) -> Dict[str, object]:
        """Every reading of the three steps: each step's loss gap, the
        worst and the median moved leaf's gradient and change gaps, and
        the worst leaves' names."""
        leaves = compare.moved_leaves(r["grad1"])
        steps = [abs(a - b) / abs(b) for a, b in zip(p["losses"],
                                                      r["losses"])]
        grad_gap, grad_leaf = compare.norm_gap(p["grad1"], r["grad1"],
                                               leaves)
        change_gap, change_leaf = compare.norm_gap(p["change"], r["change"],
                                                   leaves)
        return {"loss1_gap": steps[0], "loss_gap": max(steps),
                "loss_gaps": steps,
                "grad_gap": grad_gap, "grad_leaf": grad_leaf,
                "grad_median": compare.median_gap(p["grad1"], r["grad1"],
                                                  leaves),
                "change_gap": change_gap, "change_leaf": change_leaf,
                "change_median": compare.median_gap(p["change"],
                                                    r["change"], leaves),
                "leaves": len(leaves), "of": len(r["grad1"])}

    # -- the work of the traced window --------------------------------------
    @torch.no_grad()
    def work(self, scenes: List[int]) -> Dict[str, float]:
        """Model FLOPs of a step (forward, input and weight gradients) and
        K1b's least time, summed over the steps the traced window ran."""
        from port_bench.lib.device import bound_s
        dev, m = self.cell.device, self.cell.config["model"]
        ref = self.reference()
        per: Dict[int, Dict[str, float]] = {}
        for s in sorted(set(scenes)):
            b = rooms.to_device(self.pool[s], dev)
            counter = work.FlopCounter(backward=True, frozen=FROZEN)
            with counter.counting(ref):
                ref.forward_train(harness.batch_of(b, self.keys),
                                  **self._draws(b))
            per[s] = {"flops": counter.total}
            if self.marches:
                proj = ref._scaled_projections(b["projection"])[0]
                stride = int(m["backbone2d_stride"])
                h, w = (n // stride for n in self.cell.config["image_hw"])
                vv = torch.ones(proj.shape[0], dtype=torch.bool, device=dev)
                per[s]["volume_accum_bwd_kernel"] = bound_s(
                    *work.volume_bwd_work(proj, vv,
                                          tuple(m["voxel_dim_train"]),
                                          float(m["voxel_size"]), (0, 0, 0),
                                          h, w))
        keys = per[scenes[0]].keys() if scenes else ()
        return {k: sum(per[s][k] for s in scenes) for k in keys}

"""Optimizer and learning-rate schedule from reference-style config dicts.

Port of ``cnrma_tpu/train/optim.py``: the optax chain
``clip_by_global_norm -> multi_transform({train: adamw | adam, frozen:
set_to_zero})`` written out in torch, with optax's arithmetic:

* the clip scales every gradient by ``max_norm / ||g||`` (as
  ``(g / ||g||) * max_norm``) when the global norm over **all** gradients,
  the frozen ones included, is not below ``max_norm``;
* the frozen parameters (``freeze_at=2``: the 2D stem and res2) then get a
  zero update, so no step and no weight decay;
* AdamW: ``mu = 0.1 g + 0.9 mu``, ``nu = 0.001 g^2 + 0.999 nu``, bias
  corrected by ``1 - b^t``, ``u = mu_hat / (sqrt(nu_hat) + 1e-8)``,
  plus the decoupled ``weight_decay * p``, times ``-lr(t - 1)``; Adam
  (``optax.adam``, the stage-1 Atlas config) is the same without the
  decay, whatever ``weight_decay`` the config gives;
* the step schedule multiplies the base rate by ``gamma`` at every
  boundary ``epoch * steps_per_epoch`` the step count has reached.

``torch.optim.AdamW`` and ``clip_grad_norm_`` compute other functions
(``max_norm / (||g|| + 1e-6)``, the decay folded before the moments'
division), so they are not used.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, Mapping, Optional, Sequence

import torch
from torch import nn

# the JAX package's FROZEN_PREFIXES_FREEZE_AT_2 in the port's module names
FROZEN_PREFIXES_FREEZE_AT_2 = ("tower2d.resnet.stem.", "tower2d.resnet.res2_")


def build_lr_schedule(lr_config: Mapping[str, Any], base_lr: float,
                      steps_per_epoch: int) -> Callable[[int], float]:
    """mmcv-style ``lr_config`` (``policy='step'``) -> the rate at a step
    count (epoch boundaries)."""
    policy = lr_config.get("policy", "step")
    if policy != "step":
        raise ValueError(f"unsupported lr policy {policy!r}")
    gamma = lr_config.get("gamma", 0.1)
    bounds = sorted(int(e) * steps_per_epoch
                    for e in lr_config.get("step", []))

    def schedule(count: int) -> float:
        lr = base_lr
        for b in bounds:
            if count >= b:
                lr = lr * gamma
        return lr
    return schedule


def frozen_names(model: nn.Module, prefixes: Sequence[str]) -> frozenset:
    """The names of ``model``'s parameters under one of ``prefixes``."""
    return frozenset(n for n, _ in model.named_parameters()
                     if any(n.startswith(p) for p in prefixes))


class Optimizer:
    """The optax chain of ``build_optimizer`` (AdamW, or Adam with
    ``weight_decay=0``) over named parameters.

    ``step(grads)`` takes one gradient a parameter (a missing one counts as
    zero), clips, updates the parameters in place and returns the global
    norm of the gradients before the clip, as a 0-dim tensor."""

    def __init__(self, params: Mapping[str, nn.Parameter],
                 schedule: Callable[[int], float], weight_decay: float = 0.0,
                 max_norm: Optional[float] = None, frozen: Iterable[str] = (),
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.params = dict(params)
        self.schedule = schedule
        self.weight_decay = weight_decay
        self.max_norm = max_norm
        self.frozen = frozenset(frozen)
        unknown = self.frozen - set(self.params)
        if unknown:
            raise KeyError(f"frozen names that are no parameter: "
                           f"{sorted(unknown)}")
        self.b1, self.b2, self.eps = b1, b2, eps
        self.count = 0
        self.trained = [n for n in self.params if n not in self.frozen]
        self.mu = {n: torch.zeros_like(self.params[n]) for n in self.trained}
        self.nu = {n: torch.zeros_like(self.params[n]) for n in self.trained}

    def lr(self) -> float:
        """The rate of the next step."""
        return self.schedule(self.count)

    @torch.no_grad()
    def step(self, grads: Mapping[str, Optional[torch.Tensor]]
             ) -> torch.Tensor:
        g = {n: (grads.get(n) if grads.get(n) is not None
                 else torch.zeros_like(p)) for n, p in self.params.items()}
        norm = torch.sqrt(sum(t.float().square().sum() for t in g.values()))
        if self.max_norm is not None:
            keep = norm < self.max_norm
            g = {n: torch.where(keep, t, (t / norm) * self.max_norm)
                 for n, t in g.items()}
        lr = self.schedule(self.count)
        self.count += 1
        dev = norm.device
        bc1 = 1 - torch.tensor(self.b1, device=dev) ** self.count
        bc2 = 1 - torch.tensor(self.b2, device=dev) ** self.count
        for n in self.trained:
            p = self.params[n]
            self.mu[n] = (1 - self.b1) * g[n] + self.b1 * self.mu[n]
            self.nu[n] = (1 - self.b2) * g[n] ** 2 + self.b2 * self.nu[n]
            u = (self.mu[n] / bc1) / (torch.sqrt(self.nu[n] / bc2)
                                      + self.eps)
            p.add_((u + self.weight_decay * p) * -lr)
        return norm

    def state_dict(self) -> Dict[str, Any]:
        return {"count": self.count, "mu": dict(self.mu),
                "nu": dict(self.nu)}

    def load_state_dict(self, state: Mapping[str, Any]) -> None:
        for name in ("mu", "nu"):
            mine, theirs = getattr(self, name), state[name]
            if set(mine) != set(theirs):
                raise KeyError(f"optimizer {name}: the checkpoint's "
                               f"parameters differ from the model's")
            for n in mine:
                mine[n] = theirs[n].to(mine[n].device, mine[n].dtype)
        self.count = int(state["count"])


def build_optimizer(optimizer_cfg: Mapping[str, Any], model: nn.Module,
                    schedule: Callable[[int], float],
                    grad_clip: Optional[float] = None,
                    frozen_prefixes: Sequence[str] = ()) -> Optimizer:
    """Reference config dict (``optimizer = dict(type='AdamW', lr=...,
    weight_decay=...)`` or ``dict(type='Adam', lr=...)``) -> the optimizer
    over ``model``'s parameters."""
    kind = optimizer_cfg.get("type", "AdamW")
    if kind not in ("AdamW", "Adam"):
        raise ValueError(f"unsupported optimizer {kind!r}")
    return Optimizer(dict(model.named_parameters()), schedule,
                     weight_decay=(optimizer_cfg.get("weight_decay", 0.0)
                                   if kind == "AdamW" else 0.0),
                     max_norm=grad_clip,
                     frozen=frozen_names(model, frozen_prefixes))

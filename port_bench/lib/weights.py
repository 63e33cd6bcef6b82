"""The model's weights, made from the seed on the device in one draw.

One ``torch.randn`` over every floating parameter and buffer, cut into
the leaves in ``state_dict`` order and shaped per leaf: weights with two
or more axes LeCun-normal over their fan-in (a dense ``Conv`` keeps its
output axis first, the sparse kernels ``[K, Cin, Cout]`` last), norm
scales 1 + 0.1 z, biases and shifts 0.02 z, running means 0.1 z and
running variances 1 + 0.1 |z|, the class bias at its prior of 0.01, the
head's per-level scales 1 + 0.02 z.  The same seed gives the same tensors
to the program and to the reference, which load them by name.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
from torch import nn


def _out_first(model: nn.Module) -> set:
    """Names of the parameters laid out [Cout, Cin, k...]: those of the
    dense ``Conv`` modules."""
    return {f"{mod_name}.{p}" if mod_name else p
            for mod_name, mod in model.named_modules()
            if type(mod).__name__ == "Conv"
            for p, _ in mod.named_parameters(recurse=False)}


def make_state(model: nn.Module, seed: int, device: torch.device
               ) -> Dict[str, torch.Tensor]:
    """``model``'s floating state from ``seed``, fp32 on ``device``."""
    state = {k: v for k, v in model.state_dict().items()
             if v.is_floating_point()}
    total = sum(v.numel() for v in state.values())
    g = torch.Generator(device=device).manual_seed(int(seed) + 1)
    z = torch.randn(total, generator=g, device=device)
    out_first = _out_first(model)
    out, at = {}, 0
    for name, v in state.items():
        t = z[at:at + v.numel()].view(v.shape)
        at += v.numel()
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "running_var":
            t = 1.0 + 0.1 * t.abs()
        elif leaf == "running_mean":
            t = 0.1 * t
        elif leaf == "cls_bias":
            t = -math.log((1 - 0.01) / 0.01) + 0.02 * t
        elif v.dim() == 0:
            t = 1.0 + 0.02 * t
        elif v.dim() == 1:
            t = 1.0 + 0.1 * t if leaf == "weight" else 0.02 * t
        else:
            fan_in = v.numel() // (v.shape[0] if name in out_first
                                   else v.shape[-1])
            t = t * (1.0 / math.sqrt(fan_in))
        out[name] = t
    return out


@torch.no_grad()
def load(model: nn.Module, state: Dict[str, torch.Tensor]) -> None:
    """Copy ``state`` into ``model``'s tensors of the same names; every
    floating tensor of the model has to be there."""
    own = {k: v for k, v in model.state_dict().items()
           if v.is_floating_point()}
    if set(own) != set(state):
        missing = sorted(set(own) ^ set(state))[:5]
        raise KeyError(f"weights and model differ in names: {missing}")
    for k, v in own.items():
        v.copy_(state[k])

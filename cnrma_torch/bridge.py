"""Parameter bridge: a flax variable tree of the JAX package to a
``state_dict`` of the port.

The port's modules carry the flax module names, so a flax path
``(collection, *modules, leaf)`` becomes the torch key
``".".join(modules) + "." + name``, with

* ``params/.../kernel`` of rank 4 or 5 (dense conv, [k..., Cin, Cout]) ->
  ``weight`` as [Cout, Cin, k...] (the inverse of
  ``tools/convert_checkpoint.py:t2f_conv2d/t2f_conv3d``);
* ``params/.../kernel`` of rank 3 (sparse conv, [K, Cin, Cout]) -> ``kernel``
  unchanged;
* ``params/.../scale`` and ``bias`` of a norm -> ``weight``, ``bias``;
* ``batch_stats/.../mean``, ``var`` -> ``running_mean``, ``running_var``;
* every other leaf (``up_kernel``, ``cls_bias``, ``scale_0``, ...) keeps its
  name.

``from_flax`` raises on a leaf that no port parameter takes and, given the
target module, on a port parameter or buffer that no leaf fills.
``read_flax_npz`` reads a variable tree saved as an ``.npz`` of its
flattened leaves (keys ``params/tower2d/.../kernel``,
``batch_stats/.../mean``), the checkpoint format the test CLI takes from
the JAX package.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

_STATS = {"mean": "running_mean", "var": "running_var"}


def _leaves(tree: Mapping[str, Any], path=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, path + (str(k),))
        else:
            yield path + (str(k),), v


def _convert(collection: str, path, value: np.ndarray):
    *mods, leaf = path
    if collection == "batch_stats":
        if leaf not in _STATS:
            raise KeyError(f"unknown batch_stats leaf {'/'.join(path)}")
        name, arr = _STATS[leaf], value
    elif leaf == "kernel" and value.ndim in (4, 5):
        name = "weight"
        arr = np.transpose(value, (value.ndim - 1, value.ndim - 2)
                           + tuple(range(value.ndim - 2)))
    elif leaf == "scale":
        name, arr = "weight", value
    else:
        name, arr = leaf, value
    return ".".join(mods + [name]), arr


def read_flax_npz(path: str) -> Dict[str, Any]:
    """An ``.npz`` of flattened flax leaves (``/``-joined paths) -> the
    nested variable tree."""
    tree: Dict[str, Any] = {}
    with np.load(path) as data:
        for key in data.files:
            *mods, leaf = key.split("/")
            node = tree
            for m in mods:
                node = node.setdefault(m, {})
            node[leaf] = data[key]
    return tree


def from_flax(variables: Mapping[str, Any],
              module: Optional[nn.Module] = None) -> Dict[str, torch.Tensor]:
    """{"params": ..., "batch_stats": ...} (numpy or jax arrays) -> torch
    state dict.  With ``module``, checks that the keys are exactly the
    module's and the shapes match, and raises otherwise."""
    state: Dict[str, torch.Tensor] = {}
    for collection, tree in variables.items():
        if collection not in ("params", "batch_stats"):
            raise KeyError(f"unknown flax collection {collection!r}")
        for path, value in _leaves(tree):
            key, arr = _convert(collection, path, np.asarray(value))
            if key in state:
                raise KeyError(f"two flax leaves map to {key}")
            state[key] = torch.from_numpy(np.array(arr, np.float32,
                                                   order="C"))
    if module is not None:
        want = module.state_dict()
        unused = sorted(set(state) - set(want))
        unset = sorted(set(want) - set(state))
        if unused or unset:
            raise KeyError(f"flax leaves the port does not take: {unused}; "
                           f"port parameters no leaf fills: {unset}")
        for k, t in want.items():
            if tuple(t.shape) != tuple(state[k].shape):
                raise ValueError(f"{k}: flax shape {tuple(state[k].shape)} "
                                 f"!= port shape {tuple(t.shape)}")
    return state

"""Python-file config system (a copy of ``cnrma_tpu/core/config.py``).

Mirrors the config surface of the reference (mmcv ``Config.fromfile`` executing
python files of plain dicts / scalars; see reference ``train.py:108-110`` and
``projects/configs/mvsdetection/ray_marching_scannet.py``) without the mmcv
dependency.  Configs are plain ``.py`` files; every module-level name that does
not start with an underscore becomes a config key.  ``--cfg-options a.b.c=v``
deep-merge is supported (reference ``train.py:70-79``).
"""

from __future__ import annotations

import ast
import copy
import importlib.util
import os
import sys
import types
from typing import Any, Dict, Iterable, Mapping, Optional


class ConfigDict(dict):
    """dict with attribute access (cfg.model.type)."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __deepcopy__(self, memo):
        return ConfigDict({k: copy.deepcopy(v, memo) for k, v in self.items()})


def _wrap(value: Any) -> Any:
    if isinstance(value, dict) and not isinstance(value, ConfigDict):
        return ConfigDict({k: _wrap(v) for k, v in value.items()})
    if isinstance(value, ConfigDict):
        return ConfigDict({k: _wrap(v) for k, v in value.items()})
    if isinstance(value, (list, tuple)):
        return type(value)(_wrap(v) for v in value)
    return value


def _parse_value(text: str) -> Any:
    try:
        return ast.literal_eval(text)
    except (ValueError, SyntaxError):
        return text


class Config:
    """Config loaded from a python file.

    Usage::

        cfg = Config.fromfile('configs/ray_marching_scannet.py')
        cfg.model.type        # 'RayMarching'
        cfg.merge_from_options({'model.voxel_size': 0.02})
    """

    def __init__(self, cfg_dict: Optional[Mapping[str, Any]] = None,
                 filename: Optional[str] = None):
        self._cfg = ConfigDict()
        if cfg_dict:
            for k, v in cfg_dict.items():
                self._cfg[k] = _wrap(v)
        self.filename = filename

    # -- loading ----------------------------------------------------------
    @classmethod
    def fromfile(cls, filename: str) -> "Config":
        filename = os.path.abspath(os.path.expanduser(filename))
        if not os.path.isfile(filename):
            raise FileNotFoundError(filename)
        spec = importlib.util.spec_from_file_location("_cnrma_cfg", filename)
        module = importlib.util.module_from_spec(spec)
        # allow configs to import each other via _base_-style python imports
        sys.modules["_cnrma_cfg"] = module
        try:
            spec.loader.exec_module(module)
        finally:
            sys.modules.pop("_cnrma_cfg", None)
        cfg_dict = {
            k: v for k, v in vars(module).items()
            if not k.startswith("_") and not isinstance(v, types.ModuleType)
            and not callable(v)
        }
        return cls(cfg_dict, filename=filename)

    # -- access -----------------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        if name.startswith("_"):
            raise AttributeError(name)
        try:
            return self._cfg[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __getitem__(self, name: str) -> Any:
        return self._cfg[name]

    def __setitem__(self, name: str, value: Any) -> None:
        self._cfg[name] = _wrap(value)

    def __contains__(self, name: str) -> bool:
        return name in self._cfg

    def get(self, name: str, default: Any = None) -> Any:
        return self._cfg.get(name, default)

    def keys(self) -> Iterable[str]:
        return self._cfg.keys()

    def to_dict(self) -> Dict[str, Any]:
        return copy.deepcopy(dict(self._cfg))

    # -- merging ----------------------------------------------------------
    def merge_from_options(self, options: Mapping[str, Any]) -> None:
        """Deep-merge dotted-key overrides, e.g. {'model.voxel_size': 0.02}.

        String values are literal-eval'ed when possible (like mmcv
        DictAction, reference ``train.py:70-79``).
        """
        for dotted, value in options.items():
            if isinstance(value, str):
                value = _parse_value(value)
            keys = dotted.split(".")
            node: Any = self._cfg
            for k in keys[:-1]:
                if isinstance(node, (list, tuple)):
                    node = node[int(k)]
                else:
                    if k not in node or not isinstance(node[k], (dict, list, tuple)):
                        node[k] = ConfigDict()
                    node = node[k]
            last = keys[-1]
            if isinstance(node, (list, tuple)):
                node[int(last)] = _wrap(value)
            else:
                node[last] = _wrap(value)

    def dump(self) -> str:
        import pprint
        return pprint.pformat(dict(self._cfg), width=100, sort_dicts=False)

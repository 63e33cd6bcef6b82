"""Minimal name -> constructor registry (a copy of
``cnrma_tpu/core/registry.py``).

The reference builds every model component from config ``type`` strings via
the mmdet registries (``ray_marching.py:13-14``).  We keep the same
config-driven construction surface with a tiny explicit registry — no plugin
import machinery, no scope resolution.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional


class Registry:
    def __init__(self, name: str):
        self.name = name
        self._registry: Dict[str, Callable[..., Any]] = {}

    def register(self, name: Optional[str] = None) -> Callable:
        def deco(obj: Callable) -> Callable:
            key = name or obj.__name__
            if key in self._registry:
                raise KeyError(f"{key} already registered in {self.name}")
            self._registry[key] = obj
            return obj
        return deco

    def get(self, name: str) -> Callable[..., Any]:
        if name not in self._registry:
            raise KeyError(
                f"{name!r} is not registered in {self.name}; "
                f"known: {sorted(self._registry)}")
        return self._registry[name]

    def __contains__(self, name: str) -> bool:
        return name in self._registry


DATASETS = Registry("datasets")


def build_from_cfg(cfg: Mapping[str, Any], registry: Registry, **extra: Any):
    """Build ``registry[cfg['type']](**cfg-without-type, **extra)``."""
    if "type" not in cfg:
        raise KeyError(f"cfg needs a 'type' key, got {sorted(cfg)}")
    kwargs = {k: v for k, v in cfg.items() if k != "type"}
    kwargs.update(extra)
    return registry.get(cfg["type"])(**kwargs)

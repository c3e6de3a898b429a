"""Built-in scene registry — the framework's "model zoo" (the port's copy
of rust_raytracer_tpu/models/__init__.py).

Mirrors the reference's scene dispatch (main.rs:30-59): names map to
builders returning (SceneDef, camera-config dict).  DSL files and `model:`
paths are handled by utils/cli.py.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

from ..scene import graph

_REGISTRY: Dict[str, Callable] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def get(name: str):
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown scene '{name}'; available: {sorted(_REGISTRY)}"
        )
    return _REGISTRY[name]


def names():
    return sorted(_REGISTRY)


def build(name: str, **kwargs) -> graph.SceneDef:
    return get(name)(**kwargs)


# import for registration side effects
from . import builtin  # noqa: E402,F401

"""The port's own copy of ``lsnet_tpu/utils/registry.py`` (numpy, host side).

String-keyed component registries.

The reference framework assembles models from config dicts via registries
(`mmcv/mmcv/utils/registry.py`).  We keep the same public
ergonomics — ``@REGISTRY.register_module()`` + ``build_from_cfg(cfg, REGISTRY)``
— because the config-tree + registry pattern *is* the user-facing API of this
kind of framework.  The implementation is a clean-room ~80-line version.
"""

from __future__ import annotations

import inspect
from typing import Any, Callable, Dict, Optional


class Registry:
    """A name -> class/function registry."""

    def __init__(self, name: str):
        self._name = name
        self._module_dict: Dict[str, Any] = {}

    @property
    def name(self) -> str:
        return self._name

    @property
    def module_dict(self) -> Dict[str, Any]:
        return self._module_dict

    def __len__(self) -> int:
        return len(self._module_dict)

    def __contains__(self, key: str) -> bool:
        return key in self._module_dict

    def __repr__(self) -> str:
        return f"Registry(name={self._name}, items={list(self._module_dict)})"

    def get(self, key: str) -> Optional[Any]:
        return self._module_dict.get(key)

    def _register(self, module: Any, name: Optional[str] = None,
                  force: bool = False) -> None:
        if not (inspect.isclass(module) or inspect.isfunction(module)):
            raise TypeError(f"module must be a class or function, got {type(module)}")
        key = name if name is not None else module.__name__
        if not force and key in self._module_dict:
            raise KeyError(f"{key} is already registered in {self._name}")
        self._module_dict[key] = module

    def register_module(self, name: Optional[str] = None, force: bool = False,
                        module: Optional[Any] = None) -> Callable:
        """Register a module class, usable as decorator or plain call."""
        if module is not None:
            self._register(module, name=name, force=force)
            return module

        def _decorator(cls):
            self._register(cls, name=name, force=force)
            return cls

        return _decorator


def build_from_cfg(cfg: Dict[str, Any], registry: Registry,
                   default_args: Optional[Dict[str, Any]] = None) -> Any:
    """Instantiate a registered component from a ``dict(type=..., **kwargs)``."""
    if not isinstance(cfg, dict) or "type" not in cfg:
        raise TypeError(f"cfg must be a dict with a 'type' key, got {cfg!r}")
    args = dict(cfg)
    obj_type = args.pop("type")
    if isinstance(obj_type, str):
        obj_cls = registry.get(obj_type)
        if obj_cls is None:
            raise KeyError(f"{obj_type} is not in the {registry.name} registry")
    elif inspect.isclass(obj_type) or inspect.isfunction(obj_type):
        obj_cls = obj_type
    else:
        raise TypeError(f"type must be a str or class, got {type(obj_type)}")
    if default_args is not None:
        for k, v in default_args.items():
            args.setdefault(k, v)
    return obj_cls(**args)

"""The port's own copy of ``lsnet_tpu/utils/config.py`` (numpy, host side).

Config system with ``_base_`` inheritance.

Mirrors the user-facing semantics of the reference config system
(`mmcv/mmcv/utils/config.py:16-175`): python config
files, multi-file ``_base_`` inheritance with recursive dict merge,
``_delete_=True`` override markers, attribute-style access, and
``merge_from_dict`` for CLI ``k.x=v`` overrides.  Clean-room implementation.
"""

from __future__ import annotations

import copy
import importlib.util
import os
import sys
import types
from typing import Any, Dict, List, Optional, Union

DELETE_KEY = "_delete_"
BASE_KEY = "_base_"
RESERVED_KEYS = ("filename",)


class ConfigDict(dict):
    """dict subclass with attribute access (raises AttributeError on miss)."""

    def __getattr__(self, name: str) -> Any:
        try:
            value = self[name]
        except KeyError:
            raise AttributeError(
                f"'ConfigDict' object has no attribute '{name}'") from None
        return value

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = _to_config_dict(value)

    def __delattr__(self, name: str) -> None:
        try:
            del self[name]
        except KeyError:
            raise AttributeError(name) from None

    def __deepcopy__(self, memo):
        return ConfigDict(
            {copy.deepcopy(k, memo): copy.deepcopy(v, memo) for k, v in self.items()})

    def get(self, key: str, default: Any = None) -> Any:
        return super().get(key, default)

    def to_dict(self) -> dict:
        def plain(v):
            if isinstance(v, dict):
                return {k: plain(x) for k, x in v.items()}
            if isinstance(v, (list, tuple)):
                return type(v)(plain(x) for x in v)
            return v
        return plain(dict(self))


def _to_config_dict(obj: Any) -> Any:
    if isinstance(obj, dict) and not isinstance(obj, ConfigDict):
        return ConfigDict({k: _to_config_dict(v) for k, v in obj.items()})
    if isinstance(obj, ConfigDict):
        for k in list(obj.keys()):
            obj[k] = _to_config_dict(obj[k])
        return obj
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_config_dict(v) for v in obj)
    return obj


def _load_py_file(filename: str) -> Dict[str, Any]:
    filename = os.path.abspath(os.path.expanduser(filename))
    if not os.path.isfile(filename):
        raise FileNotFoundError(filename)
    mod_name = "_lsnet_cfg_" + os.path.splitext(os.path.basename(filename))[0]
    spec = importlib.util.spec_from_file_location(mod_name, filename)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    try:
        spec.loader.exec_module(mod)
        cfg = {
            k: v for k, v in vars(mod).items()
            if not k.startswith("__") and not isinstance(v, types.ModuleType)
            and not isinstance(v, types.FunctionType)
        }
    finally:
        sys.modules.pop(mod_name, None)
    return cfg


def merge_dict(base: Dict[str, Any], override: Dict[str, Any]) -> Dict[str, Any]:
    """Recursively merge ``override`` into ``base`` (reference semantics:

    dict values merge recursively unless override carries ``_delete_=True``,
    in which case the base value is discarded wholesale).
    """
    merged = copy.deepcopy(base)
    for key, value in override.items():
        if (isinstance(value, dict) and key in merged
                and isinstance(merged[key], dict)
                and not value.pop(DELETE_KEY, False)):
            merged[key] = merge_dict(merged[key], value)
        else:
            if isinstance(value, dict):
                value = {k: v for k, v in value.items() if k != DELETE_KEY}
            merged[key] = copy.deepcopy(value)
    return merged


class Config:
    """Top-level config object: ``Config.fromfile('cfg.py')``."""

    def __init__(self, cfg_dict: Optional[Dict[str, Any]] = None,
                 filename: Optional[str] = None):
        cfg_dict = {} if cfg_dict is None else cfg_dict
        if not isinstance(cfg_dict, dict):
            raise TypeError(f"cfg_dict must be a dict, got {type(cfg_dict)}")
        for key in RESERVED_KEYS:
            if key in cfg_dict:
                raise KeyError(f"{key} is reserved for Config")
        object.__setattr__(self, "_cfg_dict", _to_config_dict(ConfigDict(cfg_dict)))
        object.__setattr__(self, "_filename", filename)

    # -- construction ------------------------------------------------------
    @staticmethod
    def fromfile(filename: str) -> "Config":
        cfg_dict = Config._file_to_dict(filename)
        return Config(cfg_dict, filename=filename)

    @staticmethod
    def _file_to_dict(filename: str) -> Dict[str, Any]:
        filename = os.path.abspath(os.path.expanduser(filename))
        cfg_dict = _load_py_file(filename)
        base_files: Union[str, List[str]] = cfg_dict.pop(BASE_KEY, [])
        if isinstance(base_files, str):
            base_files = [base_files]
        base_dict: Dict[str, Any] = {}
        cfg_dir = os.path.dirname(filename)
        for base in base_files:
            base_cfg = Config._file_to_dict(os.path.join(cfg_dir, base))
            dup = set(base_dict) & set(base_cfg)
            for k in dup:
                if isinstance(base_dict.get(k), dict) and isinstance(base_cfg.get(k), dict):
                    base_cfg[k] = merge_dict(base_dict[k], base_cfg[k])
            base_dict.update(base_cfg)
        return merge_dict(base_dict, cfg_dict)

    # -- mapping interface -------------------------------------------------
    @property
    def filename(self) -> Optional[str]:
        return self._filename

    def __getattr__(self, name: str) -> Any:
        return getattr(self._cfg_dict, name)

    def __setattr__(self, name: str, value: Any) -> None:
        self._cfg_dict[name] = _to_config_dict(value)

    def __getitem__(self, name: str) -> Any:
        return self._cfg_dict[name]

    def __setitem__(self, name: str, value: Any) -> None:
        self._cfg_dict[name] = _to_config_dict(value)

    def __contains__(self, name: str) -> bool:
        return name in self._cfg_dict

    def __iter__(self):
        return iter(self._cfg_dict)

    def __len__(self) -> int:
        return len(self._cfg_dict)

    def __repr__(self) -> str:
        return f"Config (path: {self._filename}): {self._cfg_dict!r}"

    def get(self, key: str, default: Any = None) -> Any:
        return self._cfg_dict.get(key, default)

    def keys(self):
        return self._cfg_dict.keys()

    def items(self):
        return self._cfg_dict.items()

    def to_dict(self) -> Dict[str, Any]:
        return copy.deepcopy(dict(self._cfg_dict))

    def copy(self) -> "Config":
        return Config(copy.deepcopy(dict(self._cfg_dict)), filename=self._filename)

    # -- rendering ---------------------------------------------------------
    @property
    def pretty_text(self) -> str:
        """Config rendered as runnable Python assignments (reference
        ``mmcv.Config.pretty_text``, used by ``tools/print_config.py``)."""
        def fmt(v, indent):
            pad = " " * indent
            if isinstance(v, dict):
                if not v:
                    return "dict()"
                items = ",\n".join(
                    f"{pad}    {k}={fmt(val, indent + 4)}"
                    for k, val in v.items())
                return f"dict(\n{items})"
            if isinstance(v, (list, tuple)):
                inner = ", ".join(fmt(x, indent) for x in v)
                return f"[{inner}]" if isinstance(v, list) else f"({inner})"
            return repr(v)

        return "\n".join(f"{k} = {fmt(v, 0)}"
                         for k, v in self._cfg_dict.items())

    # -- CLI overrides -----------------------------------------------------
    def merge_from_dict(self, options: Dict[str, Any]) -> None:
        """Deep-merge dotted-key CLI options, e.g. ``{'model.head.nv': 36}``."""
        option_cfg: Dict[str, Any] = {}
        for full_key, v in options.items():
            d = option_cfg
            keys = full_key.split(".")
            for subkey in keys[:-1]:
                d = d.setdefault(subkey, {})
            d[keys[-1]] = v
        merged = merge_dict(dict(self._cfg_dict), option_cfg)
        object.__setattr__(self, "_cfg_dict", _to_config_dict(ConfigDict(merged)))


class DictAction(__import__("argparse").Action):
    """argparse action for ``--cfg-options k=v k2.sub=v2`` style overrides
    (reference ``mmcv.DictAction``): values are parsed as Python literals
    when possible, with ``a,b,c`` becoming a tuple."""

    @staticmethod
    def _parse(val: str) -> Any:
        import ast
        if "," in val:
            return tuple(DictAction._parse(v) for v in val.split(","))
        try:
            return ast.literal_eval(val)
        except (ValueError, SyntaxError):
            return {"true": True, "false": False,
                    "none": None}.get(val.lower(), val)

    def __call__(self, parser, namespace, values, option_string=None):
        options = getattr(namespace, self.dest, None) or {}
        for kv in values:
            key, _, val = kv.partition("=")
            options[key] = self._parse(val)
        setattr(namespace, self.dest, options)

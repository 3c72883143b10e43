"""Layered config system: the loader of the repo's ``configs/`` files.

Port of vfmseg_tpu/core/config.py:

* a config is a nested :class:`Config` (a dict with attribute access);
* a config file is a Python module under ``configs/`` exposing a
  module-level ``config`` dict or a ``get_config()`` function (else every
  public module-level value is a key);
* ``_base_`` entries (paths relative to the file) are deep-merged in
  order, then the file's own keys override them; ``{"_delete_": True}``
  replaces a base value instead of merging into it;
* ``--cfg-options`` overrides use dot keys (``optimizer.lr=3e-4``), values
  parsed as Python literals where they parse.

The files import the JAX package's presets and loader (``from
vfmseg_tpu.models import presets as P``, ``from vfmseg_tpu.core.config
import load_config``). A file runs here with an ``__import__`` of its own
that resolves exactly those two modules to the port's twins and raises for
any other ``vfmseg_tpu`` import; ``sys.modules`` is not touched.
"""

from __future__ import annotations

import ast
import builtins
import copy
import importlib
import importlib.util
import os
import types
from typing import Any, Dict, Iterable, List


class Config(dict):
    """dict with attribute access and recursive wrapping."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        for k, v in list(self.items()):
            self[k] = _wrap(v)

    def __getattr__(self, key: str):
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def __setattr__(self, key: str, value):
        self[key] = _wrap(value)

    def __setitem__(self, key, value):
        super().__setitem__(key, _wrap(value))

    def __deepcopy__(self, memo):
        return Config({k: copy.deepcopy(v, memo) for k, v in self.items()})

    def to_dict(self) -> Dict[str, Any]:
        return {k: (v.to_dict() if isinstance(v, Config) else v)
                for k, v in self.items()}

    def get_path(self, dotted: str, default=None):
        node: Any = self
        for part in dotted.split("."):
            if not isinstance(node, dict) or part not in node:
                return default
            node = node[part]
        return node

    def set_path(self, dotted: str, value):
        parts = dotted.split(".")
        node = self
        for part in parts[:-1]:
            if part not in node or not isinstance(node[part], dict):
                node[part] = Config()
            node = node[part]
        node[parts[-1]] = value


def _wrap(value):
    if isinstance(value, Config):
        return value
    if isinstance(value, dict):
        return Config(value)
    if isinstance(value, (list, tuple)):
        return type(value)(_wrap(v) for v in value)
    return value


def deep_merge(base: Dict, override: Dict) -> Config:
    """Recursively merge ``override`` into a copy of ``base`` (override
    wins): dicts merge, anything else (lists too) replaces; a
    ``{"_delete_": True}`` override discards the base value first."""
    out = Config(copy.deepcopy(dict(base)))
    for k, v in override.items():
        if isinstance(v, dict) and v.get("_delete_"):
            v = {kk: vv for kk, vv in v.items() if kk != "_delete_"}
            out[k] = Config(copy.deepcopy(v))
        elif k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


# the JAX package's modules a config file may import, and the port's twins
# they resolve to
MODULE_MAP = {"vfmseg_tpu.models.presets": "vfmseg_tpu_torch.models.presets",
              "vfmseg_tpu.core.config": "vfmseg_tpu_torch.core.config"}


def _namespace_of(dotted: str, leaf) -> types.SimpleNamespace:
    """``a.b.c`` -> namespace ``a`` whose ``.b.c`` is ``leaf`` (what
    ``import a.b.c as x`` reads attribute by attribute)."""
    parts = dotted.split(".")
    node = leaf
    for part in reversed(parts[1:]):
        node = types.SimpleNamespace(**{part: node})
    return node


def _config_import(path: str):
    """An ``__import__`` for the config file at ``path``."""

    def mapped(name: str) -> types.ModuleType:
        if name not in MODULE_MAP:
            raise ImportError(f"config {path} imports {name}, which has no "
                              f"counterpart in vfmseg_tpu_torch (mapped: "
                              f"{sorted(MODULE_MAP)})")
        return importlib.import_module(MODULE_MAP[name])

    def _import(name, globals=None, locals=None, fromlist=(), level=0):
        if level or not (name == "vfmseg_tpu"
                         or name.startswith("vfmseg_tpu.")):
            return builtins.__import__(name, globals, locals, fromlist, level)
        if not fromlist:
            return _namespace_of(name, mapped(name))
        if name in MODULE_MAP:
            return mapped(name)
        return types.SimpleNamespace(**{item: mapped(f"{name}.{item}")
                                        for item in fromlist})

    return _import


def _load_module(path: str) -> types.ModuleType:
    spec = importlib.util.spec_from_file_location(
        "_vfmseg_torch_cfg_" + os.path.basename(path).replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    mod.__builtins__ = dict(vars(builtins), __import__=_config_import(path))
    spec.loader.exec_module(mod)  # type: ignore[union-attr]
    return mod


# Default search root for bare config names ("dg_lora_dinov2_ms_masked").
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CONFIG_DIRS = [os.path.join(_REPO_ROOT, "configs")]


def _resolve(name_or_path: str, relative_to: str | None = None) -> str:
    if os.path.isfile(name_or_path):
        return os.path.abspath(name_or_path)
    candidates: List[str] = []
    if relative_to is not None:
        candidates.append(os.path.join(os.path.dirname(relative_to),
                                       name_or_path))
    for d in CONFIG_DIRS:
        candidates.append(os.path.join(d, name_or_path))
        candidates.append(os.path.join(d, name_or_path + ".py"))
        # bare names match anywhere under configs/
        for root, _dirs, files in os.walk(d):
            if name_or_path + ".py" in files:
                candidates.append(os.path.join(root, name_or_path + ".py"))
    for c in candidates:
        if os.path.isfile(c):
            return os.path.abspath(c)
    raise FileNotFoundError(
        f"config {name_or_path!r} not found (tried {candidates})")


def load_config(name_or_path: str, overrides: Iterable[str] = ()) -> Config:
    """Load a config file, resolving ``_base_`` inheritance and the
    ``key.path=value`` overrides."""
    path = _resolve(name_or_path)
    cfg = _load_file(path)
    for item in overrides:
        if "=" not in item:
            raise ValueError(f"override {item!r} must look like "
                             f"key.path=value")
        key, raw = item.split("=", 1)
        cfg.set_path(key.strip(), parse_value(raw.strip()))
    if "name" not in cfg:
        cfg["name"] = os.path.splitext(os.path.basename(path))[0]
    return cfg


def _load_file(path: str) -> Config:
    mod = _load_module(path)
    if hasattr(mod, "get_config"):
        own = mod.get_config()
    elif hasattr(mod, "config"):
        own = mod.config
    else:
        own = {k: v for k, v in vars(mod).items()
               if not k.startswith("_") and not callable(v)
               and not isinstance(v, type(os))}
    own = Config(copy.deepcopy(dict(own)))
    bases = own.pop("_base_", [])
    if isinstance(bases, str):
        bases = [bases]
    merged = Config()
    for b in bases:
        merged = deep_merge(merged, _load_file(_resolve(b, relative_to=path)))
    return deep_merge(merged, own)


def parse_value(raw: str):
    """A ``--cfg-options`` value: a Python literal where it parses as one,
    else the string."""
    try:
        return ast.literal_eval(raw)
    except (ValueError, SyntaxError):
        return raw

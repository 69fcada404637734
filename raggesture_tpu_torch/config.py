"""Python-file config system with ``_base_`` inheritance and CLI overrides.

The port's own copy of ``raggesture_tpu/config.py`` (the port imports
nothing of the JAX package): ``Config.fromfile``, ``merge_option_strings``
and ``parse_option_value`` load ``configs/`` to the same dict.  Configs are plain Python files whose
module-level variables become the config dict; a ``_base_ = [...]`` list
pulls in parent configs (paths relative to the child file) which are
deep-merged in order, child-last-wins; a dict valued ``{"_delete_": True}``
replaces the base dict instead of merging into it; CLI ``--options
a.b.c=value`` performs dotted-key overrides with literal-eval value parsing
(the mmcv ``DictAction`` behavior of the reference's tools/train.py).

No mmcv dependency: ~200 lines, stdlib only.
"""

from __future__ import annotations

import ast
import copy
import importlib.util
import os
import pprint
import sys
import types
from typing import Any, Dict, Iterable, List, Mapping, Optional

_DELETE_KEY = "_delete_"
_BASE_KEY = "_base_"

_RESERVED = {
    "__name__", "__doc__", "__package__", "__loader__", "__spec__",
    "__file__", "__builtins__", "__cached__",
}


class ConfigDict(dict):
    """dict with attribute access, recursively applied on get."""

    def __getattr__(self, name: str) -> Any:
        try:
            value = self[name]
        except KeyError:
            raise AttributeError(
                f"ConfigDict has no attribute {name!r}") from None
        return value

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = _wrap(value)

    def __delattr__(self, name: str) -> None:
        try:
            del self[name]
        except KeyError:
            raise AttributeError(name) from None

    def __setitem__(self, key, value):
        super().__setitem__(key, _wrap(value))

    def copy(self) -> "ConfigDict":
        return copy.deepcopy(self)


def _wrap(value: Any) -> Any:
    if isinstance(value, ConfigDict):
        return value
    if isinstance(value, Mapping):
        return ConfigDict({k: _wrap(v) for k, v in value.items()})
    if isinstance(value, (list, tuple)):
        wrapped = [_wrap(v) for v in value]
        return type(value)(wrapped) if isinstance(value, tuple) else wrapped
    return value


def _to_plain(value: Any) -> Any:
    if isinstance(value, Mapping):
        return {k: _to_plain(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_to_plain(v) for v in value]
    return value


def deep_merge(base: Dict, override: Dict) -> Dict:
    """Merge ``override`` into a deep copy of ``base`` (override wins).

    A dict containing ``_delete_: True`` replaces the base value wholesale
    (mmcv semantics)."""
    out = copy.deepcopy(dict(base))
    for key, val in override.items():
        if (
            isinstance(val, Mapping)
            and val.get(_DELETE_KEY, False)
        ):
            val = {k: v for k, v in val.items() if k != _DELETE_KEY}
            out[key] = copy.deepcopy(dict(val))
        elif (
            isinstance(val, Mapping)
            and isinstance(out.get(key), Mapping)
        ):
            out[key] = deep_merge(out[key], val)
        else:
            out[key] = copy.deepcopy(val)
    return out


def _exec_pyfile(path: str) -> Dict[str, Any]:
    path = os.path.abspath(path)
    if not os.path.isfile(path):
        raise FileNotFoundError(f"config file not found: {path}")
    spec = importlib.util.spec_from_file_location(
        f"_raggesture_cfg_{abs(hash(path))}", path)
    module = importlib.util.module_from_spec(spec)
    # keep the module importable during exec only
    sys.modules[spec.name] = module
    try:
        spec.loader.exec_module(module)
    finally:
        sys.modules.pop(spec.name, None)
    return {
        k: v for k, v in vars(module).items()
        if k not in _RESERVED and k != "__annotations__"
        and not isinstance(v, types.ModuleType)
        and not callable(v)
    }


def _load_with_bases(path: str) -> Dict[str, Any]:
    cfg = _exec_pyfile(path)
    bases = cfg.pop(_BASE_KEY, [])
    if isinstance(bases, str):
        bases = [bases]
    merged: Dict[str, Any] = {}
    for base_rel in bases:
        base_path = os.path.join(os.path.dirname(path), base_rel)
        merged = deep_merge(merged, _load_with_bases(base_path))
    return deep_merge(merged, cfg)


def _split_top_level_commas(raw: str) -> List[str]:
    """Split on commas OUTSIDE brackets/quotes (mmcv DictAction's
    _parse_iterable bracket handling): ``[64,128],[1,2]`` -> two items."""
    parts, depth, quote, start = [], 0, None, 0
    for i, ch in enumerate(raw):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "\"'":
            quote = ch
        elif ch in "([{":
            depth += 1
        elif ch in ")]}":
            depth -= 1
        elif ch == "," and depth == 0:
            parts.append(raw[start:i])
            start = i + 1
    parts.append(raw[start:])
    return parts


def parse_option_value(raw: str) -> Any:
    """Parse a CLI override value: literal-eval when possible, with
    true/false aliases; TOP-LEVEL comma-separated values become lists
    (commas inside brackets/quotes stay part of one literal, so
    ``dims=[64,128]`` parses as a list of ints, not two broken strings)."""
    parts = _split_top_level_commas(raw)
    if len(parts) > 1:
        return [parse_option_value(v) for v in parts if v != ""]
    low = raw.lower()
    if low in ("true", "yes"):
        return True
    if low in ("false", "no"):
        return False
    if low in ("none", "null"):
        return None
    try:
        return ast.literal_eval(raw)
    except (ValueError, SyntaxError):
        return raw


class Config:
    """Loaded configuration with attribute access and dotted-key overrides."""

    def __init__(self, cfg_dict: Optional[Dict[str, Any]] = None,
                 filename: Optional[str] = None):
        self._cfg = _wrap(cfg_dict or {})
        self._filename = filename

    # -- construction ------------------------------------------------------
    @classmethod
    def fromfile(cls, path: str) -> "Config":
        return cls(_load_with_bases(path), filename=os.path.abspath(path))

    @classmethod
    def fromdict(cls, d: Dict[str, Any]) -> "Config":
        return cls(copy.deepcopy(dict(d)))

    # -- mapping protocol ---------------------------------------------------
    @property
    def filename(self) -> Optional[str]:
        return self._filename

    def __getattr__(self, name: str) -> Any:
        if name.startswith("_"):
            raise AttributeError(name)
        return getattr(self._cfg, name)

    def __getitem__(self, key: str) -> Any:
        return self._cfg[key]

    def __setitem__(self, key: str, value: Any) -> None:
        self._cfg[key] = value

    def __setattr__(self, name: str, value: Any) -> None:
        if name.startswith("_"):
            object.__setattr__(self, name, value)
        else:
            self._cfg[name] = value

    def __contains__(self, key: str) -> bool:
        return key in self._cfg

    def get(self, key: str, default: Any = None) -> Any:
        return self._cfg.get(key, default)

    def keys(self) -> Iterable[str]:
        return self._cfg.keys()

    def to_dict(self) -> Dict[str, Any]:
        return _to_plain(self._cfg)

    # -- overrides ----------------------------------------------------------
    def merge_from_options(self, options: Mapping[str, Any]) -> None:
        """Apply ``{"a.b.c": value}`` overrides (reference --options
        DictAction, tools/train.py:53)."""
        for dotted, value in options.items():
            keys = dotted.split(".")
            node = self._cfg
            for j, k in enumerate(keys[:-1]):
                if k not in node:
                    node[k] = ConfigDict()
                elif not isinstance(node[k], Mapping):
                    # a typo'd path like optimizer.lr.warmup must not
                    # silently REPLACE the existing scalar (mmcv's
                    # merge_from_dict errors here too)
                    raise KeyError(
                        f"override {dotted!r}: "
                        f"{'.'.join(keys[:j + 1])!r} is not a dict "
                        f"(existing value {node[k]!r})")
                node = node[k]
            node[keys[-1]] = value

    def merge_option_strings(self, pairs: List[str]) -> None:
        """Apply ``["a.b=1", "c=true"]`` style overrides from argparse."""
        opts = {}
        for pair in pairs:
            if "=" not in pair:
                raise ValueError(f"override must be key=value, got {pair!r}")
            key, _, raw = pair.partition("=")
            opts[key.strip()] = parse_option_value(raw.strip())
        self.merge_from_options(opts)

    # -- persistence ---------------------------------------------------------
    def dump(self, path: str) -> None:
        """Write the resolved config as a loadable Python file (reference
        dumps the merged config into the workdir, tools/train.py:107)."""
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            f.write("# resolved config")
            if self._filename:
                f.write(f" (from {self._filename})")
            f.write("\n")
            for key, value in self._cfg.items():
                f.write(f"{key} = {pprint.pformat(_to_plain(value))}\n")

    def pretty_text(self) -> str:
        return pprint.pformat(self.to_dict())

    def __repr__(self) -> str:
        return f"Config(file={self._filename!r}):\n{self.pretty_text()}"

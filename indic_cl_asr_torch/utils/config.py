"""Structured config with ``--a.b.c`` CLI overrides (own copy of the
framework-free indic_cl_asr_tpu/utils/config.py).

A YAML file is loaded into a nested attribute-access dict, and one CLI flag
is registered per (nested) leaf with type coercion taken from the YAML's
original value type (bools accept true/false/1/0/yes/no/y/n/t/f); a YAML
``null`` leaf takes its flag's value as a YAML scalar, and a list leaf
takes ``nargs="*"`` values of its first element's type (reference
utils.py:77-116, config.yaml).
"""

from __future__ import annotations

import argparse
import copy
from typing import Any, Iterator, Mapping

import yaml

_MISSING = object()


class ConfigDict(dict):
    """Nested dict with attribute access. The single config container."""

    def __init__(self, data: Mapping[str, Any] | None = None):
        super().__init__()
        if data:
            for k, v in data.items():
                self[k] = v

    def __setitem__(self, key: str, value: Any) -> None:
        if isinstance(value, Mapping) and not isinstance(value, ConfigDict):
            value = ConfigDict(value)
        super().__setitem__(key, value)

    def __getattr__(self, key: str) -> Any:
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def __setattr__(self, key: str, value: Any) -> None:
        self[key] = value

    def __deepcopy__(self, memo):
        return ConfigDict({k: copy.deepcopy(v, memo) for k, v in self.items()})

    # ---- dotted-path access ----

    def get_path(self, path: str, default: Any = _MISSING) -> Any:
        node: Any = self
        for part in path.split("."):
            if isinstance(node, Mapping) and part in node:
                node = node[part]
            elif default is not _MISSING:
                return default
            else:
                raise KeyError(path)
        return node

    def set_path(self, path: str, value: Any) -> None:
        parts = path.split(".")
        node = self
        for part in parts[:-1]:
            if part not in node or not isinstance(node[part], ConfigDict):
                node[part] = ConfigDict()
            node = node[part]
        node[parts[-1]] = value

    def leaves(self, prefix: str = "") -> Iterator[tuple[str, Any]]:
        for k, v in self.items():
            path = f"{prefix}{k}"
            if isinstance(v, ConfigDict):
                yield from v.leaves(prefix=path + ".")
            else:
                yield path, v

    def to_dict(self) -> dict:
        return {
            k: (v.to_dict() if isinstance(v, ConfigDict) else v)
            for k, v in self.items()
        }

    def merge(self, other: Mapping[str, Any]) -> "ConfigDict":
        """Deep-merge ``other`` into self (other wins). Returns self."""
        for k, v in other.items():
            if (
                k in self
                and isinstance(self[k], ConfigDict)
                and isinstance(v, Mapping)
            ):
                self[k].merge(v)
            else:
                self[k] = v
        return self


def load_config(path: str) -> ConfigDict:
    with open(path) as f:
        data = yaml.safe_load(f) or {}
    return ConfigDict(data)


def _parse_bool(s: str) -> bool:
    truthy = {"true", "1", "yes", "y", "t"}
    falsy = {"false", "0", "no", "n", "f"}
    low = str(s).strip().lower()
    if low in truthy:
        return True
    if low in falsy:
        return False
    raise argparse.ArgumentTypeError(f"not a bool: {s!r}")


def _coerce_like(example: Any):
    """Pick an argparse ``type`` callable matching the YAML leaf's type."""
    if isinstance(example, bool):
        return _parse_bool
    if isinstance(example, int):
        return int
    if isinstance(example, float):
        return float
    if example is None:
        # untyped leaf: accept raw string but try yaml scalar parse
        return lambda s: yaml.safe_load(s)
    return type(example)


def override_config_with_args(
    config: ConfigDict,
    argv: list[str] | None = None,
    extra_args: dict[str, dict] | None = None,
) -> tuple[ConfigDict, argparse.Namespace]:
    """Auto-register one ``--a.b.c`` flag per config leaf and apply overrides.

    Mirrors reference utils.py:77-116 behavior: flag types are coerced from
    the YAML values' types; bools accept the usual spellings. ``extra_args``
    adds non-config flags (e.g. ``--notes``) as {name: argparse kwargs}.
    """
    parser = argparse.ArgumentParser()
    for path, value in config.leaves():
        if isinstance(value, (list, tuple)):
            parser.add_argument(
                f"--{path}", nargs="*", default=None,
                type=_coerce_like(value[0]) if len(value) else str,
            )
        else:
            parser.add_argument(f"--{path}", type=_coerce_like(value), default=None)
    for name, kwargs in (extra_args or {}).items():
        parser.add_argument(f"--{name}", **kwargs)
    ns = parser.parse_args(argv)
    for path, _ in list(config.leaves()):
        val = getattr(ns, path, None)
        if val is not None:
            config.set_path(path, val)
    return config, ns

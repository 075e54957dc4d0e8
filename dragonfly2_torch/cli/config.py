"""Config loading for service binaries (counterpart of the reference's
``cli/config.py``): YAML file + environment overrides onto dataclass
configs (upstream cobra+viper yaml config per binary, cmd/*/cmd/root.go).

Precedence (last wins): dataclass defaults < YAML file < env vars <
explicit CLI flags (applied by the caller).

Env vars are ``<PREFIX>_<FIELD>`` with the field name upper-cased, e.g.
``DF_SCHEDULER_LISTEN=0.0.0.0:8002``. Values parse by the field's type
(int/float/bool/str); dict/list fields are YAML-parsed.
"""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path
from typing import Any, Type, TypeVar

import yaml

T = TypeVar("T")


class ConfigError(ValueError):
    pass


def _parse_scalar(raw: str, typ: Any) -> Any:
    if typ is bool or typ == "bool":
        return raw.strip().lower() in ("1", "true", "yes", "on")
    for t in (int, float):
        if typ is t:
            return t(raw)
    if typ is str:
        return raw
    # lists/dicts/optionals: YAML covers all of them
    return yaml.safe_load(raw)


def load_config(
    cls: Type[T],
    path: str | Path | None = None,
    env_prefix: str | None = None,
    overrides: dict[str, Any] | None = None,
) -> T:
    """Build a dataclass config from defaults + YAML + env + overrides,
    rejecting unknown keys (a typo'd key must fail loudly, not silently
    keep the default — the host_stats_override lesson)."""
    fields = {f.name: f for f in dataclasses.fields(cls)}
    values: dict[str, Any] = {}

    if path is not None:
        with open(path) as f:
            doc = yaml.safe_load(f) or {}
        if not isinstance(doc, dict):
            raise ConfigError(f"{path}: top level must be a mapping")
        for k, v in doc.items():
            if k not in fields:
                raise ConfigError(f"{path}: unknown config key {k!r} for {cls.__name__}")
            values[k] = v

    if env_prefix:
        for name, f in fields.items():
            raw = os.environ.get(f"{env_prefix}_{name.upper()}")
            if raw is not None:
                try:
                    values[name] = _parse_scalar(raw, f.type if isinstance(f.type, type) else _hint(cls, name))
                except Exception as e:
                    raise ConfigError(
                        f"{env_prefix}_{name.upper()}={raw!r}: {e}"
                    ) from e

    for k, v in (overrides or {}).items():
        if k not in fields:
            raise ConfigError(f"unknown config key {k!r} for {cls.__name__}")
        if v is None and not _allows_none(cls, k):
            # an explicit null may clear Optional fields, but injecting
            # None into an int/str/float field would surface later as an
            # unrelated TypeError deep in the service
            raise ConfigError(
                f"config key {k!r} of {cls.__name__} cannot be null"
            )
        values[k] = v

    return cls(**values)


def _allows_none(cls, name: str) -> bool:
    import types
    import typing

    h = typing.get_type_hints(cls).get(name)
    if h is None:
        return True
    if h is type(None):
        return True
    origin = typing.get_origin(h)
    # typing.Optional[X] and PEP 604 `X | None` both count
    if origin is typing.Union or origin is types.UnionType:
        return type(None) in typing.get_args(h)
    return False


def _hint(cls, name: str):
    import typing

    hints = typing.get_type_hints(cls)
    h = hints.get(name, str)
    origin = typing.get_origin(h)
    if origin is None:
        return h
    return object  # containers / optionals → YAML parse


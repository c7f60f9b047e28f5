"""config.toml load/save (reference: config/toml.go template + viper load):
the port's copy of tendermint_tpu/config/toml.py, which writes the same text.

The dataclass tree in config.py is the source of truth: save() renders every
section generically from dataclass fields, load() parses with the stdlib
tomllib and applies values onto a fresh Config — unknown keys are ignored,
missing keys keep their defaults (viper semantics).
"""

from __future__ import annotations

import dataclasses
import os

try:
    import tomllib  # py3.11+ stdlib; only loads() needs it
except ImportError:  # pragma: no cover - py3.10 containers
    tomllib = None
from typing import Any

from tendermint_tpu_torch.config.config import Config

_SECTIONS = (
    "rpc",
    "p2p",
    "mempool",
    "statesync",
    "fastsync",
    "overload",
    "slo",
    "light_service",
    "scheduler",
    "consensus",
    "crypto",
    "instrumentation",
)

_HEADER = """\
# TOML configuration for a tendermint_tpu node.
# Generated by `tendermint-tpu init` — edit freely; unknown keys are ignored.

"""


def _toml_value(v: Any) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (int, float)):
        return repr(v)
    if isinstance(v, str):
        return '"' + v.replace("\\", "\\\\").replace('"', '\\"') + '"'
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_toml_value(x) for x in v) + "]"
    raise TypeError(f"cannot render {type(v).__name__} to TOML")


def dumps(cfg: Config) -> str:
    out = [_HEADER]
    # base fields live at top level (reference: config/toml.go)
    for f in dataclasses.fields(cfg.base):
        out.append(f"{f.name} = {_toml_value(getattr(cfg.base, f.name))}\n")
    for section in _SECTIONS:
        sub = getattr(cfg, section)
        out.append(f"\n[{section}]\n")
        for f in dataclasses.fields(sub):
            out.append(f"{f.name} = {_toml_value(getattr(sub, f.name))}\n")
    return "".join(out)


def loads(text: str) -> Config:
    if tomllib is None:
        raise RuntimeError(
            "parsing config.toml needs the stdlib tomllib (python >= 3.11)"
        )
    data = tomllib.loads(text)
    cfg = Config()
    base_fields = {f.name: f for f in dataclasses.fields(cfg.base)}
    for key, value in data.items():
        if key in _SECTIONS and isinstance(value, dict):
            sub = getattr(cfg, key)
            sub_fields = {f.name for f in dataclasses.fields(sub)}
            for k, v in value.items():
                if k in sub_fields:
                    setattr(sub, k, _coerce(getattr(sub, k), v))
        elif key in base_fields:
            setattr(cfg.base, key, _coerce(getattr(cfg.base, key), value))
    return cfg


def _coerce(current: Any, new: Any) -> Any:
    """Keep the dataclass field's type stable (TOML ints for float fields)."""
    if isinstance(current, bool):
        return bool(new)
    if isinstance(current, float) and isinstance(new, int):
        return float(new)
    if isinstance(current, list) and isinstance(new, (list, tuple)):
        return list(new)
    return new


def save_config(cfg: Config, path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(dumps(cfg))
    os.replace(tmp, path)


def load_config(path: str) -> Config:
    with open(path, "rb") as f:
        cfg = loads(f.read().decode())
    return cfg

"""Module-filtered structured logging (reference: libs/log + filter.go):
the port's copy of tendermint_tpu/libs/log.py, whole.

setup(level_spec) configures the framework's loggers from a spec like the
reference's --log_level: "info", "consensus:debug,p2p:none,*:error" —
per-module levels with '*' as the default. Modules map to the
"tendermint_tpu_torch.<module>" logger namespace.
"""

from __future__ import annotations

import logging
from typing import Dict

ROOT = "tendermint_tpu_torch"

_LEVELS = {
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warn": logging.WARNING,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "critical": logging.CRITICAL,
    "none": logging.CRITICAL + 10,
}


def parse_level_spec(spec: str) -> Dict[str, int]:
    """'consensus:debug,p2p:none,*:error' -> {module: level}. A bare level
    ('info') applies to '*' (reference: libs/log/filter.go ParseLogLevel)."""
    out: Dict[str, int] = {}
    spec = (spec or "info").strip()
    if ":" not in spec:
        out["*"] = _level(spec)
        return out
    for item in spec.split(","):
        item = item.strip()
        if not item:
            continue
        mod, _, lvl = item.partition(":")
        out[mod.strip() or "*"] = _level(lvl.strip())
    out.setdefault("*", logging.INFO)
    return out


def _level(name: str, strict: bool = True) -> int:
    try:
        return _LEVELS[name.lower()]
    except KeyError:
        if strict:
            raise ValueError(
                f"unknown log level {name!r} (expected one of {sorted(_LEVELS)})"
            ) from None
        logging.getLogger(ROOT).warning(
            "unknown log level %r; falling back to info", name
        )
        return logging.INFO


def setup(level_spec: str = "info", fmt: str = "%(asctime)s %(name)s %(levelname)s %(message)s") -> None:
    """Configure the tendermint_tpu_torch logger tree from a level spec. A bad spec
    degrades to INFO with a warning — a typo in config.toml must not stop a
    node from booting."""
    try:
        levels = parse_level_spec(level_spec)
    except ValueError:
        logging.getLogger(ROOT).warning(
            "invalid log_level spec %r; using info", level_spec
        )
        levels = {"*": logging.INFO}
    root = logging.getLogger(ROOT)
    if not root.handlers and not logging.getLogger().handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter(fmt))
        root.addHandler(handler)
    root.setLevel(levels.get("*", logging.INFO))
    for mod, lvl in levels.items():
        if mod == "*":
            continue
        logging.getLogger(f"{ROOT}.{mod}").setLevel(lvl)

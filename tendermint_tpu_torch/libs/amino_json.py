"""Registered-type JSON, the port's copy of tendermint_tpu/libs/amino_json.py:
{"type": <registered name>, "value": ...} envelopes for interface-typed values (reference: libs/json — amino-compatible JSON with
type tags; registrations like crypto/ed25519/ed25519.go:38-40).

Concrete types register an (name, encode, decode) triple; marshal/unmarshal
wrap/unwrap the envelope so heterogeneous values (e.g. PubKey variants)
round-trip through JSON without out-of-band type knowledge.
"""

from __future__ import annotations

import base64
import json
from typing import Any, Callable, Dict, Tuple, Type

_BY_TYPE: Dict[Type, Tuple[str, Callable]] = {}
_BY_NAME: Dict[str, Callable] = {}


class UnregisteredTypeError(TypeError):
    pass


def register(cls: Type, name: str, encode: Callable[[Any], Any], decode: Callable[[Any], Any]) -> None:
    """reference: libs/json/registry.go RegisterType."""
    if name in _BY_NAME:
        raise ValueError(f"type name {name!r} already registered")
    _BY_TYPE[cls] = (name, encode)
    _BY_NAME[name] = decode


def marshal(value: Any) -> str:
    """Value -> '{"type": ..., "value": ...}' JSON."""
    for cls in type(value).__mro__:
        if cls in _BY_TYPE:
            name, encode = _BY_TYPE[cls]
            return json.dumps({"type": name, "value": encode(value)}, sort_keys=True)
    raise UnregisteredTypeError(f"{type(value).__name__} is not a registered type")


def unmarshal(data: str) -> Any:
    o = json.loads(data)
    if not isinstance(o, dict) or "type" not in o:
        raise ValueError("not a type-tagged JSON envelope")
    decode = _BY_NAME.get(o["type"])
    if decode is None:
        raise UnregisteredTypeError(f"unknown type tag {o['type']!r}")
    return decode(o.get("value"))


# -- standard registrations (reference tag names) ---------------------------


def _register_std() -> None:
    from tendermint_tpu_torch.crypto.keys import Ed25519PrivKey, Ed25519PubKey

    register(
        Ed25519PubKey,
        "tendermint/PubKeyEd25519",
        lambda k: base64.b64encode(k.bytes()).decode(),
        lambda v: Ed25519PubKey(base64.b64decode(v)),
    )
    register(
        Ed25519PrivKey,
        "tendermint/PrivKeyEd25519",
        lambda k: base64.b64encode(k.bytes()).decode(),
        lambda v: Ed25519PrivKey(base64.b64decode(v)),
    )
    try:
        from tendermint_tpu_torch.crypto.sr25519 import Sr25519PubKey

        register(
            Sr25519PubKey,
            "tendermint/PubKeySr25519",
            lambda k: base64.b64encode(k.bytes()).decode(),
            lambda v: Sr25519PubKey(base64.b64decode(v)),
        )
    except ImportError:  # sr25519 backend optional
        pass


_register_std()

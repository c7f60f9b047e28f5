"""Fail points (reference libs/fail/fail.go): the port's copy of
tendermint_tpu/libs/fail.py.

Two mechanisms share the call sites:

1. TMTPU_FAIL_INDEX=<n>: the n-th fail point hit in the process exits it
   hard (os._exit(77)), a crash at that exact point of the commit / apply
   sequence (reference state/execution.go:143-189, consensus/state.go:746).
2. `inject(name, handler)`: a handler for one named point, run when it is
   hit; it may raise (SimulatedCrash) to crash the component in process.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional

_counter = 0

# name -> handler; consulted BEFORE the env counter so a chaos schedule can
# target a specific ordering point by name instead of by global hit index.
_HANDLERS: Dict[str, Callable[[], None]] = {}


class SimulatedCrash(Exception):
    """Raised by injected fail-point handlers to crash a component in-process
    (the consensus receive loop treats any escaped exception as a consensus
    failure and halts — the in-process analog of os._exit)."""


def fail_index() -> int:
    try:
        return int(os.environ.get("TMTPU_FAIL_INDEX", "-1"))
    except ValueError:
        return -1


def reset() -> None:
    global _counter
    _counter = 0


def inject(name: str, handler: Optional[Callable[[], None]]) -> None:
    """Register (or, with None, remove) a handler for a named fail point."""
    if handler is None:
        _HANDLERS.pop(name, None)
    else:
        _HANDLERS[name] = handler


def clear_injections() -> None:
    _HANDLERS.clear()


def fail_point(name: str = "") -> None:
    global _counter
    handler = _HANDLERS.get(name)
    if handler is not None:
        handler()  # may raise (SimulatedCrash) back into the caller
    target = fail_index()
    if target < 0:
        return
    if _counter == target:
        os.write(2, f"FAIL_POINT {_counter} {name}: crashing\n".encode())
        os._exit(77)
    _counter += 1

"""State store (reference: state/store.go:42).

Persists: the State blob, per-height validator sets with lastHeightChanged
dedup (reference: state/store.go:412 LoadValidators), per-height consensus
params, and ABCI responses per height (for /block_results and replay).

The port's copy of tendermint_tpu/state/store.py, the same encodings byte for byte.
"""

from __future__ import annotations

import json
import struct
from typing import List, Optional

from tendermint_tpu_torch.libs.kvdb import KVDB
from tendermint_tpu_torch.state.sm_state import State, _valset_from_json, _valset_to_json
from tendermint_tpu_torch.types.validator_set import ValidatorSet

_STATE_KEY = b"SS:state"


def _vkey(height: int) -> bytes:
    return b"SS:validators:" + struct.pack(">q", height)


def _akey(height: int) -> bytes:
    return b"SS:abci_responses:" + struct.pack(">q", height)


class ABCIResponses:
    """DeliverTx results + EndBlock/BeginBlock for one height."""

    def __init__(self, deliver_txs=None, begin_block=None, end_block=None):
        self.deliver_txs = deliver_txs or []
        self.begin_block = begin_block
        self.end_block = end_block

    def to_json(self) -> str:
        from tendermint_tpu_torch.abci.types import ValidatorUpdate

        end = self.end_block
        return json.dumps(
            {
                "deliver_txs": [
                    {"code": r.code, "data": r.data.hex(), "log": r.log, "gas_wanted": r.gas_wanted, "gas_used": r.gas_used}
                    for r in self.deliver_txs
                ],
                "validator_updates": [
                    {"type": u.pub_key_type, "pub_key": u.pub_key_bytes.hex(), "power": u.power}
                    for u in (end.validator_updates if end else [])
                ],
            }
        )

    @classmethod
    def from_json(cls, data: str) -> "ABCIResponses":
        from tendermint_tpu_torch.abci.types import (
            ResponseDeliverTx,
            ResponseEndBlock,
            ValidatorUpdate,
        )

        o = json.loads(data)
        dts = [
            ResponseDeliverTx(
                code=r["code"], data=bytes.fromhex(r["data"]), log=r["log"],
                gas_wanted=r["gas_wanted"], gas_used=r["gas_used"],
            )
            for r in o["deliver_txs"]
        ]
        end = ResponseEndBlock(
            validator_updates=[
                ValidatorUpdate(u["type"], bytes.fromhex(u["pub_key"]), u["power"])
                for u in o.get("validator_updates", [])
            ]
        )
        return cls(deliver_txs=dts, end_block=end)


class StateStore:
    def __init__(self, db: KVDB):
        self.db = db

    def load(self) -> Optional[State]:
        raw = self.db.get(_STATE_KEY)
        return State.from_json(raw.decode()) if raw else None

    def save(self, state: State) -> None:
        """Also saves next_validators at their effective height
        (reference: state/store.go:149 Save → saveValidatorsInfo)."""
        next_height = state.last_block_height + 1
        if state.last_block_height == 0:
            # genesis bootstrap: save both current (initial) and next
            self._save_validators(state.initial_height, state.last_height_validators_changed, state.validators)
            self._save_validators(state.initial_height + 1, state.last_height_validators_changed, state.next_validators)
        else:
            self._save_validators(next_height + 1, state.last_height_validators_changed, state.next_validators)
        self.db.set(_STATE_KEY, state.to_json().encode())

    def bootstrap(self, state: State) -> None:
        """State-sync entry (reference: state/store.go:182)."""
        height = state.last_block_height
        if height == 0:
            height = state.initial_height - 1
        if state.last_validators is not None:
            self._save_validators(height, height, state.last_validators)
        self._save_validators(height + 1, height + 1, state.validators)
        self._save_validators(height + 2, height + 2, state.next_validators)
        self.db.set(_STATE_KEY, state.to_json().encode())

    def _save_validators(self, height: int, last_changed: int, valset: Optional[ValidatorSet]) -> None:
        if valset is None:
            return
        payload = {"last_height_changed": last_changed}
        if height == last_changed or height % 100000 == 0:
            payload["valset"] = _valset_to_json(valset)
        self.db.set(_vkey(height), json.dumps(payload).encode())

    def load_validators(self, height: int) -> Optional[ValidatorSet]:
        """Follows the lastHeightChanged indirection
        (reference: state/store.go:412)."""
        raw = self.db.get(_vkey(height))
        if raw is None:
            return None
        o = json.loads(raw)
        if "valset" in o:
            return _valset_from_json(o["valset"])
        last_changed = o["last_height_changed"]
        raw2 = self.db.get(_vkey(last_changed))
        if raw2 is None:
            return None
        o2 = json.loads(raw2)
        if "valset" not in o2:
            return None
        vs = _valset_from_json(o2["valset"])
        if vs is not None and height > last_changed:
            vs.increment_proposer_priority(height - last_changed)
        return vs

    def save_abci_responses(self, height: int, responses: ABCIResponses) -> None:
        self.db.set(_akey(height), responses.to_json().encode())

    def load_abci_responses(self, height: int) -> Optional[ABCIResponses]:
        raw = self.db.get(_akey(height))
        return ABCIResponses.from_json(raw.decode()) if raw else None

    def prune_states(self, retain_height: int) -> None:
        """(reference: state/store.go:217)"""
        if retain_height <= 0:
            raise ValueError("height must be greater than 0")
        # Keep the indirection target alive: materialize the full valset at the
        # retain height before deleting older entries (reference:
        # state/store.go:217 PruneStates does the same).
        vs = self.load_validators(retain_height)
        if vs is not None:
            self.db.set(
                _vkey(retain_height),
                json.dumps(
                    {"last_height_changed": retain_height, "valset": _valset_to_json(vs)}
                ).encode(),
            )
        deletes: List[bytes] = []
        for key, _ in self.db.iterate_prefix(b"SS:validators:"):
            h = struct.unpack(">q", key[len(b"SS:validators:"):])[0]
            if h < retain_height:
                deletes.append(key)
        for key, _ in self.db.iterate_prefix(b"SS:abci_responses:"):
            h = struct.unpack(">q", key[len(b"SS:abci_responses:"):])[0]
            if h < retain_height:
                deletes.append(key)
        self.db.write_batch([], deletes)

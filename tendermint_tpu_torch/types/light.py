"""SignedHeader and LightBlock, the light client's unit of work, with their
JSON and bytes codecs.

The port's copy of tendermint_tpu/types/light.py (reference types/light.go
LightBlock :13, SignedHeader :85; JSON shapes of rpc/core/types/
responses.go). The codecs back the light store's persistence and carry
light blocks between the two packages (convert.py): the bytes of one
package's light_block_to_bytes decode in the other.
"""

from __future__ import annotations

import base64
import json
from dataclasses import dataclass
from typing import Optional

from tendermint_tpu_torch.crypto.keys import pubkey_from_type_and_bytes
from tendermint_tpu_torch.types.basic import (
    NANOS,
    BlockID,
    BlockIDFlag,
    PartSetHeader,
    ts_seconds_nanos,
)
from tendermint_tpu_torch.types.block import Commit, CommitSig, ConsensusVersion, Header
from tendermint_tpu_torch.types.validator_set import Validator, ValidatorSet


@dataclass(frozen=True)
class SignedHeader:
    """Header + the commit that signed it (reference: types/light.go:85)."""

    header: Header
    commit: Commit

    @property
    def height(self) -> int:
        return self.header.height

    def hash(self) -> bytes:
        return self.header.hash()

    def validate_basic(self, chain_id: str) -> None:
        """reference: types/light.go:96 SignedHeader.ValidateBasic."""
        if self.header is None:
            raise ValueError("missing header")
        if self.commit is None:
            raise ValueError("missing commit")
        self.header.validate_basic()
        self.commit.validate_basic()
        if self.header.chain_id != chain_id:
            raise ValueError(
                f"header belongs to another chain {self.header.chain_id!r}, not {chain_id!r}"
            )
        if self.commit.height != self.header.height:
            raise ValueError(
                f"commit signs block {self.commit.height}, header is block {self.header.height}"
            )
        hhash = self.header.hash()
        if self.commit.block_id.hash != hhash:
            raise ValueError(
                f"commit signs block {self.commit.block_id.hash.hex()}, "
                f"header is block {hhash.hex()}"
            )


@dataclass(frozen=True)
class LightBlock:
    """SignedHeader + the validator set that signed it
    (reference: types/light.go:13)."""

    signed_header: SignedHeader
    validator_set: ValidatorSet

    @property
    def height(self) -> int:
        return self.signed_header.height

    @property
    def header(self) -> Header:
        return self.signed_header.header

    @property
    def time_ns(self) -> int:
        return self.signed_header.header.time_ns

    def hash(self) -> bytes:
        return self.signed_header.hash()

    def validate_basic(self, chain_id: str) -> None:
        """reference: types/light.go:36 LightBlock.ValidateBasic — also pins
        the valset to the header's ValidatorsHash."""
        if self.signed_header is None:
            raise ValueError("missing signed header")
        if self.validator_set is None:
            raise ValueError("missing validator set")
        self.signed_header.validate_basic(chain_id)
        self.validator_set.validate_basic()
        vh = self.validator_set.hash()
        if self.signed_header.header.validators_hash != vh:
            raise ValueError(
                f"expected validators hash {self.signed_header.header.validators_hash.hex()}, "
                f"got {vh.hex()}"
            )


# ---------------------------------------------------------------- JSON codecs

def _b64(b: bytes) -> str:
    return base64.b64encode(b).decode("ascii")


def _unb64(s: str) -> bytes:
    return base64.b64decode(s) if s else b""


def _time_json(ts_ns: int) -> str:
    sec, nanos = ts_seconds_nanos(ts_ns)
    return f"{sec}.{nanos:09d}"


def _time_from_json(s: str) -> int:
    sec, _, nanos = s.partition(".")
    return int(sec) * NANOS + int(nanos or 0)


def block_id_to_json(bid: BlockID) -> dict:
    return {
        "hash": bid.hash.hex().upper(),
        "parts": {
            "total": bid.part_set_header.total,
            "hash": bid.part_set_header.hash.hex().upper(),
        },
    }


def block_id_from_json(o: dict) -> BlockID:
    parts = o.get("parts") or {}
    return BlockID(
        hash=bytes.fromhex(o.get("hash", "")),
        part_set_header=PartSetHeader(
            total=int(parts.get("total", 0)),
            hash=bytes.fromhex(parts.get("hash", "")),
        ),
    )


def header_to_json(h: Header) -> dict:
    return {
        "version": {"block": str(h.version.block), "app": str(h.version.app)},
        "chain_id": h.chain_id,
        "height": str(h.height),
        "time": _time_json(h.time_ns),
        "last_block_id": block_id_to_json(h.last_block_id),
        "last_commit_hash": h.last_commit_hash.hex().upper(),
        "data_hash": h.data_hash.hex().upper(),
        "validators_hash": h.validators_hash.hex().upper(),
        "next_validators_hash": h.next_validators_hash.hex().upper(),
        "consensus_hash": h.consensus_hash.hex().upper(),
        "app_hash": h.app_hash.hex().upper(),
        "last_results_hash": h.last_results_hash.hex().upper(),
        "evidence_hash": h.evidence_hash.hex().upper(),
        "proposer_address": h.proposer_address.hex().upper(),
    }


def header_from_json(o: dict) -> Header:
    ver = o.get("version") or {}
    return Header(
        version=ConsensusVersion(int(ver.get("block", 0)), int(ver.get("app", 0))),
        chain_id=o["chain_id"],
        height=int(o["height"]),
        time_ns=_time_from_json(o["time"]),
        last_block_id=block_id_from_json(o.get("last_block_id") or {}),
        last_commit_hash=bytes.fromhex(o.get("last_commit_hash", "")),
        data_hash=bytes.fromhex(o.get("data_hash", "")),
        validators_hash=bytes.fromhex(o.get("validators_hash", "")),
        next_validators_hash=bytes.fromhex(o.get("next_validators_hash", "")),
        consensus_hash=bytes.fromhex(o.get("consensus_hash", "")),
        app_hash=bytes.fromhex(o.get("app_hash", "")),
        last_results_hash=bytes.fromhex(o.get("last_results_hash", "")),
        evidence_hash=bytes.fromhex(o.get("evidence_hash", "")),
        proposer_address=bytes.fromhex(o.get("proposer_address", "")),
    )


def commit_to_json(c: Commit) -> dict:
    return {
        "height": str(c.height),
        "round": c.round,
        "block_id": block_id_to_json(c.block_id),
        "signatures": [
            {
                "block_id_flag": int(cs.block_id_flag),
                "validator_address": cs.validator_address.hex().upper(),
                "timestamp": _time_json(cs.timestamp_ns),
                "signature": _b64(cs.signature),
            }
            for cs in c.signatures
        ],
    }


def commit_from_json(o: dict) -> Commit:
    return Commit(
        height=int(o["height"]),
        round=int(o.get("round", 0)),
        block_id=block_id_from_json(o.get("block_id") or {}),
        signatures=[
            CommitSig(
                block_id_flag=BlockIDFlag(int(s["block_id_flag"])),
                validator_address=bytes.fromhex(s.get("validator_address", "")),
                timestamp_ns=_time_from_json(s.get("timestamp", "0.0")),
                signature=_unb64(s.get("signature", "")),
            )
            for s in o.get("signatures", [])
        ],
    )


def validator_to_json(v: Validator) -> dict:
    return {
        "address": v.address.hex().upper(),
        "pub_key": {"type": v.pub_key.type_name(), "value": _b64(v.pub_key.bytes())},
        "voting_power": str(v.voting_power),
        "proposer_priority": str(v.proposer_priority),
    }


def validator_from_json(o: dict) -> Validator:
    pk = o["pub_key"]
    v = Validator(
        pub_key=pubkey_from_type_and_bytes(pk["type"], _unb64(pk["value"])),
        voting_power=int(o["voting_power"]),
        proposer_priority=int(o.get("proposer_priority", 0)),
    )
    return v


def validator_set_to_json(vs: ValidatorSet) -> dict:
    return {
        "validators": [validator_to_json(v) for v in vs.validators],
        "proposer": validator_to_json(vs.get_proposer()) if len(vs) else None,
    }


def validator_set_from_json(o: dict) -> ValidatorSet:
    vals = [validator_from_json(v) for v in o.get("validators", [])]
    vs = ValidatorSet(vals)
    prop = o.get("proposer")
    if prop:
        addr = bytes.fromhex(prop["address"])
        _, v = vs.get_by_address(addr)
        if v is not None:
            vs.proposer = v
    return vs


def signed_header_to_json(sh: SignedHeader) -> dict:
    return {"header": header_to_json(sh.header), "commit": commit_to_json(sh.commit)}


def signed_header_from_json(o: dict) -> SignedHeader:
    return SignedHeader(
        header=header_from_json(o["header"]), commit=commit_from_json(o["commit"])
    )


def light_block_to_json(lb: LightBlock) -> dict:
    return {
        "signed_header": signed_header_to_json(lb.signed_header),
        "validator_set": validator_set_to_json(lb.validator_set),
    }


def light_block_from_json(o: dict) -> LightBlock:
    return LightBlock(
        signed_header=signed_header_from_json(o["signed_header"]),
        validator_set=validator_set_from_json(o["validator_set"]),
    )


def light_block_to_bytes(lb: LightBlock) -> bytes:
    return json.dumps(light_block_to_json(lb), separators=(",", ":")).encode()


def light_block_from_bytes(data: bytes) -> LightBlock:
    return light_block_from_json(json.loads(data.decode()))

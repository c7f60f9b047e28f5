"""GenesisDoc (reference: types/genesis.go).

The port's copy of tendermint_tpu/types/genesis.py, the same encodings byte for byte.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import List

from tendermint_tpu_torch.crypto.keys import pubkey_from_type_and_bytes
from tendermint_tpu_torch.types.params import ConsensusParams, DEFAULT_CONSENSUS_PARAMS
from tendermint_tpu_torch.types.validator_set import Validator

MAX_CHAIN_ID_LEN = 50


@dataclass
class GenesisValidator:
    pub_key: object  # a crypto.keys public key
    power: int
    name: str = ""
    address: bytes = b""

    def __post_init__(self):
        if not self.address:
            self.address = self.pub_key.address()


@dataclass
class GenesisDoc:
    chain_id: str
    genesis_time_ns: int = 0
    initial_height: int = 1
    consensus_params: ConsensusParams = field(default_factory=lambda: DEFAULT_CONSENSUS_PARAMS)
    validators: List[GenesisValidator] = field(default_factory=list)
    app_hash: bytes = b""
    app_state: bytes = b"{}"

    def validate_and_complete(self) -> None:
        """(reference: types/genesis.go ValidateAndComplete)"""
        if not self.chain_id:
            raise ValueError("genesis doc must include non-empty chain_id")
        if len(self.chain_id) > MAX_CHAIN_ID_LEN:
            raise ValueError(f"chain_id in genesis doc is too long (max: {MAX_CHAIN_ID_LEN})")
        if self.initial_height < 0:
            raise ValueError("initial_height cannot be negative")
        if self.initial_height == 0:
            self.initial_height = 1
        self.consensus_params.validate_basic()
        for i, v in enumerate(self.validators):
            if v.power == 0:
                raise ValueError(f"the genesis file cannot contain validators with no voting power: {i}")
            if v.address and v.pub_key.address() != v.address:
                raise ValueError(f"incorrect address for validator {i}")

    def validator_hash(self) -> bytes:
        from tendermint_tpu_torch.types.validator_set import ValidatorSet

        vs = ValidatorSet([Validator(v.pub_key, v.power) for v in self.validators])
        return vs.hash()

    def to_json(self) -> str:
        return json.dumps(
            {
                "genesis_time_ns": self.genesis_time_ns,
                "chain_id": self.chain_id,
                "initial_height": str(self.initial_height),
                "consensus_params": {
                    "block": {
                        "max_bytes": str(self.consensus_params.block.max_bytes),
                        "max_gas": str(self.consensus_params.block.max_gas),
                    },
                    "evidence": {
                        "max_age_num_blocks": str(self.consensus_params.evidence.max_age_num_blocks),
                        "max_age_duration_ns": str(self.consensus_params.evidence.max_age_duration_ns),
                        "max_bytes": str(self.consensus_params.evidence.max_bytes),
                    },
                    "validator": {
                        "pub_key_types": list(self.consensus_params.validator.pub_key_types)
                    },
                },
                "validators": [
                    {
                        "address": v.address.hex().upper(),
                        "pub_key": {
                            "type": v.pub_key.type_name(),
                            "value": v.pub_key.bytes().hex(),
                        },
                        "power": str(v.power),
                        "name": v.name,
                    }
                    for v in self.validators
                ],
                "app_hash": self.app_hash.hex().upper(),
                "app_state": json.loads(self.app_state.decode("utf-8") or "{}"),
            },
            indent=2,
        )

    @classmethod
    def from_json(cls, data: str) -> "GenesisDoc":
        obj = json.loads(data)
        from tendermint_tpu_torch.types.params import (
            BlockParams,
            EvidenceParams,
            ValidatorParams,
        )

        cp = obj.get("consensus_params", {})
        params = ConsensusParams(
            block=BlockParams(
                max_bytes=int(cp.get("block", {}).get("max_bytes", 22020096)),
                max_gas=int(cp.get("block", {}).get("max_gas", -1)),
            ),
            evidence=EvidenceParams(
                max_age_num_blocks=int(cp.get("evidence", {}).get("max_age_num_blocks", 100000)),
                max_age_duration_ns=int(
                    cp.get("evidence", {}).get("max_age_duration_ns", 48 * 3600 * 10**9)
                ),
                max_bytes=int(cp.get("evidence", {}).get("max_bytes", 1048576)),
            ),
            validator=ValidatorParams(
                pub_key_types=tuple(cp.get("validator", {}).get("pub_key_types", ["ed25519"]))
            ),
        )
        validators = []
        for v in obj.get("validators", []):
            pk = pubkey_from_type_and_bytes(v["pub_key"]["type"], bytes.fromhex(v["pub_key"]["value"]))
            validators.append(
                GenesisValidator(pub_key=pk, power=int(v["power"]), name=v.get("name", ""))
            )
        doc = cls(
            chain_id=obj["chain_id"],
            genesis_time_ns=int(obj.get("genesis_time_ns", 0)),
            initial_height=int(obj.get("initial_height", 1)),
            consensus_params=params,
            validators=validators,
            app_hash=bytes.fromhex(obj.get("app_hash", "")),
            app_state=json.dumps(obj.get("app_state", {})).encode(),
        )
        doc.validate_and_complete()
        return doc

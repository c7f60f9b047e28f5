"""sm.State — the replicated-state value object (reference: state/state.go:48-81).

Immutable-ish: every mutation site produces a new State via dataclasses.replace.
Validator sets follow the H+2 rule: `validators` sign H, `next_validators`
sign H+1, `last_validators` signed H-1 (reference: state/state.go:63-65).

The port's copy of tendermint_tpu/state/sm_state.py, the same encodings byte for byte.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field, replace
from typing import Optional, Sequence

from tendermint_tpu_torch.crypto.keys import pubkey_from_type_and_bytes
from tendermint_tpu_torch.crypto.merkle import hash_from_byte_slices
from tendermint_tpu_torch.libs import protowire as pw
from tendermint_tpu_torch.types.basic import BlockID
from tendermint_tpu_torch.types.block import Block, Commit, ConsensusVersion, Header, txs_hash
from tendermint_tpu_torch.types.genesis import GenesisDoc
from tendermint_tpu_torch.types.params import ConsensusParams
from tendermint_tpu_torch.types.validator_set import Validator, ValidatorSet


def results_hash(deliver_tx_results: Sequence) -> bytes:
    """Deterministic hash of DeliverTx results (reference: types.NewResults().Hash(),
    Result{code, data} proto → merkle)."""
    items = []
    for r in deliver_tx_results:
        w = pw.Writer()
        w.varint_field(1, r.code)
        w.bytes_field(2, r.data)
        items.append(w.bytes())
    return hash_from_byte_slices(items)


def _valset_to_json(vs: Optional[ValidatorSet]) -> Optional[dict]:
    if vs is None:
        return None
    return {
        "validators": [
            {
                "pub_key_type": v.pub_key.type_name(),
                "pub_key": v.pub_key.bytes().hex(),
                "power": v.voting_power,
                "priority": v.proposer_priority,
            }
            for v in vs.validators
        ],
        "proposer": vs.proposer.address.hex() if vs.proposer else None,
    }


def _valset_from_json(obj: Optional[dict]) -> Optional[ValidatorSet]:
    if obj is None:
        return None
    vals = [
        Validator(
            pubkey_from_type_and_bytes(v["pub_key_type"], bytes.fromhex(v["pub_key"])),
            v["power"],
            proposer_priority=v["priority"],
        )
        for v in obj["validators"]
    ]
    vs = ValidatorSet(vals)
    if obj.get("proposer"):
        addr = bytes.fromhex(obj["proposer"])
        _, val = vs.get_by_address(addr)
        if val is not None:
            vs.proposer = val
    return vs


@dataclass(frozen=True)
class State:
    chain_id: str
    initial_height: int
    last_block_height: int
    last_block_id: BlockID
    last_block_time_ns: int
    next_validators: Optional[ValidatorSet]
    validators: Optional[ValidatorSet]
    last_validators: Optional[ValidatorSet]
    last_height_validators_changed: int
    consensus_params: ConsensusParams
    last_height_consensus_params_changed: int
    last_results_hash: bytes
    app_hash: bytes
    version: ConsensusVersion = field(default_factory=ConsensusVersion)

    def copy(self) -> "State":
        return replace(
            self,
            validators=self.validators.copy() if self.validators else None,
            next_validators=self.next_validators.copy() if self.next_validators else None,
            last_validators=self.last_validators.copy() if self.last_validators else None,
        )

    def is_empty(self) -> bool:
        return self.validators is None

    def make_block(
        self,
        height: int,
        txs: Sequence[bytes],
        last_commit: Commit,
        evidence: Sequence,
        proposer_address: bytes,
        time_ns: int,
    ) -> Block:
        """(reference: state/state.go MakeBlock)"""
        ev_hash = hash_from_byte_slices([e.hash() for e in evidence])
        header = Header(
            version=self.version,
            chain_id=self.chain_id,
            height=height,
            time_ns=time_ns,
            last_block_id=self.last_block_id,
            last_commit_hash=last_commit.hash(),
            data_hash=txs_hash(txs),
            validators_hash=self.validators.hash(),
            next_validators_hash=self.next_validators.hash(),
            consensus_hash=self.consensus_params.hash(),
            app_hash=self.app_hash,
            last_results_hash=self.last_results_hash,
            evidence_hash=ev_hash,
            proposer_address=proposer_address,
        )
        return Block(header, tuple(txs), tuple(evidence), last_commit)

    # -- persistence --------------------------------------------------------

    def to_json(self) -> str:
        return json.dumps(
            {
                "chain_id": self.chain_id,
                "initial_height": self.initial_height,
                "last_block_height": self.last_block_height,
                "last_block_id": {
                    "hash": self.last_block_id.hash.hex(),
                    "total": self.last_block_id.part_set_header.total,
                    "psh_hash": self.last_block_id.part_set_header.hash.hex(),
                },
                "last_block_time_ns": self.last_block_time_ns,
                "next_validators": _valset_to_json(self.next_validators),
                "validators": _valset_to_json(self.validators),
                "last_validators": _valset_to_json(self.last_validators),
                "last_height_validators_changed": self.last_height_validators_changed,
                "consensus_params": {
                    "block_max_bytes": self.consensus_params.block.max_bytes,
                    "block_max_gas": self.consensus_params.block.max_gas,
                    "evidence_max_age_num_blocks": self.consensus_params.evidence.max_age_num_blocks,
                    "evidence_max_age_duration_ns": self.consensus_params.evidence.max_age_duration_ns,
                    "evidence_max_bytes": self.consensus_params.evidence.max_bytes,
                    "pub_key_types": list(self.consensus_params.validator.pub_key_types),
                    "app_version": self.consensus_params.version.app_version,
                },
                "last_height_consensus_params_changed": self.last_height_consensus_params_changed,
                "last_results_hash": self.last_results_hash.hex(),
                "app_hash": self.app_hash.hex(),
                "version_block": self.version.block,
                "version_app": self.version.app,
            }
        )

    @classmethod
    def from_json(cls, data: str) -> "State":
        from tendermint_tpu_torch.types.basic import PartSetHeader
        from tendermint_tpu_torch.types.params import (
            BlockParams,
            EvidenceParams,
            ValidatorParams,
            VersionParams,
        )

        o = json.loads(data)
        bid = o["last_block_id"]
        return cls(
            chain_id=o["chain_id"],
            initial_height=o["initial_height"],
            last_block_height=o["last_block_height"],
            last_block_id=BlockID(
                bytes.fromhex(bid["hash"]),
                PartSetHeader(bid["total"], bytes.fromhex(bid["psh_hash"])),
            ),
            last_block_time_ns=o["last_block_time_ns"],
            next_validators=_valset_from_json(o["next_validators"]),
            validators=_valset_from_json(o["validators"]),
            last_validators=_valset_from_json(o["last_validators"]),
            last_height_validators_changed=o["last_height_validators_changed"],
            consensus_params=ConsensusParams(
                block=BlockParams(o["consensus_params"]["block_max_bytes"], o["consensus_params"]["block_max_gas"]),
                evidence=EvidenceParams(
                    o["consensus_params"]["evidence_max_age_num_blocks"],
                    o["consensus_params"]["evidence_max_age_duration_ns"],
                    o["consensus_params"]["evidence_max_bytes"],
                ),
                validator=ValidatorParams(tuple(o["consensus_params"]["pub_key_types"])),
                version=VersionParams(o["consensus_params"]["app_version"]),
            ),
            last_height_consensus_params_changed=o["last_height_consensus_params_changed"],
            last_results_hash=bytes.fromhex(o["last_results_hash"]),
            app_hash=bytes.fromhex(o["app_hash"]),
            version=ConsensusVersion(o["version_block"], o["version_app"]),
        )


def state_from_genesis(gen: GenesisDoc) -> State:
    """(reference: state/state.go MakeGenesisState)"""
    validators = ValidatorSet([Validator(v.pub_key, v.power) for v in gen.validators]) if gen.validators else None
    next_validators = validators.copy_increment_proposer_priority(1) if validators else None
    return State(
        chain_id=gen.chain_id,
        initial_height=gen.initial_height,
        last_block_height=0,
        last_block_id=BlockID(),
        last_block_time_ns=gen.genesis_time_ns,
        next_validators=next_validators,
        validators=validators,
        last_validators=None,
        last_height_validators_changed=gen.initial_height,
        consensus_params=gen.consensus_params,
        last_height_consensus_params_changed=gen.initial_height,
        last_results_hash=b"",
        app_hash=gen.app_hash,
    )

"""ConsensusParams (reference: types/params.go) — chain-level parameters the
app can adjust at runtime via EndBlock.

The port's copy of tendermint_tpu/types/params.py, the same encodings byte for byte.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from tendermint_tpu_torch.crypto import tmhash
from tendermint_tpu_torch.libs import protowire as pw

MAX_BLOCK_SIZE_BYTES = 104857600  # 100MB


@dataclass(frozen=True)
class BlockParams:
    max_bytes: int = 22020096  # 21MB (reference default)
    max_gas: int = -1

    def encode(self) -> bytes:
        w = pw.Writer()
        w.varint_field(1, self.max_bytes)
        w.varint_field(2, self.max_gas)
        return w.bytes()


@dataclass(frozen=True)
class EvidenceParams:
    max_age_num_blocks: int = 100000
    max_age_duration_ns: int = 48 * 3600 * 1_000_000_000
    max_bytes: int = 1048576

    def encode(self) -> bytes:
        w = pw.Writer()
        w.varint_field(1, self.max_age_num_blocks)
        # duration message: seconds(1), nanos(2)
        sec, nanos = divmod(self.max_age_duration_ns, 1_000_000_000)
        d = pw.Writer()
        d.varint_field(1, sec)
        d.varint_field(2, nanos)
        w.message_field(2, d.bytes(), always=True)
        w.varint_field(3, self.max_bytes)
        return w.bytes()


@dataclass(frozen=True)
class ValidatorParams:
    pub_key_types: tuple = ("ed25519",)

    def encode(self) -> bytes:
        w = pw.Writer()
        for t in self.pub_key_types:
            w.string_field(1, t, emit_empty=True)
        return w.bytes()


@dataclass(frozen=True)
class VersionParams:
    app_version: int = 0

    def encode(self) -> bytes:
        w = pw.Writer()
        w.varint_field(1, self.app_version)
        return w.bytes()


@dataclass(frozen=True)
class ConsensusParams:
    block: BlockParams = field(default_factory=BlockParams)
    evidence: EvidenceParams = field(default_factory=EvidenceParams)
    validator: ValidatorParams = field(default_factory=ValidatorParams)
    version: VersionParams = field(default_factory=VersionParams)

    def hash(self) -> bytes:
        """Hash of the subset (block+evidence) the reference hashes
        (reference: types/params.go HashConsensusParams)."""
        w = pw.Writer()
        w.varint_field(1, self.block.max_bytes)
        w.varint_field(2, self.block.max_gas)
        w.varint_field(3, self.evidence.max_age_num_blocks)
        w.varint_field(4, self.evidence.max_age_duration_ns)
        return tmhash.sum256(w.bytes())

    def validate_basic(self) -> None:
        if self.block.max_bytes <= 0 or self.block.max_bytes > MAX_BLOCK_SIZE_BYTES:
            raise ValueError("block.MaxBytes out of range")
        if self.block.max_gas < -1:
            raise ValueError("block.MaxGas must be >= -1")
        if self.evidence.max_age_num_blocks <= 0:
            raise ValueError("evidence.MaxAgeNumBlocks must be positive")
        if self.evidence.max_age_duration_ns <= 0:
            raise ValueError("evidence.MaxAgeDuration must be positive")
        if not self.validator.pub_key_types:
            raise ValueError("len(validator.PubKeyTypes) must be > 0")

    def update(self, block=None, evidence=None, validator=None, version=None) -> "ConsensusParams":
        return ConsensusParams(
            block=block or self.block,
            evidence=evidence or self.evidence,
            validator=validator or self.validator,
            version=version or self.version,
        )


DEFAULT_CONSENSUS_PARAMS = ConsensusParams()

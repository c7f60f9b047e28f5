"""Validator and ValidatorSet with batched and aggregate commit verification.

The verify_commit and verify_aggregate_commit parts of
tendermint_tpu/types/validator_set.py. verify_commit (reference
types/validator_set.go:662-714): the reference's serial per-validator verify
loop becomes one crypto.batch.verify_batch flush on the card, with each
row's key type, so BLS rows of a plain Commit are verified on the host.
verify_aggregate_commit: one BLS pairing check against a signer bitmap, with
the aggregate-pubkey fold (ops/bls12_torch.py) and the Miller loop
(ops/pairing_torch.py) on the card; decoding, hash_to_g2 and the final
exponentiation stay on the host (crypto/bls_ref.py). Same errors and messages
as the JAX package. Proposer selection and set updates are not part of the
port yet.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from tendermint_tpu_torch.crypto.batch import verify_batch
from tendermint_tpu_torch.crypto.keys import Bls12381PubKey, Ed25519PubKey

INT64_MAX = 2**63 - 1


class CommitVerifyError(Exception):
    pass


class NotEnoughVotingPowerError(CommitVerifyError):
    def __init__(self, got: int, needed: int):
        super().__init__(
            f"invalid commit -- insufficient voting power: got {got}, needed more than {needed}"
        )
        self.got = got
        self.needed = needed


def _clip64(x: int) -> int:
    return max(-(2**63), min(INT64_MAX, x))


@dataclass
class Validator:
    pub_key: Union[Ed25519PubKey, Bls12381PubKey]
    voting_power: int
    address: bytes = b""

    def __post_init__(self):
        if not self.address:
            self.address = self.pub_key.address()


class ValidatorSet:
    """Validators sorted by descending voting power, ties by ascending address
    (reference: types/validator_set.go ValidatorsByVotingPower)."""

    def __init__(self, validators: Sequence[Validator]):
        self.validators: List[Validator] = sorted(
            (Validator(v.pub_key, v.voting_power, v.address) for v in validators),
            key=lambda v: (-v.voting_power, v.address),
        )
        if len({v.address for v in self.validators}) != len(self.validators):
            raise ValueError("duplicate validator address")
        self._total_voting_power: Optional[int] = None

    def size(self) -> int:
        return len(self.validators)

    def total_voting_power(self) -> int:
        if self._total_voting_power is None:
            tot = 0
            for v in self.validators:
                tot = _clip64(tot + v.voting_power)
            self._total_voting_power = tot
        return self._total_voting_power

    def verify_commit(self, chain_id: str, block_id, height: int, commit, device=None) -> None:
        """All signatures checked; +2/3 must be for the block."""
        if self.size() != len(commit.signatures):
            raise CommitVerifyError(
                f"invalid commit -- wrong set size: {self.size()} vs {len(commit.signatures)}"
            )
        if height != commit.height:
            raise CommitVerifyError(f"invalid commit -- wrong height: {height} vs {commit.height}")
        if block_id != commit.block_id:
            raise CommitVerifyError(
                f"invalid commit -- wrong block ID: want {block_id}, got {commit.block_id}"
            )
        pubkeys, sigs, meta, key_types, idxs = [], [], [], [], []
        for idx, cs in enumerate(commit.signatures):
            if cs.absent():
                continue
            val = self.validators[idx]
            pubkeys.append(val.pub_key.bytes())
            idxs.append(idx)
            sigs.append(cs.signature)
            meta.append((idx, val.voting_power, cs.for_block()))
            key_types.append(val.pub_key.type_name())
        msgs = commit.vote_sign_bytes_many(chain_id, idxs)
        mask = verify_batch(pubkeys, msgs, sigs, device=device, key_types=key_types)
        tallied = 0
        for ok, (idx, power, for_block) in zip(mask, meta):
            if not ok:
                raise CommitVerifyError(f"wrong signature (#{idx})")
            if for_block:
                tallied += power
        needed = self.total_voting_power() * 2 // 3
        if tallied <= needed:
            raise NotEnoughVotingPowerError(tallied, needed)

    def verify_aggregate_commit(self, chain_id: str, block_id, height: int, commit,
                                device=None) -> None:
        """One pairing check against one aggregate BLS signature and a signer
        bitmap (types/block.AggregateCommit); a plain Commit routes to
        verify_commit. The reference's checks in the reference's order:
        validate_basic, height, block ID, signer index range, each signer's
        key type and proof of possession, apk = the sum of the signers' keys
        (on the card), the signature's decode, e(-g1, sigma) e(apk, H(m)) == 1
        (Miller loop on the card, final exponentiation on the host), then
        signer power > 2/3 of the total. Raises CommitVerifyError /
        NotEnoughVotingPowerError (ValueError from validate_basic).
        Each call's stage times go to LAST_AGGREGATE."""
        from tendermint_tpu_torch.crypto import bls_ref
        from tendermint_tpu_torch.crypto.keys import pop_verified
        from tendermint_tpu_torch.ops import bls12_torch, pairing_torch
        from tendermint_tpu_torch.types.block import AggregateCommit

        if not isinstance(commit, AggregateCommit):
            return self.verify_commit(chain_id, block_id, height, commit, device=device)
        commit.validate_basic()
        if height != commit.height:
            raise CommitVerifyError(
                f"invalid commit -- wrong height: {height} vs {commit.height}"
            )
        if block_id != commit.block_id:
            raise CommitVerifyError(
                f"invalid commit -- wrong block ID: want {block_id}, got {commit.block_id}"
            )
        idxs = commit.signer_indices()
        if idxs and idxs[-1] >= self.size():
            raise CommitVerifyError(
                f"invalid commit -- signer index {idxs[-1]} out of range ({self.size()} validators)"
            )
        stages = LAST_AGGREGATE
        stages.clear()
        t0 = time.perf_counter()
        limbs, powers = [], []
        for i in idxs:
            val = self.validators[i]
            if val.pub_key.type_name() != "bls12_381":
                raise CommitVerifyError(
                    f"invalid commit -- validator #{i} is {val.pub_key.type_name()}, "
                    "cannot join a BLS aggregate"
                )
            if not pop_verified(val.pub_key.bytes()):
                raise CommitVerifyError(
                    f"invalid commit -- validator #{i} has no verified proof of "
                    "possession (rogue-key defense)"
                )
            limbs.append(_bls_pubkey_entry(val.pub_key.bytes())[1])
            powers.append(val.voting_power)
        t1 = time.perf_counter()
        apk = bls12_torch.fold_points(np.stack(limbs, axis=-1), device)
        t2 = time.perf_counter()
        stages.update(signers=len(idxs), keys_s=t1 - t0, fold_s=t2 - t1, apk=apk)
        if apk is None:
            raise CommitVerifyError("invalid commit -- empty aggregate pubkey")
        sig = bls_ref.g2_from_bytes(commit.agg_signature)
        t3 = time.perf_counter()
        stages["sig_decode_s"] = t3 - t2
        if sig is None:
            raise CommitVerifyError("invalid commit -- malformed aggregate signature")
        apk_jac = (bls_ref._G1Field(apk[0]), bls_ref._G1Field(apk[1]), bls_ref._G1Field(1))
        h = bls_ref.hash_to_g2(commit.sign_bytes(chain_id))
        t4 = time.perf_counter()
        pairs = [(bls_ref._jac_neg(bls_ref.G1_GEN), sig), (apk_jac, h)]
        f = pairing_torch.miller_product(pairs, device)
        t5 = time.perf_counter()
        ok = bls_ref.final_exponentiation(f).is_one()
        t6 = time.perf_counter()
        stages.update(hash_to_g2_s=t4 - t3, miller_s=t5 - t4, final_exp_s=t6 - t5, pairs=pairs,
                      pairing_ok=ok)
        if not ok:
            raise CommitVerifyError("invalid commit -- aggregate signature mismatch")
        tallied = sum(powers)
        needed = self.total_voting_power() * 2 // 3
        if tallied <= needed:
            raise NotEnoughVotingPowerError(tallied, needed)


# Stage times (s) of the last verify_aggregate_commit that reached the fold:
# keys_s (signer checks and key lookups), fold_s, sig_decode_s, hash_to_g2_s,
# miller_s, final_exp_s; with the signer count, apk, the pairs and the
# pairing verdict. Process-global, last call wins.
LAST_AGGREGATE: dict = {}

# Decompressed BLS pubkeys: consensus re-verifies the same set every height,
# and the 48-byte decode (a field sqrt and a subgroup check) is the per-key
# host cost worth amortizing. Each entry holds the affine ints and their
# Montgomery limbs (2, 33), so a warm call converts nothing.
_BLS_COORD_CACHE: Dict[bytes, Tuple[Tuple[int, int], np.ndarray]] = {}


def _bls_pubkey_coords(pk_bytes: bytes) -> Tuple[int, int]:
    return _bls_pubkey_entry(pk_bytes)[0]


def _bls_pubkey_entry(pk_bytes: bytes):
    got = _BLS_COORD_CACHE.get(pk_bytes)
    if got is not None:
        return got
    from tendermint_tpu_torch.crypto import bls_ref
    from tendermint_tpu_torch.ops import fp381

    pt = bls_ref.g1_from_bytes(pk_bytes)
    if pt is None:
        raise CommitVerifyError("invalid bls12_381 pubkey in validator set")
    aff = bls_ref._jac_to_affine(pt)
    xy = (aff[0].v, aff[1].v)
    got = (xy, np.stack([fp381.mont_from_int(xy[0]), fp381.mont_from_int(xy[1])]))
    if len(_BLS_COORD_CACHE) < 1 << 20:
        _BLS_COORD_CACHE[bytes(pk_bytes)] = got
    return got

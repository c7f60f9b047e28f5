"""Validator and ValidatorSet with batched, light and aggregate commit
verification.

The port's copy of tendermint_tpu/types/validator_set.py. The set is
sorted by descending power, ties by ascending address; the proposer is
computed at construction (from the validators' priorities), and hash() is
the Merkle root of the SimpleValidator encodings, so a LightBlock's
validate_basic holds. increment_proposer_priority and
update_with_change_set follow the reference's weighted round robin and
updates (types/validator_set.go:113-247, :577-652), Go's truncating and
Euclidean divisions spelled out where Python's differ.

verify_commit (reference types/validator_set.go:662-714): the reference's
serial per-validator loop becomes one crypto.batch.verify_batch flush on
the card, with each row's key type, so BLS rows of a plain Commit are
verified on the host.

verify_commit_light / verify_commit_light_trusting and their begin_*
submit/finish forms (reference :719, :772): the for-block rows go to
crypto.batch.verify_batch_submit, and the finish tallies only the rows
that verified, as the JAX package does (it departs from Go, which stops at
the first bad signature): a commit with a bad row and enough power left
still passes.

verify_aggregate_commit: one BLS pairing check against a signer bitmap,
with the aggregate-pubkey fold (ops/bls12_torch.py) and the Miller loop
(ops/pairing_torch.py) on the card; decoding, hash_to_g2 and the final
exponentiation stay on the host (crypto/bls_ref.py). Same errors and
messages as the JAX package.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from fractions import Fraction  # noqa: F401  (the trust level type, as the reference's)
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from tendermint_tpu_torch.crypto import batch, tmhash
from tendermint_tpu_torch.crypto.batch import verify_batch
from tendermint_tpu_torch.crypto.keys import Bls12381PubKey, Ed25519PubKey
from tendermint_tpu_torch.crypto.merkle import hash_from_byte_slices
from tendermint_tpu_torch.libs import protowire as pw

INT64_MAX = 2**63 - 1
MAX_TOTAL_VOTING_POWER = INT64_MAX // 8
PRIORITY_WINDOW_SIZE_FACTOR = 2


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
    proposer_priority: int = 0

    def __post_init__(self):
        if not self.address:
            self.address = self.pub_key.address()

    def copy(self) -> "Validator":
        return Validator(self.pub_key, self.voting_power, self.address, self.proposer_priority)

    def validate_basic(self) -> None:
        if self.pub_key is None:
            raise ValueError("validator does not have a public key")
        if self.voting_power < 0:
            raise ValueError("validator has negative voting power")
        if len(self.address) != tmhash.TRUNCATED_SIZE:
            raise ValueError("validator address is the wrong size")

    def compare_proposer_priority(self, other: "Validator") -> "Validator":
        """Higher priority wins; a tie goes to the smaller address
        (reference: types/validator.go:64-84)."""
        if self.proposer_priority > other.proposer_priority:
            return self
        if self.proposer_priority < other.proposer_priority:
            return other
        if self.address < other.address:
            return self
        if self.address > other.address:
            return other
        raise ValueError("cannot compare identical validators")

    def simple_bytes(self) -> bytes:
        """The SimpleValidator proto encoding that ValidatorSet.hash merkles
        (reference: types/validator.go ToProto, types/validator_set.go Hash)."""
        field = {"ed25519": 1, "sr25519": 3, "bls12_381": 4}.get(self.pub_key.type_name())
        if field is None:
            raise ValueError(f"unsupported key type {self.pub_key.type_name()}")
        pk = pw.Writer()
        pk.bytes_field(field, self.pub_key.bytes())
        w = pw.Writer()
        w.message_field(1, pk.bytes(), always=True)
        w.varint_field(2, self.voting_power)
        return w.bytes()


class ValidatorSet:
    """Validators sorted by descending voting power, ties by ascending address
    (reference: types/validator_set.go ValidatorsByVotingPower), and the
    proposer."""

    def __init__(self, validators: Sequence[Validator], proposer: Optional[Validator] = None):
        self.validators: List[Validator] = sorted(
            (v.copy() for v in validators), key=lambda v: (-v.voting_power, v.address))
        self._total_voting_power: Optional[int] = None
        self._by_address: Dict[bytes, int] = {v.address: i for i, v in enumerate(self.validators)}
        if len(self._by_address) != len(self.validators):
            raise ValueError("duplicate validator address")
        self.proposer: Optional[Validator] = proposer
        if self.proposer is None and self.validators:
            self.proposer = self._compute_proposer()

    def __len__(self) -> int:
        return len(self.validators)

    def is_nil_or_empty(self) -> bool:
        return len(self.validators) == 0

    def has_address(self, address: bytes) -> bool:
        return address in self._by_address

    def get_by_address(self, address: bytes) -> Tuple[int, Optional[Validator]]:
        idx = self._by_address.get(address)
        if idx is None:
            return -1, None
        return idx, self.validators[idx]

    def get_by_index(self, index: int) -> Tuple[bytes, Optional[Validator]]:
        if index < 0 or index >= len(self.validators):
            return b"", None
        v = self.validators[index]
        return v.address, v

    def copy(self) -> "ValidatorSet":
        vs = ValidatorSet.__new__(ValidatorSet)
        vs.validators = [v.copy() for v in self.validators]
        vs._total_voting_power = self._total_voting_power
        vs._by_address = dict(self._by_address)
        vs.proposer = self.proposer.copy() if self.proposer else None
        return vs

    def validate_basic(self) -> None:
        if self.is_nil_or_empty():
            raise ValueError("validator set is nil or empty")
        for v in self.validators:
            v.validate_basic()
        if self.proposer is None:
            raise ValueError("proposer failed validate basic, error: nil validator")
        self.proposer.validate_basic()

    def hash(self) -> bytes:
        """Merkle root of the SimpleValidator encodings (reference:
        types/validator_set.go Hash)."""
        return hash_from_byte_slices([v.simple_bytes() for v in self.validators])

    def _compute_proposer(self) -> Validator:
        res = self.validators[0]
        for v in self.validators[1:]:
            res = res.compare_proposer_priority(v)
        return res

    def get_proposer(self) -> Validator:
        if not self.validators:
            raise ValueError("empty validator set")
        if self.proposer is None:
            self.proposer = self._compute_proposer()
        return self.proposer

    def size(self) -> int:
        return len(self.validators)

    def total_voting_power(self) -> int:
        if self._total_voting_power is None:
            tot = 0
            for v in self.validators:
                tot = _clip64(tot + v.voting_power)
            self._total_voting_power = tot
        return self._total_voting_power

    # -- proposer priorities (reference types/validator_set.go:113-247) -----

    def _compute_avg_proposer_priority(self) -> int:
        # Go's big.Int Div is Euclidean; for a positive divisor that is floor
        # division, as Python's //.
        return sum(v.proposer_priority for v in self.validators) // len(self.validators)

    def _shift_by_avg_proposer_priority(self) -> None:
        avg = self._compute_avg_proposer_priority()
        for v in self.validators:
            v.proposer_priority = _clip64(v.proposer_priority - avg)

    def rescale_priorities(self, diff_max: int) -> None:
        """Divide every priority by ceil(spread / diff_max) when the spread
        exceeds diff_max, truncating toward zero as Go's integer division."""
        if diff_max <= 0:
            return
        prios = [v.proposer_priority for v in self.validators]
        diff = abs(max(prios) - min(prios))
        ratio = (diff + diff_max - 1) // diff_max
        if diff > diff_max:
            for v in self.validators:
                p = v.proposer_priority
                v.proposer_priority = -((-p) // ratio) if p < 0 else p // ratio

    def _increment_proposer_priority(self) -> Validator:
        for v in self.validators:
            v.proposer_priority = _clip64(v.proposer_priority + v.voting_power)
        mostest = self._compute_proposer()
        mostest.proposer_priority = _clip64(mostest.proposer_priority - self.total_voting_power())
        return mostest

    def increment_proposer_priority(self, times: int) -> None:
        """Rescale, centre, then `times` rounds of the weighted round robin;
        the last round's winner is the proposer (reference
        types/validator_set.go:116-138)."""
        if self.is_nil_or_empty():
            raise ValueError("empty validator set")
        if times <= 0:
            raise ValueError("cannot call IncrementProposerPriority with non-positive times")
        self.rescale_priorities(PRIORITY_WINDOW_SIZE_FACTOR * self.total_voting_power())
        self._shift_by_avg_proposer_priority()
        proposer = None
        for _ in range(times):
            proposer = self._increment_proposer_priority()
        self.proposer = proposer

    def copy_increment_proposer_priority(self, times: int) -> "ValidatorSet":
        c = self.copy()
        c.increment_proposer_priority(times)
        return c

    def update_with_change_set(self, changes: Sequence[Validator]) -> None:
        """Apply updates and removals (power 0 removes), as the reference's
        updateWithChangeSet (types/validator_set.go:577-652): the checks in
        its order, the new total bounded by MAX_TOTAL_VOTING_POWER before
        removals, a new validator's priority -1.125 x the new total, then
        rescale and centre. Raises ValueError and leaves the set as it was."""
        if not changes:
            return
        seen = set()
        updates: List[Validator] = []
        deletes: List[Validator] = []
        # copies: the priorities assigned below must not reach the caller's objects
        for c in sorted((c.copy() for c in changes), key=lambda v: v.address):
            if c.address in seen:
                raise ValueError(f"duplicate entry {c.address.hex()} in changes")
            seen.add(c.address)
            if c.voting_power < 0:
                raise ValueError("voting power can't be negative")
            if c.voting_power > MAX_TOTAL_VOTING_POWER:
                raise ValueError(
                    "to prevent clipping/overflow, voting power can't be higher than max")
            (deletes if c.voting_power == 0 else updates).append(c)
        for d in deletes:
            if d.address not in self._by_address:
                raise ValueError(f"failed to find validator {d.address.hex()} to remove")
        new_total = self.total_voting_power()
        for u in updates:
            _, old = self.get_by_address(u.address)
            new_total += u.voting_power - (old.voting_power if old else 0)
            if new_total > MAX_TOTAL_VOTING_POWER:
                raise ValueError("total voting power of resulting valset exceeds max")
        for u in updates:
            _, old = self.get_by_address(u.address)
            u.proposer_priority = (-(new_total + (new_total >> 3)) if old is None
                                   else old.proposer_priority)
        by_addr = {v.address: v for v in self.validators}
        for u in updates:
            by_addr[u.address] = u.copy()
        for d in deletes:
            by_addr.pop(d.address, None)
        if not by_addr:
            raise ValueError("applying the validator changes would result in empty set")
        self.validators = sorted(by_addr.values(), key=lambda v: (-v.voting_power, v.address))
        self._by_address = {v.address: i for i, v in enumerate(self.validators)}
        self._total_voting_power = None
        self.rescale_priorities(PRIORITY_WINDOW_SIZE_FACTOR * self.total_voting_power())
        self._shift_by_avg_proposer_priority()
        if self.proposer is not None and self.proposer.address in self._by_address:
            self.proposer = self.validators[self._by_address[self.proposer.address]]
        elif self.validators:
            self.proposer = self._compute_proposer()

    # -- commit verification -------------------------------------------------

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

    def begin_verify_commit_light(self, chain_id: str, block_id, height: int, commit,
                                  device=None):
        """The submit half of verify_commit_light: the structural checks and
        a verify_batch_submit of the for-block rows on `device`; returns a
        finish() that syncs, tallies the rows that verified and raises
        NotEnoughVotingPowerError at or below 2/3 of the power. Several
        begins before their finishes put their flushes on the card together
        (light/verifier.py does so with the trusting and light checks)."""
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
        idxs = [idx for idx, cs in enumerate(commit.signatures) if cs.for_block()]
        vals = [self.validators[idx] for idx in idxs]
        handle = _submit_rows(chain_id, commit, idxs, vals, device)
        powers = [v.voting_power for v in vals]

        def finish() -> None:
            mask = batch.verify_batch_finish(handle)
            tallied = sum(p for ok, p in zip(mask, powers) if ok)
            needed = self.total_voting_power() * 2 // 3
            if tallied <= needed:
                raise NotEnoughVotingPowerError(tallied, needed)

        return finish

    def verify_commit_light(self, chain_id: str, block_id, height: int, commit,
                            device=None) -> None:
        """Only the for-block signatures, in one flush; the power of those
        that verified must exceed 2/3 (reference: types/validator_set.go:719-763)."""
        self.begin_verify_commit_light(chain_id, block_id, height, commit, device=device)()

    def begin_verify_commit_light_trusting(self, chain_id: str, commit, trust_level,
                                           device=None):
        """The submit half of verify_commit_light_trusting (see
        begin_verify_commit_light): each for-block signature is looked up by
        address in this (trusted) set, unknown addresses are skipped, a
        validator seen twice raises, and the finish fails at or below
        total * numerator // denominator of the power."""
        if trust_level.denominator == 0:
            raise CommitVerifyError("trustLevel has zero Denominator")
        needed = self.total_voting_power() * trust_level.numerator // trust_level.denominator
        seen: Dict[int, int] = {}
        idxs, vals = [], []
        for idx, cs in enumerate(commit.signatures):
            if not cs.for_block():
                continue
            val_idx, val = self.get_by_address(cs.validator_address)
            if val is None:
                continue
            if val_idx in seen:
                raise CommitVerifyError(
                    f"double vote from {val.address.hex()} ({seen[val_idx]} and {idx})"
                )
            seen[val_idx] = idx
            idxs.append(idx)
            vals.append(val)
        handle = _submit_rows(chain_id, commit, idxs, vals, device)
        powers = [v.voting_power for v in vals]

        def finish() -> None:
            mask = batch.verify_batch_finish(handle)
            tallied = sum(p for ok, p in zip(mask, powers) if ok)
            if tallied <= needed:
                raise NotEnoughVotingPowerError(tallied, needed)

        return finish

    def verify_commit_light_trusting(self, chain_id: str, commit, trust_level,
                                     device=None) -> None:
        """Trust-level verification against a possibly different validator
        set (reference: types/validator_set.go:772-830)."""
        self.begin_verify_commit_light_trusting(chain_id, commit, trust_level, device=device)()

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
        Before the fold, the signers count as bls12_381 rows
        (record_backend_rows) and set the aggregate_size gauge, as in the
        reference. Each call's stage times go to LAST_AGGREGATE."""
        from tendermint_tpu_torch.crypto import bls_ref
        from tendermint_tpu_torch.crypto.batch import record_backend_rows
        from tendermint_tpu_torch.libs.metrics import batch_metrics
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
        record_backend_rows("bls12_381", len(idxs))
        batch_metrics().aggregate_size.set(len(idxs))
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


def _submit_rows(chain_id: str, commit, idxs, vals, device):
    """verify_batch_submit of commit rows `idxs`, signed by `vals`."""
    return batch.verify_batch_submit(
        [v.pub_key.bytes() for v in vals], commit.vote_sign_bytes_many(chain_id, idxs),
        [commit.signatures[i].signature for i in idxs], device=device,
        key_types=[v.pub_key.type_name() for v in vals])


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

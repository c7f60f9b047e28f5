"""Evidence pool (reference: evidence/pool.go:26).

Stores pending DuplicateVoteEvidence in the db, verifies on add
(age by height+time vs ConsensusParams.Evidence, validator membership, the two
conflicting sigs — reference: evidence/verify.go:15), marks committed on
update, and serves PendingEvidence for proposals.

The port's copy of tendermint_tpu/evidence/pool.py, the same encodings byte for byte.
"""

from __future__ import annotations

import struct
import threading
from typing import List, Optional

from tendermint_tpu_torch.libs.kvdb import KVDB
from tendermint_tpu_torch.state.sm_state import State
from tendermint_tpu_torch.types.evidence import DuplicateVoteEvidence, decode_evidence


class EvidenceError(Exception):
    pass


class EvidenceWindowError(EvidenceError):
    """Evidence outside this node's acceptance window (expired, or the
    validator set at its height is no longer stored). NOT peer misconduct:
    an honest peer whose state lags/leads ours can legitimately offer it
    (a gossip layer must not score these against the sender)."""


def _pending_key(ev) -> bytes:
    return b"EV:pending:" + struct.pack(">q", ev.height) + ev.hash()


def _committed_key(ev) -> bytes:
    return b"EV:committed:" + struct.pack(">q", ev.height) + ev.hash()


class EvidencePool:
    def __init__(self, db: KVDB, state_store, block_store):
        self.db = db
        self.state_store = state_store
        self.block_store = block_store
        self._state: Optional[State] = None
        # gossiped adds may run on executor threads (so the catch-up-lane
        # verify never parks the event loop) while update() runs on the loop
        # at commit: the check-then-set in add_evidence must not interleave
        # with the committed-marking, or just-committed evidence re-enters
        # pending and gets proposed again (rejected by every honest peer)
        self._mut_lock = threading.Lock()

    def set_state(self, state: State) -> None:
        self._state = state

    # -- queries ------------------------------------------------------------

    def pending_evidence(self, max_bytes: int) -> List[DuplicateVoteEvidence]:
        out: List[DuplicateVoteEvidence] = []
        size = 0
        for _, raw in self.db.iterate_prefix(b"EV:pending:"):
            ev = decode_evidence(raw)
            size += len(raw)
            if max_bytes >= 0 and size > max_bytes:
                break
            out.append(ev)
        return out

    def is_committed(self, ev) -> bool:
        return self.db.has(_committed_key(ev))

    def is_pending(self, ev) -> bool:
        return self.db.has(_pending_key(ev))

    # -- verification -------------------------------------------------------

    def _is_expired(self, state: State, height: int, time_ns: int) -> bool:
        """(reference: evidence/pool.go isExpired)"""
        params = state.consensus_params.evidence
        age_blocks = state.last_block_height - height
        age_ns = state.last_block_time_ns - time_ns
        return age_blocks > params.max_age_num_blocks and age_ns > params.max_age_duration_ns

    @staticmethod
    def _catchup_verifier():
        """The global scheduler's catch-up lane as an evidence signature
        verifier (crypto/scheduler.py), but only OFF the event loop
        (executor threads, replay threads): on the loop (live
        block validation in state/execution.py) a catch-up-lane wait would
        stall consensus, so those two signatures verify inline as before.
        Returns None when inline is the right answer."""
        import asyncio

        try:
            asyncio.get_running_loop()
            return None  # event-loop caller: latency-critical, stay inline
        except RuntimeError:
            pass
        from tendermint_tpu_torch.crypto import scheduler as _scheduler

        sched = _scheduler.default_scheduler()
        if sched is None:
            return None
        return lambda pk, msgs, sigs, kt: sched.verify_rows(
            "catchup", pk, msgs, sigs, kt
        )

    def check_evidence(self, state: State, ev) -> None:
        """Verify evidence against a given state (used by block validation)."""
        if not isinstance(ev, DuplicateVoteEvidence):
            raise EvidenceError(f"unknown evidence type {type(ev)}")
        if self.is_committed(ev):
            raise EvidenceError("evidence was already committed")
        ev.validate_basic()
        if self._is_expired(state, ev.height, ev.timestamp_ns):
            raise EvidenceWindowError("evidence is expired")
        vals = self.state_store.load_validators(ev.height)
        if vals is None:
            raise EvidenceWindowError(
                f"no validator set at evidence height {ev.height}"
            )
        _, val = vals.get_by_address(ev.address())
        if val is None:
            raise EvidenceError("validator in evidence is not in the validator set")
        ev.verify(state.chain_id, val.pub_key,
                  batch_verifier=self._catchup_verifier())
        # power consistency (reference: evidence/verify.go)
        if ev.validator_power != val.voting_power:
            raise EvidenceError(
                f"evidence validator power {ev.validator_power} != {val.voting_power}"
            )
        if ev.total_voting_power != vals.total_voting_power():
            raise EvidenceError("evidence total voting power mismatch")

    # -- mutations ----------------------------------------------------------

    def add_evidence(self, ev) -> None:
        """(reference: evidence/pool.go:118 AddEvidence)"""
        if self._state is None:
            raise EvidenceError("evidence pool has no state")
        if self.is_pending(ev) or self.is_committed(ev):
            return
        self.check_evidence(self._state, ev)
        with self._mut_lock:
            # re-check under the mutation lock: a block committing this
            # exact evidence may have landed while we verified it off-loop
            if self.is_committed(ev):
                return
            self.db.set(_pending_key(ev), ev.encode())

    def add_evidence_from_consensus(self, ev, time_ns: int, val_set) -> None:
        """Evidence discovered locally by consensus (conflicting votes)
        (reference: evidence/pool.go AddEvidenceFromConsensus).

        Consensus already verified the two vote signatures on intake, but the
        pool is the LAST gate before this evidence is gossiped, proposed, and
        committed — so it re-checks everything it can against the validator
        set consensus saw the conflict in: structural validity, expiry, set
        membership, and both conflicting signatures. A bug (or a corrupted
        intake path) upstream must surface HERE as a rejected add,
        not as an invalid-evidence block proposal that every honest peer
        rejects."""
        if not isinstance(ev, DuplicateVoteEvidence):
            raise EvidenceError(f"unknown evidence type {type(ev)}")
        if self.is_pending(ev) or self.is_committed(ev):
            return
        ev.validate_basic()
        if self._state is not None:
            if self._is_expired(self._state, ev.height, ev.timestamp_ns):
                raise EvidenceWindowError("evidence from consensus is already expired")
            if val_set is not None:
                _, val = val_set.get_by_address(ev.address())
                if val is None:
                    raise EvidenceError(
                        "evidence validator is not in the conflict's validator set"
                    )
                ev.verify(self._state.chain_id, val.pub_key,
                          batch_verifier=self._catchup_verifier())
        with self._mut_lock:
            if self.is_committed(ev):
                return
            self.db.set(_pending_key(ev), ev.encode())

    def update(self, state: State, committed_evidence) -> None:
        """Mark committed, drop expired (reference: evidence/pool.go:91)."""
        self._state = state
        with self._mut_lock:
            for ev in committed_evidence:
                self.db.set(_committed_key(ev), b"\x01")
                self.db.delete(_pending_key(ev))
        # prune expired pending
        deletes = []
        for key, raw in self.db.iterate_prefix(b"EV:pending:"):
            ev = decode_evidence(raw)
            if self._is_expired(state, ev.height, ev.timestamp_ns):
                deletes.append(key)
        if deletes:
            self.db.write_batch([], deletes)

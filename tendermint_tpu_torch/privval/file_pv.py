"""File-backed private validator with double-sign protection (reference
privval/file.go:150): the port's copy of tendermint_tpu/privval/file_pv.py.

Key file: JSON {address, pub_key, priv_key}. State file: JSON last-sign
state {height, round, step, signature, sign_bytes}. check_hrs refuses a
lower (H, R, S) and allows re-signing the identical payload; a vote or
proposal that differs only in its timestamp gets the previous signature and
timestamp back (reference privval/file.go:93 CheckHRS,
checkVotesOnlyDifferByTimestamp). The remote signer waits for the node
(ROADMAP A10).
"""

from __future__ import annotations

import json
import os
import tempfile
from dataclasses import replace
from typing import Optional, Tuple

from tendermint_tpu_torch.crypto.keys import Ed25519PrivKey, gen_ed25519
from tendermint_tpu_torch.libs import protowire as pw
from tendermint_tpu_torch.types.basic import SignedMsgType
from tendermint_tpu_torch.types.proposal import Proposal
from tendermint_tpu_torch.types.vote import Vote

STEP_PROPOSAL = 1
STEP_PREVOTE = 2
STEP_PRECOMMIT = 3

_STEP_FOR_TYPE = {
    SignedMsgType.PROPOSAL: STEP_PROPOSAL,
    SignedMsgType.PREVOTE: STEP_PREVOTE,
    SignedMsgType.PRECOMMIT: STEP_PRECOMMIT,
}


class DoubleSignError(Exception):
    pass


def _atomic_write(path: str, data: str) -> None:
    d = os.path.dirname(path) or "."
    fd, tmp = tempfile.mkstemp(dir=d)
    try:
        with os.fdopen(fd, "w") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


class FilePVLastSignState:
    def __init__(self, height=0, round_=0, step=0, signature=b"", sign_bytes=b""):
        self.height = height
        self.round = round_
        self.step = step
        self.signature = signature
        self.sign_bytes = sign_bytes

    def check_hrs(self, height: int, round_: int, step: int) -> bool:
        """Returns True if we might be re-signing the same HRS (caller must
        compare sign bytes); raises on regression (reference: privval/file.go:93)."""
        if self.height > height:
            raise DoubleSignError(f"height regression. Got {height}, last height {self.height}")
        if self.height == height:
            if self.round > round_:
                raise DoubleSignError(f"round regression at height {height}. Got {round_}, last round {self.round}")
            if self.round == round_:
                if self.step > step:
                    raise DoubleSignError(
                        f"step regression at height {height} round {round_}. Got {step}, last step {self.step}"
                    )
                if self.step == step:
                    if not self.sign_bytes:
                        raise DoubleSignError("no sign_bytes but HRS matches")
                    return True
        return False


class FilePV:
    """Implements the PrivValidator contract: get_pub_key / sign_vote /
    sign_proposal (reference: types/priv_validator.go)."""

    def __init__(self, priv_key, key_file: Optional[str] = None, state_file: Optional[str] = None):
        self.priv_key = priv_key
        self.key_file = key_file
        self.state_file = state_file
        self.last_sign_state = FilePVLastSignState()
        if state_file and os.path.exists(state_file):
            self._load_state()

    # -- persistence --------------------------------------------------------

    @classmethod
    def generate(cls, key_file: Optional[str] = None, state_file: Optional[str] = None, seed: Optional[bytes] = None) -> "FilePV":
        pv = cls(gen_ed25519(seed), key_file, state_file)
        if key_file:
            pv.save_key()
        if state_file:
            pv._save_state()
        return pv

    @classmethod
    def load(cls, key_file: str, state_file: str) -> "FilePV":
        with open(key_file) as f:
            o = json.load(f)
        priv = Ed25519PrivKey(bytes.fromhex(o["priv_key"]))
        return cls(priv, key_file, state_file)

    def save_key(self) -> None:
        pub = self.priv_key.pub_key()
        _atomic_write(
            self.key_file,
            json.dumps(
                {
                    "address": pub.address().hex().upper(),
                    "pub_key": pub.bytes().hex(),
                    "priv_key": self.priv_key.bytes().hex(),
                },
                indent=2,
            ),
        )

    def _save_state(self) -> None:
        s = self.last_sign_state
        _atomic_write(
            self.state_file,
            json.dumps(
                {
                    "height": s.height,
                    "round": s.round,
                    "step": s.step,
                    "signature": s.signature.hex(),
                    "sign_bytes": s.sign_bytes.hex(),
                },
                indent=2,
            ),
        )

    def _load_state(self) -> None:
        with open(self.state_file) as f:
            o = json.load(f)
        self.last_sign_state = FilePVLastSignState(
            o["height"], o["round"], o["step"], bytes.fromhex(o["signature"]), bytes.fromhex(o["sign_bytes"])
        )

    # -- PrivValidator interface --------------------------------------------

    def get_pub_key(self):
        return self.priv_key.pub_key()

    def sign_vote(self, chain_id: str, vote: Vote) -> Vote:
        """(reference: privval/file.go signVote)"""
        step = _STEP_FOR_TYPE[vote.type]
        lss = self.last_sign_state
        same_hrs = lss.check_hrs(vote.height, vote.round, step)
        sign_bytes = vote.sign_bytes(chain_id)

        if same_hrs:
            if sign_bytes == lss.sign_bytes:
                return vote.with_signature(lss.signature)
            ts = _vote_timestamp_swap(lss.sign_bytes, sign_bytes)
            if ts is not None:
                # votes differ only by timestamp: re-use previous signature
                return replace(vote, timestamp_ns=ts, signature=lss.signature)
            raise DoubleSignError("conflicting data: same HRS, different sign bytes")

        sig = self.priv_key.sign(sign_bytes)
        self._update_state(vote.height, vote.round, step, sign_bytes, sig)
        return vote.with_signature(sig)

    def sign_proposal(self, chain_id: str, proposal: Proposal) -> Proposal:
        lss = self.last_sign_state
        same_hrs = lss.check_hrs(proposal.height, proposal.round, STEP_PROPOSAL)
        sign_bytes = proposal.sign_bytes(chain_id)
        if same_hrs:
            if sign_bytes == lss.sign_bytes:
                return proposal.with_signature(lss.signature)
            ts = _proposal_timestamp_swap(lss.sign_bytes, sign_bytes)
            if ts is not None:
                return replace(proposal, timestamp_ns=ts, signature=lss.signature)
            raise DoubleSignError("conflicting data: same HRS, different sign bytes")
        sig = self.priv_key.sign(sign_bytes)
        self._update_state(proposal.height, proposal.round, STEP_PROPOSAL, sign_bytes, sig)
        return proposal.with_signature(sig)

    def _update_state(self, height: int, round_: int, step: int, sign_bytes: bytes, sig: bytes) -> None:
        self.last_sign_state = FilePVLastSignState(height, round_, step, sig, sign_bytes)
        if self.state_file:
            self._save_state()


def _strip_timestamp(sign_bytes: bytes, ts_field: int) -> Optional[Tuple[bytes, int]]:
    """Remove the timestamp field from canonical sign bytes; returns
    (bytes-without-timestamp, timestamp_ns)."""
    try:
        body, _ = pw.read_length_delimited(sign_bytes)
        out = pw.Writer()
        ts_ns = 0
        for f, wt, v in pw.Reader(body):
            if f == ts_field and wt == pw.BYTES:
                sec = nanos = 0
                for ff, _, vv in pw.Reader(v):
                    if ff == 1:
                        sec = pw.int64_from_varint(vv)
                    elif ff == 2:
                        nanos = pw.int64_from_varint(vv)
                ts_ns = sec * 1_000_000_000 + nanos
                continue
            if wt == pw.VARINT:
                out.varint_field(f, v)
            elif wt == pw.FIXED64:
                out.fixed64_field(f, v)
            elif wt == pw.BYTES:
                out.bytes_field(f, v, emit_empty=True)
        return out.bytes(), ts_ns
    except ValueError:
        return None


def _vote_timestamp_swap(last: bytes, new: bytes) -> Optional[int]:
    """If vote sign bytes differ only by timestamp (field 5), return the LAST
    timestamp (to re-sign identically); else None."""
    a = _strip_timestamp(last, 5)
    b = _strip_timestamp(new, 5)
    if a is None or b is None or a[0] != b[0]:
        return None
    return a[1]


def _proposal_timestamp_swap(last: bytes, new: bytes) -> Optional[int]:
    a = _strip_timestamp(last, 6)
    b = _strip_timestamp(new, 6)
    if a is None or b is None or a[0] != b[0]:
        return None
    return a[1]

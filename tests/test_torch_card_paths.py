"""The slice's paths on the card, held against the port's own host arm: a
deferred VoteSet flush of 512 precommits, the commit it makes answered from
the verified-row memo with no launch, DuplicateVoteEvidence checked by a
card flush, and blocksync's batched commit check over a run of 4 blocks x
128 validators, honest and with a block whose bad signatures leave 2/3 or
less of the power.

Every test needs a CUDA card and skips without one. The file imports
neither JAX nor the JAX package, so it also runs where JAX is not
installed, without tests/conftest.py (which imports JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_card_paths.py

Tolerance: zero. Masks, failed indices, commit bytes and returned indices
equal the host arm's.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tendermint_tpu_torch.blocksync.verify import verify_run_batched
from tendermint_tpu_torch.crypto import batch
from tendermint_tpu_torch.crypto import ed25519_ref as ref
from tendermint_tpu_torch.crypto.keys import Ed25519PubKey
from tendermint_tpu_torch.ops import cuda_fe, cuda_msm
from tendermint_tpu_torch.types.basic import BlockID, BlockIDFlag, PartSetHeader, SignedMsgType
from tendermint_tpu_torch.types.block import Commit, CommitSig
from tendermint_tpu_torch.types.evidence import DuplicateVoteEvidence
from tendermint_tpu_torch.types.validator_set import Validator, ValidatorSet
from tendermint_tpu_torch.types.vote import Vote
from tendermint_tpu_torch.types.vote_set import VoteSet

CHAIN = "card-paths"
KERNELS = ("padd", "pdbl", "fsquare_chain", "uptree", "fenwick_reduce", "bucket_fold")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _port_memo_off():
    """The verified-row memo off unless a test installs one."""
    prev, batch._MEMO = batch._MEMO, batch.VerifiedRowMemo(0)
    yield
    batch._MEMO = prev


def _launches() -> dict:
    return {**cuda_fe.LAUNCHES, **cuda_msm.LAUNCHES}


def _reset() -> None:
    cuda_fe.reset_launches()
    cuda_msm.reset_launches()


def _set(n: int, seed: int):
    rng = np.random.default_rng(seed)
    seeds = [rng.bytes(32) for _ in range(n)]
    vals = ValidatorSet([Validator(Ed25519PubKey(ref.public_key(s)), 10) for s in seeds])
    seed_of = {ref.public_key(s): s for s in seeds}
    return vals, [seed_of[v.pub_key.bytes()] for v in vals.validators], rng


def _precommits(vals, seeds, height, bid, bad=()):
    out = []
    for idx, v in enumerate(vals.validators):
        vote = Vote(SignedMsgType.PRECOMMIT, height, 0, bid, 1_000 * idx + height, v.address, idx)
        sig = ref.sign(seeds[idx], vote.sign_bytes(CHAIN))
        if idx in bad:
            sig = sig[:33] + bytes([sig[33] ^ 1]) + sig[34:]
        out.append(vote.with_signature(sig))
    return out


def _commit(votes, height, bid):
    return Commit(height, 0, bid, [CommitSig(BlockIDFlag.COMMIT, v.validator_address,
                                             v.timestamp_ns, v.signature) for v in votes])


@pytest.mark.cuda
def test_vote_flush_on_the_card_then_commit_from_the_memo(cuda_device):
    vals, seeds, rng = _set(512, 1)
    bid = BlockID(rng.bytes(32), PartSetHeader(1, rng.bytes(32)))
    votes = _precommits(vals, seeds, 3, bid, bad=(7, 300))
    out = {}
    for arm, device in (("cpu", None), ("cuda", cuda_device)):
        vs = VoteSet(CHAIN, 3, 0, SignedMsgType.PRECOMMIT, vals, defer_verification=True,
                     device=device, backend=arm)
        for v in votes:
            assert vs.add_vote(v) == "pending"
        _reset()
        committed, failed = vs.flush()
        out[arm] = ([v.encode() for v in committed], failed, vs.make_commit().encode(),
                    dict(batch.LAST_FLUSH), _launches())
    assert out["cuda"][:3] == out["cpu"][:3] and out["cuda"][1] == [7, 300]
    assert out["cpu"][3]["path"] == "cpu"
    # the 512-row combined check fails; its one bisection leaf is the ladder
    assert (out["cuda"][3]["path"], out["cuda"][3]["recovery_flushes"]) == ("persig", 1)
    assert all(out["cuda"][4][k] > 0 for k in KERNELS)
    batch._MEMO = batch.VerifiedRowMemo(4096)
    vs = VoteSet(CHAIN, 3, 0, SignedMsgType.PRECOMMIT, vals, defer_verification=True)
    for v in votes:
        vs.add_vote(v)
    vs.flush()
    commit = vs.make_commit()
    _reset()
    vals.verify_commit(CHAIN, bid, 3, commit)
    assert batch.LAST_FLUSH["path"] == "memo" and not any(_launches()[k] for k in KERNELS)


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["none", "a", "b"])
def test_duplicate_vote_evidence_on_the_card(cuda_device, bad):
    vals, seeds, rng = _set(1, 2)
    pk = vals.validators[0].pub_key
    bids = [BlockID(bytes([t]) * 32, PartSetHeader(1, bytes([t]) * 32)) for t in (4, 5)]
    a, b = (_precommits(vals, seeds, 9, bid)[0] for bid in bids)
    ev = DuplicateVoteEvidence.from_votes(a, b, 1, 10, 10)
    flip = {"a": "vote_a", "b": "vote_b"}.get(bad)
    if flip:
        v = getattr(ev, flip)
        ev = dataclasses.replace(ev, **{flip: v.with_signature(
            v.signature[:2] + bytes([v.signature[2] ^ 1]) + v.signature[3:])})

    def card(p, m, s, kt):
        return batch.verify_batch(p, m, s, device=cuda_device, key_types=kt, backend="cuda")

    def outcome(verifier):
        try:
            ev.verify(CHAIN, pk, batch_verifier=verifier)
        except ValueError as e:
            return str(e)
        return "ok"

    assert outcome(card) == outcome(None) == {
        "none": "ok", "a": "verifying VoteA: invalid signature",
        "b": "verifying VoteB: invalid signature"}[bad]


class _Block:
    """The two things verify_run_batched reads of a block: hash() and
    header.height; and last_commit for the block after it."""

    def __init__(self, height, h, last_commit=None):
        self.header = type("H", (), {"height": height})()
        self._h = h
        self.last_commit = last_commit

    def hash(self):
        return self._h


@pytest.mark.cuda
@pytest.mark.parametrize("tampered", [None, 2])
def test_run_check_on_the_card(cuda_device, tampered):
    """4 blocks x 128 validators, 512 rows: the card's combined check; 43
    bad signatures in block 2 (more than a third of the power)."""
    vals, seeds, rng = _set(128, 3)
    parts = [type("P", (), {"header": PartSetHeader(1, rng.bytes(32))})() for _ in range(4)]
    blocks = [_Block(h + 1, rng.bytes(32)) for h in range(4)]
    run = []
    for i, (first, ps) in enumerate(zip(blocks, parts)):
        bid = BlockID(first.hash(), ps.header)
        bad = range(0, 86, 2) if i == tampered else ()
        votes = _precommits(vals, seeds, first.header.height, bid, bad=bad)
        run.append((first, ps, _Block(first.header.height + 1, b"",
                                      _commit(votes, first.header.height, bid))))
    want = verify_run_batched(vals, CHAIN, run, backend="cpu")
    _reset()
    got = verify_run_batched(vals, CHAIN, run, device=cuda_device)
    assert got == want == tampered
    assert all(_launches()[k] > 0 for k in KERNELS)

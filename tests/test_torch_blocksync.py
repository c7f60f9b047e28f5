"""Blocksync's batched commit check and the types under it, in the port
(tendermint_tpu_torch/blocksync/verify.py, crypto/merkle.py Proof,
types/part_set.py, types/block.py Block) against the JAX package.

Chains are built in the reference from seeded keys, transactions and one
DuplicateVoteEvidence: each block's header carries the previous block's
ID, its last commit's hash, its data and evidence hashes; each block is
cut into parts (a small part size, so a block has several) and committed
by the set, and the commit rides in the next block. They cross into the
port as bytes (convert.block_from_reference). Checked: Merkle proofs and
their refusals, PartSet headers, add_part (a bad proof raises) and
assemble, Block hash, codec and validate_basic errors, and
verify_run_batched against the reference's
BlocksyncReactor._verify_run_batched on a good run, a run with a block
whose bad signatures leave 2/3 or less of the power, a wrong block ID, a
commit of the wrong size, absent and nil signatures, an empty run, a run
without a for-block signature and a mixed Ed25519 / sr25519 set. These
runs are under 256 rows, on both packages' host arms; one run of 576 rows
takes the port's card arm (backend="cuda", device="cpu": the kernels'
plain versions) against the reference's under its host twins, labels
compared. Tolerance: zero.
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from tendermint_tpu.blocksync.reactor import BlocksyncReactor
from tendermint_tpu.crypto import keys as jkeys
from tendermint_tpu.crypto import merkle as jmerkle
from tendermint_tpu.crypto import sr25519 as jsr
from tendermint_tpu.libs import trace as jtrace
from tendermint_tpu.types import basic as jbasic
from tendermint_tpu.types import block as jblock
from tendermint_tpu.types import evidence as jev
from tendermint_tpu.types import part_set as jparts
from tendermint_tpu.types import validator_set as jvs
from tendermint_tpu.types import vote as jvote
from tendermint_tpu_torch import convert
from tendermint_tpu_torch.blocksync.verify import verify_run_batched
from tendermint_tpu_torch.crypto import batch as tbatch
from tendermint_tpu_torch.crypto import merkle as tmerkle
from tendermint_tpu_torch.types import basic as tbasic
from tendermint_tpu_torch.types import block as tblock
from tendermint_tpu_torch.types import part_set as tparts
from tests.torch_routing_util import knobs  # noqa: F401  (fixture)

torch.set_num_threads(2)

CHAIN = "blocksync-chain"
T0 = 1_700_000_000_000_000_000
PART_SIZE = 512


@pytest.fixture(autouse=True)
def _port_memo_off():
    """The port's verified-row memo is off, as tests/conftest.py turns the
    reference's off: a row verified twice takes its route twice."""
    prev, tbatch._MEMO = tbatch._MEMO, tbatch.VerifiedRowMemo(0)
    yield
    tbatch._MEMO = prev


def _outcome(fn):
    try:
        out = fn()
    except Exception as e:  # compared by type name and message
        return type(e).__name__, str(e)
    return ("ok", out)


# ---------------------------------------------------------------------------
# Merkle proofs and part sets


@pytest.mark.parametrize("n", [0, 1, 2, 3, 5, 8, 13])
def test_proofs_match(n):
    rng = np.random.default_rng(n)
    items = [rng.bytes(int(rng.integers(0, 80))) for _ in range(n)]
    root, proofs = tmerkle.proofs_from_byte_slices(items)
    jroot, jproofs = jmerkle.proofs_from_byte_slices(items)
    assert root == jroot == tmerkle.hash_from_byte_slices(items)
    assert [dataclasses.astuple(p) for p in proofs] == [dataclasses.astuple(p) for p in jproofs]
    for i, p in enumerate(proofs):
        assert p.verify(root, items[i]) and p.compute_root_hash() == root
        assert not p.verify(root, items[i] + b"x")
        for bad in (dataclasses.replace(p, index=p.index + 1),
                    dataclasses.replace(p, total=p.total + 1),
                    dataclasses.replace(p, aunts=p.aunts + [root]),
                    dataclasses.replace(p, aunts=p.aunts[:-1])):
            jbad = jmerkle.Proof(bad.total, bad.index, bad.leaf_hash, list(bad.aunts))
            assert bad.compute_root_hash() == jbad.compute_root_hash()
            assert bad.verify(root, items[i]) is jbad.verify(root, items[i])


def test_part_set_matches():
    rng = np.random.default_rng(7)
    data = rng.bytes(5 * PART_SIZE + 77)
    ps = tparts.PartSet.from_data(data, PART_SIZE)
    jps = jparts.PartSet.from_data(data, PART_SIZE)
    assert (ps.header.total, ps.header.hash) == (jps.header.total, jps.header.hash)
    assert ps.total == 6
    assert ps.assemble() == data and ps.byte_size == len(data) and ps.is_complete()
    fresh = tparts.PartSet(ps.header)
    jfresh = jparts.PartSet(jps.header)
    for i in (3, 0, 5, 1, 4, 2):
        part = tparts.Part.decode(jps.get_part(i).encode())
        assert part.encode() == jps.get_part(i).encode()
        assert fresh.add_part(part) is jfresh.add_part(jps.get_part(i)) is True
        assert fresh.add_part(part) is False
        assert fresh.bit_array() == jfresh.bit_array() and fresh.count == jfresh.count
        if i != 2:
            assert _outcome(fresh.assemble) == _outcome(jfresh.assemble) == (
                "ValueError", "part set incomplete")
    assert fresh.assemble() == data
    other = tparts.PartSet.from_data(rng.bytes(6 * PART_SIZE), PART_SIZE)
    forged = other.get_part(2)
    for ps_, part, jpart in ((tparts.PartSet(ps.header), forged,
                              jparts.Part.decode(forged.encode())),
                             (tparts.PartSet(ps.header), dataclasses.replace(forged, index=7),
                              jparts.Part.decode(dataclasses.replace(forged, index=7).encode()))):
        got = _outcome(lambda: ps_.add_part(part))
        assert got == _outcome(lambda: jparts.PartSet(jps.header).add_part(jpart))
        assert got[0] == "ValueError"


# ---------------------------------------------------------------------------
# chains


def _keys(n, n_sr=0, seed=0):
    return [(jsr.gen_sr25519 if i >= n - n_sr else jkeys.gen_ed25519)(
        bytes([0x44, seed, i]) + bytes(29)) for i in range(n)]


def _valset(privs, rng):
    jset = jvs.ValidatorSet([jvs.Validator(p.pub_key(), int(rng.integers(5, 15)))
                             for p in privs])
    return jset, {p.pub_key().address(): p for p in privs}


def _commit(jset, priv_of, height, bid, flags=None):
    """The set's precommits for bid; flags[idx] is "absent", "nil" or "bad"
    (a flipped signature) for the rows it names."""
    flags = flags or {}
    sigs = []
    for idx, v in enumerate(jset.validators):
        f = flags.get(idx, "commit")
        if f == "absent":
            sigs.append(jblock.CommitSig.absent_sig())
            continue
        vote = jvote.Vote(jbasic.SignedMsgType.PRECOMMIT, height, 0,
                          jbasic.BlockID() if f == "nil" else bid, T0 + 1_000 * idx + height,
                          v.address, idx)
        sig = priv_of[v.address].sign(vote.sign_bytes(CHAIN))
        if f == "bad":
            sig = sig[:3] + bytes([sig[3] ^ 1]) + sig[4:]
        sigs.append(jblock.CommitSig(jbasic.BlockIDFlag.NIL if f == "nil" else
                                     jbasic.BlockIDFlag.COMMIT, v.address,
                                     T0 + 1_000 * idx + height, sig))
    return jblock.Commit(height, 0, bid, sigs)


def _evidence(privs, height):
    priv = privs[0]
    votes = [jvote.Vote(jbasic.SignedMsgType.PREVOTE, height, 0,
                        jbasic.BlockID(bytes([t]) * 32, jbasic.PartSetHeader(1, bytes([t]) * 32)),
                        T0, priv.pub_key().address(), 0) for t in (1, 2)]
    votes = [v.with_signature(priv.sign(v.sign_bytes(CHAIN))) for v in votes]
    return jev.DuplicateVoteEvidence.from_votes(*votes, T0, 100, 10)


def make_chain(jset, priv_of, n_blocks, seed=0, flags=None):
    """n_blocks + 1 reference blocks with their part sets; flags: {block
    index: commit flags} for the commit of that block (it rides in the
    next one)."""
    rng = np.random.default_rng(seed)
    privs = list(priv_of.values())
    flags = flags or {}
    out = []
    last_bid, last_commit = jbasic.BlockID(), jblock.EMPTY_COMMIT
    for i in range(n_blocks + 1):
        h = i + 1
        txs = [rng.bytes(int(rng.integers(1, 300))) for _ in range(int(rng.integers(0, 6)))]
        ev = (_evidence(privs, h),) if i == 1 else ()
        header = jblock.Header(
            jblock.ConsensusVersion(), CHAIN, h, T0 + h * 1_000_000_000, last_bid,
            last_commit.hash(), jblock.txs_hash(txs), jset.hash(), jset.hash(), b"\x01" * 32,
            b"\x02" * 32, b"\x03" * 32, jmerkle.hash_from_byte_slices([e.hash() for e in ev]),
            jset.validators[0].address)
        block = jblock.Block(header, txs, ev, last_commit)
        parts = jparts.PartSet.from_data(block.encode(), PART_SIZE)
        bid = jbasic.BlockID(block.hash(), parts.header)
        out.append((block, parts))
        last_bid, last_commit = bid, _commit(jset, priv_of, h, bid, flags.get(i))
    return out


def runs(chain, lo=0, hi=None):
    """(reference run of 4-tuples, port run of triples) over blocks lo..hi-1."""
    hi = len(chain) - 1 if hi is None else hi
    ref = [(chain[i][0], chain[i][1], chain[i + 1][0], b"") for i in range(lo, hi)]
    port = [(convert.block_from_reference(first), carry_parts(parts),
             convert.block_from_reference(second)) for first, parts, second, _ in ref]
    return ref, port


def carry_parts(jps):
    """A reference PartSet as the port's: its header, then each part's bytes
    through add_part (which checks every proof)."""
    ps = tparts.PartSet(tbasic.PartSetHeader(jps.header.total, jps.header.hash))
    for i in range(jps.total):
        assert ps.add_part(tparts.Part.decode(jps.get_part(i).encode()))
    return ps


def reference_index(jset, run):
    stub = SimpleNamespace(state=SimpleNamespace(validators=jset, chain_id=CHAIN),
                           metrics=None, scheduler=None)
    return BlocksyncReactor._verify_run_batched(stub, run)


def check(jset, chain_or_runs, **kw):
    ref, port = chain_or_runs if isinstance(chain_or_runs, tuple) else runs(chain_or_runs)
    tset = convert.validator_set_from_reference(jset)
    got = verify_run_batched(tset, CHAIN, port, **kw)
    assert got == reference_index(jset, ref)
    return got


RNG = np.random.default_rng(11)
PRIVS = _keys(32)
JSET, PRIV_OF = _valset(PRIVS, RNG)
GOOD = make_chain(JSET, PRIV_OF, 5)


def test_blocks_cross_as_bytes():
    for block, parts in GOOD:
        t = convert.block_from_reference(block)
        assert t.encode() == block.encode() and t.hash() == block.hash()
        assert t.data_hash() == block.data_hash()
        assert tblock.Block.decode(block.encode()) == t
        header = tparts.PartSet.from_data(t.encode(), PART_SIZE).header
        assert (header.total, header.hash) == (parts.header.total, parts.header.hash)
        assert _outcome(t.validate_basic) == _outcome(block.validate_basic) == ("ok", None)
    assert len(convert.block_from_reference(GOOD[1][0]).evidence) == 1


def test_block_validate_basic_errors():
    block = GOOD[1][0]  # height 2, with the evidence
    h = block.header
    variants = [
        dataclasses.replace(block, txs=block.txs + (b"extra",)),
        dataclasses.replace(block, evidence=()),
        dataclasses.replace(block, last_commit=GOOD[2][0].last_commit),
        dataclasses.replace(block, last_commit=jblock.EMPTY_COMMIT),
        dataclasses.replace(block, header=dataclasses.replace(h, height=0)),
        dataclasses.replace(block, header=dataclasses.replace(h, proposer_address=b"\x01")),
        dataclasses.replace(block, header=dataclasses.replace(h, data_hash=b"\x00" * 31)),
    ]
    errors = set()
    for v in variants:
        t = convert.block_from_reference(v)
        got = _outcome(t.validate_basic)
        assert got == _outcome(v.validate_basic)
        errors.add(got)
    assert len(errors) == len(variants) and all(e[0] == "ValueError" for e in errors)
    assert _outcome(lambda: tblock.Block.decode(b"\x12\x00")) == _outcome(
        lambda: jblock.Block.decode(b"\x12\x00")) == ("ValueError", "block missing header")


def test_good_run_and_empty_runs():
    assert check(JSET, GOOD) is None
    assert tbatch.LAST_FLUSH["path"] == "cpu"
    assert check(JSET, ([], [])) is None
    nil_chain = make_chain(JSET, PRIV_OF, 2, seed=3, flags={
        0: {i: "nil" for i in range(32)}, 1: {i: "nil" for i in range(32)}})
    assert check(JSET, nil_chain) == 0  # no for-block row in the whole run


@pytest.mark.parametrize("k", [0, 2, 4])
def test_bad_signatures_in_block_k(k):
    """11 of 32 signatures bad in block k: the power left is 2/3 or less
    (the seeded powers put it under 2/3 at each of these blocks)."""
    chain = make_chain(JSET, PRIV_OF, 5, seed=k, flags={k: {i: "bad" for i in range(0, 22, 2)}})
    assert check(JSET, chain) == k
    one = make_chain(JSET, PRIV_OF, 5, seed=k, flags={k: {5: "bad"}})
    assert check(JSET, one) is None  # one bad row leaves more than 2/3


def test_wrong_block_id_and_height():
    chain = list(GOOD)
    second = chain[3][0]
    other = jbasic.BlockID(b"\x0c" * 32, second.last_commit.block_id.part_set_header)
    chain[3] = (dataclasses.replace(second, last_commit=dataclasses.replace(
        second.last_commit, block_id=other)), chain[3][1])
    assert check(JSET, chain) == 2
    ref, port = runs(GOOD)
    shifted = dataclasses.replace(GOOD[4][0], header=dataclasses.replace(GOOD[4][0].header,
                                                                         height=9))
    ref[3] = (shifted, ref[3][1], ref[3][2], b"")
    port[3] = (convert.block_from_reference(shifted), port[3][1], port[3][2])
    assert check(JSET, (ref, port)) == 3


def test_commit_of_the_wrong_size():
    chain = list(GOOD)
    second = chain[2][0]
    short = dataclasses.replace(second.last_commit,
                                signatures=second.last_commit.signatures[:-1])
    chain[2] = (dataclasses.replace(second, last_commit=short), chain[2][1])
    assert check(JSET, chain) == 1


@pytest.mark.parametrize("flag", ["absent", "nil"])
def test_insufficient_power(flag):
    chain = make_chain(JSET, PRIV_OF, 4, seed=5, flags={3: {i: flag for i in range(12)}})
    assert check(JSET, chain) == 3
    fine = make_chain(JSET, PRIV_OF, 4, seed=5, flags={3: {i: flag for i in range(3)}})
    assert check(JSET, fine) is None


def test_mixed_key_set():
    privs = _keys(24, n_sr=8, seed=1)
    jset, priv_of = _valset(privs, np.random.default_rng(12))
    chain = make_chain(jset, priv_of, 3, seed=6)
    assert check(jset, chain) is None
    assert tbatch.LAST_FLUSH["path"] == "mixed"
    sr_rows = [i for i, v in enumerate(jset.validators) if v.pub_key.type_name() == "sr25519"]
    bad = make_chain(jset, priv_of, 3, seed=6, flags={1: {i: "bad" for i in sr_rows}})
    assert check(jset, bad) == 1


def test_card_arm_run(knobs):
    """18 blocks x 32 validators: 576 rows, one combined check on the port's
    card arm (backend="cuda", device="cpu") and the reference's (its host
    twins), both "rlc"."""
    chain = make_chain(JSET, PRIV_OF, 18, seed=8)
    ref, port = runs(chain)
    tset = convert.validator_set_from_reference(JSET)
    jtrace.reset_stats()
    want = reference_index(JSET, ref)
    got = verify_run_batched(tset, CHAIN, port, device="cpu", backend="cuda")
    assert got == want is None
    assert tbatch.LAST_FLUSH["path"] == jtrace.verify_stats()["last_flush"]["path"] == "rlc"

"""The light client's types in the port (tendermint_tpu_torch/crypto/merkle.py,
types/{basic,block,validator_set,light}.py, convert.py) against the JAX
package on seeded headers, commits and validator sets.

Tolerance: zero. Hashes, wire encodings, JSON bytes, proposers and
validate_basic messages must be identical.
"""

import numpy as np
import pytest

from tendermint_tpu.crypto import merkle as jmerkle
from tendermint_tpu.crypto.keys import pubkey_from_type_and_bytes as jpubkey
from tendermint_tpu.types import basic as jbasic
from tendermint_tpu.types import block as jblock
from tendermint_tpu.types import light as jlight
from tendermint_tpu.types import validator_set as jvs
from tendermint_tpu_torch import convert
from tendermint_tpu_torch.crypto import merkle as tmerkle
from tendermint_tpu_torch.crypto.keys import pubkey_from_type_and_bytes as tpubkey
from tendermint_tpu_torch.types import basic as tbasic
from tendermint_tpu_torch.types import block as tblock
from tendermint_tpu_torch.types import light as tlight
from tendermint_tpu_torch.types import validator_set as tvs
from tests.test_light import CHAIN_ID, make_chain, make_keys

PKGS = {"ref": (jbasic, jblock, jvs, jpubkey), "port": (tbasic, tblock, tvs, tpubkey)}


def _seeded_fields(seed: int, short: str = ""):
    """Header and commit fields from a numpy seed; `short` names one hash
    field that gets 31 bytes (a validate_basic failure)."""
    rng = np.random.default_rng(seed)
    h32 = {name: rng.bytes(31 if name == short else 32) for name in (
        "last_commit_hash", "data_hash", "validators_hash", "next_validators_hash",
        "consensus_hash", "app_hash", "last_results_hash", "evidence_hash")}
    return dict(
        version=(int(rng.integers(0, 300)), int(rng.integers(0, 1 << 40))),
        chain_id="chain-%d" % seed,
        height=int(rng.integers(1, 1 << 62)),
        time_ns=int(rng.integers(0, 1 << 62)),
        last_block=(rng.bytes(32), int(rng.integers(0, 1000)), rng.bytes(32)),
        proposer=rng.bytes(20),
        sigs=[(int(rng.integers(1, 4)), rng.bytes(20), int(rng.integers(0, 1 << 62)),
               rng.bytes(64)) for _ in range(int(rng.integers(1, 9)))],
        **h32,
    )


def _header(pkg, f):
    basic, block, _, _ = PKGS[pkg]
    bid = basic.BlockID(f["last_block"][0], basic.PartSetHeader(*f["last_block"][1:]))
    return block.Header(
        version=block.ConsensusVersion(*f["version"]), chain_id=f["chain_id"],
        height=f["height"], time_ns=f["time_ns"], last_block_id=bid,
        proposer_address=f["proposer"],
        **{k: f[k] for k in ("last_commit_hash", "data_hash", "validators_hash",
                             "next_validators_hash", "consensus_hash", "app_hash",
                             "last_results_hash", "evidence_hash")})


def _commit(pkg, f):
    basic, block, _, _ = PKGS[pkg]
    bid = basic.BlockID(f["last_block"][0], basic.PartSetHeader(*f["last_block"][1:]))
    sigs = [block.CommitSig(basic.BlockIDFlag(flag), addr, ts, sig) if flag != 1
            else block.CommitSig.absent_sig() for flag, addr, ts, sig in f["sigs"]]
    return block.Commit(f["height"], 3, bid, sigs)


def _error(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


@pytest.mark.parametrize("n", list(range(0, 18)) + [100, 1025])
def test_merkle_root_matches_reference(n):
    items = [np.random.default_rng(n).bytes(int(k % 40)) for k in range(n)]
    assert tmerkle.hash_from_byte_slices(items) == jmerkle.hash_from_byte_slices(items)
    if n >= 2:
        assert tmerkle.split_point(n) == jmerkle.split_point(n)


@pytest.mark.parametrize("seed", range(6))
def test_header_and_commit_hash_and_codec(seed):
    f = _seeded_fields(seed)
    jh, th = _header("ref", f), _header("port", f)
    assert th.hash() == jh.hash() and len(th.hash()) == 32
    assert th.encode() == jh.encode()
    assert tblock.Header.decode(jh.encode()) == th
    assert _error(th.validate_basic) == _error(jh.validate_basic)
    jc, tc = _commit("ref", f), _commit("port", f)
    assert tc.hash() == jc.hash()
    assert tc.encode() == jc.encode()
    assert tblock.Commit.decode(jc.encode()) == tc
    assert _error(tc.validate_basic) == _error(jc.validate_basic)
    for jcs, tcs in zip(jc.signatures, tc.signatures):
        assert tcs.encode() == jcs.encode()
        assert tblock.CommitSig.decode(jcs.encode()) == tcs
    assert tc.block_id.encode() == jc.block_id.encode()
    assert tbasic.BlockID.decode(jc.block_id.encode()) == tc.block_id


@pytest.mark.parametrize("case", ["short_hash", "zero_height", "long_chain_id", "proposer",
                                  "part_total", "no_validators_hash"])
def test_header_validate_basic_messages(case):
    f = _seeded_fields(11, short="data_hash" if case == "short_hash" else "")
    if case == "zero_height":
        f["height"] = 0
    elif case == "long_chain_id":
        f["chain_id"] = "c" * 51
    elif case == "proposer":
        f["proposer"] = b"\x01" * 19
    elif case == "part_total":
        f["last_block"] = (f["last_block"][0], jbasic.MAX_PART_SET_TOTAL + 1, f["last_block"][2])
    elif case == "no_validators_hash":
        f["validators_hash"] = b""
    jh, th = _header("ref", f), _header("port", f)
    assert th.hash() == jh.hash()
    got, want = _error(th.validate_basic), _error(jh.validate_basic)
    assert got == want and (want is not None or case == "no_validators_hash")


def _valset(pkg, seed: int, n: int):
    """Seeded ed25519 and sr25519 keys with seeded powers (ties included)."""
    rng = np.random.default_rng(seed)
    _, _, vs, pubkey = PKGS[pkg]
    keys = make_keys(bytes([seed % 256]), n)
    rows = []
    for i in range(n):
        kind = "sr25519" if i % 5 == 4 else "ed25519"
        enc = rng.bytes(32) if kind == "sr25519" else bytes(keys[i].pub_key().bytes())
        rows.append((kind, enc, int(rng.integers(1, 4)) * 10))
    return vs.ValidatorSet([vs.Validator(pubkey(k, e), p) for k, e, p in rows])


@pytest.mark.parametrize("seed,n", [(1, 1), (2, 4), (3, 17), (4, 40)])
def test_validator_set_hash_proposer_and_lookups(seed, n):
    jset, tset = _valset("ref", seed, n), _valset("port", seed, n)
    assert tset.hash() == jset.hash()
    assert [v.address for v in tset.validators] == [v.address for v in jset.validators]
    assert tset.get_proposer().address == jset.get_proposer().address
    assert [v.simple_bytes() for v in tset.validators] == [v.simple_bytes() for v in
                                                           jset.validators]
    for v in jset.validators:
        assert tset.get_by_address(v.address)[0] == jset.get_by_address(v.address)[0]
    assert tset.get_by_address(b"\x00" * 20) == (-1, None)
    assert tset.get_by_index(n) == (b"", None) and tset.get_by_index(0)[0] == jset.get_by_index(0)[0]
    tset.validate_basic()
    jset.validate_basic()
    c = tset.copy()
    assert c.hash() == tset.hash() and c.proposer.address == tset.proposer.address


def test_validator_validate_basic_messages():
    for power, addr in ((-1, None), (10, b"\x01" * 19)):
        msgs = []
        for vs, pubkey in ((jvs, jpubkey), (tvs, tpubkey)):
            pk = pubkey("ed25519", bytes(make_keys(b"\x09", 1)[0].pub_key().bytes()))
            v = vs.Validator(pk, power, addr or b"")
            msgs.append(_error(v.validate_basic))
        assert msgs[0] == msgs[1] and msgs[0] is not None
    assert _error(tvs.ValidatorSet([]).validate_basic) == _error(jvs.ValidatorSet([]).validate_basic)


@pytest.mark.parametrize("rotation", [None, 4], ids=["constant", "rotating"])
def test_light_block_bytes_round_trip_and_carry(rotation):
    """A reference-built chain: the port decodes each block's bytes
    (convert.light_block_from_reference_bytes) with every hash and the
    proposer kept, validate_basic passes, and the port's own
    light_block_to_bytes gives the reference's bytes back."""
    privs = {rotation: make_keys(b"\x02", 5)} if rotation else None
    blocks = make_chain(6, privs_by_height=privs)
    for h, lb in blocks.items():
        data = jlight.light_block_to_bytes(lb)
        p = convert.light_block_from_reference_bytes(data)
        assert p.hash() == lb.hash() and p.height == h
        assert p.signed_header.commit.hash() == lb.signed_header.commit.hash()
        assert p.validator_set.hash() == lb.validator_set.hash() == p.header.validators_hash
        assert p.validator_set.get_proposer().address == lb.validator_set.get_proposer().address
        assert tlight.light_block_to_bytes(p) == data
        assert tlight.light_block_to_bytes(tlight.light_block_from_bytes(data)) == data
        p.validate_basic(CHAIN_ID)
        assert tlight.signed_header_to_json(p.signed_header) == jlight.signed_header_to_json(
            lb.signed_header)


@pytest.mark.parametrize("case", ["chain", "height", "hash", "valset"])
def test_light_block_validate_basic_messages(case):
    blocks = make_chain(3)
    other = make_chain(3, default_privs=make_keys(b"\x05", 4))
    out = []
    for mod, carry in ((jlight, lambda lb: lb),
                       (tlight, lambda lb: convert.light_block_from_reference_bytes(
                           jlight.light_block_to_bytes(lb)))):
        lb, lb2 = carry(blocks[2]), carry(other[2])
        chain = CHAIN_ID
        if case == "chain":
            chain = "other-chain"
        elif case == "height":
            lb = mod.LightBlock(mod.SignedHeader(lb.header, carry(blocks[3]).signed_header.commit),
                                lb.validator_set)
        elif case == "hash":
            lb = mod.LightBlock(mod.SignedHeader(lb.header, lb2.signed_header.commit),
                                lb.validator_set)
        else:
            lb = mod.LightBlock(lb.signed_header, lb2.validator_set)
        out.append(_error(lambda: lb.validate_basic(chain)))
    assert out[0] == out[1] and out[0] is not None

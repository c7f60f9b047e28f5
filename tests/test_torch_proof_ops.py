"""The port's Merkle proof operators (crypto/proof_ops.py), crypto/merkle.py
and MerkleKVStoreApplication, held against the JAX package with tolerance
0 (byte for byte):

- tests/test_proof_ops.py and tests/test_merkle.py, each case run on both
  packages;
- the same pairs give the same app hashes, ValueOp bytes and `prove=true`
  query answers in both MerkleKVStoreApplications;
- a proof that one package wrote verifies in the other's operators, carried
  by its protobuf bytes (convert.proof_op_from_reference one way, ProofOp
  encode/decode the other);
- a tampered value, key path, root or proof byte is refused by both.
"""

import hashlib

import numpy as np
import pytest

from tendermint_tpu.abci import types as rabci
from tendermint_tpu.abci.kvstore import MerkleKVStoreApplication as RefApp
from tendermint_tpu.crypto import merkle as rmerkle
from tendermint_tpu.crypto import proof_ops as rops
from tendermint_tpu_torch import convert
from tendermint_tpu_torch.abci import types as tabci
from tendermint_tpu_torch.abci.kvstore import MerkleKVStoreApplication as PortApp
from tendermint_tpu_torch.crypto import merkle as tmerkle
from tendermint_tpu_torch.crypto import proof_ops as tops

OPS = {"ref": rops, "port": tops}
MERKLE = {"ref": rmerkle, "port": tmerkle}
BOTH = pytest.mark.parametrize("pkg", ["ref", "port"])


def _pairs(seed: int, n: int) -> dict:
    rng = np.random.default_rng(seed)
    return {b"k%03d-" % i + rng.bytes(int(rng.integers(0, 9))).hex().encode():
            rng.bytes(int(rng.integers(1, 40))).hex().encode() for i in range(n)}


# -- tests/test_proof_ops.py, both packages -----------------------------------

@BOTH
def test_key_path_roundtrip(pkg):
    P = OPS[pkg]
    kp = P.KeyPath()
    kp.append_key(b"App", P.KEY_ENCODING_URL)
    kp.append_key(b"IBC", P.KEY_ENCODING_URL)
    kp.append_key(b"\x01\x02\x03", P.KEY_ENCODING_HEX)
    s = str(kp)
    assert s == "/App/IBC/x:010203"
    assert P.key_path_to_keys(s) == [b"App", b"IBC", b"\x01\x02\x03"]
    kp2 = P.KeyPath().append_key(b"a/b c%", P.KEY_ENCODING_URL)
    assert P.key_path_to_keys(str(kp2)) == [b"a/b c%"]
    with pytest.raises(ValueError):
        P.key_path_to_keys("no-leading-slash")
    key = b"\xff\x00 high&/bytes"  # byte-wise escapes, as Go's url.PathEscape
    s = str(P.KeyPath().append_key(key, P.KEY_ENCODING_URL))
    assert "%FF" in s.upper() and "%C3" not in s.upper()
    assert P.key_path_to_keys(s) == [key]


@BOTH
def test_value_op_verifies_and_rejects_tampering(pkg):
    P = OPS[pkg]
    kv = {b"k%d" % i: b"v%d" % i for i in range(7)}
    root, ops = P.simple_map_proofs(kv)
    prt = P.default_proof_runtime()
    pop = ops[b"k3"].proof_op()
    kp = str(P.KeyPath().append_key(b"k3"))
    prt.verify_value([pop], root, kp, b"v3")
    for args in (([pop], root, kp, b"v4"), ([pop], b"\x00" * 32, kp, b"v3"),
                 ([pop], root, str(P.KeyPath().append_key(b"k4")), b"v3"),
                 ([pop], root, str(P.KeyPath().append_key(b"extra").append_key(b"k3")), b"v3")):
        with pytest.raises(ValueError):
            prt.verify_value(*args)


@BOTH
def test_proof_op_wire_roundtrip_and_two_layers(pkg):
    P = OPS[pkg]
    root, ops = P.simple_map_proofs({b"alpha": b"1", b"beta": b"2"})
    back = P.decode_proof_ops(P.encode_proof_ops([ops[b"beta"].proof_op()]))
    assert len(back) == 1 and back[0].key == b"beta"
    assert P.ValueOp.from_proof_op(back[0]).run([b"2"])[0] == root
    inner_root, inner_ops = P.simple_map_proofs({b"x": b"42"})
    outer_root, outer_ops = P.simple_map_proofs({b"store": inner_root, b"other": b"zzz"})
    pops = [inner_ops[b"x"].proof_op(), outer_ops[b"store"].proof_op()]
    kp = str(P.KeyPath().append_key(b"store").append_key(b"x"))
    P.default_proof_runtime().verify_value(pops, outer_root, kp, b"42")
    with pytest.raises(ValueError):
        P.default_proof_runtime().verify_value(pops, outer_root, kp, b"43")


@BOTH
def test_merkle_kvstore_app_proofs(pkg):
    App, abci = (RefApp, rabci) if pkg == "ref" else (PortApp, tabci)
    P = OPS[pkg]
    app = App()
    app.deliver_tx(abci.RequestDeliverTx(tx=b"name=tpu"))
    app.deliver_tx(abci.RequestDeliverTx(tx=b"lang=py"))
    root = app.commit().data
    assert root == app.app_hash and len(root) == 32
    res = app.query(abci.RequestQuery(data=b"name", prove=True))
    assert res.value == b"tpu" and len(res.proof_ops) == 1
    P.default_proof_runtime().verify_value(
        res.proof_ops, root, str(P.KeyPath().append_key(b"name")), b"tpu")
    assert app.query(abci.RequestQuery(data=b"name")).proof_ops is None


# -- tests/test_merkle.py, both packages --------------------------------------

@BOTH
def test_merkle_golden_vectors(pkg):
    M = MERKLE[pkg]
    assert M.hash_from_byte_slices([]) == hashlib.sha256(b"").digest()
    assert M.hash_from_byte_slices([b"hello"]) == hashlib.sha256(b"\x00hello").digest()
    la, lb = hashlib.sha256(b"\x00a").digest(), hashlib.sha256(b"\x00b").digest()
    assert M.hash_from_byte_slices([b"a", b"b"]) == hashlib.sha256(b"\x01" + la + lb).digest()
    assert [M.split_point(n) for n in (2, 3, 4, 5, 8, 9)] == [1, 2, 2, 4, 4, 8]
    items = [bytes([i]) for i in range(5)]
    expect = hashlib.sha256(b"\x01" + M.hash_from_byte_slices(items[:4])
                            + M.hash_from_byte_slices(items[4:])).digest()
    assert M.hash_from_byte_slices(items) == expect


@BOTH
def test_merkle_proofs_verify(pkg):
    M = MERKLE[pkg]
    for n in [1, 2, 3, 5, 8, 13, 64]:
        items = [b"item-%d" % i for i in range(n)]
        root, proofs = M.proofs_from_byte_slices(items)
        assert root == M.hash_from_byte_slices(items)
        for i, proof in enumerate(proofs):
            assert proof.total == n and proof.index == i
            assert proof.verify(root, items[i])
            assert not proof.verify(root, b"bogus")
            assert not proof.verify(b"\x00" * 32, items[i])
    root, proofs = M.proofs_from_byte_slices([b"a", b"b", b"c", b"d"])
    proofs[0].index = 1
    assert not proofs[0].verify(root, b"a")


# -- the port against the reference -------------------------------------------

@pytest.mark.parametrize("seed,n", [(1, 1), (2, 7), (3, 64)])
def test_same_roots_and_value_op_bytes(seed, n):
    kv = _pairs(seed, n)
    rroot, rvops = rops.simple_map_proofs(kv)
    troot, tvops = tops.simple_map_proofs(kv)
    assert troot == rroot
    for k in kv:
        assert tvops[k].proof_op().encode() == rvops[k].proof_op().encode()
        assert tops.encode_proof(tvops[k].proof) == rops.encode_proof(rvops[k].proof)
    assert tops.encode_proof_ops([v.proof_op() for v in tvops.values()]) == \
        rops.encode_proof_ops([v.proof_op() for v in rvops.values()])


def _apps(kv: dict, heights: int = 2):
    """Both apps fed the same txs over `heights` commits; the app hashes."""
    ref, port = RefApp(), PortApp()
    hashes = []
    items = sorted(kv.items())
    for h in range(heights):
        for k, v in items[h::heights]:
            ref.deliver_tx(rabci.RequestDeliverTx(tx=k + b"=" + v))
            port.deliver_tx(tabci.RequestDeliverTx(tx=k + b"=" + v))
        hashes.append((ref.commit().data, port.commit().data))
    return ref, port, hashes


def test_app_hashes_and_prove_queries_match():
    kv = _pairs(11, 24)
    ref, port, hashes = _apps(kv, heights=3)
    assert all(r == t for r, t in hashes)
    assert port.app_hash == ref.app_hash == rops.simple_map_proofs(kv)[0]
    for k in list(kv)[:6] + [b"missing-key"]:
        rq = ref.query(rabci.RequestQuery(data=k, prove=True))
        tq = port.query(tabci.RequestQuery(data=k, prove=True))
        assert (tq.code, tq.value, tq.height) == (rq.code, rq.value, rq.height)
        assert [op.encode() for op in tq.proof_ops or []] == \
            [op.encode() for op in rq.proof_ops or []]


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_proof_crosses_between_packages(writer):
    kv = _pairs(21, 16)
    ref, port, _ = _apps(kv)
    key = sorted(kv)[5]
    if writer == "ref":
        ops = ref.query(rabci.RequestQuery(data=key, prove=True)).proof_ops
        carried = [convert.proof_op_from_reference(op) for op in ops]
        verifier, root = tops, ref.app_hash
    else:
        ops = port.query(tabci.RequestQuery(data=key, prove=True)).proof_ops
        carried = [rops.ProofOp.decode(op.encode()) for op in ops]
        verifier, root = rops, port.app_hash
    kp = str(verifier.KeyPath().append_key(key))
    verifier.default_proof_runtime().verify_value(carried, root, kp, kv[key])


def _tampered(kind: str, ops, key: bytes, value: bytes, root: bytes):
    """(ops, root, key path, value) with one thing changed."""
    op = ops[0]
    if kind == "value":
        return ops, root, "/" + key.decode(), value + b"x"
    if kind == "key_path":
        return ops, root, "/" + key.decode() + "x", value
    if kind == "root":
        return ops, bytes([root[0] ^ 1]) + root[1:], "/" + key.decode(), value
    data = bytearray(op.data)  # a byte of the proof's leaf hash
    data[-5] ^= 1
    return [type(op)(op.type, op.key, bytes(data))], root, "/" + key.decode(), value


@pytest.mark.parametrize("kind", ["value", "key_path", "root", "proof_byte"])
def test_tampered_proof_refused_by_both(kind):
    kv = _pairs(31, 9)
    key = sorted(kv)[2]
    rroot, rvops = rops.simple_map_proofs(kv)
    rop = rvops[key].proof_op()
    rargs = _tampered(kind, [rop], key, kv[key], rroot)
    targs = ([convert.proof_op_from_reference(op) for op in rargs[0]],) + rargs[1:]
    errors = []
    for P, args in ((rops, rargs), (tops, targs)):
        with pytest.raises(ValueError) as ei:
            P.default_proof_runtime().verify_value(*args)
        errors.append(str(ei.value))
    assert errors[0] == errors[1]

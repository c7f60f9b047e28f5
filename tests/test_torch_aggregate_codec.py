"""The port's AggregateCommit wire codec (types/block.py encode / decode)
against the JAX package's on the same fields: encodings byte-identical, a
decode round trip, and truncated, reordered and foreign-field inputs decoded
as the reference decodes them (the same fields, or an error of the same
type). Fields made from a numpy seed. Tolerance: zero (bytes and fields).
"""

import numpy as np
import pytest

from tendermint_tpu.libs import protowire as jpw
from tendermint_tpu.types import basic as jbasic
from tendermint_tpu.types import block as jblock
from tendermint_tpu_torch.types import basic as tbasic
from tendermint_tpu_torch.types import block as tblock


def fields(seed: int, n_vals: int = 100):
    rng = np.random.default_rng(seed)
    signers = sorted(set(int(i) for i in rng.integers(0, n_vals, size=n_vals // 2)))
    return dict(
        height=int(rng.integers(0, 1 << 40)), round=int(rng.integers(0, 5)),
        block_hash=rng.bytes(32), parts=(int(rng.integers(1, 9)), rng.bytes(32)),
        timestamp_ns=int(rng.integers(0, 1 << 62)),
        signers=jblock.AggregateCommit.bitmap_of(signers, n_vals), sig=rng.bytes(96))


def build(pkg_block, pkg_basic, f):
    bid = pkg_basic.BlockID(f["block_hash"], pkg_basic.PartSetHeader(*f["parts"]))
    return pkg_block.AggregateCommit(f["height"], f["round"], bid, f["timestamp_ns"],
                                     f["signers"], f["sig"])


def as_tuple(ac):
    return (ac.height, ac.round, ac.block_id.hash, ac.block_id.part_set_header.total,
            ac.block_id.part_set_header.hash, ac.timestamp_ns, ac.signers, ac.agg_signature)


def decoded(pkg_block, data):
    try:
        return as_tuple(pkg_block.AggregateCommit.decode(data))
    except Exception as e:  # the error's type is the outcome
        return type(e).__name__


CASES = [fields(s) for s in range(6)] + [
    dict(fields(9), height=0, round=0, timestamp_ns=0, block_hash=b"", parts=(0, b"")),
    dict(fields(10), timestamp_ns=-1_500_000_001),  # before the epoch
]


@pytest.mark.parametrize("f", CASES)
def test_encode_bytes_equal_and_decode_round_trips(f):
    ref, port = build(jblock, jbasic, f), build(tblock, tbasic, f)
    data = port.encode()
    assert data == ref.encode()
    assert as_tuple(tblock.AggregateCommit.decode(data)) == as_tuple(port)
    assert tblock.AggregateCommit.decode(data) == port
    assert decoded(tblock, data) == decoded(jblock, data)


def test_truncated_inputs_decode_as_the_reference():
    data = build(jblock, jbasic, fields(21)).encode()
    for cut in range(len(data)):
        assert decoded(tblock, data[:cut]) == decoded(jblock, data[:cut]), cut


def test_reordered_and_foreign_fields_decode_as_the_reference():
    f = fields(33)
    ref = build(jblock, jbasic, f)
    parts = list(jpw.Reader(ref.encode()))
    w = jpw.Writer()
    for fno, wt, v in reversed(parts):  # every field, last first
        if wt == 0:
            w.varint_field(fno, v, emit_zero=True)
        else:
            w.bytes_field(fno, bytes(v), emit_empty=True)
    w.varint_field(15, 7)  # a field neither package knows
    w.bytes_field(6, b"\x01" * 96)  # a repeated field: the last wins
    data = w.bytes()
    got = decoded(tblock, data)
    assert got == decoded(jblock, data)
    assert got[-1] == b"\x01" * 96 and got[0] == f["height"]

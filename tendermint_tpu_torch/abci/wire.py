"""ABCI wire codec for the socket transport (reference:
proto/tendermint/abci/types.proto, abci/client/socket_client.go framing): the
port's copy of tendermint_tpu/abci/wire.py, whole, the same bytes. The gRPC
broadcast API encodes its responses with it; the socket and gRPC ABCI
clients that also use it wait for ROADMAP A3.

Requests/responses are protowire messages inside a Request/Response oneof
envelope, length-delimited on the socket (reference: libs/protoio). Field
numbers follow the v0.34 proto. Nested rich objects (block Header,
ConsensusParams) are carried as their own encoded submessages; the decode
side surfaces them as raw bytes (apps that need them decode with the types
layer) — the in-process local client keeps the live objects and never touches
this codec."""

from __future__ import annotations

from dataclasses import fields as dc_fields
from typing import Callable, Dict, List, Tuple

from tendermint_tpu_torch.abci import types as a
from tendermint_tpu_torch.libs import protowire as pw

# ---------------------------------------------------------------------------
# leaf encoders
# ---------------------------------------------------------------------------


def _enc_event(ev: a.Event) -> bytes:
    w = pw.Writer()
    w.string_field(1, ev.type)
    for key, value, index in ev.attributes:
        aw = pw.Writer()
        aw.bytes_field(1, key)
        aw.bytes_field(2, value)
        aw.varint_field(3, 1 if index else 0)
        w.message_field(2, aw.bytes(), always=True)
    return w.bytes()


def _dec_event(data: bytes) -> a.Event:
    ev = a.Event()
    for f, _, v in pw.Reader(data):
        if f == 1:
            ev.type = v.decode()
        elif f == 2:
            key = value = b""
            index = False
            for ff, _, vv in pw.Reader(v):
                if ff == 1:
                    key = vv
                elif ff == 2:
                    value = vv
                elif ff == 3:
                    index = bool(vv)
            ev.attributes.append((key, value, index))
    return ev


def _enc_valupdate(u: a.ValidatorUpdate) -> bytes:
    w = pw.Writer()
    pk = pw.Writer()
    # PublicKey oneof: 1=ed25519 bytes, 2=sr25519 bytes
    pk.bytes_field(1 if u.pub_key_type == "ed25519" else 2, u.pub_key_bytes, emit_empty=True)
    w.message_field(1, pk.bytes(), always=True)
    w.varint_field(2, u.power)
    return w.bytes()


def _dec_valupdate(data: bytes) -> a.ValidatorUpdate:
    ktype, kbytes, power = "ed25519", b"", 0
    for f, _, v in pw.Reader(data):
        if f == 1:
            for ff, _, vv in pw.Reader(v):
                if ff == 1:
                    ktype, kbytes = "ed25519", vv
                elif ff == 2:
                    ktype, kbytes = "sr25519", vv
        elif f == 2:
            power = pw.int64_from_varint(v)
    return a.ValidatorUpdate(ktype, kbytes, power)


def _enc_lci(l: a.LastCommitInfo) -> bytes:
    w = pw.Writer()
    w.varint_field(1, l.round)
    for addr, power, signed in l.votes:
        vw = pw.Writer()
        valw = pw.Writer()
        valw.bytes_field(1, addr)
        valw.varint_field(3, power)
        vw.message_field(1, valw.bytes(), always=True)
        vw.varint_field(2, 1 if signed else 0)
        w.message_field(2, vw.bytes(), always=True)
    return w.bytes()


def _dec_lci(data: bytes) -> a.LastCommitInfo:
    out = a.LastCommitInfo()
    for f, _, v in pw.Reader(data):
        if f == 1:
            out.round = pw.int64_from_varint(v)
        elif f == 2:
            addr, power, signed = b"", 0, False
            for ff, _, vv in pw.Reader(v):
                if ff == 1:
                    for g, _, gv in pw.Reader(vv):
                        if g == 1:
                            addr = gv
                        elif g == 3:
                            power = pw.int64_from_varint(gv)
                elif ff == 2:
                    signed = bool(vv)
            out.votes.append((addr, power, signed))
    return out


def _enc_evidence(e: a.EvidenceABCI) -> bytes:
    w = pw.Writer()
    w.varint_field(1, e.type)
    vw = pw.Writer()
    vw.bytes_field(1, e.validator_address)
    vw.varint_field(3, e.validator_power)
    w.message_field(2, vw.bytes(), always=True)
    w.varint_field(3, e.height)
    w.varint_field(4, e.time_ns)
    w.varint_field(5, e.total_voting_power)
    return w.bytes()


def _dec_evidence(data: bytes) -> a.EvidenceABCI:
    out = a.EvidenceABCI()
    for f, _, v in pw.Reader(data):
        if f == 1:
            out.type = v
        elif f == 2:
            for ff, _, vv in pw.Reader(v):
                if ff == 1:
                    out.validator_address = vv
                elif ff == 3:
                    out.validator_power = pw.int64_from_varint(vv)
        elif f == 3:
            out.height = pw.int64_from_varint(v)
        elif f == 4:
            out.time_ns = pw.int64_from_varint(v)
        elif f == 5:
            out.total_voting_power = pw.int64_from_varint(v)
    return out


def _enc_snapshot(s: a.Snapshot) -> bytes:
    w = pw.Writer()
    w.varint_field(1, s.height)
    w.varint_field(2, s.format)
    w.varint_field(3, s.chunks)
    w.bytes_field(4, s.hash)
    w.bytes_field(5, s.metadata)
    return w.bytes()


def _dec_snapshot(data: bytes) -> a.Snapshot:
    s = a.Snapshot()
    for f, _, v in pw.Reader(data):
        if f == 1:
            s.height = pw.int64_from_varint(v)
        elif f == 2:
            s.format = v
        elif f == 3:
            s.chunks = v
        elif f == 4:
            s.hash = v
        elif f == 5:
            s.metadata = v
    return s


def _maybe_encode(obj) -> bytes:
    if obj is None:
        return b""
    if isinstance(obj, (bytes, bytearray)):
        return bytes(obj)
    enc = getattr(obj, "encode", None)
    return enc() if enc else b""


# ---------------------------------------------------------------------------
# message field specs: (field_no, attr, kind)
# kinds: i=varint int, b=bool, y=bytes, s=str, E=[Event], V=[ValidatorUpdate],
#        L=LastCommitInfo, X=[EvidenceABCI], S=Snapshot, SS=[Snapshot],
#        O=opaque submessage (encode() out, raw bytes in), I=[int], T=[str]
# ---------------------------------------------------------------------------

SPECS: Dict[type, List[Tuple[int, str, str]]] = {
    a.RequestInfo: [(1, "version", "s"), (2, "block_version", "i"), (3, "p2p_version", "i")],
    a.ResponseInfo: [(1, "data", "s"), (2, "version", "s"), (3, "app_version", "i"),
                     (4, "last_block_height", "i"), (5, "last_block_app_hash", "y")],
    a.RequestSetOption: [(1, "key", "s"), (2, "value", "s")],
    a.ResponseSetOption: [(1, "code", "i"), (3, "log", "s"), (4, "info", "s")],
    a.RequestInitChain: [(1, "time_ns", "i"), (2, "chain_id", "s"), (3, "consensus_params", "O"),
                         (4, "validators", "V"), (5, "app_state_bytes", "y"), (6, "initial_height", "i")],
    a.ResponseInitChain: [(1, "consensus_params", "O"), (2, "validators", "V"), (3, "app_hash", "y")],
    a.RequestQuery: [(1, "data", "y"), (2, "path", "s"), (3, "height", "i"), (4, "prove", "b")],
    a.ResponseQuery: [(1, "code", "i"), (3, "log", "s"), (4, "info", "s"), (5, "index", "i"),
                      (6, "key", "y"), (7, "value", "y"), (8, "proof_ops", "O"),
                      (9, "height", "i"), (10, "codespace", "s")],
    a.RequestBeginBlock: [(1, "hash", "y"), (2, "header", "O"), (3, "last_commit_info", "L"),
                          (4, "byzantine_validators", "X")],
    a.ResponseBeginBlock: [(1, "events", "E")],
    a.RequestCheckTx: [(1, "tx", "y"), (2, "type", "i"),
                       # node-side signature-precheck verdict (ABCI split,
                       # types.SIG_PRECHECK_*); proto3 zero-default = NONE,
                       # so peers without the field interop unchanged
                       (3, "sig_precheck", "i")],
    a.ResponseCheckTx: [(1, "code", "i"), (2, "data", "y"), (3, "log", "s"), (4, "info", "s"),
                        (5, "gas_wanted", "i"), (6, "gas_used", "i"), (7, "events", "E"),
                        (8, "codespace", "s")],
    a.RequestDeliverTx: [(1, "tx", "y")],
    a.ResponseDeliverTx: [(1, "code", "i"), (2, "data", "y"), (3, "log", "s"), (4, "info", "s"),
                          (5, "gas_wanted", "i"), (6, "gas_used", "i"), (7, "events", "E"),
                          (8, "codespace", "s")],
    a.RequestEndBlock: [(1, "height", "i")],
    a.ResponseEndBlock: [(1, "validator_updates", "V"), (2, "consensus_param_updates", "O"),
                         (3, "events", "E")],
    a.ResponseCommit: [(2, "data", "y"), (3, "retain_height", "i")],
    a.ResponseListSnapshots: [(1, "snapshots", "SS")],
    a.RequestOfferSnapshot: [(1, "snapshot", "S"), (2, "app_hash", "y")],
    a.ResponseOfferSnapshot: [(1, "result", "i")],
    a.RequestLoadSnapshotChunk: [(1, "height", "i"), (2, "format", "i"), (3, "chunk", "i")],
    a.ResponseLoadSnapshotChunk: [(1, "chunk", "y")],
    a.RequestApplySnapshotChunk: [(1, "index", "i"), (2, "chunk", "y"), (3, "sender", "s")],
    a.ResponseApplySnapshotChunk: [(1, "result", "i"), (2, "refetch_chunks", "I"),
                                   (3, "reject_senders", "T")],
}


def encode_msg(msg) -> bytes:
    w = pw.Writer()
    for num, attr, kind in SPECS[type(msg)]:
        val = getattr(msg, attr)
        if kind == "i":
            w.varint_field(num, int(val))
        elif kind == "b":
            w.varint_field(num, 1 if val else 0)
        elif kind == "y":
            w.bytes_field(num, bytes(val))
        elif kind == "s":
            w.string_field(num, val)
        elif kind == "E":
            for ev in val:
                w.message_field(num, _enc_event(ev), always=True)
        elif kind == "V":
            for u in val:
                w.message_field(num, _enc_valupdate(u), always=True)
        elif kind == "L":
            w.message_field(num, _enc_lci(val), always=True)
        elif kind == "X":
            for e in val:
                w.message_field(num, _enc_evidence(e), always=True)
        elif kind == "S":
            if val is not None:
                w.message_field(num, _enc_snapshot(val), always=True)
        elif kind == "SS":
            for s in val:
                w.message_field(num, _enc_snapshot(s), always=True)
        elif kind == "O":
            raw = _maybe_encode(val)
            if raw:
                w.message_field(num, raw, always=True)
        elif kind == "I":
            for x in val:
                w.varint_field(num, x, emit_zero=True)
        elif kind == "T":
            for s in val:
                w.string_field(num, s, emit_empty=True)
    return w.bytes()


def decode_msg(cls, data: bytes):
    spec = {num: (attr, kind) for num, attr, kind in SPECS[cls]}
    msg = cls()
    for f, _, v in pw.Reader(data):
        if f not in spec:
            continue
        attr, kind = spec[f]
        if kind == "i":
            setattr(msg, attr, pw.int64_from_varint(v))
        elif kind == "b":
            setattr(msg, attr, bool(v))
        elif kind == "y":
            setattr(msg, attr, v)
        elif kind == "s":
            setattr(msg, attr, v.decode())
        elif kind == "E":
            getattr(msg, attr).append(_dec_event(v))
        elif kind == "V":
            getattr(msg, attr).append(_dec_valupdate(v))
        elif kind == "L":
            setattr(msg, attr, _dec_lci(v))
        elif kind == "X":
            getattr(msg, attr).append(_dec_evidence(v))
        elif kind == "S":
            setattr(msg, attr, _dec_snapshot(v))
        elif kind == "SS":
            getattr(msg, attr).append(_dec_snapshot(v))
        elif kind == "O":
            setattr(msg, attr, v)  # raw bytes; types layer decodes if needed
        elif kind == "I":
            getattr(msg, attr).append(pw.int64_from_varint(v))
        elif kind == "T":
            getattr(msg, attr).append(v.decode())
    return msg


# ---------------------------------------------------------------------------
# Request / Response envelopes (oneof field numbers from the v0.34 proto)
# ---------------------------------------------------------------------------

REQUEST_FIELDS = {
    "echo": 1, "flush": 2, "info": 3, "set_option": 4, "init_chain": 5,
    "query": 6, "begin_block": 7, "check_tx": 8, "deliver_tx": 9,
    "end_block": 10, "commit": 11, "list_snapshots": 12, "offer_snapshot": 13,
    "load_snapshot_chunk": 14, "apply_snapshot_chunk": 15,
}
REQUEST_TYPES = {
    "info": a.RequestInfo, "set_option": a.RequestSetOption,
    "init_chain": a.RequestInitChain, "query": a.RequestQuery,
    "begin_block": a.RequestBeginBlock, "check_tx": a.RequestCheckTx,
    "deliver_tx": a.RequestDeliverTx, "end_block": a.RequestEndBlock,
    "offer_snapshot": a.RequestOfferSnapshot,
    "load_snapshot_chunk": a.RequestLoadSnapshotChunk,
    "apply_snapshot_chunk": a.RequestApplySnapshotChunk,
}
RESPONSE_FIELDS = {
    "exception": 1, "echo": 2, "flush": 3, "info": 4, "set_option": 5,
    "init_chain": 6, "query": 7, "begin_block": 8, "check_tx": 9,
    "deliver_tx": 10, "end_block": 11, "commit": 12, "list_snapshots": 13,
    "offer_snapshot": 14, "load_snapshot_chunk": 15, "apply_snapshot_chunk": 16,
}
RESPONSE_TYPES = {
    "info": a.ResponseInfo, "set_option": a.ResponseSetOption,
    "init_chain": a.ResponseInitChain, "query": a.ResponseQuery,
    "begin_block": a.ResponseBeginBlock, "check_tx": a.ResponseCheckTx,
    "deliver_tx": a.ResponseDeliverTx, "end_block": a.ResponseEndBlock,
    "commit": a.ResponseCommit, "list_snapshots": a.ResponseListSnapshots,
    "offer_snapshot": a.ResponseOfferSnapshot,
    "load_snapshot_chunk": a.ResponseLoadSnapshotChunk,
    "apply_snapshot_chunk": a.ResponseApplySnapshotChunk,
}
_REQ_FIELD_TO_NAME = {v: k for k, v in REQUEST_FIELDS.items()}
_RESP_FIELD_TO_NAME = {v: k for k, v in RESPONSE_FIELDS.items()}


def encode_request(method: str, msg=None) -> bytes:
    w = pw.Writer()
    body = b"" if method in ("flush", "echo") and msg is None else (
        encode_msg(msg) if msg is not None else b""
    )
    w.message_field(REQUEST_FIELDS[method], body, always=True)
    return w.bytes()


def decode_request(data: bytes):
    """-> (method, msg_or_None)"""
    for f, _, v in pw.Reader(data):
        name = _REQ_FIELD_TO_NAME.get(f)
        if name is None:
            continue
        cls = REQUEST_TYPES.get(name)
        return name, (decode_msg(cls, v) if cls else None)
    raise ValueError("empty ABCI request")


def encode_response(method: str, msg=None, exception: str = "") -> bytes:
    w = pw.Writer()
    if exception:
        ew = pw.Writer()
        ew.string_field(1, exception)
        w.message_field(RESPONSE_FIELDS["exception"], ew.bytes(), always=True)
        return w.bytes()
    body = encode_msg(msg) if msg is not None else b""
    w.message_field(RESPONSE_FIELDS[method], body, always=True)
    return w.bytes()


def decode_response(data: bytes):
    """-> (method, msg_or_None); raises on exception responses."""
    for f, _, v in pw.Reader(data):
        name = _RESP_FIELD_TO_NAME.get(f)
        if name is None:
            continue
        if name == "exception":
            err = ""
            for ff, _, vv in pw.Reader(v):
                if ff == 1:
                    err = vv.decode()
            raise RuntimeError(f"ABCI exception: {err}")
        cls = RESPONSE_TYPES.get(name)
        return name, (decode_msg(cls, v) if cls else None)
    raise ValueError("empty ABCI response")

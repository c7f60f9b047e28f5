"""ABCI: the 17-method application boundary (reference: abci/types/application.go:9-32).

Requests/responses are plain dataclasses (the local in-process path needs no
serialization; the socket/grpc transports marshal them). Method set and
semantics mirror ABCI 0.17 / Tendermint v0.34:

  Info/SetOption/Query            — query connection
  CheckTx                         — mempool connection
  InitChain/BeginBlock/DeliverTx/EndBlock/Commit — consensus connection
  ListSnapshots/OfferSnapshot/LoadSnapshotChunk/ApplySnapshotChunk — snapshot
  Echo/Flush                      — transport plumbing

The port's copy of tendermint_tpu/abci/types.py, the same encodings byte for byte.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

CODE_TYPE_OK = 0


@dataclass
class Event:
    type: str = ""
    attributes: List[Tuple[bytes, bytes, bool]] = field(default_factory=list)
    # (key, value, index)


@dataclass
class ValidatorUpdate:
    pub_key_type: str
    pub_key_bytes: bytes
    power: int


@dataclass
class RequestInfo:
    version: str = ""
    block_version: int = 0
    p2p_version: int = 0


@dataclass
class ResponseInfo:
    data: str = ""
    version: str = ""
    app_version: int = 0
    last_block_height: int = 0
    last_block_app_hash: bytes = b""


@dataclass
class RequestSetOption:
    key: str = ""
    value: str = ""


@dataclass
class ResponseSetOption:
    code: int = CODE_TYPE_OK
    log: str = ""
    info: str = ""


@dataclass
class RequestInitChain:
    time_ns: int = 0
    chain_id: str = ""
    consensus_params: Optional[object] = None  # types.ConsensusParams
    validators: List[ValidatorUpdate] = field(default_factory=list)
    app_state_bytes: bytes = b""
    initial_height: int = 1


@dataclass
class ResponseInitChain:
    consensus_params: Optional[object] = None
    validators: List[ValidatorUpdate] = field(default_factory=list)
    app_hash: bytes = b""


@dataclass
class RequestQuery:
    data: bytes = b""
    path: str = ""
    height: int = 0
    prove: bool = False


@dataclass
class ResponseQuery:
    code: int = CODE_TYPE_OK
    log: str = ""
    info: str = ""
    index: int = 0
    key: bytes = b""
    value: bytes = b""
    proof_ops: Optional[object] = None
    height: int = 0
    codespace: str = ""


@dataclass
class LastCommitInfo:
    round: int = 0
    votes: List[Tuple[bytes, int, bool]] = field(default_factory=list)
    # (validator address, power, signed_last_block)


@dataclass
class EvidenceABCI:
    type: int = 0  # 1 = duplicate vote
    validator_address: bytes = b""
    validator_power: int = 0
    height: int = 0
    time_ns: int = 0
    total_voting_power: int = 0


@dataclass
class RequestBeginBlock:
    hash: bytes = b""
    header: Optional[object] = None  # types.Header
    last_commit_info: LastCommitInfo = field(default_factory=LastCommitInfo)
    byzantine_validators: List[EvidenceABCI] = field(default_factory=list)


@dataclass
class ResponseBeginBlock:
    events: List[Event] = field(default_factory=list)


CHECK_TX_TYPE_NEW = 0
CHECK_TX_TYPE_RECHECK = 1

# Node-side signature-precheck verdict riding RequestCheckTx (the ABCI
# split behind device-batched tx admission, crypto/scheduler.py): the node
# decoded a signed-tx envelope (types/signed_tx.py) and batch-verified its
# signature through the admission lane, so the app consumes the verdict
# instead of paying a serial per-tx verify. NONE means the node did not
# pre-verify (plain tx, precheck disabled, or a remote submitter) — the
# app must verify itself exactly as before.
SIG_PRECHECK_NONE = 0
SIG_PRECHECK_OK = 1
SIG_PRECHECK_BAD = 2


@dataclass
class RequestCheckTx:
    tx: bytes = b""
    type: int = CHECK_TX_TYPE_NEW
    sig_precheck: int = SIG_PRECHECK_NONE


@dataclass
class ResponseCheckTx:
    code: int = CODE_TYPE_OK
    data: bytes = b""
    log: str = ""
    info: str = ""
    gas_wanted: int = 0
    gas_used: int = 0
    events: List[Event] = field(default_factory=list)
    codespace: str = ""
    sender: str = ""
    priority: int = 0


@dataclass
class RequestDeliverTx:
    tx: bytes = b""


@dataclass
class ResponseDeliverTx:
    code: int = CODE_TYPE_OK
    data: bytes = b""
    log: str = ""
    info: str = ""
    gas_wanted: int = 0
    gas_used: int = 0
    events: List[Event] = field(default_factory=list)
    codespace: str = ""

    def is_ok(self) -> bool:
        return self.code == CODE_TYPE_OK


@dataclass
class RequestEndBlock:
    height: int = 0


@dataclass
class ResponseEndBlock:
    validator_updates: List[ValidatorUpdate] = field(default_factory=list)
    consensus_param_updates: Optional[object] = None
    events: List[Event] = field(default_factory=list)


@dataclass
class ResponseCommit:
    data: bytes = b""  # the app hash
    retain_height: int = 0


@dataclass
class Snapshot:
    height: int = 0
    format: int = 0
    chunks: int = 0
    hash: bytes = b""
    metadata: bytes = b""


@dataclass
class ResponseListSnapshots:
    snapshots: List[Snapshot] = field(default_factory=list)


@dataclass
class RequestOfferSnapshot:
    snapshot: Optional[Snapshot] = None
    app_hash: bytes = b""


OFFER_SNAPSHOT_ACCEPT = 1
OFFER_SNAPSHOT_ABORT = 2
OFFER_SNAPSHOT_REJECT = 3
OFFER_SNAPSHOT_REJECT_FORMAT = 4
OFFER_SNAPSHOT_REJECT_SENDER = 5


@dataclass
class ResponseOfferSnapshot:
    result: int = OFFER_SNAPSHOT_ACCEPT


@dataclass
class RequestLoadSnapshotChunk:
    height: int = 0
    format: int = 0
    chunk: int = 0


@dataclass
class ResponseLoadSnapshotChunk:
    chunk: bytes = b""


APPLY_SNAPSHOT_CHUNK_ACCEPT = 1
APPLY_SNAPSHOT_CHUNK_ABORT = 2
APPLY_SNAPSHOT_CHUNK_RETRY = 3
APPLY_SNAPSHOT_CHUNK_RETRY_SNAPSHOT = 4
APPLY_SNAPSHOT_CHUNK_REJECT_SNAPSHOT = 5


@dataclass
class RequestApplySnapshotChunk:
    index: int = 0
    chunk: bytes = b""
    sender: str = ""


@dataclass
class ResponseApplySnapshotChunk:
    result: int = APPLY_SNAPSHOT_CHUNK_ACCEPT
    refetch_chunks: List[int] = field(default_factory=list)
    reject_senders: List[str] = field(default_factory=list)


class Application:
    """Base application: every method is a no-op returning defaults
    (reference: abci/types/application.go BaseApplication)."""

    def info(self, req: RequestInfo) -> ResponseInfo:
        return ResponseInfo()

    def set_option(self, req: RequestSetOption) -> ResponseSetOption:
        return ResponseSetOption()

    def query(self, req: RequestQuery) -> ResponseQuery:
        return ResponseQuery()

    def check_tx(self, req: RequestCheckTx) -> ResponseCheckTx:
        return ResponseCheckTx()

    def init_chain(self, req: RequestInitChain) -> ResponseInitChain:
        return ResponseInitChain()

    def begin_block(self, req: RequestBeginBlock) -> ResponseBeginBlock:
        return ResponseBeginBlock()

    def deliver_tx(self, req: RequestDeliverTx) -> ResponseDeliverTx:
        return ResponseDeliverTx()

    def end_block(self, req: RequestEndBlock) -> ResponseEndBlock:
        return ResponseEndBlock()

    def commit(self) -> ResponseCommit:
        return ResponseCommit()

    def list_snapshots(self) -> ResponseListSnapshots:
        return ResponseListSnapshots()

    def offer_snapshot(self, req: RequestOfferSnapshot) -> ResponseOfferSnapshot:
        return ResponseOfferSnapshot(result=OFFER_SNAPSHOT_ABORT)

    def load_snapshot_chunk(self, req: RequestLoadSnapshotChunk) -> ResponseLoadSnapshotChunk:
        return ResponseLoadSnapshotChunk()

    def apply_snapshot_chunk(self, req: RequestApplySnapshotChunk) -> ResponseApplySnapshotChunk:
        return ResponseApplySnapshotChunk(result=APPLY_SNAPSHOT_CHUNK_ABORT)

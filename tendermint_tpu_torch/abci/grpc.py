"""ABCI over gRPC: the reference's third transport
(reference: abci/client/grpc_client.go:1, abci/server/grpc_server.go:1,
service `tendermint.abci.ABCIApplication` in proto/tendermint/abci/types.proto);
the port's copy of tendermint_tpu/abci/grpc.py. The only module of the port
besides rpc/grpc_api.py that imports grpc: the node imports it only when
`[base] abci = "grpc"` and `proxy_app` is set.

No generated stubs: grpc-python's generic handlers take per-method
serializers, and the bare RequestX/ResponseX messages are exactly what
abci/wire.py already encodes for the socket transport (same v0.34 field
numbers) — so the wire format matches the reference's gRPC service without a
protoc step.

The reference runs one gRPC call per request with per-call goroutines but
documents that the socket client is the performant one
(abci/client/grpc_client.go:24); matching that, this transport is correct
and simple rather than the hot path — consensus deployments use the local
or socket client.
"""

from __future__ import annotations

import threading
from concurrent import futures
from typing import Optional

import grpc

from tendermint_tpu_torch.abci import types as a
from tendermint_tpu_torch.abci.client import ABCIClient
from tendermint_tpu_torch.abci.wire import REQUEST_TYPES, RESPONSE_TYPES, decode_msg, encode_msg

_SERVICE = "tendermint.abci.ABCIApplication"

# gRPC method name -> (snake name, request cls or None, response cls or None).
# None request/response = empty proto message (Flush/Commit/ListSnapshots…).
_METHODS = {
    "Echo": ("echo", None, None),  # special-cased string codec below
    "Flush": ("flush", None, None),
    "Info": ("info", a.RequestInfo, a.ResponseInfo),
    "SetOption": ("set_option", a.RequestSetOption, a.ResponseSetOption),
    "DeliverTx": ("deliver_tx", a.RequestDeliverTx, a.ResponseDeliverTx),
    "CheckTx": ("check_tx", a.RequestCheckTx, a.ResponseCheckTx),
    "Query": ("query", a.RequestQuery, a.ResponseQuery),
    "Commit": ("commit", None, a.ResponseCommit),
    "InitChain": ("init_chain", a.RequestInitChain, a.ResponseInitChain),
    "BeginBlock": ("begin_block", a.RequestBeginBlock, a.ResponseBeginBlock),
    "EndBlock": ("end_block", a.RequestEndBlock, a.ResponseEndBlock),
    "ListSnapshots": ("list_snapshots", None, a.ResponseListSnapshots),
    "OfferSnapshot": ("offer_snapshot", a.RequestOfferSnapshot, a.ResponseOfferSnapshot),
    "LoadSnapshotChunk": (
        "load_snapshot_chunk", a.RequestLoadSnapshotChunk, a.ResponseLoadSnapshotChunk,
    ),
    "ApplySnapshotChunk": (
        "apply_snapshot_chunk", a.RequestApplySnapshotChunk, a.ResponseApplySnapshotChunk,
    ),
}


def _enc_echo(message: str) -> bytes:
    from tendermint_tpu_torch.libs import protowire as pw

    w = pw.Writer()
    w.string_field(1, message)
    return w.bytes()


def _dec_echo(data: bytes) -> str:
    from tendermint_tpu_torch.libs import protowire as pw

    for f, _, v in pw.Reader(data):
        if f == 1:
            return v.decode()
    return ""


# grpc-python rejects None from (de)serializers, so empty proto messages
# (RequestFlush, RequestCommit, ResponseFlush, …) travel as b"".
def _req_serializer(cls):
    if cls is None:
        return lambda _msg: b""
    return encode_msg


def _req_deserializer(cls):
    if cls is None:
        return lambda _data: b""
    return lambda data: decode_msg(cls, data)


def _resp_serializer(cls):
    if cls is None:
        return lambda _msg: b""
    return encode_msg


def _resp_deserializer(cls):
    if cls is None:
        return lambda _data: b""
    return lambda data: decode_msg(cls, data)


class GrpcServer:
    """Serves one Application over gRPC
    (reference: abci/server/grpc_server.go:30)."""

    def __init__(self, addr: str, app: a.Application, max_workers: int = 8):
        self.app = app
        self._app_lock = threading.Lock()
        self._server = grpc.server(futures.ThreadPoolExecutor(max_workers=max_workers))
        handlers = {}
        for grpc_name, (snake, req_cls, resp_cls) in _METHODS.items():
            handlers[grpc_name] = grpc.unary_unary_rpc_method_handler(
                self._make_handler(grpc_name, snake),
                request_deserializer=(
                    _dec_echo if grpc_name == "Echo" else _req_deserializer(req_cls)
                ),
                response_serializer=(
                    _enc_echo if grpc_name == "Echo" else _resp_serializer(resp_cls)
                ),
            )
        self._server.add_generic_rpc_handlers(
            (grpc.method_handlers_generic_handler(_SERVICE, handlers),)
        )
        host_port = addr.replace("tcp://", "")
        self.port = self._server.add_insecure_port(host_port)
        self.bound_addr = (host_port.rsplit(":", 1)[0], self.port)

    def _make_handler(self, grpc_name: str, snake: str):
        def handle(request, context):
            with self._app_lock:
                if grpc_name == "Echo":
                    return request  # ResponseEcho.message = RequestEcho.message
                if grpc_name == "Flush":
                    return b""
                method = getattr(self.app, snake)
                # commit / list_snapshots take no request message (b"" sentinel)
                return method() if request == b"" else method(request)

        return handle

    def start(self) -> None:
        self._server.start()

    def stop(self) -> None:
        self._server.stop(grace=0.5)


class GrpcClient(ABCIClient):
    """Synchronous gRPC client, one unary call per ABCI request
    (reference: abci/client/grpc_client.go — kept FIFO-equivalent by the
    caller's request ordering; errors surface as exceptions)."""

    def __init__(self, addr: str, timeout: float = 10.0):
        target = addr.replace("tcp://", "").replace("grpc://", "")
        self._channel = grpc.insecure_channel(target)
        self._timeout = timeout
        self._calls = {}
        for grpc_name, (snake, req_cls, resp_cls) in _METHODS.items():
            self._calls[snake] = self._channel.unary_unary(
                f"/{_SERVICE}/{grpc_name}",
                request_serializer=(
                    _enc_echo if grpc_name == "Echo" else _req_serializer(req_cls)
                ),
                response_deserializer=(
                    _dec_echo if grpc_name == "Echo" else _resp_deserializer(resp_cls)
                ),
            )

    def _call(self, name: str, req=None):
        return self._calls[name](req, timeout=self._timeout)

    # -- the 17-method surface ------------------------------------------

    def echo(self, msg: str) -> str:
        return self._call("echo", msg)

    def flush(self) -> None:
        self._call("flush", None)

    def info(self, req):
        return self._call("info", req)

    def set_option(self, req):
        return self._call("set_option", req)

    def query(self, req):
        return self._call("query", req)

    def check_tx(self, req):
        return self._call("check_tx", req)

    def init_chain(self, req):
        return self._call("init_chain", req)

    def begin_block(self, req):
        return self._call("begin_block", req)

    def deliver_tx(self, req):
        return self._call("deliver_tx", req)

    def end_block(self, req):
        return self._call("end_block", req)

    def commit(self):
        return self._call("commit", None)

    def list_snapshots(self):
        return self._call("list_snapshots", None)

    def offer_snapshot(self, req):
        return self._call("offer_snapshot", req)

    def load_snapshot_chunk(self, req):
        return self._call("load_snapshot_chunk", req)

    def apply_snapshot_chunk(self, req):
        return self._call("apply_snapshot_chunk", req)

    def close(self) -> None:
        self._channel.close()

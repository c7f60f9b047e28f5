"""Minimal gRPC broadcast API (reference: rpc/grpc/api.go:1 —
service BroadcastAPI { rpc Ping; rpc BroadcastTx }): the port's copy of
tendermint_tpu/rpc/grpc_api.py, whole. `grpc` is imported with this module,
which the node imports only when `rpc.grpc_laddr` is set.

The reference keeps this deliberately tiny ("only BroadcastTx") and so do
we: Ping answers empty, BroadcastTx runs the full broadcast_tx_commit
semantics (CheckTx -> wait for DeliverTx event) by scheduling the node's RPC
handler on the node's asyncio loop from the gRPC worker thread.

Wire format matches proto/tendermint/rpc/grpc/types.proto:
  RequestBroadcastTx { bytes tx = 1 }
  ResponseBroadcastTx { abci.ResponseCheckTx check_tx = 1;
                        abci.ResponseDeliverTx deliver_tx = 2 }
"""

from __future__ import annotations

import asyncio
import base64
from concurrent import futures

import grpc

from tendermint_tpu_torch.abci import types as a
from tendermint_tpu_torch.abci.wire import encode_msg
from tendermint_tpu_torch.libs import protowire as pw

_SERVICE = "tendermint.rpc.grpc.BroadcastAPI"


def _dec_request_broadcast_tx(data: bytes) -> bytes:
    for f, _, v in pw.Reader(data):
        if f == 1:
            return v
    return b""


def _enc_response_broadcast_tx(resp: dict) -> bytes:
    """resp: the broadcast_tx_commit JSON-RPC result (rpc/server.py)."""

    def _b64(v):
        return base64.b64decode(v) if v else b""

    check = a.ResponseCheckTx(
        code=int(resp["check_tx"]["code"]),
        data=_b64(resp["check_tx"].get("data")),
        log=resp["check_tx"].get("log", ""),
    )
    deliver = resp.get("deliver_tx") or {}
    deliver_msg = a.ResponseDeliverTx(
        code=int(deliver.get("code", 0)),
        data=_b64(deliver.get("data")),
        log=deliver.get("log", ""),
    )
    w = pw.Writer()
    w.message_field(1, encode_msg(check), always=True)
    w.message_field(2, encode_msg(deliver_msg), always=True)
    return w.bytes()


class GrpcBroadcastServer:
    """Serves Ping + BroadcastTx next to the JSON-RPC server
    (enabled by config.rpc.grpc_laddr, reference: config/config.go
    GRPCListenAddress)."""

    def __init__(self, node, addr: str):
        self.node = node
        self._loop: asyncio.AbstractEventLoop | None = None
        self._server = grpc.server(futures.ThreadPoolExecutor(max_workers=4))
        handlers = {
            # grpc-python rejects None from (de)serializers/handlers; empty
            # proto messages travel as b"".
            "Ping": grpc.unary_unary_rpc_method_handler(
                lambda req, ctx: b"",
                request_deserializer=lambda d: b"",
                response_serializer=lambda m: b"",
            ),
            "BroadcastTx": grpc.unary_unary_rpc_method_handler(
                self._broadcast_tx,
                request_deserializer=_dec_request_broadcast_tx,
                response_serializer=_enc_response_broadcast_tx,
            ),
        }
        self._server.add_generic_rpc_handlers(
            (grpc.method_handlers_generic_handler(_SERVICE, handlers),)
        )
        host_port = addr.replace("tcp://", "")
        self.port = self._server.add_insecure_port(host_port)

    def _broadcast_tx(self, tx: bytes, context) -> dict:
        from tendermint_tpu_torch.rpc.client import LocalClient

        client = LocalClient(self.node)
        fut = asyncio.run_coroutine_threadsafe(
            client.call("broadcast_tx_commit", tx="0x" + tx.hex()), self._loop
        )
        return fut.result(timeout=30)

    def start(self) -> None:
        self._loop = asyncio.get_running_loop()
        self._server.start()

    def stop(self) -> None:
        self._server.stop(grace=0.5)

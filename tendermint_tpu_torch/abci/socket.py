"""ABCI socket client + server: length-prefixed proto over TCP/unix with
strict FIFO request/response matching
(reference: abci/client/socket_client.go, abci/server/socket_server.go:30);
the port's copy of tendermint_tpu/abci/socket.py, the same frames.

The client presents the same synchronous ABCIClient surface as the local
client (consensus and mempool call it from sync code), with pipelined
`*_async` variants returning futures — deliver_tx_async is what the executor
uses to pipeline a block's transactions (reference: state/execution.go:308
DeliverTxAsync). A dedicated reader thread matches responses FIFO."""

from __future__ import annotations

import logging
import queue
import socket
import struct
import threading
from concurrent.futures import Future
from typing import Optional, Tuple

from tendermint_tpu_torch.abci import types as a
from tendermint_tpu_torch.abci import wire
from tendermint_tpu_torch.abci.client import ABCIClient
from tendermint_tpu_torch.libs import fail
from tendermint_tpu_torch.libs import protowire as pw

logger = logging.getLogger("tendermint_tpu_torch.abci.socket")


def _read_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("ABCI socket closed")
        buf += chunk
    return buf


def _read_varint(sock: socket.socket) -> int:
    out = shift = 0
    while True:
        b = _read_exact(sock, 1)[0]
        out |= (b & 0x7F) << shift
        if not (b & 0x80):
            return out
        shift += 7
        if shift > 63:
            raise ValueError("varint too long")


def read_frame(sock: socket.socket, max_size: int = 104_857_600) -> bytes:
    ln = _read_varint(sock)
    if ln > max_size:
        raise ValueError("ABCI message too large")
    return _read_exact(sock, ln)


def write_frame(sock: socket.socket, data: bytes) -> None:
    sock.sendall(pw.encode_varint(len(data)) + data)


def _parse_addr(addr: str) -> Tuple[str, object]:
    if addr.startswith("unix://"):
        return "unix", addr[len("unix://") :]
    addr = addr.split("://", 1)[-1]
    host, _, port = addr.rpartition(":")
    return "tcp", (host or "127.0.0.1", int(port))


class SocketClient(ABCIClient):
    """(reference: abci/client/socket_client.go)"""

    def __init__(
        self,
        addr: str,
        connect_timeout: float = 10.0,
        call_timeout: float = 30.0,
    ):
        self.addr = addr
        self.call_timeout = call_timeout  # per-call ([base] abci_call_timeout)
        kind, target = _parse_addr(addr)
        if kind == "unix":
            self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        else:
            self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.settimeout(connect_timeout)
        self._sock.connect(target)
        self._sock.settimeout(None)
        self._wlock = threading.Lock()
        self._pending: "queue.Queue[Tuple[str, Future]]" = queue.Queue()
        self._closed = False
        self._dead: Optional[Exception] = None  # reader died / socket broke
        self._reader = threading.Thread(target=self._recv_routine, daemon=True, name="abci-sock-recv")
        self._reader.start()

    def close(self) -> None:
        self._closed = True
        try:
            self._sock.close()
        except OSError:
            pass

    def is_dead(self) -> bool:
        return self._closed or self._dead is not None

    # -- plumbing ----------------------------------------------------------

    def _recv_routine(self) -> None:
        """Strict FIFO matching (reference: socket_client.go recvResponseRoutine)."""
        try:
            while not self._closed:
                frame = read_frame(self._sock)
                method, msg = wire.decode_response(frame)
                if method == "flush":
                    continue  # flush responses pair with flush requests we absorb
                want, fut = self._pending.get_nowait()
                if want != method:
                    err = RuntimeError(f"unexpected response {method}, want {want}")
                    if not fut.done():
                        fut.set_exception(err)  # fail the popped waiter too
                    raise err
                fut.set_result(msg)
        except Exception as e:
            self._dead = e
            if not self._closed:
                logger.error("ABCI socket reader died: %s", e)
            # fail all pending futures
            while True:
                try:
                    _, fut = self._pending.get_nowait()
                except queue.Empty:
                    break
                if not fut.done():
                    fut.set_exception(ConnectionError(str(e)))

    def _call_async(self, method: str, msg=None) -> Future:
        if self.is_dead():
            raise ConnectionError(
                f"ABCI socket client is dead: {self._dead or 'closed'}"
            )
        # chaos hook: a registered handler can kill the app server (or this
        # client's socket) mid-flight to exercise the reconnect path
        # (docs/ROBUSTNESS.md fail-point catalog)
        fail.fail_point("abci_client_call")
        fut: Future = Future()
        with self._wlock:
            self._pending.put((method, fut))
            write_frame(self._sock, wire.encode_request(method, msg))
        return fut

    def _call(self, method: str, msg=None):
        fut = self._call_async(method, msg)
        self.flush()
        return fut.result(timeout=self.call_timeout)

    def flush(self) -> None:
        with self._wlock:
            write_frame(self._sock, wire.encode_request("flush"))

    # -- the 17 methods ----------------------------------------------------

    def echo(self, msg: str) -> str:
        return msg  # transport liveness only

    def info(self, req: a.RequestInfo) -> a.ResponseInfo:
        return self._call("info", req)

    def set_option(self, req: a.RequestSetOption) -> a.ResponseSetOption:
        return self._call("set_option", req)

    def query(self, req: a.RequestQuery) -> a.ResponseQuery:
        return self._call("query", req)

    def check_tx(self, req: a.RequestCheckTx) -> a.ResponseCheckTx:
        return self._call("check_tx", req)

    def init_chain(self, req: a.RequestInitChain) -> a.ResponseInitChain:
        return self._call("init_chain", req)

    def begin_block(self, req: a.RequestBeginBlock) -> a.ResponseBeginBlock:
        return self._call("begin_block", req)

    def deliver_tx(self, req: a.RequestDeliverTx) -> a.ResponseDeliverTx:
        return self._call("deliver_tx", req)

    def deliver_tx_async(self, req: a.RequestDeliverTx) -> Future:
        """Pipelined delivery (reference: state/execution.go:308)."""
        return self._call_async("deliver_tx", req)

    def end_block(self, req: a.RequestEndBlock) -> a.ResponseEndBlock:
        return self._call("end_block", req)

    def commit(self) -> a.ResponseCommit:
        return self._call("commit")

    def list_snapshots(self) -> a.ResponseListSnapshots:
        return self._call("list_snapshots")

    def offer_snapshot(self, req: a.RequestOfferSnapshot) -> a.ResponseOfferSnapshot:
        return self._call("offer_snapshot", req)

    def load_snapshot_chunk(self, req: a.RequestLoadSnapshotChunk) -> a.ResponseLoadSnapshotChunk:
        return self._call("load_snapshot_chunk", req)

    def apply_snapshot_chunk(self, req: a.RequestApplySnapshotChunk) -> a.ResponseApplySnapshotChunk:
        return self._call("apply_snapshot_chunk", req)


class SocketServer:
    """Serves one Application to N connections, each handled by a thread;
    requests processed in order per connection
    (reference: abci/server/socket_server.go:30)."""

    def __init__(self, addr: str, app: a.Application):
        self.app = app
        self.kind, self.target = _parse_addr(addr)
        if self.kind == "unix":
            self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        else:
            self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind(self.target)
        self._sock.listen(8)
        self._app_lock = threading.Lock()  # one app, many conns
        self._threads = []
        self._conns: list = []  # live accepted sockets, closed on stop()
        self._running = False
        self.bound_addr = self._sock.getsockname()

    def start(self) -> None:
        self._running = True
        t = threading.Thread(target=self._accept_routine, daemon=True, name="abci-srv-accept")
        t.start()
        self._threads.append(t)

    def stop(self) -> None:
        """Close the listener AND every accepted connection — a stopped app
        must look dead to its clients immediately (their reads fail now, not
        whenever the OS notices), which is what the reconnect path and the
        chaos app-restart scenario key off."""
        self._running = False
        try:
            # shutdown BEFORE close: a thread blocked in accept() pins the
            # open file description, so close() alone leaves the port in
            # LISTEN until that accept returns — shutdown wakes it, making
            # an immediate rebind (app restart on the same port) possible
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        for conn in list(self._conns):
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                conn.close()
            except OSError:
                pass
        self._conns.clear()

    def serve_forever(self) -> None:
        self.start()
        import time

        while self._running:
            time.sleep(0.2)

    def _accept_routine(self) -> None:
        while self._running:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            # daemon handler threads are not tracked: reconnecting clients
            # would otherwise accumulate dead Thread objects unboundedly
            self._conns.append(conn)
            threading.Thread(target=self._handle_conn, args=(conn,), daemon=True).start()

    def _handle_conn(self, conn: socket.socket) -> None:
        try:
            while True:
                frame = read_frame(conn)
                method, msg = wire.decode_request(frame)
                if method == "flush":
                    write_frame(conn, wire.encode_response("flush"))
                    continue
                if method == "echo":
                    write_frame(conn, wire.encode_response("echo"))
                    continue
                try:
                    with self._app_lock:
                        handler = getattr(self.app, method)
                        resp = handler(msg) if msg is not None else handler()
                    write_frame(conn, wire.encode_response(method, resp))
                except Exception as e:  # app error -> exception response
                    logger.exception("app %s failed", method)
                    write_frame(conn, wire.encode_response(method, exception=str(e)))
        except (ConnectionError, OSError):
            pass
        finally:
            try:
                self._conns.remove(conn)
            except ValueError:
                pass
            try:
                conn.close()
            except OSError:
                pass

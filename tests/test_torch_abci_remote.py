"""The port's remote ABCI transports (abci/socket.py, abci/grpc.py, the
ReconnectingClient of abci/client.py, the creators of proxy/multi.py) against
the JAX package's.

Each client talks to the other package's server over every ABCI method,
the four snapshot methods included, on a kvstore app taking a snapshot every
height: the responses are equal, and the frames each side writes are byte
for byte the other package's. The ReconnectingClient of either package
survives a server restart on the same port. A port Node whose app runs
behind a socket or a gRPC server (base.proxy_app) commits heights whose app
hashes equal those of the same chain on the in-process app.
"""

import asyncio
import importlib
import os
import threading
from types import SimpleNamespace

import numpy as np
import pytest

os.environ.setdefault("TMTPU_CRYPTO_BACKEND", "cpu")

pytest.importorskip("grpc")

_MODULES = {
    "abci": "abci.types", "wire": "abci.wire", "client": "abci.client",
    "socket": "abci.socket", "grpc": "abci.grpc", "kvstore": "abci.kvstore",
    "multi": "proxy.multi",
}


def pkg(which: str) -> SimpleNamespace:
    root = "tendermint_tpu" if which == "ref" else "tendermint_tpu_torch"
    return SimpleNamespace(which=which, **{k: importlib.import_module(f"{root}.{m}")
                                         for k, m in _MODULES.items()})


REF, PORT = pkg("ref"), pkg("port")


def calls(P, rng):
    """Every ABCI method, in an order the kvstore accepts: (method, request)."""
    a = P.abci
    txs = [b"k%d=v%d" % (i, int(v)) for i, v in enumerate(rng.integers(0, 1 << 30, 3))]
    out = [("info", a.RequestInfo(version="0.34")),
           ("set_option", a.RequestSetOption(key="k", value="v")),
           ("init_chain", a.RequestInitChain(chain_id="remote-chain", time_ns=5))]
    for h in (1, 2):
        out.append(("begin_block", a.RequestBeginBlock(hash=bytes(rng.integers(0, 256, 32,
                                                                               np.uint8)))))
        out += [("check_tx", a.RequestCheckTx(tx=tx)) for tx in txs]
        out += [("deliver_tx", a.RequestDeliverTx(tx=tx + b"%d" % h)) for tx in txs]
        out += [("end_block", a.RequestEndBlock(height=h)), ("commit", None)]
    out += [("query", a.RequestQuery(data=b"k0", path="/store")),
            ("list_snapshots", None),
            ("load_snapshot_chunk", a.RequestLoadSnapshotChunk(2, 1, 0))]
    return out


def restore_calls(P, snap, chunk, app_hash):
    a = P.abci
    s = a.Snapshot(height=snap.height, format=snap.format, chunks=snap.chunks,
                   hash=snap.hash, metadata=snap.metadata)
    return [("offer_snapshot", a.RequestOfferSnapshot(snapshot=s, app_hash=app_hash)),
            ("apply_snapshot_chunk", a.RequestApplySnapshotChunk(index=0, chunk=chunk,
                                                                  sender="peer")),
            ("info", a.RequestInfo())]


def drive(client, P, seed):
    """Run the calls on `client`: the responses encoded by P's wire codec."""
    rng = np.random.default_rng(seed)
    out = []
    for method, req in calls(P, rng):
        resp = getattr(client, method)(req) if req is not None else getattr(client, method)()
        out.append(P.wire.encode_response(method, resp))
    return out


class Recorder:
    """Frames written by one package's socket module."""

    def __init__(self, P, monkeypatch):
        self.frames = []
        real = P.socket.write_frame

        def write_frame(sock, data):
            self.frames.append(bytes(data))
            real(sock, data)

        monkeypatch.setattr(P.socket, "write_frame", write_frame)


def socket_session(C, S, seed, monkeypatch):
    """C's SocketClient against S's SocketServer: responses, the client's and
    the server's frames, then a restore of the served snapshot."""
    with monkeypatch.context() as mp:
        rc, rs = Recorder(C, mp), Recorder(S, mp)
        server = S.socket.SocketServer("tcp://127.0.0.1:0",
                                       S.kvstore.KVStoreApplication(snapshot_interval=1))
        server.start()
        client = C.socket.SocketClient(f"tcp://127.0.0.1:{server.bound_addr[1]}")
        try:
            resps = drive(client, C, seed)
            snap = client.list_snapshots().snapshots[-1]
            chunk = client.load_snapshot_chunk(C.abci.RequestLoadSnapshotChunk(
                snap.height, snap.format, 0)).chunk
            app_hash = client.info(C.abci.RequestInfo()).last_block_app_hash
        finally:
            client.close()
            server.stop()
        server2 = S.socket.SocketServer("tcp://127.0.0.1:0", S.kvstore.KVStoreApplication())
        server2.start()
        client2 = C.socket.SocketClient(f"tcp://127.0.0.1:{server2.bound_addr[1]}")
        try:
            for method, req in restore_calls(C, snap, chunk, app_hash):
                resps.append(C.wire.encode_response(method, getattr(client2, method)(req)))
        finally:
            client2.close()
            server2.stop()
        # the reader thread's flush frames interleave with the calls: keep the
        # non-flush frames, whose order is the calls'
        flush_req, flush_resp = C.wire.encode_request("flush"), S.wire.encode_response("flush")
        return (resps, [f for f in rc.frames if f[-len(flush_req):] != flush_req],
                [f for f in rs.frames if f[-len(flush_resp):] != flush_resp])


def test_socket_transport_both_directions(monkeypatch):
    """A port SocketClient on a reference SocketServer and a reference client
    on a port server: every method answers the same, and each side writes
    the other package's frames byte for byte."""
    port_on_ref = socket_session(PORT, REF, 7, monkeypatch)
    ref_on_port = socket_session(REF, PORT, 7, monkeypatch)
    assert port_on_ref[0] == ref_on_port[0]
    assert port_on_ref[1] == ref_on_port[1]  # the clients' frames
    assert port_on_ref[2] == ref_on_port[2]  # the servers' frames
    # the restore succeeded: offer accepted, chunk accepted, app hash restored
    a = PORT.abci
    offer, apply_, info = (PORT.wire.decode_response(f)[1] for f in port_on_ref[0][-3:])
    assert offer.result == a.OFFER_SNAPSHOT_ACCEPT
    assert apply_.result == a.APPLY_SNAPSHOT_CHUNK_ACCEPT
    assert info.last_block_height == 2


def test_socket_frame_codec_is_shared():
    """read_frame / write_frame / _read_varint: the same uvarint framing."""
    import socket as sk

    for data in (b"", b"x", bytes(range(200)), b"y" * 70_000):
        for W, R in ((PORT, REF), (REF, PORT)):
            a, b = sk.socketpair()
            try:
                W.socket.write_frame(a, data)
                assert R.socket.read_frame(b) == data
            finally:
                a.close()
                b.close()


def grpc_session(C, S, seed):
    server = S.grpc.GrpcServer("tcp://127.0.0.1:0",
                               S.kvstore.KVStoreApplication(snapshot_interval=1))
    server.start()
    client = C.grpc.GrpcClient(f"tcp://127.0.0.1:{server.port}")
    try:
        assert client.echo("hello") == "hello"
        client.flush()
        resps = drive(client, C, seed)
        snap = client.list_snapshots().snapshots[-1]
        chunk = client.load_snapshot_chunk(C.abci.RequestLoadSnapshotChunk(
            snap.height, snap.format, 0)).chunk
        app_hash = client.info(C.abci.RequestInfo()).last_block_app_hash
    finally:
        client.close()
        server.stop()
    server2 = S.grpc.GrpcServer("tcp://127.0.0.1:0", S.kvstore.KVStoreApplication())
    server2.start()
    client2 = C.grpc.GrpcClient(f"tcp://127.0.0.1:{server2.port}")
    try:
        for method, req in restore_calls(C, snap, chunk, app_hash):
            resps.append(C.wire.encode_response(method, getattr(client2, method)(req)))
    finally:
        client2.close()
        server2.stop()
    return resps


def test_grpc_transport_both_directions():
    """The gRPC service: a port client on a reference server and the other way
    round answer every method with the same messages; the message bytes are
    the shared wire codec's (the serializers are encode_msg)."""
    port_on_ref = grpc_session(PORT, REF, 11)
    ref_on_port = grpc_session(REF, PORT, 11)
    assert port_on_ref == ref_on_port
    info = PORT.wire.decode_response(port_on_ref[-1])[1]
    assert info.last_block_height == 2 and info.last_block_app_hash
    # the request messages the two clients serialize are the same bytes
    for (m1, r1), (m2, r2) in zip(calls(PORT, np.random.default_rng(3)),
                                  calls(REF, np.random.default_rng(3))):
        if r1 is not None:
            assert PORT.wire.encode_msg(r1) == REF.wire.encode_msg(r2)


@pytest.mark.parametrize("which", ["port", "ref"])
def test_reconnecting_client_across_server_restart(which):
    """ReconnectingClient over a socket app that restarts on the same port:
    the call during the outage retries with backoff and lands on the new
    server. An exception the app raises in process passes through with no
    retry (only transport errors are retried)."""
    P = PORT if which == "port" else REF

    class Failing(P.kvstore.KVStoreApplication):
        def query(self, req):
            raise ValueError("app says no")

    local = P.client.ReconnectingClient(P.multi.local_client_creator(Failing()), attempts=3,
                                        base_delay=0.01, max_delay=0.02)
    with pytest.raises(ValueError, match="app says no"):
        local.query(P.abci.RequestQuery(data=b"a"))
    assert local.reconnects == 0

    server = P.socket.SocketServer("tcp://127.0.0.1:0", P.kvstore.KVStoreApplication())
    server.start()
    addr = f"tcp://127.0.0.1:{server.bound_addr[1]}"  # the restart binds the same port
    rc = P.client.ReconnectingClient(P.multi.socket_client_creator(addr), attempts=6,
                                     base_delay=0.05, max_delay=0.2, name="mempool")
    restarted = {}
    try:
        assert rc.check_tx(P.abci.RequestCheckTx(tx=b"a=1")).code == 0
        assert rc.reconnects == 0
        server.stop()

        def restart():
            import time

            time.sleep(0.15)
            restarted["server"] = P.socket.SocketServer(addr, P.kvstore.KVStoreApplication())
            restarted["server"].start()

        t = threading.Thread(target=restart)
        t.start()
        info = rc.info(P.abci.RequestInfo())
        t.join()
        assert info.last_block_height == 0
        assert rc.reconnects >= 1
    finally:
        rc.close()
        server.stop()
        if "server" in restarted:
            restarted["server"].stop()


def test_port_client_creators_and_app_conns():
    """default_client_creator picks the transport as the reference's does;
    AppConns(resilient=True) wraps all but the consensus conn."""
    m = PORT.multi
    with pytest.raises(ValueError):
        m.default_client_creator("", "socket")
    server = PORT.socket.SocketServer("tcp://127.0.0.1:0", PORT.kvstore.KVStoreApplication())
    server.start()
    try:
        conns = m.AppConns(m.default_client_creator(
            f"tcp://127.0.0.1:{server.bound_addr[1]}", "socket"),
                           resilient=True, attempts=2, base_delay=0.01, max_delay=0.02)
        assert isinstance(conns.consensus, PORT.socket.SocketClient)
        for c in (conns.mempool, conns.query, conns.snapshot):
            assert isinstance(c, PORT.client.ReconnectingClient)
        assert conns.query.info(PORT.abci.RequestInfo()).last_block_height == 0
        conns.stop()
    finally:
        server.stop()


# ------------------------------------------------------------ the node


def run_chain(transport, tmp_path, heights=4):
    """A port validator node on an app that runs in process, behind a port
    SocketServer, or behind a port GrpcServer: (app hashes of heights 1..)."""
    from tendermint_tpu_torch.config import test_config
    from tendermint_tpu_torch.crypto.keys import gen_ed25519
    from tendermint_tpu_torch.node.node import Node
    from tendermint_tpu_torch.privval.file_pv import FilePV
    from tendermint_tpu_torch.types.genesis import GenesisDoc, GenesisValidator

    priv = gen_ed25519(b"\x42" * 32)
    gen = GenesisDoc(chain_id="remote-app-chain", genesis_time_ns=1_700_000_000_000_000_000,
                     validators=[GenesisValidator(priv.pub_key(), 10)])
    cfg = test_config()
    cfg.base.db_backend, cfg.root_dir, cfg.rpc.laddr = "memdb", "", ""
    cfg.instrumentation.forensics_dir = ""
    cfg.consensus.wal_path = str(tmp_path / transport / "wal")
    cfg.consensus.timeout_commit = 0.05
    cfg.consensus.skip_timeout_commit = False
    server = None
    app = PORT.kvstore.KVStoreApplication()
    if transport == "socket":
        server = PORT.socket.SocketServer("tcp://127.0.0.1:0", app)
        cfg.base.proxy_app = f"tcp://127.0.0.1:{server.bound_addr[1]}"
    elif transport == "grpc":
        server = PORT.grpc.GrpcServer("tcp://127.0.0.1:0", app)
        cfg.base.proxy_app = f"tcp://127.0.0.1:{server.port}"
        cfg.base.abci = "grpc"
    if server is not None:
        server.start()

    async def go():
        node = Node(cfg, gen, priv_validator=FilePV(priv), device="cpu",
                    app=app if server is None else None)
        for i in range(3):  # before the start: all three go into block 1
            node.mempool.check_tx(b"remote%d=v%d" % (i, i))
        await node.start()
        try:
            await node.wait_for_height(heights, timeout=30)
            hashes = [node.block_store.load_block(h).header.app_hash
                      for h in range(1, heights + 1)]
            kinds = {type(c).__name__ for c in (node.proxy_app.consensus,
                                                node.proxy_app.mempool)}
            return hashes, kinds
        finally:
            await node.stop()

    try:
        return asyncio.run(asyncio.wait_for(go(), 60))
    finally:
        if server is not None:
            server.stop()


def test_node_on_remote_apps_commits_the_in_process_hashes(tmp_path):
    """base.proxy_app over the socket and over gRPC: the node commits, and
    the app hashes in the headers of heights 1-4 equal the in-process app's."""
    local, kinds = run_chain("local", tmp_path)
    sock, sock_kinds = run_chain("socket", tmp_path)
    grpc_, grpc_kinds = run_chain("grpc", tmp_path)
    assert local == sock == grpc_
    assert any(h != local[0] for h in local)  # the txs moved the hash
    assert kinds == {"LocalClient"}
    assert sock_kinds == {"SocketClient", "ReconnectingClient"}
    assert grpc_kinds == {"GrpcClient", "ReconnectingClient"}

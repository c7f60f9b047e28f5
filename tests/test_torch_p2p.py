"""The port's p2p fabric (tendermint_tpu_torch/p2p/) beside the JAX
package's and across it, tolerance 0.

Port only, the reference's own tests run on the port's modules:
tests/test_p2p.py:78-245 (secret-connection handshake and frames, channel
routing, a large multiplexed message, peer removal, the wrong network and
the wrong ID refused, the trust store across a restart),
tests/test_evil_secret_connection.py:64-219 (all nine evil peers) and
tests/test_pex.py:37-195 (the address book, the PEX codec, the reactor).

Across the packages, on 127.0.0.1:0 in one event loop: a port
SecretConnection handshakes with a reference one in both roles and sealed
frames pass both ways; a port Switch dials a reference Switch and the other
way round, and a message over 1 MB on one channel and small ones on another
arrive whole and in order; NodeKey IDs and NodeInfo.encode() bytes are equal
for the same seed and fields; a port PexReactor and a reference one exchange
addresses, and a third node is connected through PEX; the seeded fuzzed
connection drops the same writes in both packages.
"""

import asyncio
import hashlib
import struct

import pytest

pytest.importorskip("cryptography")

from cryptography.hazmat.primitives import serialization
from cryptography.hazmat.primitives.asymmetric.x25519 import X25519PrivateKey, X25519PublicKey
from cryptography.hazmat.primitives.ciphers.aead import ChaCha20Poly1305

from tendermint_tpu_torch import convert
from tests.torch_p2p_util import PORT, REF, run, wait_for

SC = PORT.secret


class EchoMixin:
    """Records every message; echoes on channel 0x02 (tests/test_p2p.py)."""

    def __init__(self, name, P=PORT):
        super().__init__(name)
        self.P = P
        self.received = []
        self.peers_added = []
        self.peers_removed = []
        self.got = asyncio.Event()

    def get_channels(self):
        return [self.P.conn.ChannelDescriptor(id=0x01, priority=5),
                self.P.conn.ChannelDescriptor(id=0x02, priority=1)]

    async def add_peer(self, peer):
        self.peers_added.append(peer.id)

    async def remove_peer(self, peer, reason):
        self.peers_removed.append(peer.id)

    async def receive(self, chan_id, peer, msg):
        self.received.append((chan_id, msg))
        self.got.set()
        if chan_id == 0x02:
            await peer.send(0x01, b"echo:" + msg)


def _reactor_cls(P):
    """The echo reactor on package P's Reactor base."""
    return type(f"Echo{P.which}", (EchoMixin, P.p2p.Reactor), {})


def make_switch(name, chain="p2p-test", secret=True, P=PORT):
    nk = P.key.NodeKey(P.keys.gen_ed25519())
    ni = P.node_info.NodeInfo(node_id=nk.id, network=chain, moniker=name)
    sw = P.switch.Switch(P.transport.MultiplexTransport(nk, ni, use_secret_conn=secret))
    reactor = _reactor_cls(P)(f"echo-{name}", P)
    sw.add_reactor("echo", reactor)
    return sw, reactor


async def start_pair(secret=True, P1=PORT, P2=PORT):
    sw1, r1 = make_switch("alice", secret=secret, P=P1)
    sw2, r2 = make_switch("bob", secret=secret, P=P2)
    await sw1.start()
    await sw2.start()
    addr = await sw1.transport.listen("127.0.0.1", 0)
    await sw2.dial_peer(f"{sw1.node_info.node_id}@{addr}")
    await wait_for(lambda: sw1.num_peers() and sw2.num_peers(), 5, "the pair")
    return sw1, r1, sw2, r2


# -- tests/test_p2p.py on the port ---------------------------------------------


def test_secret_connection_handshake_and_frames():
    async def go():
        k1, k2 = PORT.keys.gen_ed25519(), PORT.keys.gen_ed25519()
        server_done = asyncio.get_running_loop().create_future()

        async def on_conn(reader, writer):
            sc = await SC.SecretConnection.upgrade(reader, writer, k1)
            msg = await sc.read_msg()
            await sc.write_msg(b"pong:" + msg)
            server_done.set_result(sc.remote_pubkey.bytes())

        server = await asyncio.start_server(on_conn, "127.0.0.1", 0)
        port = server.sockets[0].getsockname()[1]
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        sc = await SC.SecretConnection.upgrade(reader, writer, k2)
        assert sc.remote_pubkey.bytes() == k1.pub_key().bytes()
        big = bytes(range(256)) * 20  # 5,120 bytes: several frames
        await sc.write_msg(big)
        assert await sc.read_msg() == b"pong:" + big
        assert await server_done == k2.pub_key().bytes()
        server.close()

    run(go(), 30)


def test_switch_connects_and_routes_channels():
    async def go():
        sw1, r1, sw2, r2 = await start_pair()
        try:
            assert sw1.num_peers() == 1 and sw2.num_peers() == 1
            await sw2.peers.list()[0].send(0x02, b"hello")
            await wait_for(lambda: (0x01, b"echo:hello") in r2.received, 5, "the echo")
            assert (0x02, b"hello") in r1.received
            await sw1.broadcast(0x01, b"blast")
            await wait_for(lambda: (0x01, b"blast") in r2.received, 5, "the broadcast")
        finally:
            await sw2.stop()
            await sw1.stop()

    run(go(), 30)


def test_large_message_multiplexed():
    async def go():
        sw1, r1, sw2, r2 = await start_pair()
        try:
            big = bytes(range(256)) * 300  # 76,800 bytes: 75 packets
            await sw2.peers.list()[0].send(0x01, big)
            await wait_for(lambda: any(m == big for _, m in r1.received), 5, "the message")
        finally:
            await sw2.stop()
            await sw1.stop()

    run(go(), 30)


def test_peer_removal_on_disconnect():
    async def go():
        sw1, r1, sw2, r2 = await start_pair()
        try:
            peer = sw1.peers.list()[0]
            await sw1.stop_peer_for_error(peer, "test kill")
            assert sw1.num_peers() == 0
            assert r1.peers_removed == [peer.id]
            await wait_for(lambda: sw2.num_peers() == 0, 5, "bob noticing")
        finally:
            await sw2.stop()
            await sw1.stop()

    run(go(), 30)


@pytest.mark.parametrize("case", ["network", "wrong_id"])
def test_dial_refused(case):
    """A peer on another network, and a dial that names the wrong ID, are
    refused and leave no peer on either side."""

    async def go():
        sw1, _ = make_switch("alice", chain="chain-A")
        sw2, _ = make_switch("bob", chain="chain-B" if case == "network" else "chain-A")
        await sw1.start()
        await sw2.start()
        try:
            addr = await sw1.transport.listen("127.0.0.1", 0)
            node_id = sw1.node_info.node_id if case == "network" else "ab" * 20
            with pytest.raises(Exception):
                await sw2.dial_peer(f"{node_id}@{addr}")
            assert sw2.num_peers() == 0
            await asyncio.sleep(0.1)
            assert sw1.num_peers() == 0
        finally:
            await sw2.stop()
            await sw1.stop()

    run(go(), 30)


def test_trust_store_persists_across_restart(tmp_path):
    B = PORT.behaviour
    path = str(tmp_path / "trust.json")
    rep = B.Reporter(store=B.TrustStore(path))

    async def drive():
        for _ in range(5):
            await rep.report(B.PeerBehaviour("peer-a", B.CONSENSUS_VOTE))
        for _ in range(3):
            await rep.report(B.PeerBehaviour("peer-b", B.BAD_MESSAGE))

    run(drive(), 10)
    assert rep.score("peer-a") > 0.9
    assert rep.score("peer-b") < 0.5
    rep.save()
    rep2 = B.Reporter(store=B.TrustStore(path))
    assert rep2.score("peer-a") > 0.9
    assert rep2.score("peer-b") < 0.5
    with open(path, "w") as f:
        f.write("{not json")
    assert B.Reporter(store=B.TrustStore(path)).score("peer-a") == 1.0


# -- tests/test_evil_secret_connection.py on the port -----------------------


def run_handshake_against(evil_peer, timeout=10):
    """A server runs the port's real upgrade; the evil client talks to it;
    returns the server-side exception (None on success)."""

    async def go():
        key = PORT.keys.gen_ed25519()
        outcome = asyncio.get_running_loop().create_future()

        async def on_conn(reader, writer):
            try:
                await asyncio.wait_for(SC.SecretConnection.upgrade(reader, writer, key), timeout)
                outcome.set_result(None)
            except Exception as e:
                if not outcome.done():
                    outcome.set_result(e)

        server = await asyncio.start_server(on_conn, "127.0.0.1", 0)
        port = server.sockets[0].getsockname()[1]
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        try:
            await evil_peer(reader, writer)
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        result = await asyncio.wait_for(outcome, timeout + 5)
        writer.close()
        server.close()
        return result

    return run(go(), timeout + 20)


class _EvilFramer:
    """Speaks the real post-DH framing so auth-stage attacks can be scripted
    (the reference test's framer, over the port's _hkdf)."""

    def __init__(self, reader, writer):
        self.reader = reader
        self.writer = writer

    async def dh(self):
        self.eph = X25519PrivateKey.generate()
        my_pub = self.eph.public_key().public_bytes(
            serialization.Encoding.Raw, serialization.PublicFormat.Raw)
        self.writer.write(struct.pack(">I", 32) + my_pub)
        await self.writer.drain()
        hdr = await self.reader.readexactly(4)
        assert struct.unpack(">I", hdr)[0] == 32
        their_pub = await self.reader.readexactly(32)
        shared = self.eph.exchange(X25519PublicKey.from_public_bytes(their_pub))
        low_is_us = my_pub < their_pub
        lo, hi = (my_pub, their_pub) if low_is_us else (their_pub, my_pub)
        recv_secret, send_secret, challenge_lo = SC._hkdf(shared + lo + hi)
        send_key, recv_key = ((send_secret, recv_secret) if low_is_us
                              else (recv_secret, send_secret))
        self.send = ChaCha20Poly1305(send_key)
        self.recv = ChaCha20Poly1305(recv_key)
        self.send_seq = 0
        self.transcript = hashlib.sha256(
            b"TMTPU_SECRET_CONNECTION_TRANSCRIPT" + lo + hi + challenge_lo).digest()

    async def send_msg(self, payload: bytes):
        chunk = struct.pack(">I", len(payload)) + payload
        frame = struct.pack("<I", len(chunk)) + chunk
        frame += b"\x00" * (4 + 1024 - len(frame))
        nonce = struct.pack("<Q", self.send_seq) + b"\x00\x00\x00\x00"
        self.send_seq += 1
        self.writer.write(self.send.encrypt(nonce, frame, None))
        await self.writer.drain()


async def _wrong_length_ephemeral(reader, writer):
    writer.write(struct.pack(">I", 31) + b"\x01" * 31)
    await writer.drain()


async def _low_order_ephemeral(reader, writer):
    writer.write(struct.pack(">I", 32) + b"\x00" * 32)
    await writer.drain()
    await reader.readexactly(4 + 32)


async def _garbage_auth(reader, writer):
    eph = X25519PrivateKey.generate()
    pub = eph.public_key().public_bytes(serialization.Encoding.Raw,
                                        serialization.PublicFormat.Raw)
    writer.write(struct.pack(">I", 32) + pub)
    await writer.drain()
    await reader.readexactly(4 + 32)
    writer.write(b"\xAA" * (4 + 1024 + 16))
    await writer.drain()


async def _sig_over_wrong_transcript(reader, writer):
    f = _EvilFramer(reader, writer)
    await f.dh()
    key = PORT.keys.gen_ed25519()
    await f.send_msg(key.pub_key().bytes() + key.sign(b"not-the-transcript"))


async def _key_mismatch_sig(reader, writer):
    f = _EvilFramer(reader, writer)
    await f.dh()
    claimed, signer = PORT.keys.gen_ed25519(), PORT.keys.gen_ed25519()
    await f.send_msg(claimed.pub_key().bytes() + signer.sign(f.transcript))


async def _auth_wrong_size(reader, writer):
    f = _EvilFramer(reader, writer)
    await f.dh()
    await f.send_msg(b"\x01" * 77)


@pytest.mark.parametrize("evil,needle", [
    (_wrong_length_ephemeral, "ephemeral key length"),
    (_low_order_ephemeral, "ephemeral point"),
    (_garbage_auth, "decryption failed"),
    (_sig_over_wrong_transcript, "signature verification failed"),
    (_key_mismatch_sig, "signature verification failed"),
    (_auth_wrong_size, "auth message size"),
], ids=["wrong_length_ephemeral", "low_order_ephemeral", "garbage_auth",
        "sig_over_wrong_transcript", "key_mismatch_sig", "auth_wrong_size"])
def test_evil_handshake_refused(evil, needle):
    err = run_handshake_against(evil)
    assert isinstance(err, SC.HandshakeError)
    assert needle in str(err)


def test_early_disconnect_mid_handshake():
    async def evil(reader, writer):
        writer.write(struct.pack(">I", 32) + b"\x09" * 16)
        await writer.drain()
        writer.close()

    err = run_handshake_against(evil)
    assert err is not None and not isinstance(err, asyncio.TimeoutError)


def test_honest_framer_would_succeed():
    async def honest(reader, writer):
        f = _EvilFramer(reader, writer)
        await f.dh()
        key = PORT.keys.gen_ed25519()
        await f.send_msg(key.pub_key().bytes() + key.sign(f.transcript))

    assert run_handshake_against(honest) is None


def test_post_handshake_frame_tampering():
    async def go():
        k1, k2 = PORT.keys.gen_ed25519(), PORT.keys.gen_ed25519()
        got = asyncio.get_running_loop().create_future()

        async def on_conn(reader, writer):
            sc = await SC.SecretConnection.upgrade(reader, writer, k1)
            try:
                await sc.read_msg()
                got.set_result(None)
            except Exception as e:
                got.set_result(e)

        server = await asyncio.start_server(on_conn, "127.0.0.1", 0)
        port = server.sockets[0].getsockname()[1]
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        sc = await SC.SecretConnection.upgrade(reader, writer, k2)
        payload = b"tamper-me"
        chunk = struct.pack(">I", len(payload)) + payload
        frame = struct.pack("<I", len(chunk)) + chunk
        frame += b"\x00" * (4 + 1024 - len(frame))
        sealed = bytearray(sc._send.encrypt(sc._send_nonce.use(), bytes(frame), None))
        sealed[5] ^= 0x40
        writer.write(bytes(sealed))
        await writer.drain()
        err = await asyncio.wait_for(got, 10)
        assert isinstance(err, SC.HandshakeError)
        server.close()

    run(go(), 30)


# -- tests/test_pex.py on the port -----------------------------------------------

PEX = PORT.pex


def ka_id(i: int) -> str:
    return f"{i:040x}"


def addr(i: int) -> str:
    return f"{ka_id(i)}@127.0.0.1:{20000 + i}"


def test_addrbook_add_pick_mark_and_promote(tmp_path):
    book = PEX.AddrBook(str(tmp_path / "addrbook.json"))
    assert book.is_empty()
    assert book.add_address(addr(1), src=ka_id(99))
    assert not book.add_address(addr(1), src=ka_id(99))
    assert not book.add_address("noid:nonsense")
    assert not book.add_address(f"{ka_id(2)}@h:0")
    assert book.size() == 1
    ka = book.pick_address()
    assert ka.id == ka_id(1) and not ka.is_old
    book.mark_attempt(ka_id(1))
    assert book._addrs[ka_id(1)].attempts == 1
    book.mark_good(ka_id(1))
    assert book._addrs[ka_id(1)].is_old and book._addrs[ka_id(1)].attempts == 0
    book.mark_bad(ka_id(1))
    assert book.is_empty()


def test_addrbook_persistence_roundtrip(tmp_path):
    path = str(tmp_path / "book.json")
    book = PEX.AddrBook(path)
    for i in range(10):
        book.add_address(addr(i), src=ka_id(50))
    book.mark_good(ka_id(3))
    book.save()
    book2 = PEX.AddrBook(path)
    assert book2.size() == 10 and book2.key == book.key
    assert book2._addrs[ka_id(3)].is_old and not book2._addrs[ka_id(4)].is_old


def test_addrbook_selection_bounded():
    book = PEX.AddrBook()
    for i in range(200):
        book.add_address(addr(i), src=ka_id(900))
    sel = book.get_selection()
    assert 0 < len(sel) <= 100 and len(set(sel)) == len(sel)


def test_pex_message_codec_and_bounds():
    """The codec, and its bytes equal to the reference's."""
    assert PEX.decode_pex_message(PEX.encode_pex_request()) is None
    addrs = [addr(i) for i in range(5)]
    assert PEX.decode_pex_message(PEX.encode_pex_addrs(addrs)) == addrs
    assert PEX.encode_pex_addrs(addrs) == REF.pex.encode_pex_addrs(addrs)
    assert PEX.encode_pex_request() == REF.pex.encode_pex_request()
    with pytest.raises(ValueError):
        PEX.decode_pex_message(b"")
    with pytest.raises(ValueError):
        PEX.decode_pex_message(b"\xff" * (65 * 1024))


def make_pex_switch(name, ensure_period=0.2, seeds=None, P=PORT):
    nk = P.key.NodeKey(P.keys.gen_ed25519())
    ni = P.node_info.NodeInfo(node_id=nk.id, network="pex-net", moniker=name)
    sw = P.switch.Switch(P.transport.MultiplexTransport(nk, ni))
    reactor = P.pex.PexReactor(P.pex.AddrBook(), seeds=seeds, ensure_period=ensure_period)
    sw.add_reactor("PEX", reactor)
    return sw, reactor


@pytest.mark.parametrize("kinds", [("port", "port", "port"), ("ref", "port", "port"),
                                   ("port", "ref", "port"), ("port", "port", "ref")],
                         ids=["port_only", "ref_a", "ref_b", "ref_c"])
def test_pex_gossip_connects_third_node(kinds):
    """C learns B's address from A through PEX and dials it (reference
    pex_reactor_test.go TestPEXReactorRunning); with one node of the three
    from the reference, the addresses cross the packages."""
    from tests.torch_p2p_util import P_OF

    async def go():
        switches = [make_pex_switch(n, P=P_OF[k])[0] for n, k in zip("abc", kinds)]
        sw_a, sw_b, sw_c = switches
        try:
            for sw in switches:
                await sw.start()
            addr_a = await sw_a.transport.listen("127.0.0.1", 0)
            await sw_b.transport.listen("127.0.0.1", 0)
            await sw_c.transport.listen("127.0.0.1", 0)
            await sw_b.dial_peer(f"{sw_a.node_info.node_id}@{addr_a}")
            await sw_c.dial_peer(f"{sw_a.node_info.node_id}@{addr_a}")
            b_listen = f"{sw_b.node_info.node_id}@{sw_b.transport.listen_addr}"
            sw_a.reactors["PEX"].book.add_address(b_listen, src=sw_a.node_info.node_id)
            await wait_for(lambda: sw_c.peers.has(sw_b.node_info.node_id)
                           and sw_b.peers.has(sw_c.node_info.node_id), 15, "C<->B via PEX")
            assert sw_c.reactors["PEX"].book.size() >= 1
        finally:
            for sw in switches:
                await sw.stop()

    run(go(), 40)


def test_pex_seed_bootstrap():
    async def go():
        seed_sw, seed_r = make_pex_switch("seed")
        node_b, _ = make_pex_switch("b")
        try:
            await seed_sw.start()
            await node_b.start()
            seed_addr = await seed_sw.transport.listen("127.0.0.1", 0)
            b_addr = await node_b.transport.listen("127.0.0.1", 0)
            seed_r.book.add_address(f"{node_b.node_info.node_id}@{b_addr}",
                                    src=seed_sw.node_info.node_id)
            fresh, _ = make_pex_switch("fresh",
                                       seeds=[f"{seed_sw.node_info.node_id}@{seed_addr}"])
            try:
                await fresh.start()
                await fresh.transport.listen("127.0.0.1", 0)
                await wait_for(lambda: fresh.peers.has(node_b.node_info.node_id), 15,
                               "fresh node reaching B via seed")
            finally:
                await fresh.stop()
        finally:
            await node_b.stop()
            await seed_sw.stop()

    run(go(), 40)


def test_pex_unsolicited_addrs_disconnects_peer():
    async def go():
        sw_a, _ = make_pex_switch("a", ensure_period=3600)
        sw_b, _ = make_pex_switch("b", ensure_period=3600)
        try:
            await sw_a.start()
            await sw_b.start()
            addr_a = await sw_a.transport.listen("127.0.0.1", 0)
            await sw_b.dial_peer(f"{sw_a.node_info.node_id}@{addr_a}")
            await wait_for(lambda: sw_a.num_peers() == 1, 10, "connection")
            await sw_b.peers.list()[0].send(PEX.PEX_CHANNEL, PEX.encode_pex_addrs([addr(1), addr(2)]))
            await wait_for(lambda: sw_a.num_peers() == 0, 10, "A dropping the spammer")
        finally:
            await sw_b.stop()
            await sw_a.stop()

    run(go(), 30)


# -- across the packages -------------------------------------------------------


@pytest.mark.parametrize("server", ["port", "ref"])
def test_secret_connection_across_packages(server):
    """A port SecretConnection and a reference one handshake, in both roles;
    each authenticates the other's key, and sealed frames (one of several
    frames) pass both ways."""
    S, C = (PORT, REF) if server == "port" else (REF, PORT)

    async def go():
        ks, kc = S.keys.gen_ed25519(b"\x31" * 32), C.keys.gen_ed25519(b"\x32" * 32)
        done = asyncio.get_running_loop().create_future()

        async def on_conn(reader, writer):
            sc = await S.secret.SecretConnection.upgrade(reader, writer, ks)
            msgs = [await sc.read_msg() for _ in range(2)]
            for m in msgs:
                await sc.write_msg(b"re:" + m)
            done.set_result(sc.remote_pubkey.bytes())

        srv = await asyncio.start_server(on_conn, "127.0.0.1", 0)
        port = srv.sockets[0].getsockname()[1]
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        sc = await C.secret.SecretConnection.upgrade(reader, writer, kc)
        big = bytes(range(256)) * 40  # 10,240 bytes: eleven sealed frames
        await sc.write_msg(b"small")
        await sc.write_msg(big)
        got = [await sc.read_msg() for _ in range(2)]
        out = (sc.remote_pubkey.bytes(), await done, got)
        writer.close()
        srv.close()
        return out, ks.pub_key().bytes(), kc.pub_key().bytes(), big

    (remote_s, remote_c, got), pk_s, pk_c, big = run(go(), 30)
    assert remote_s == pk_s and remote_c == pk_c
    assert got == [b"re:small", b"re:" + big]


@pytest.mark.parametrize("dialer", ["port", "ref"])
def test_switch_across_packages(dialer):
    """A port Switch and a reference Switch over secret connections, each
    dialing the other: a 1.1 MB message on channel 0x01 and small ones on
    0x02 (which the far side echoes on 0x01) arrive whole and in order."""
    P_dial, P_listen = (PORT, REF) if dialer == "port" else (REF, PORT)

    async def go():
        sw1, r1, sw2, r2 = await start_pair(P1=P_listen, P2=P_dial)
        try:
            assert sw1.peers.list()[0].id == sw2.node_info.node_id
            big = bytes((i * 7) & 0xFF for i in range(1_100_000))
            peer = sw2.peers.list()[0]
            await peer.send(0x01, big)
            for i in range(5):
                await peer.send(0x02, b"small-%d" % i)
            want = [(0x01, big)] + [(0x02, b"small-%d" % i) for i in range(5)]
            await wait_for(lambda: len(r1.received) >= 6, 20, "the messages")
            echoes = [(0x01, b"echo:small-%d" % i) for i in range(5)]
            await wait_for(lambda: len(r2.received) >= 5, 10, "the echoes")
            return (sorted(r1.received, key=lambda m: m[0]) == want,
                    [m for m in r1.received if m[0] == 2] == want[1:],
                    r2.received == echoes)
        finally:
            await sw2.stop()
            await sw1.stop()

    assert run(go(), 60) == (True, True, True)


@pytest.mark.parametrize("seed", [b"\x01" * 32, b"\x5a" * 32, bytes(range(32))])
def test_node_key_and_node_info_bytes(seed, tmp_path):
    """The same seed gives the same node ID; the same fields give the same
    NodeInfo.encode() bytes, and each package decodes the other's; the
    node_key.json one writes the other loads."""
    ref_nk = REF.key.NodeKey(REF.keys.gen_ed25519(seed))
    nk = PORT.key.NodeKey(PORT.keys.gen_ed25519(seed))
    assert nk.id == ref_nk.id == convert.node_key_from_reference(ref_nk).id
    fields = dict(node_id=nk.id, listen_addr="tcp://127.0.0.1:26656", network="bytes-chain",
                  channels=bytes([0x00, 0x20, 0x21, 0x22, 0x23, 0x30, 0x38, 0x40]),
                  moniker="m-%d" % seed[0])
    ni, ref_ni = PORT.node_info.NodeInfo(**fields), REF.node_info.NodeInfo(**fields)
    assert ni.encode() == ref_ni.encode()
    assert convert.node_info_from_reference(ref_ni) == ni
    assert REF.node_info.NodeInfo.decode(ni.encode()) == ref_ni
    path = str(tmp_path / "node_key.json")
    first = REF.key.NodeKey.load_or_gen(path)
    assert PORT.key.NodeKey.load_or_gen(path).id == first.id


def test_fuzzed_connection_replays_the_reference():
    """[p2p] test_fuzz with a seed: the port's FuzzedConnection drops the
    same writes as the reference's for the same seed and clock."""

    class Sink:
        def __init__(self):
            self.out = []

        async def write(self, data):
            self.out.append(data)

        async def read(self, n):
            return b""

        def close(self):
            pass

    async def drops(P):
        cfg = P.fuzz.FuzzConfig(mode="drop", prob_drop_rw=0.3, start_after=0.0, seed=1234)
        sink = Sink()
        fc = P.fuzz.FuzzedConnection(sink, cfg, clock=lambda: 0.0)
        for i in range(200):
            await fc.write(b"%d" % i)
        return sink.out

    ref, port = run(drops(REF), 10), run(drops(PORT), 10)
    assert port == ref and 100 < len(port) < 200


def test_port_peer_skips_channels_the_peer_does_not_list():
    """The port's Peer.send / try_send give False on a channel the far
    side's NodeInfo does not list (Go p2p/peer.go hasChannel), so a
    reference switch with fewer channels keeps the connection; a listed
    channel still delivers."""

    class OneChannel(EchoMixin, REF.p2p.Reactor):
        def get_channels(self):
            return [REF.conn.ChannelDescriptor(id=0x01, priority=5)]

    async def go():
        sw1, r1 = make_switch("alice", P=REF)
        sw1.reactors.clear()
        sw1._chan_to_reactor.clear()
        sw1._channel_descs.clear()
        sw1.add_reactor("one", OneChannel("one", REF))
        r1 = sw1.reactors["one"]
        sw2, _ = make_switch("bob")
        await sw1.start()
        await sw2.start()
        try:
            addr = await sw1.transport.listen("127.0.0.1", 0)
            await sw2.dial_peer(f"{sw1.node_info.node_id}@{addr}")
            await wait_for(lambda: sw1.num_peers() and sw2.num_peers(), 5, "the pair")
            peer = sw2.peers.list()[0]
            out = (await peer.send(0x02, b"unlisted"), peer.try_send(0x02, b"unlisted"),
                   await peer.send(0x01, b"listed"))
            await wait_for(lambda: (0x01, b"listed") in r1.received, 5, "the listed message")
            await asyncio.sleep(0.1)
            return out, sw1.num_peers(), sw2.num_peers(), r1.received
        finally:
            await sw2.stop()
            await sw1.stop()

    assert run(go(), 30) == ((False, False, True), 1, 1, [(0x01, b"listed")])

"""The port's UPnP IGD client (p2p/upnp.py) against the JAX package's, both
driving the reference's loopback fake gateway (tests/test_upnp.py FakeIGD).

Each package runs the same sequence: SSDP discovery, the external address,
a port mapping and its removal, a removal of a mapping that does not exist,
and probe(). The gateway records every SSDP datagram and every SOAP request
(action header, content type, body): the two packages' records are equal
byte for byte, and so are their results and errors. The local address is
pinned to 127.0.0.1, so no test reaches past the loopback. No tolerance
applies.
"""

import asyncio

from test_upnp import FakeIGD

from tendermint_tpu.p2p import upnp as R_upnp
from tendermint_tpu_torch.p2p import upnp as T_upnp


class RecordingIGD(FakeIGD):
    """FakeIGD that keeps what it was sent."""

    def __init__(self):
        super().__init__()
        self.seen = []

    async def _ssdp_loop(self):
        loop = asyncio.get_running_loop()
        while True:
            data, addr = await loop.sock_recvfrom(self._ssdp_sock, 4096)
            self.seen.append(("ssdp", data))
            if b"M-SEARCH" not in data:
                continue
            resp = (
                "HTTP/1.1 200 OK\r\n"
                "ST: urn:schemas-upnp-org:device:InternetGatewayDevice:1\r\n"
                f"LOCATION: http://127.0.0.1:{self.http_port}/igd.xml\r\n"
                "\r\n"
            ).encode()
            await loop.sock_sendto(self._ssdp_sock, resp, addr)

    async def _soap(self, request):
        body = await request.read()
        self.seen.append(("soap", request.headers.get("SOAPAction"),
                          request.headers.get("Content-Type"), body))
        return await super()._soap(_Replay(request, body))


class _Replay:
    """The request FakeIGD._soap reads, with its body already taken."""

    def __init__(self, request, body: bytes):
        self.headers = request.headers
        self._body = body

    async def text(self):
        return self._body.decode()


def drive(U, monkeypatch) -> tuple:
    monkeypatch.setattr(U, "local_ipv4", lambda probe_target="8.8.8.8": "127.0.0.1")

    async def go():
        igd = RecordingIGD()
        await igd.start()
        out = []
        try:
            kw = dict(timeout=3.0, ssdp_addr="127.0.0.1", ssdp_port=igd.ssdp_port)
            nat = await U.discover(**kw)
            out.append(nat.control_url.replace(str(igd.http_port), "HTTP_PORT"))
            out.append(nat.urn_domain)
            out.append(await nat.get_external_address())
            await nat.add_port_mapping("tcp", 26656, 26657, "127.0.0.1", "tm <probe> & co", 60)
            out.append(sorted(igd.mappings))
            await nat.delete_port_mapping("TCP", 26656)
            try:
                await nat.delete_port_mapping("udp", 1)
            except U.UPNPError as e:
                out.append(("error", str(e)))
            try:
                await nat.add_port_mapping("sctp", 1, 1, "127.0.0.1", "x")
            except ValueError as e:
                out.append(("value_error", str(e)))
            out.append(await U.probe(int_port=30000, ext_port=30001, **kw))
            out.append(sorted(igd.mappings))
        finally:
            await igd.stop()

        def norm(x):  # the gateway's two ports differ between runs
            for port, name in ((igd.http_port, b"HTTP_PORT"), (igd.ssdp_port, b"SSDP_PORT")):
                x = x.replace(str(port).encode(), name)
            return x

        seen = [tuple(norm(x) if isinstance(x, bytes) else x for x in rec) for rec in igd.seen]
        return out, seen

    return asyncio.run(go())


def test_same_requests_and_results_against_the_fake_gateway(monkeypatch):
    ref_out, ref_seen = drive(R_upnp, monkeypatch)
    port_out, port_seen = drive(T_upnp, monkeypatch)
    assert port_out == ref_out
    assert port_seen == ref_seen
    assert ref_out[3] == [("TCP", 26656)]
    assert ref_out[-2] == {"upnp": True, "external_ip": "203.0.113.7", "port_mapping": True}
    assert sum(1 for rec in ref_seen if rec[0] == "soap") == 7


def test_discover_timeout_and_bad_descriptions_raise_alike():
    import socket

    async def silent(U):
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        s.bind(("127.0.0.1", 0))
        try:
            await U.discover(timeout=0.3, ssdp_addr="127.0.0.1", ssdp_port=s.getsockname()[1])
        except U.UPNPError as e:
            return str(e)
        finally:
            s.close()

    assert asyncio.run(silent(T_upnp)) == asyncio.run(silent(R_upnp)) is not None
    for text in ("<root><service><serviceType>x</serviceType></service></root>", "<<"):
        errs = []
        for U in (R_upnp, T_upnp):
            try:
                U._find_wanip_control(text, "http://h/")
            except U.UPNPError as e:
                errs.append(str(e))
        assert len(errs) == 2 and errs[0] == errs[1]

"""UPnP IGD port mapping (reference: p2p/upnp/upnp.go, probe.go): the port's
copy of tendermint_tpu/p2p/upnp.py, the same SSDP and SOAP bytes.

SSDP discovery (M-SEARCH over UDP multicast 239.255.255.250:1900), device
description fetch, WANIPConnection:1 SOAP control: GetExternalIPAddress /
AddPortMapping / DeletePortMapping — so a node behind a home NAT can expose
its p2p port, and `probe-upnp` (cli) can report NAT capabilities.

Pure-asyncio, no extra dependencies: SSDP over a raw UDP socket, the
description + SOAP over aiohttp, XML via xml.etree. Discovery endpoints are
parameterizable so tests can run a loopback IGD."""

from __future__ import annotations

import asyncio
import socket
import xml.etree.ElementTree as ET
from dataclasses import dataclass
from typing import Optional, Tuple
from urllib.parse import urljoin, urlparse

SSDP_ADDR = "239.255.255.250"
SSDP_PORT = 1900
WANIP = "WANIPConnection:1"


class UPNPError(Exception):
    pass


@dataclass
class NAT:
    """A discovered IGD's WANIPConnection control endpoint."""

    control_url: str
    urn_domain: str = "schemas-upnp-org"

    # ---------------------------------------------------------- SOAP calls

    async def _soap(self, function: str, body: str) -> str:
        import aiohttp

        envelope = (
            "<?xml version=\"1.0\"?>"
            "<s:Envelope xmlns:s=\"http://schemas.xmlsoap.org/soap/envelope/\" "
            "s:encodingStyle=\"http://schemas.xmlsoap.org/soap/encoding/\">"
            "<s:Body>" + body + "</s:Body></s:Envelope>"
        )
        headers = {
            "Content-Type": "text/xml; charset=\"utf-8\"",
            "SOAPAction": f"\"urn:{self.urn_domain}:service:{WANIP}#{function}\"",
        }
        async with aiohttp.ClientSession() as sess:
            async with sess.post(
                self.control_url, data=envelope.encode(), headers=headers,
                timeout=aiohttp.ClientTimeout(total=10),
            ) as resp:
                text = await resp.text()
                if resp.status != 200:
                    raise UPNPError(f"SOAP {function} failed: {resp.status} {text[:200]}")
                return text

    def _u(self, function: str, args: str = "") -> str:
        return (
            f"<u:{function} xmlns:u=\"urn:{self.urn_domain}:service:{WANIP}\">"
            + args
            + f"</u:{function}>"
        )

    async def get_external_address(self) -> str:
        """(upnp.go:301 getExternalIPAddress)"""
        text = await self._soap(
            "GetExternalIPAddress", self._u("GetExternalIPAddress")
        )
        ip = _xml_find_text(text, "NewExternalIPAddress")
        if not ip:
            raise UPNPError("no NewExternalIPAddress in response")
        return ip

    async def add_port_mapping(
        self, protocol: str, external_port: int, internal_port: int,
        internal_client: str, description: str, lease_seconds: int = 0,
    ) -> None:
        """(upnp.go:348 AddPortMapping)"""
        from xml.sax.saxutils import escape

        protocol = protocol.upper()
        if protocol not in ("TCP", "UDP"):
            raise ValueError(f"protocol must be TCP or UDP, got {protocol!r}")
        args = (
            "<NewRemoteHost></NewRemoteHost>"
            f"<NewExternalPort>{int(external_port)}</NewExternalPort>"
            f"<NewProtocol>{protocol}</NewProtocol>"
            f"<NewInternalPort>{int(internal_port)}</NewInternalPort>"
            f"<NewInternalClient>{escape(internal_client)}</NewInternalClient>"
            "<NewEnabled>1</NewEnabled>"
            f"<NewPortMappingDescription>{escape(description)}</NewPortMappingDescription>"
            f"<NewLeaseDuration>{int(lease_seconds)}</NewLeaseDuration>"
        )
        await self._soap("AddPortMapping", self._u("AddPortMapping", args))

    async def delete_port_mapping(self, protocol: str, external_port: int) -> None:
        """(upnp.go:384 DeletePortMapping)"""
        protocol = protocol.upper()
        if protocol not in ("TCP", "UDP"):
            raise ValueError(f"protocol must be TCP or UDP, got {protocol!r}")
        args = (
            "<NewRemoteHost></NewRemoteHost>"
            f"<NewExternalPort>{int(external_port)}</NewExternalPort>"
            f"<NewProtocol>{protocol}</NewProtocol>"
        )
        await self._soap("DeletePortMapping", self._u("DeletePortMapping", args))


def _xml_find_text(xml_text: str, tag: str) -> Optional[str]:
    """Find the first element whose tag (namespace-stripped) matches."""
    try:
        root = ET.fromstring(xml_text)
    except ET.ParseError as e:
        raise UPNPError(f"bad XML: {e}") from e
    for el in root.iter():
        if el.tag.split("}")[-1] == tag:
            return el.text or ""
    return None


def _find_wanip_control(xml_text: str, root_url: str) -> Tuple[str, str]:
    """Parse a device description; return (control_url, urn_domain) for the
    WANIPConnection:1 service (upnp.go:204 getServiceURL)."""
    try:
        root = ET.fromstring(xml_text)
    except ET.ParseError as e:
        raise UPNPError(f"bad device description: {e}") from e
    for svc in root.iter():
        if svc.tag.split("}")[-1] != "service":
            continue
        st = ctl = ""
        for child in svc:
            t = child.tag.split("}")[-1]
            if t == "serviceType":
                st = child.text or ""
            elif t == "controlURL":
                ctl = child.text or ""
        if WANIP in st and ctl:
            domain = "schemas-upnp-org"
            if st.startswith("urn:"):
                domain = st.split(":")[1]
            return urljoin(root_url, ctl), domain
    raise UPNPError("no WANIPConnection service in device description")


async def discover(
    timeout: float = 3.0,
    ssdp_addr: str = SSDP_ADDR,
    ssdp_port: int = SSDP_PORT,
) -> NAT:
    """SSDP M-SEARCH for an InternetGatewayDevice; fetch its description and
    return the WANIPConnection NAT handle (upnp.go:39 Discover)."""
    import aiohttp

    search = (
        "M-SEARCH * HTTP/1.1\r\n"
        f"HOST: {ssdp_addr}:{ssdp_port}\r\n"
        "ST: ssdp:all\r\n"
        "MAN: \"ssdp:discover\"\r\n"
        "MX: 2\r\n\r\n"
    ).encode()

    loop = asyncio.get_running_loop()
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sock.setblocking(False)
    sock.bind(("0.0.0.0", 0))
    try:
        await loop.sock_sendto(sock, search, (ssdp_addr, ssdp_port))
        deadline = loop.time() + timeout
        location = None
        while loop.time() < deadline:
            try:
                data = await asyncio.wait_for(
                    loop.sock_recv(sock, 4096), deadline - loop.time()
                )
            except (asyncio.TimeoutError, TimeoutError):
                break
            text = data.decode(errors="replace")
            loc = next(
                (
                    line.split(":", 1)[1].strip()
                    for line in text.split("\r\n")
                    if line.lower().startswith("location:")
                ),
                None,
            )
            if loc:
                location = loc
                # gateway devices win outright; keep listening otherwise
                if "InternetGatewayDevice" in text or "WANIPConnection" in text:
                    break
        if not location:
            raise UPNPError("no UPnP gateway responded to M-SEARCH")
    finally:
        sock.close()

    async with aiohttp.ClientSession() as sess:
        async with sess.get(
            location, timeout=aiohttp.ClientTimeout(total=10)
        ) as resp:
            if resp.status != 200:
                raise UPNPError(f"description fetch failed: {resp.status}")
            desc = await resp.text()
    base = f"{urlparse(location).scheme}://{urlparse(location).netloc}/"
    control_url, domain = _find_wanip_control(desc, base)
    return NAT(control_url, domain)


def local_ipv4(probe_target: str = "8.8.8.8") -> str:
    """Best-effort local IPv4 (upnp.go:179 localIPv4)."""
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        s.connect((probe_target, 80))
        return s.getsockname()[0]
    except OSError:
        return "127.0.0.1"
    finally:
        s.close()


async def probe(
    int_port: int = 26656, ext_port: int = 26656, **discover_kwargs
) -> dict:
    """NAT capability probe: discover, map a port, fetch the external IP,
    unmap (probe.go:84 Probe). Returns a capability report."""
    caps = {"upnp": False, "external_ip": "", "port_mapping": False}
    nat = await discover(**discover_kwargs)
    caps["upnp"] = True
    caps["external_ip"] = await nat.get_external_address()
    ip = local_ipv4()
    await nat.add_port_mapping("tcp", ext_port, int_port, ip, "tendermint-tpu probe", 0)
    caps["port_mapping"] = True
    await nat.delete_port_mapping("tcp", ext_port)
    return caps

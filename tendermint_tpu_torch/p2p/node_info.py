"""NodeInfo: identity + capabilities exchanged during the transport handshake
(reference: p2p/node_info.go DefaultNodeInfo).

The port's copy of tendermint_tpu/p2p/node_info.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple

from tendermint_tpu_torch.libs import protowire as pw

MAX_NUM_CHANNELS = 16


@dataclass(frozen=True)
class ProtocolVersion:
    p2p: int = 8
    block: int = 11
    app: int = 0


@dataclass
class NodeInfo:
    node_id: str = ""
    listen_addr: str = ""
    network: str = ""  # chain id
    version: str = "0.34.0"
    channels: bytes = b""
    moniker: str = "node"
    protocol_version: ProtocolVersion = field(default_factory=ProtocolVersion)

    def validate_basic(self) -> None:
        if len(self.node_id) != 40:
            raise ValueError("invalid node ID length")
        if len(self.channels) > MAX_NUM_CHANNELS:
            raise ValueError("too many channels")
        if len(set(self.channels)) != len(self.channels):
            raise ValueError("duplicate channel id")

    def compatible_with(self, other: "NodeInfo") -> None:
        """(reference: p2p/node_info.go CompatibleWith): same block protocol
        version, same network, at least one common channel."""
        if self.protocol_version.block != other.protocol_version.block:
            raise ValueError(
                f"peer block version {other.protocol_version.block} != {self.protocol_version.block}"
            )
        if self.network != other.network:
            raise ValueError(f"peer network {other.network!r} != {self.network!r}")
        if self.channels and other.channels:
            if not set(self.channels) & set(other.channels):
                raise ValueError("no common channels")

    def encode(self) -> bytes:
        w = pw.Writer()
        pv = pw.Writer()
        pv.varint_field(1, self.protocol_version.p2p)
        pv.varint_field(2, self.protocol_version.block)
        pv.varint_field(3, self.protocol_version.app)
        w.message_field(1, pv.bytes(), always=True)
        w.string_field(2, self.node_id)
        w.string_field(3, self.listen_addr)
        w.string_field(4, self.network)
        w.string_field(5, self.version)
        w.bytes_field(6, self.channels)
        w.string_field(7, self.moniker)
        return w.bytes()

    @classmethod
    def decode(cls, data: bytes) -> "NodeInfo":
        ni = cls()
        pv = [8, 11, 0]
        for f, _, v in pw.Reader(data):
            if f == 1:
                for ff, _, vv in pw.Reader(v):
                    if 1 <= ff <= 3:
                        pv[ff - 1] = vv
            elif f == 2:
                ni.node_id = v.decode()
            elif f == 3:
                ni.listen_addr = v.decode()
            elif f == 4:
                ni.network = v.decode()
            elif f == 5:
                ni.version = v.decode()
            elif f == 6:
                ni.channels = v
            elif f == 7:
                ni.moniker = v.decode()
        ni.protocol_version = ProtocolVersion(*pv)
        return ni


def parse_addr(addr: str) -> Tuple[str, str, int]:
    """'id@host:port' -> (id, host, port); id may be empty."""
    node_id = ""
    if "@" in addr:
        node_id, addr = addr.split("@", 1)
    host, _, port = addr.rpartition(":")
    return node_id, host or "127.0.0.1", int(port)

"""P2P fabric: authenticated multiplexed connections, switch/reactor routing,
peer exchange (reference: p2p/).

The port's copy of tendermint_tpu/p2p/__init__.py.
"""

from tendermint_tpu_torch.p2p.base_reactor import Reactor
from tendermint_tpu_torch.p2p.conn.connection import ChannelDescriptor, MConnection
from tendermint_tpu_torch.p2p.key import NodeKey, pubkey_to_id
from tendermint_tpu_torch.p2p.node_info import NodeInfo, parse_addr
from tendermint_tpu_torch.p2p.peer import Peer, PeerSet

try:
    # SecretConnection's `cryptography` import is itself gated (the
    # plaintext transport runs without the wheel), so this import normally
    # succeeds; the guard stays for any transitive import the wheel owns
    # (reference p2p/__init__.py:10-19).
    from tendermint_tpu_torch.p2p.switch import Switch
    from tendermint_tpu_torch.p2p.transport import MultiplexTransport
except ImportError:  # pragma: no cover - exercised in minimal containers
    Switch = None  # type: ignore[assignment]
    MultiplexTransport = None  # type: ignore[assignment]

__all__ = [
    "ChannelDescriptor",
    "MConnection",
    "MultiplexTransport",
    "NodeInfo",
    "NodeKey",
    "Peer",
    "PeerSet",
    "Reactor",
    "Switch",
    "parse_addr",
    "pubkey_to_id",
]

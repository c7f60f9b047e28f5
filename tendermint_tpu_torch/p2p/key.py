"""Node identity: ed25519 node key, ID = hex(address(pubkey))
(reference: p2p/key.go).

The port's copy of tendermint_tpu/p2p/key.py.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

from tendermint_tpu_torch.crypto.keys import Ed25519PrivKey, Ed25519PubKey, gen_ed25519


def pubkey_to_id(pub: Ed25519PubKey) -> str:
    """ID is the hex of the 20-byte address (reference: p2p/key.go PubKeyToID)."""
    return pub.address().hex()


@dataclass
class NodeKey:
    priv_key: Ed25519PrivKey

    @property
    def id(self) -> str:
        return pubkey_to_id(self.priv_key.pub_key())

    @classmethod
    def generate(cls) -> "NodeKey":
        return cls(gen_ed25519())

    @classmethod
    def load_or_gen(cls, path: str) -> "NodeKey":
        """(reference: p2p/key.go LoadOrGenNodeKey)"""
        if os.path.exists(path):
            with open(path) as f:
                doc = json.load(f)
            return cls(Ed25519PrivKey(bytes.fromhex(doc["priv_key"])))
        nk = cls.generate()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump({"priv_key": nk.priv_key.bytes().hex()}, f)
        os.chmod(path, 0o600)
        return nk

"""The port's remote signer (privval/remote.py) against the JAX package's.

A port SignerClient signs through a reference SignerServer and a reference
client through a port server, over plain TCP and over the secret connection
with an allowlist: the public key, the signed votes and proposals are byte
for byte what a local FilePV of the same seed gives; a double sign and a
wrong chain ID are refused with the same codes and the same descriptions
on both sides; a client off the allowlist is refused. A port validator Node
signing through `base.priv_validator_addr` commits heights.
"""

import asyncio
import importlib
import os
from types import SimpleNamespace

import numpy as np
import pytest

os.environ.setdefault("TMTPU_CRYPTO_BACKEND", "cpu")

_MODULES = {
    "remote": "privval.remote", "file_pv": "privval.file_pv", "keys": "crypto.keys",
    "vote": "types.vote", "proposal": "types.proposal", "basic": "types.basic",
}

CHAIN = "remote-signer-chain"
SEED = b"\x5a" * 32


def pkg(which: str) -> SimpleNamespace:
    root = "tendermint_tpu" if which == "ref" else "tendermint_tpu_torch"
    return SimpleNamespace(which=which, **{k: importlib.import_module(f"{root}.{m}")
                                         for k, m in _MODULES.items()})


REF, PORT = pkg("ref"), pkg("port")


def block_id(P, rng):
    b = P.basic
    return b.BlockID(bytes(rng.integers(0, 256, 32, np.uint8)),
                     b.PartSetHeader(1, bytes(rng.integers(0, 256, 32, np.uint8))))


def vote(P, rng, height, round_=0, typ=None):
    b = P.basic
    addr = P.keys.gen_ed25519(SEED).pub_key().address()
    return P.vote.Vote(typ or b.SignedMsgType.PREVOTE, height, round_, block_id(P, rng),
                       1_700_000_000_000_000_000 + height, addr, 0)


def proposal(P, rng, height):
    return P.proposal.Proposal(height, 0, -1, block_id(P, rng),
                               1_700_000_000_000_000_000 + height)


def session(C, S, secret: bool):
    """C's SignerClient against S's SignerServer: what each call gave."""
    pv = S.file_pv.FilePV(S.keys.gen_ed25519(SEED))
    client_key = C.keys.gen_ed25519(b"\x21" * 32)
    server_id = S.keys.gen_ed25519(b"\x31" * 32)
    kw = {}
    if secret:
        kw = dict(authorized_keys=[S.keys.gen_ed25519(b"\x21" * 32).pub_key()],
                  identity_key=server_id)
    server = S.remote.SignerServer(pv, CHAIN, port=0, **kw)
    server.start()
    client = C.remote.SignerClient(
        server.addr[0], server.addr[1], auth_key=client_key if secret else None,
        server_pubkey=(C.keys.gen_ed25519(b"\x31" * 32).pub_key() if secret else None))
    out = {}
    try:
        rng = np.random.default_rng(5)
        client.ping()
        pub = client.get_pub_key()
        out["pub"] = (pub.type_name(), pub.bytes())
        v1 = client.sign_vote(CHAIN, vote(C, rng, 1))
        p2 = client.sign_proposal(CHAIN, proposal(C, rng, 2))
        v2 = client.sign_vote(CHAIN, vote(C, rng, 2, typ=C.basic.SignedMsgType.PRECOMMIT))
        out["signed"] = [v1.encode(), p2.encode(), v2.encode()]
        # the same height, round and step on another block: a double sign
        with pytest.raises(C.file_pv.DoubleSignError) as e:
            client.sign_vote(CHAIN, vote(C, rng, 2, typ=C.basic.SignedMsgType.PRECOMMIT))
        out["double_sign"] = str(e.value)
        with pytest.raises(C.remote.RemoteSignerError) as e:
            client.sign_vote("other-chain", vote(C, rng, 3))
        out["wrong_chain"] = (e.value.code, e.value.description)
        with pytest.raises(C.remote.RemoteSignerError) as e:
            client.sign_proposal("other-chain", proposal(C, rng, 3))
        out["wrong_chain_proposal"] = (e.value.code, e.value.description)
    finally:
        client.close()
        server.stop()
    return out


def local_signatures(P):
    """The same calls on a local FilePV of P."""
    pv = P.file_pv.FilePV(P.keys.gen_ed25519(SEED))
    rng = np.random.default_rng(5)
    v1 = pv.sign_vote(CHAIN, vote(P, rng, 1))
    p2 = pv.sign_proposal(CHAIN, proposal(P, rng, 2))
    v2 = pv.sign_vote(CHAIN, vote(P, rng, 2, typ=P.basic.SignedMsgType.PRECOMMIT))
    return [v1.encode(), p2.encode(), v2.encode()]


@pytest.mark.parametrize("secret", [False, True], ids=["plain", "secret"])
def test_remote_signer_both_directions(secret):
    if secret:
        pytest.importorskip("cryptography")
    port_on_ref = session(PORT, REF, secret)
    ref_on_port = session(REF, PORT, secret)
    assert port_on_ref == ref_on_port
    assert port_on_ref["signed"] == local_signatures(PORT) == local_signatures(REF)
    assert port_on_ref["pub"] == ("ed25519", PORT.keys.gen_ed25519(SEED).pub_key().bytes())
    assert port_on_ref["wrong_chain"][0] == PORT.remote.ERR_GENERIC == REF.remote.ERR_GENERIC
    assert "want chainID: remote-signer-chain, got chainID: other-chain" in \
        port_on_ref["wrong_chain"][1]
    assert PORT.remote.ERR_DOUBLE_SIGN == REF.remote.ERR_DOUBLE_SIGN == 1


@pytest.mark.parametrize("client_pkg", ["port", "ref"])
def test_client_off_the_allowlist_is_refused(client_pkg):
    """A secret-connection client whose key is not on a port server's
    allowlist gets no signature (the server drops it after the handshake),
    and a port client pinning the wrong server identity refuses a
    reference server."""
    pytest.importorskip("cryptography")
    C = PORT if client_pkg == "port" else REF
    pv = PORT.file_pv.FilePV(PORT.keys.gen_ed25519(SEED))
    server = PORT.remote.SignerServer(pv, CHAIN, port=0, authorized_keys=[
        PORT.keys.gen_ed25519(b"\x22" * 32).pub_key()])
    server.start()
    client = C.remote.SignerClient(server.addr[0], server.addr[1],
                                   auth_key=C.keys.gen_ed25519(b"\x21" * 32), dial_retry=0)
    try:
        with pytest.raises((ConnectionError, OSError)):
            client.get_pub_key()
    finally:
        client.close()
        server.stop()
    ref_server = REF.remote.SignerServer(REF.file_pv.FilePV(REF.keys.gen_ed25519(SEED)), CHAIN,
                                         port=0, authorized_keys=[
                                             REF.keys.gen_ed25519(b"\x21" * 32).pub_key()])
    ref_server.start()
    pinned = PORT.remote.SignerClient(
        ref_server.addr[0], ref_server.addr[1], auth_key=PORT.keys.gen_ed25519(b"\x21" * 32),
        server_pubkey=PORT.keys.gen_ed25519(b"\x77" * 32).pub_key(), dial_retry=0)
    try:
        with pytest.raises(ConnectionError, match="identity mismatch"):
            pinned.get_pub_key()
    finally:
        pinned.close()
        ref_server.stop()


def test_port_node_signs_through_a_remote_signer(tmp_path):
    """base.priv_validator_addr: the node dials a reference SignerServer
    holding the validator's key, commits heights, and every vote of its own
    in the stored commits verifies under that key; stop() closes the
    client."""
    from tendermint_tpu_torch.config import test_config
    from tendermint_tpu_torch.node.node import Node
    from tendermint_tpu_torch.types.genesis import GenesisDoc, GenesisValidator

    pv = REF.file_pv.FilePV(REF.keys.gen_ed25519(SEED))
    server = REF.remote.SignerServer(pv, CHAIN, port=0)
    server.start()
    pub = PORT.keys.gen_ed25519(SEED).pub_key()
    gen = GenesisDoc(chain_id=CHAIN, genesis_time_ns=1_700_000_000_000_000_000,
                     validators=[GenesisValidator(pub, 10)])
    cfg = test_config()
    cfg.base.db_backend, cfg.root_dir, cfg.rpc.laddr = "memdb", "", ""
    cfg.instrumentation.forensics_dir = ""
    cfg.consensus.wal_path = str(tmp_path / "wal")
    cfg.base.priv_validator_addr = f"tcp://{server.addr[0]}:{server.addr[1]}"

    async def go():
        node = Node(cfg, gen, device="cpu")
        assert type(node.priv_validator).__name__ == "SignerClient"
        await node.start()
        try:
            await node.wait_for_height(3, timeout=30)
            commits = [node.block_store.load_block_commit(h) for h in (1, 2)]
            return [(c.height, c.signatures[0].signature, c.vote_sign_bytes(CHAIN, 0))
                    for c in commits]
        finally:
            await node.stop()
            assert node.priv_validator._sock is None

    try:
        got = asyncio.run(asyncio.wait_for(go(), 60))
    finally:
        server.stop()
    for height, sig, msg in got:
        assert pub.verify(msg, sig), height

"""Helpers of the RPC test files (tests/test_torch_rpc*.py; this module
holds no test): one namespace per package and a node builder for either.

`P = pkg("ref")` / `pkg("port")` name the RPC, node, light and crypto modules
of the JAX package or of the port. `make_node(P, tmp, ...)` is the
reference's tests/test_rpc.py make_node over either: a single validator
(or a full node, priv=None) on memdb or on SQLite files under `root`, the
port's on `device="cpu"`. The reference runs its host arm
(TMTPU_CRYPTO_BACKEND=cpu, as its tests run).
"""

import asyncio
import importlib
import os
import socket
from types import SimpleNamespace

os.environ.setdefault("TMTPU_CRYPTO_BACKEND", "cpu")

_MODULES = {
    "server": "rpc.server", "client": "rpc.client", "node": "node.node",
    "kvstore": "abci.kvstore", "abci": "abci.types", "keys": "crypto.keys",
    "tmhash": "crypto.tmhash", "file_pv": "privval.file_pv", "genesis": "types.genesis",
    "metrics": "libs.metrics", "light": "light", "light_client": "light.client",
    "provider": "light.provider", "proxy": "light.proxy", "service": "light.service",
    "store": "light.store", "kvdb": "libs.kvdb", "tlight": "types.light",
    "mempool": "mempool.mempool", "signed_tx": "types.signed_tx", "trace": "libs.trace",
    "batch": "crypto.batch", "slo": "libs.slo", "overload": "node.overload",
    "proof_ops": "crypto.proof_ops", "evidence": "types.evidence", "vote": "types.vote",
    "basic": "types.basic", "prom": "libs.prometheus_server", "protowire": "libs.protowire",
}


def pkg(which: str) -> SimpleNamespace:
    root = "tendermint_tpu" if which == "ref" else "tendermint_tpu_torch"
    ns = SimpleNamespace(which=which, **{k: importlib.import_module(f"{root}.{m}")
                                         for k, m in _MODULES.items()})
    ns.config = importlib.import_module(
        "tendermint_tpu.config.config" if which == "ref" else "tendermint_tpu_torch.config")
    return ns


REF, PORT = pkg("ref"), pkg("port")
BOTH = (REF, PORT)


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def node_config(P, tmp, root=None, rpc=False, abci="kvstore", edit=None):
    cfg = P.config.test_config()
    cfg.base.abci = abci
    cfg.base.db_backend = "sqlite" if root else "memdb"
    cfg.root_dir = str(root) if root else ""
    cfg.rpc.laddr = f"tcp://127.0.0.1:{free_port()}" if rpc else ""
    cfg.consensus.wal_path = str(tmp / f"wal-{P.which}") if not root else cfg.consensus.wal_path
    cfg.instrumentation.forensics_dir = ""
    if edit is not None:
        edit(cfg)
    return cfg


def make_node(P, tmp, seed=b"\x81" * 32, chain="rpc-chain", priv=True, app=None,
              genesis=None, **kw):
    """A node of package P; `priv=False` makes it a full node of the same
    single-validator chain."""
    cfg = node_config(P, tmp, **kw)
    key = P.file_pv.FilePV(P.keys.gen_ed25519(seed))
    gen = genesis or P.genesis.GenesisDoc(
        chain_id=chain, genesis_time_ns=1_700_000_000_000_000_000,
        validators=[P.genesis.GenesisValidator(key.get_pub_key(), 10)])
    extra = {"device": "cpu"} if P.which == "port" else {}
    return P.node.Node(cfg, gen, priv_validator=key if priv else None, app=app, **extra)


def run(coro):
    return asyncio.run(coro)


def url_of(node) -> str:
    return f"http://127.0.0.1:{node.rpc_server.port}"

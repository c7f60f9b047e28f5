"""Helpers of the p2p and reactor test files (tests/test_torch_p2p.py,
tests/test_torch_reactors.py, tests/test_torch_multinode.py; this module
holds no test): one namespace per package for the p2p fabric, the reactors
and the node, and functions that make nets whose nodes come from either
package.

`P = pkg("ref")` / `pkg("port")` name the modules of the JAX package or of
the port. `make_net(kinds, tmp, ...)` builds one node per entry of `kinds`
("ref" or "port") over one genesis (the same validators, the same genesis
time), each with its own WAL; the port's nodes run on `device="cpu"`, the
reference's on its host arm (TMTPU_CRYPTO_BACKEND=cpu, as its tests run).
Waits are progress-based, as tests/test_multinode.py's are, and bounded by
a hard timeout.
"""

import asyncio
import importlib
import os
from types import SimpleNamespace

os.environ.setdefault("TMTPU_CRYPTO_BACKEND", "cpu")

_MODULES = {
    "keys": "crypto.keys", "tmhash": "crypto.tmhash", "p2p": "p2p",
    "key": "p2p.key", "node_info": "p2p.node_info", "conn": "p2p.conn.connection",
    "secret": "p2p.conn.secret_connection", "transport": "p2p.transport",
    "switch": "p2p.switch", "peer": "p2p.peer", "pex": "p2p.pex",
    "behaviour": "p2p.behaviour", "fuzz": "p2p.fuzz", "bits": "libs.bits",
    "flowrate": "libs.flowrate", "metrics": "libs.metrics",
    "bs_messages": "blocksync.messages", "bs_pool": "blocksync.pool",
    "bs_checkpoint": "blocksync.checkpoint", "bs_reactor": "blocksync.reactor",
    "cs_reactor": "consensus.reactor", "cs_messages": "consensus.messages",
    "round_state": "consensus.round_state", "mp_reactor": "mempool.reactor",
    "ev_reactor": "evidence.reactor", "event_bus": "types.event_bus",
    "basic": "types.basic", "vote": "types.vote", "block": "types.block",
    "evidence": "types.evidence", "node": "node.node", "kvstore": "abci.kvstore",
    "file_pv": "privval.file_pv", "genesis": "types.genesis",
    "signed_tx": "types.signed_tx", "provenance": "crypto.provenance",
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
P_OF = {"ref": REF, "port": PORT}

GENESIS_TIME_NS = 1_700_000_000_000_000_000


def val_seed(i: int) -> bytes:
    return bytes([10 + i]) * 32


def genesis(P, chain: str, n_vals: int, power: int = 10):
    return P.genesis.GenesisDoc(
        chain_id=chain, genesis_time_ns=GENESIS_TIME_NS,
        validators=[P.genesis.GenesisValidator(P.keys.gen_ed25519(val_seed(i)).pub_key(), power)
                    for i in range(n_vals)])


def make_node(P, tmp, name: str, chain: str, n_vals: int, val: int = None, defer_votes=False,
              plaintext=False, abci="kvstore", edit=None):
    """A node of package P on a chain of `n_vals` equal-power validators;
    `val` is its validator index (None: a full node)."""
    cfg = P.config.test_config()
    cfg.base.db_backend = "memdb"
    cfg.base.abci = abci
    cfg.rpc.laddr = ""
    cfg.root_dir = ""
    cfg.p2p.laddr = "tcp://127.0.0.1:0"
    cfg.p2p.plaintext = plaintext
    cfg.consensus.wal_path = str(tmp / f"wal-{name}" / "wal")
    cfg.consensus.defer_vote_verification = defer_votes
    cfg.instrumentation.forensics_dir = ""
    if edit is not None:
        edit(cfg)
    priv = P.file_pv.FilePV(P.keys.gen_ed25519(val_seed(val))) if val is not None else None
    app = P.kvstore.SignedKVStoreApplication() if abci == "signed_kvstore" else \
        P.kvstore.KVStoreApplication()
    extra = {"device": "cpu"} if P.which == "port" else {}
    return P.node.Node(cfg, genesis(P, chain, n_vals), priv_validator=priv, app=app, **extra)


def make_net(kinds, tmp, chain="multinode-chain", **kw):
    """One validator node per entry of kinds ("ref" / "port")."""
    return [make_node(P_OF[k], tmp, f"{k}{i}", chain, len(kinds), val=i, **kw)
            for i, k in enumerate(kinds)]


def addr_of(node) -> str:
    return f"{node.node_key.id}@{node.p2p_addr}"


async def connect(nodes) -> None:
    """Full mesh: node i dials every node after it (persistent)."""
    for i, node in enumerate(nodes):
        for other in nodes[i + 1:]:
            await node.switch.dial_peers_async([addr_of(other)], persistent=True)


async def start_and_connect(nodes) -> None:
    for node in nodes:
        await node.start()
    await connect(nodes)


async def stop_all(nodes) -> None:
    for node in nodes:
        try:
            await node.stop()
        except Exception:
            pass


async def wait_until(pred, nodes, max_new_heights, hard_timeout=40.0, poll=0.05):
    """Poll `pred()`; fail once the net has committed `max_new_heights`
    more blocks without it holding (machine-load independent), or after
    `hard_timeout` seconds (a net that makes no progress at all)."""
    loop = asyncio.get_running_loop()
    start_h = max(n.block_store.height for n in nodes)
    t0 = loop.time()
    while True:
        if pred():
            return
        h = max(n.block_store.height for n in nodes)
        if h - start_h >= max_new_heights:
            raise AssertionError(f"condition not reached after {h - start_h} new heights "
                                 f"(started at {start_h})")
        if loop.time() - t0 > hard_timeout:
            raise AssertionError(f"hard timeout {hard_timeout}s with chain at height {h}")
        await asyncio.sleep(poll)


async def wait_for(cond, timeout=10.0, what="condition", poll=0.02):
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout
    while not cond():
        if loop.time() > deadline:
            raise TimeoutError(f"timed out waiting for {what}")
        await asyncio.sleep(poll)


def run(coro, timeout=60.0):
    """asyncio.run with a hard timeout of its own: nothing hangs the run."""
    return asyncio.run(asyncio.wait_for(coro, timeout))


def block_in_store(node, tx: bytes) -> bool:
    for h in range(1, node.block_store.height + 1):
        b = node.block_store.load_block(h)
        if b is not None and tx in b.txs:
            return True
    return False

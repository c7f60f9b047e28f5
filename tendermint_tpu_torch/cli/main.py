"""Command-line interface: the port's copy of tendermint_tpu/cli/main.py
(reference: cmd/tendermint/main.go:15-32 and cmd/tendermint/commands/*).

Subcommands: init, start, testnet, localnet, show-node-id, show-validator,
gen-validator, unsafe-reset-all, version, replay, replay-console,
signer-harness, debug, wal-inspect, probe-upnp, load-test, abci, light.

Run as `python -m tendermint_tpu_torch.cli [--home H] [--device D] <cmd>`
(module entry in cli/__main__.py).

`--device` is where the verification runs, for `start`, `replay`,
`replay-console` and `light`, and for every child that `localnet` spawns:
unset, the card with the reference's routing (the host arm below 256 rows,
crypto/batch.py); `cuda`, the card at every row count; `cpu`, the plain
versions. Without `--device cpu` on a host without a card these commands
exit non-zero with device.resolve's error before they build anything.
`start` runs until SIGINT or SIGTERM (exit 0) or until the node stores a
failure (a failed prewarm, a consensus halt, a catch-up or state-sync device
error: exit 1), where the reference's `start` waits only for the signal
(ROADMAP D1).
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
import os
import shutil
import signal
import sys
import time

from tendermint_tpu_torch.config.config import Config
from tendermint_tpu_torch.config.toml import load_config, save_config

VERSION = "0.2.0"

logger = logging.getLogger("tendermint_tpu_torch.cli")


def default_home() -> str:
    return os.environ.get("TMTPU_HOME", os.path.expanduser("~/.tendermint_tpu_torch"))


def _config_path(home: str) -> str:
    return os.path.join(home, "config", "config.toml")


def parse_hostport(addr: str, what: str = "address") -> tuple:
    """'tcp://host:port' / 'host:port' -> (host, port) with a usage-grade
    error. An empty host (e.g. 'tcp://:8888') defaults to 127.0.0.1."""
    bare = addr.replace("tcp://", "")
    host, sep, port_s = bare.rpartition(":")
    if not sep or not port_s.isdigit():
        raise SystemExit(f"{what} must look like tcp://host:port, got {addr!r}")
    return host or "127.0.0.1", int(port_s)


def load_home(home: str) -> Config:
    path = _config_path(home)
    cfg = load_config(path) if os.path.exists(path) else Config()
    cfg.root_dir = home
    return cfg


# ------------------------------------------------------------------ init


def init_files(home: str, chain_id: str = "", seed: bytes | None = None,
               overwrite: bool = False) -> dict:
    """Create config dir tree + keys + genesis
    (reference: cmd/tendermint/commands/init.go)."""
    from tendermint_tpu_torch.p2p.key import NodeKey
    from tendermint_tpu_torch.privval.file_pv import FilePV
    from tendermint_tpu_torch.types.genesis import GenesisDoc, GenesisValidator

    cfg = Config()
    cfg.root_dir = home
    os.makedirs(os.path.join(home, "config"), exist_ok=True)
    os.makedirs(os.path.join(home, "data"), exist_ok=True)

    cfg_path = _config_path(home)
    if overwrite or not os.path.exists(cfg_path):
        save_config(cfg, cfg_path)

    key_file = cfg.path(cfg.base.priv_validator_key_file)
    state_file = cfg.path(cfg.base.priv_validator_state_file)
    if overwrite or not os.path.exists(key_file):
        pv = FilePV.generate(key_file, state_file, seed=seed)
    else:
        pv = FilePV.load(key_file, state_file)

    node_key = NodeKey.load_or_gen(cfg.path(cfg.base.node_key_file))

    gen_path = cfg.genesis_path()
    if overwrite or not os.path.exists(gen_path):
        gen = GenesisDoc(
            chain_id=chain_id or f"test-chain-{os.urandom(3).hex()}",
            genesis_time_ns=time.time_ns(),
            validators=[GenesisValidator(pv.get_pub_key(), 10)],
        )
        gen.validate_and_complete()
        with open(gen_path, "w") as f:
            f.write(gen.to_json())
    return {
        "home": home,
        "node_id": node_key.id,
        "validator_address": pv.get_pub_key().address().hex().upper(),
    }


# ------------------------------------------------------------------ start


def run_node(home: str, device=None) -> None:
    """reference: cmd/tendermint/commands/run_node.go:100. Raises the
    device's error before anything is built, and the node's first stored
    failure while it runs (module docstring)."""
    from tendermint_tpu_torch.device import resolve
    from tendermint_tpu_torch.node.node import Node
    from tendermint_tpu_torch.privval.file_pv import FilePV
    from tendermint_tpu_torch.types.genesis import GenesisDoc

    resolve(device)
    cfg = load_home(home)
    from tendermint_tpu_torch.libs import log as tmlog

    tmlog.setup(cfg.base.log_level)
    with open(cfg.genesis_path()) as f:
        gen = GenesisDoc.from_json(f.read())
    pv = None
    if not cfg.base.priv_validator_addr:
        pv = FilePV.load(
            cfg.path(cfg.base.priv_validator_key_file),
            cfg.path(cfg.base.priv_validator_state_file),
        )
    node = Node(cfg, gen, priv_validator=pv, device=device)

    async def main():
        stop = asyncio.Event()
        loop = asyncio.get_event_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            try:
                loop.add_signal_handler(sig, stop.set)
            except NotImplementedError:
                pass
        await node.start()
        print(f"node {node.node_key.id if node.node_key else ''} started; "
              f"chain {gen.chain_id}; ^C to stop", flush=True)
        failure = None
        while not stop.is_set():
            try:
                node.raise_failures()
            except RuntimeError as e:
                failure = e
                break
            try:
                await asyncio.wait_for(stop.wait(), 0.2)
            except asyncio.TimeoutError:
                pass
        try:
            await node.stop()
        except RuntimeError as e:
            failure = failure or e
        if failure is not None:
            raise failure

    asyncio.run(main())


# ----------------------------------------------------------------- replay


def run_replay(home: str, console: bool = False, device=None) -> None:
    """Replay the WAL of the in-progress height through a fresh consensus
    state, printing the round state after every message — interactively in
    console mode (reference: consensus/replay_file.go:1 RunReplayFile +
    cmd/tendermint/commands/replay.go:1).

    Console commands: n/next [N] step, rs dump round state, q quit,
    back restart from the beginning."""
    import asyncio

    from tendermint_tpu_torch.consensus.wal import MsgInfo, TimeoutInfo
    from tendermint_tpu_torch.device import resolve
    from tendermint_tpu_torch.node.node import Node
    from tendermint_tpu_torch.privval.file_pv import FilePV
    from tendermint_tpu_torch.types.genesis import GenesisDoc

    class _NullWAL:
        """Replay must never mutate the WAL it reads (the reference's
        RunReplayFile runs with a nil WAL): every consensus step would
        otherwise append EventRoundState/EndHeight frames to the live log."""

        def write(self, *_a, **_k):
            pass

        write_sync = write
        write_end_height = write
        flush_and_sync = write
        close = write

        def search_for_end_height(self, *_a, **_k):
            return None

    resolve(device)

    def build():
        cfg = load_home(home)
        with open(cfg.genesis_path()) as f:
            gen = GenesisDoc.from_json(f.read())
        pv = None
        if not cfg.base.priv_validator_addr:
            pv = FilePV.load(
                cfg.path(cfg.base.priv_validator_key_file),
                cfg.path(cfg.base.priv_validator_state_file),
            )
        node = Node(cfg, gen, priv_validator=pv, device=device)
        cs = node.consensus
        msgs = cs.wal.search_for_end_height(cs.rs.height - 1) or []
        cs.wal.close()
        cs.wal = _NullWAL()
        return node, cs, msgs

    async def replay():
        node, cs, msgs = build()
        cs.replay_mode = True
        print(f"replaying {len(msgs)} WAL messages for height {cs.rs.height}")
        print(json.dumps(cs.rs.round_state_summary()))
        i = 0

        def step_one():
            nonlocal i
            msg = msgs[i]
            if isinstance(msg, MsgInfo):
                label = type(msg.msg).__name__
                cs._handle_msg(msg)
            elif isinstance(msg, TimeoutInfo):
                label = f"Timeout({msg.step})"
                cs._handle_timeout(msg)
            else:
                label = type(msg).__name__
            i += 1
            print(f"[{i}/{len(msgs)}] {label} -> "
                  f"H={cs.rs.height} R={cs.rs.round} S={cs.rs.step.name}")

        if not console:
            while i < len(msgs):
                step_one()
        else:
            print("console: n [count] = step, rs = round state, q = quit")
            while True:
                try:
                    line = input(f"replay [{i}/{len(msgs)}]> ").strip()
                except EOFError:
                    break
                if line in ("q", "quit"):
                    break
                if line in ("rs",):
                    print(json.dumps(cs.rs.round_state_summary(), indent=1))
                    continue
                if line.startswith(("n", "next")) or line == "":
                    parts = line.split()
                    if len(parts) > 1 and not parts[1].isdigit():
                        print("commands: n [count], rs, q")
                        continue
                    count = int(parts[1]) if len(parts) > 1 else 1
                    for _ in range(count):
                        if i >= len(msgs):
                            print("end of WAL")
                            break
                        step_one()
                    continue
                print("commands: n [count], rs, q")
        print(json.dumps(cs.rs.round_state_summary()))

    asyncio.run(replay())


# ---------------------------------------------------------------- testnet


def make_testnet(output_dir: str, n_validators: int, chain_id: str = "",
                 starting_port: int = 26656, populate_persistent_peers: bool = True) -> list:
    """N validator config dirs sharing one genesis
    (reference: cmd/tendermint/commands/testnet.go)."""
    from tendermint_tpu_torch.p2p.key import NodeKey
    from tendermint_tpu_torch.privval.file_pv import FilePV
    from tendermint_tpu_torch.types.genesis import GenesisDoc, GenesisValidator

    chain_id = chain_id or f"chain-{os.urandom(3).hex()}"
    nodes = []
    for i in range(n_validators):
        home = os.path.join(output_dir, f"node{i}")
        cfg = Config()
        cfg.root_dir = home
        os.makedirs(os.path.join(home, "config"), exist_ok=True)
        os.makedirs(os.path.join(home, "data"), exist_ok=True)
        pv = FilePV.generate(
            cfg.path(cfg.base.priv_validator_key_file),
            cfg.path(cfg.base.priv_validator_state_file),
        )
        node_key = NodeKey.load_or_gen(cfg.path(cfg.base.node_key_file))
        nodes.append((home, cfg, pv, node_key, starting_port + 2 * i))

    gen = GenesisDoc(
        chain_id=chain_id,
        genesis_time_ns=time.time_ns(),
        validators=[
            GenesisValidator(pv.get_pub_key(), 10, name=f"node{i}")
            for i, (_, _, pv, _, _) in enumerate(nodes)
        ],
    )
    gen.validate_and_complete()
    gen_json = gen.to_json()

    peers = ",".join(
        f"{nk.id}@127.0.0.1:{port}" for (_, _, _, nk, port) in nodes
    )
    out = []
    for i, (home, cfg, pv, nk, port) in enumerate(nodes):
        cfg.base.moniker = f"node{i}"
        cfg.p2p.laddr = f"tcp://127.0.0.1:{port}"
        cfg.rpc.laddr = f"tcp://127.0.0.1:{port + 1}"
        if populate_persistent_peers:
            cfg.p2p.persistent_peers = ",".join(
                p for p in peers.split(",") if not p.startswith(nk.id)
            )
        save_config(cfg, _config_path(home))
        with open(cfg.genesis_path(), "w") as f:
            f.write(gen_json)
        out.append({"home": home, "node_id": nk.id, "p2p": cfg.p2p.laddr, "rpc": cfg.rpc.laddr})
    return out


# --------------------------------------------------------------- localnet


def run_localnet(output_dir: str, n_validators: int, chain_id: str,
                 starting_port: int, blocks: int, device=None) -> None:
    """Generate a testnet and run every node as a subprocess until all reach
    `blocks` (the reference's networks/local docker-compose story, as plain
    processes). `device`, when set, goes to every child as `--device`."""
    import subprocess
    import urllib.request

    if os.path.isdir(output_dir) and os.listdir(output_dir):
        raise SystemExit(
            f"output dir {output_dir!r} is not empty — localnet always starts "
            "from a fresh testnet (delete it or pick another --output-dir)"
        )
    make_testnet(output_dir, n_validators, chain_id, starting_port)
    homes = sorted(
        os.path.join(output_dir, d)
        for d in os.listdir(output_dir)
        if d.startswith("node")
    )
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "tendermint_tpu_torch.cli", "--home", h]
            + (["--device", str(device)] if device is not None else []) + ["start"],
            stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL,
        )
        for h in homes
    ]

    def height(rpc_laddr: str) -> int:
        url = "http://" + rpc_laddr.replace("tcp://", "")
        req = urllib.request.Request(
            url,
            json.dumps({"jsonrpc": "2.0", "id": 1, "method": "status", "params": {}}).encode(),
            {"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=2) as resp:
            st = json.load(resp)
        return int(st["result"]["sync_info"]["latest_block_height"])

    try:
        rpcs = [load_home(h).rpc.laddr for h in homes]
        deadline = time.time() + 60 + 10 * blocks
        heights = [0] * len(homes)
        while time.time() < deadline:
            for i, r in enumerate(rpcs):
                try:
                    heights[i] = height(r)
                except Exception:
                    pass
            print(json.dumps({"heights": heights}), flush=True)
            if all(h >= blocks for h in heights):
                print(json.dumps({"localnet": "ok", "heights": heights}))
                return
            time.sleep(1.0)
        raise SystemExit(f"localnet did not reach height {blocks}: {heights}")
    finally:
        for p in procs:
            p.send_signal(signal.SIGINT)
        for p in procs:
            try:
                p.wait(10)
            except subprocess.TimeoutExpired:
                p.kill()


# --------------------------------------------------------- signer-harness


def run_signer_harness(addr: str, chain_id: str) -> None:
    """Acceptance checks against a remote signer
    (reference: tools/tm-signer-harness — ping, pubkey, vote/proposal signing,
    double-sign refusal).

    The signer must have FRESH sign state (like the reference harness, which
    loads disposable key/state files): the checks sign at low heights and the
    double-sign probe advances the signer's watermark. NEVER point this at a
    production validator's signer."""
    from tendermint_tpu_torch.crypto import tmhash
    from tendermint_tpu_torch.privval.file_pv import DoubleSignError
    from tendermint_tpu_torch.privval.remote import SignerClient
    from tendermint_tpu_torch.types.basic import BlockID, PartSetHeader, SignedMsgType
    from tendermint_tpu_torch.types.proposal import Proposal
    from tendermint_tpu_torch.types.vote import Vote

    host, port = parse_hostport(addr, "--addr")
    client = SignerClient(host, port)
    results = {}

    def vote(h, tag, t=SignedMsgType.PREVOTE):
        bh = tmhash.sum256(tag)
        return Vote(type=t, height=h, round=0,
                    block_id=BlockID(bh, PartSetHeader(1, tmhash.sum256(bh))),
                    timestamp_ns=time.time_ns(), validator_address=b"\x01" * 20,
                    validator_index=0)

    try:
        client.ping()
        results["ping"] = "ok"
        pub = client.get_pub_key()
        results["pubkey"] = pub.bytes().hex()

        try:
            signed = client.sign_vote(chain_id, vote(1, b"a"))
        except DoubleSignError:
            print(json.dumps({
                "passed": False,
                "results": {**results, "sign_vote": "signer state is not fresh "
                            "(height 1 already signed) — use a disposable signer"},
            }))
            raise SystemExit(1)
        results["sign_vote"] = (
            "ok" if pub.verify(signed.sign_bytes(chain_id), signed.signature)
            else "BAD SIGNATURE"
        )

        try:
            client.sign_vote(chain_id, vote(1, b"b"))
            results["double_sign_guard"] = "FAILED: equivocation signed"
        except DoubleSignError:
            results["double_sign_guard"] = "ok"

        bh = tmhash.sum256(b"p")
        prop = Proposal(type=SignedMsgType.PROPOSAL, height=2, round=0,
                        pol_round=-1, block_id=BlockID(bh, PartSetHeader(1, tmhash.sum256(bh))),
                        timestamp_ns=time.time_ns())
        sp = client.sign_proposal(chain_id, prop)
        results["sign_proposal"] = "ok" if pub.verify(sp.sign_bytes(chain_id), sp.signature) else "BAD SIGNATURE"
    except (ConnectionError, OSError) as e:
        print(json.dumps({"passed": False, "results": {**results, "error": str(e)}}))
        raise SystemExit(1)
    finally:
        client.close()
    ok = all(v == "ok" or k == "pubkey" for k, v in results.items())
    print(json.dumps({"passed": ok, "results": results}))
    if not ok:
        raise SystemExit(1)


# ------------------------------------------------------------------ debug


def debug_dump(home: str, rpc_url: str, output: str) -> None:
    """Capture node state + config + WAL into a zip
    (reference: cmd/tendermint/commands/debug/dump.go:117-125)."""
    import zipfile

    cfg = load_home(home)
    with zipfile.ZipFile(output, "w", zipfile.ZIP_DEFLATED) as z:
        if rpc_url:
            from tendermint_tpu_torch.rpc.client import HTTPClient

            async def fetch():
                client = HTTPClient(rpc_url)
                try:
                    for method in (
                        "status",
                        "net_info",
                        "dump_consensus_state",
                        # stack/heap profiles (pprof analogs; need rpc.unsafe)
                        "unsafe_dump_stacks",
                        "unsafe_dump_heap",
                    ):
                        try:
                            res = await client.call(method)
                            z.writestr(f"{method}.json", json.dumps(res, indent=2))
                        except Exception as e:
                            z.writestr(f"{method}.error.txt", str(e))
                finally:
                    await client.close()

            asyncio.run(fetch())
        for rel in ("config/config.toml", "config/genesis.json"):
            path = cfg.path(rel)
            if os.path.exists(path):
                z.write(path, rel)
        wal_dir = cfg.path(cfg.consensus.wal_path)
        if os.path.isdir(wal_dir):
            for fn in sorted(os.listdir(wal_dir)):
                z.write(os.path.join(wal_dir, fn), f"wal/{fn}")
        elif os.path.isfile(wal_dir):
            z.write(wal_dir, "wal/" + os.path.basename(wal_dir))


# ------------------------------------------------------------------ light


def run_light(chain_id: str, primary: str, witnesses: list, trust_height: int,
              trust_hash: str, home: str, height: int | None,
              laddr: str = "", device=None) -> None:
    """Verify a header via the light client against live RPC endpoints; with
    --laddr, keep running as a verifying RPC proxy
    (reference: cmd/tendermint/commands/lite.go `tendermint light` +
    light/proxy/proxy.go). The client's commit checks run on `device`."""
    from tendermint_tpu_torch.device import resolve
    from tendermint_tpu_torch.libs.kvdb import SQLiteDB
    from tendermint_tpu_torch.light import Client, HTTPProvider, LightStore, TrustOptions
    from tendermint_tpu_torch.rpc.client import HTTPClient
    from tendermint_tpu_torch.types.basic import NANOS

    resolve(device)

    async def main():
        clients = [HTTPClient(primary)] + [HTTPClient(w) for w in witnesses]
        providers = [HTTPProvider(chain_id, c) for c in clients]
        os.makedirs(home, exist_ok=True)
        store = LightStore(SQLiteDB(os.path.join(home, "light.db")))
        lc = Client(
            chain_id,
            TrustOptions(7 * 24 * 3600 * NANOS, trust_height, bytes.fromhex(trust_hash)),
            providers[0],
            providers[1:],
            store,
            device=device,
        )
        try:
            if laddr:
                from tendermint_tpu_torch.light.proxy import LightProxy

                host, port = parse_hostport(
                    laddr if ":" in laddr.replace("tcp://", "") else laddr + ":0",
                    "--laddr",
                )
                proxy = LightProxy(lc, clients[0], host, port)
                await proxy.start()
                print(json.dumps({"proxy": proxy.addr}), flush=True)
                stop = asyncio.Event()
                loop = asyncio.get_event_loop()
                for sig in (signal.SIGINT, signal.SIGTERM):
                    try:
                        loop.add_signal_handler(sig, stop.set)
                    except NotImplementedError:
                        pass
                await stop.wait()
                await proxy.stop()
                return
            await lc.initialize()
            lb = (
                await lc.verify_light_block_at_height(height)
                if height
                else await lc.update()
            )
            if lb is None:
                lb = store.latest_light_block()
            print(json.dumps({
                "height": lb.height,
                "hash": lb.hash().hex().upper(),
                "app_hash": lb.header.app_hash.hex().upper(),
                "trusted_heights": store.heights()[-10:],
            }))
        finally:
            for c in clients:
                await c.close()

    asyncio.run(main())


# ------------------------------------------------------------------- main


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tendermint-tpu", description=__doc__)
    p.add_argument("--home", default=default_home(), help="node home directory")
    p.add_argument(
        "--device", default=None,
        help="where start, replay and light verify: unset = the card with the "
             "reference's routing, cuda = the card at every size, cpu = the host",
    )
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("init", help="create config dir, keys, and genesis")
    sp.add_argument("--chain-id", default="")
    sp.add_argument("--overwrite", action="store_true")

    sub.add_parser("start", help="run the node")

    sp = sub.add_parser("testnet", help="generate N validator config dirs")
    sp.add_argument("--v", type=int, default=4, help="number of validators")
    sp.add_argument("--output-dir", default="./mytestnet")
    sp.add_argument("--chain-id", default="")
    sp.add_argument("--starting-port", type=int, default=26656)

    sub.add_parser("show-node-id", help="print the p2p node id")
    sub.add_parser("show-validator", help="print the validator pubkey")
    sub.add_parser("gen-validator", help="print a fresh validator key (JSON)")
    sub.add_parser("unsafe-reset-all", help="wipe data dir, keep config + keys")
    sub.add_parser("version", help="print version")

    sp = sub.add_parser("localnet", help="generate + run an N-validator localnet as subprocesses")
    sp.add_argument("--v", type=int, default=4)
    sp.add_argument("--output-dir", default="./localnet")
    sp.add_argument("--chain-id", default="")
    sp.add_argument("--starting-port", type=int, default=26656)
    sp.add_argument("--blocks", type=int, default=5, help="run until every node reaches this height")

    sp = sub.add_parser("signer-harness", help="acceptance checks against a remote signer")
    sp.add_argument("--addr", required=True, help="signer address, e.g. tcp://127.0.0.1:26659")
    sp.add_argument("--chain-id", default="harness-chain")

    sub.add_parser("replay", help="replay the last height's WAL through consensus")
    sub.add_parser("replay-console", help="interactive WAL replay (n/rs/q)")

    sp = sub.add_parser(
        "wal-inspect",
        help="post-mortem: rebuild the consensus timeline (heights/rounds/steps, "
             "vote arrival, EndHeight gaps) from a WAL, offline and read-only",
    )
    sp.add_argument(
        "--wal", default="",
        help="WAL head file; defaults to the home's consensus.wal_path",
    )
    sp.add_argument("--limit", type=int, default=None,
                    help="only the most recent N heights")

    sp = sub.add_parser(
        "probe-upnp", help="probe the local NAT for UPnP port-mapping support"
    )
    sp.add_argument("--port", type=int, default=26656)
    sp.add_argument("--timeout", type=float, default=3.0)

    sp = sub.add_parser(
        "debug", help="capture a debug dump (node state over RPC + config + WAL) into a zip"
    )
    sp.add_argument("--rpc", default="", help="RPC URL of the running node (optional)")
    sp.add_argument("--output", default="debug_dump.zip")

    sp = sub.add_parser(
        "load-test",
        help="tx load generator: spam a running net over RPC, report send + commit "
             "throughput plus chain-side block-interval/step-duration summaries "
             "scraped from /metrics (chain_metrics; null if not served)",
    )
    sp.add_argument(
        "--endpoints", default="http://127.0.0.1:26657",
        help="comma-separated RPC base URLs",
    )
    sp.add_argument("--rate", type=float, default=200.0, help="aggregate target tx/s")
    sp.add_argument("--duration", type=float, default=10.0, help="send window seconds")
    sp.add_argument("--connections", type=int, default=2, help="workers per endpoint")
    sp.add_argument("--tx-size", type=int, default=64, help="tx bytes (unique prefix + pad)")
    sp.add_argument("--method", default="async", choices=("async", "sync"))
    sp.add_argument("--settle", type=float, default=2.0,
                    help="post-send wait before counting committed txs")
    sp.add_argument("--signed", action="store_true",
                    help="wrap every tx in a signed-tx envelope (one key "
                         "per worker) — exercises device-batched CheckTx "
                         "admission against a signed_kvstore app")

    sp = sub.add_parser(
        "abci", help="abci-cli console: drive an ABCI app (conformance tool)"
    )
    sp.add_argument(
        "--app", default="kvstore",
        help="kvstore | persistent_kvstore | counter | counter:noserial | tcp://host:port",
    )
    sp.add_argument(
        "batch_file", nargs="?", default=None,
        help="command script (one command per line); stdin console if omitted",
    )

    sp = sub.add_parser("light", help="light client: verify headers over RPC")
    sp.add_argument("chain_id")
    sp.add_argument("--primary", required=True, help="primary RPC URL")
    sp.add_argument("--witness", action="append", default=[], help="witness RPC URL")
    sp.add_argument("--trust-height", type=int, required=True)
    sp.add_argument("--trust-hash", required=True)
    sp.add_argument("--height", type=int, default=None)
    sp.add_argument("--laddr", default="", help="run a verifying RPC proxy on this address")

    args = p.parse_args(argv)

    if args.cmd == "init":
        info = init_files(args.home, args.chain_id, overwrite=args.overwrite)
        print(json.dumps(info))
    elif args.cmd == "start":
        try:
            run_node(args.home, device=args.device)
        except RuntimeError as e:
            cause = f" ({e.__cause__!r})" if e.__cause__ is not None else ""
            print(f"start: {e}{cause}", file=sys.stderr, flush=True)
            return 1
    elif args.cmd == "testnet":
        out = make_testnet(args.output_dir, args.v, args.chain_id, args.starting_port)
        print(json.dumps(out))
    elif args.cmd == "show-node-id":
        from tendermint_tpu_torch.p2p.key import NodeKey

        cfg = load_home(args.home)
        print(NodeKey.load_or_gen(cfg.path(cfg.base.node_key_file)).id)
    elif args.cmd == "show-validator":
        from tendermint_tpu_torch.privval.file_pv import FilePV

        cfg = load_home(args.home)
        pv = FilePV.load(
            cfg.path(cfg.base.priv_validator_key_file),
            cfg.path(cfg.base.priv_validator_state_file),
        )
        from tendermint_tpu_torch.libs import amino_json

        print(amino_json.marshal(pv.get_pub_key()))
    elif args.cmd == "gen-validator":
        from tendermint_tpu_torch.crypto.keys import gen_ed25519

        priv = gen_ed25519()
        pub = priv.pub_key()
        print(json.dumps({
            "address": pub.address().hex().upper(),
            "pub_key": pub.bytes().hex(),
            "priv_key": priv.bytes().hex(),
        }))
    elif args.cmd == "unsafe-reset-all":
        cfg = load_home(args.home)
        data_dir = cfg.path("data")
        if os.path.isdir(data_dir):
            shutil.rmtree(data_dir)
        os.makedirs(data_dir, exist_ok=True)
        # reset the privval sign state but KEEP the key
        state_file = cfg.path(cfg.base.priv_validator_state_file)
        if os.path.exists(state_file):
            os.unlink(state_file)
        print(json.dumps({"reset": args.home}))
    elif args.cmd == "localnet":
        run_localnet(args.output_dir, args.v, args.chain_id, args.starting_port, args.blocks,
                     device=args.device)
    elif args.cmd == "signer-harness":
        run_signer_harness(args.addr, args.chain_id)
    elif args.cmd == "replay":
        run_replay(args.home, console=False, device=args.device)
    elif args.cmd == "replay-console":
        run_replay(args.home, console=True, device=args.device)
    elif args.cmd == "wal-inspect":
        from tendermint_tpu_torch.tools.wal_inspect import inspect_wal

        wal_path = args.wal
        if not wal_path:
            cfg = load_home(args.home)
            wal_path = (
                cfg.consensus.wal_path
                if os.path.isabs(cfg.consensus.wal_path)
                else cfg.path(cfg.consensus.wal_path)
            )
        if not os.path.exists(wal_path):
            raise SystemExit(f"WAL not found: {wal_path!r} (pass --wal)")
        print(json.dumps(inspect_wal(wal_path, limit=args.limit), indent=1))
    elif args.cmd == "probe-upnp":
        # (reference: cmd/tendermint/commands/probe_upnp.go)
        from tendermint_tpu_torch.p2p.upnp import UPNPError, probe

        try:
            caps = asyncio.run(
                probe(int_port=args.port, ext_port=args.port, timeout=args.timeout)
            )
            print(json.dumps(caps))
        except UPNPError as e:
            print(json.dumps({"upnp": False, "error": str(e)}))
    elif args.cmd == "debug":
        debug_dump(args.home, args.rpc, args.output)
        print(json.dumps({"dump": args.output}))
    elif args.cmd == "load-test":
        # in-tree equivalent of the external tm-load-test harness the
        # reference README delegates to (reference: README.md:153-155)
        from tendermint_tpu_torch.tools.loadtest import run_load

        report = asyncio.run(
            run_load(
                [e.strip() for e in args.endpoints.split(",") if e.strip()],
                rate=args.rate,
                duration=args.duration,
                connections=args.connections,
                tx_size=args.tx_size,
                method=args.method,
                settle=args.settle,
                signed=args.signed,
            )
        )
        print(json.dumps(report))
    elif args.cmd == "abci":
        from tendermint_tpu_torch.cli.abci_console import main as abci_main

        abci_main(args.app, args.batch_file)
    elif args.cmd == "version":
        print(VERSION)
    elif args.cmd == "light":
        run_light(
            args.chain_id, args.primary, args.witness,
            args.trust_height, args.trust_hash, args.home, args.height,
            laddr=args.laddr, device=args.device,
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())

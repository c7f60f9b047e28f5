"""The port's command line (cli/main.py, `python -m tendermint_tpu_torch.cli`)
against the JAX package's.

With os.urandom and the clock pinned (and each package's lazy imports done
first), `init` with a fixed seed and `testnet` write byte-identical files
in both packages: config.toml, genesis.json, the validator key and state,
the node key; the small commands print the same lines; `unsafe-reset-all`
keeps the keys in both. On one WAL written by a port node (hard-killed in
the middle of a height), `wal-inspect` prints the same JSON from both
packages and `replay` the same steps. `signer-harness` passes against the
port's SignerServer and the reference's. A 2-node net boots from the port's
`testnet` output and commits. Then the processes a user starts: `init`,
then `--device cpu start`, commits blocks, serves `debug` and `load-test
--signed` (skipped without OpenSSL, as tests/test_loadtest.py is) and exits
0 on SIGINT; `start` without `--device` exits non-zero on this card-less
host before it writes anything, and a node that stores a failure ends
`start` with exit 1 (ROADMAP D1). No tolerance applies.
"""

import asyncio
import contextlib
import io
import json
import os
import random
import shutil
import signal
import socket
import subprocess
import sys
import time
import zipfile
from unittest import mock

import pytest

os.environ.setdefault("TMTPU_CRYPTO_BACKEND", "cpu")

import tendermint_tpu.cli.main as R  # noqa: E402
import tendermint_tpu_torch.cli.main as T  # noqa: E402
from tendermint_tpu_torch.crypto import keys as T_keys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GEN_TIME = 1_700_000_000_000_000_000
FILES = ("config/config.toml", "config/genesis.json", "config/priv_validator_key.json",
         "config/node_key.json", "data/priv_validator_state.json")


@contextlib.contextmanager
def pinned(seed: int):
    """os.urandom from a seeded stream and a fixed clock."""
    rng = random.Random(seed)
    with mock.patch("os.urandom", lambda n: bytes(rng.getrandbits(8) for _ in range(n))), \
            mock.patch("time.time_ns", lambda: GEN_TIME):
        yield


@pytest.fixture(scope="module")
def warm(tmp_path_factory):
    """Both packages' lazy imports done, so pinned() sees only the
    commands' own draws."""
    d = tmp_path_factory.mktemp("warm")
    for name, M in (("ref", R), ("port", T)):
        M.init_files(str(d / name), "")
        M.make_testnet(str(d / f"{name}-net"), 2)
    return d


def read(home, rel):
    with open(os.path.join(home, rel), "rb") as f:
        return f.read()


def run_cli(M, argv) -> tuple:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = M.main(argv)
    return rc, out.getvalue()


@pytest.mark.parametrize("seed,chain", [(1, "cli-chain"), (2, ""), (3, "x")])
def test_init_with_a_fixed_seed_writes_the_same_files(tmp_path, warm, seed, chain):
    infos = {}
    for name, M in (("ref", R), ("port", T)):
        with pinned(seed):
            infos[name] = M.init_files(str(tmp_path / name), chain, seed=bytes([seed]) * 32)
    assert {k: v for k, v in infos["port"].items() if k != "home"} == \
        {k: v for k, v in infos["ref"].items() if k != "home"}
    for rel in FILES:
        assert read(tmp_path / "port", rel) == read(tmp_path / "ref", rel), rel
    gen = json.loads(read(tmp_path / "port", "config/genesis.json"))
    assert len(gen["validators"]) == 1
    # a second init keeps the identity and the chain
    again = T.init_files(str(tmp_path / "port"), "other")
    assert again["node_id"] == infos["port"]["node_id"]
    assert json.loads(read(tmp_path / "port", "config/genesis.json")) == gen


@pytest.mark.parametrize("n,port", [(2, 30000), (4, 41000)])
def test_testnet_writes_the_same_configs(tmp_path, warm, n, port):
    outs = {}
    for name, M in (("ref", R), ("port", T)):
        with pinned(n):
            rc, text = run_cli(M, ["testnet", "--v", str(n), "--output-dir",
                                   str(tmp_path / name), "--chain-id", "net-chain",
                                   "--starting-port", str(port)])
        assert rc == 0
        outs[name] = json.loads(text.replace(str(tmp_path / name), "OUT"))
    assert outs["port"] == outs["ref"]
    for i, node in enumerate(outs["port"]):
        for rel in FILES[:4]:
            assert read(tmp_path / "port" / f"node{i}", rel) == \
                read(tmp_path / "ref" / f"node{i}", rel), (i, rel)
        cfg = T.load_home(str(tmp_path / "port" / f"node{i}"))
        peers = [p for p in cfg.p2p.persistent_peers.split(",") if p]
        assert len(peers) == n - 1 and not any(p.startswith(node["node_id"]) for p in peers)
        assert cfg.p2p.laddr == f"tcp://127.0.0.1:{port + 2 * i}"
        assert cfg.rpc.laddr == f"tcp://127.0.0.1:{port + 2 * i + 1}"


def test_small_commands_print_the_same(tmp_path, warm):
    got = {}
    for name, M in (("ref", R), ("port", T)):
        home = str(tmp_path / name)
        with pinned(9):
            M.init_files(home, "small", seed=b"\x09" * 32)
            got[name] = [run_cli(M, ["--home", home, cmd])
                         for cmd in ("show-node-id", "show-validator", "version",
                                     "gen-validator")]
    assert got["port"] == got["ref"]
    v = json.loads(got["port"][1][1])
    assert v["type"] == "tendermint/PubKeyEd25519"
    assert got["port"][2][1].strip() == R.VERSION == T.VERSION


def test_unsafe_reset_all_keeps_the_keys(tmp_path, warm):
    listing = {}
    for name, M in (("ref", R), ("port", T)):
        home = str(tmp_path / name)
        M.init_files(home, "reset", seed=b"\x05" * 32)
        key = read(home, "config/priv_validator_key.json")
        with open(os.path.join(home, "data", "junk"), "w") as f:
            f.write("x")
        rc, text = run_cli(M, ["--home", home, "unsafe-reset-all"])
        assert rc == 0 and json.loads(text) == {"reset": home}
        assert read(home, "config/priv_validator_key.json") == key
        listing[name] = sorted(os.path.relpath(os.path.join(dp, f), home)
                               for dp, _, fs in os.walk(home) for f in fs)
    assert listing["port"] == listing["ref"]
    assert "data/junk" not in listing["port"]
    assert "config/priv_validator_key.json" in listing["port"]


@pytest.fixture(scope="module")
def crashed_home(tmp_path_factory):
    """A home whose port node committed 3 heights and was hard-killed."""
    from tendermint_tpu_torch.chaos.process import hard_kill
    from tendermint_tpu_torch.node.node import Node
    from tendermint_tpu_torch.privval.file_pv import FilePV
    from tendermint_tpu_torch.types.genesis import GenesisDoc

    home = str(tmp_path_factory.mktemp("wal") / "h")
    T.init_files(home, "replay-chain", seed=b"\x03" * 32)
    cfg = T.load_home(home)
    cfg.rpc.laddr, cfg.p2p.laddr = "", ""
    cfg.instrumentation.forensics_dir = ""
    cfg.consensus.timeout_commit = 0.05
    with open(cfg.genesis_path()) as f:
        gen = GenesisDoc.from_json(f.read())
    pv = FilePV.load(cfg.path(cfg.base.priv_validator_key_file),
                     cfg.path(cfg.base.priv_validator_state_file))
    node = Node(cfg, gen, priv_validator=pv, device="cpu")

    async def run():
        await node.start()
        await node.wait_for_height(3, timeout=60)
        await hard_kill(node)

    asyncio.run(run())
    return home


@pytest.mark.parametrize("cmd", [["wal-inspect"], ["wal-inspect", "--limit", "2"], ["replay"]])
def test_wal_inspect_and_replay_agree_on_a_port_wal(tmp_path, crashed_home, cmd):
    outs = {}
    for name, M, extra in (("ref", R, []), ("port", T, ["--device", "cpu"])):
        home = str(tmp_path / name)
        shutil.copytree(crashed_home, home)
        rc, text = run_cli(M, ["--home", home] + extra + cmd)
        assert rc == 0
        outs[name] = text.replace(home, "HOME")
    assert outs["port"] == outs["ref"]
    if cmd[0] == "wal-inspect":
        rep = json.loads(outs["port"])
        assert rep["heights_seen"] >= (2 if len(cmd) > 1 else 3)
        from tendermint_tpu.tools.wal_inspect import inspect_wal as r_inspect
        from tendermint_tpu_torch.tools.wal_inspect import build_timeline, inspect_wal

        wal = os.path.join(crashed_home, "data", "cs.wal", "wal")
        assert inspect_wal(wal) == r_inspect(wal)
        if len(cmd) == 1:
            assert json.loads(json.dumps(build_timeline(wal).dump(None))) == rep["heights"]
    else:
        lines = outs["port"].strip().splitlines()
        assert lines[0].startswith("replaying ")
        assert json.loads(lines[-1])["height"] >= 3


@pytest.mark.parametrize("server", ["port", "ref"])
def test_signer_harness_passes(server):
    if server == "port":
        from tendermint_tpu_torch.privval.file_pv import FilePV
        from tendermint_tpu_torch.privval.remote import SignerServer

        pv = FilePV(T_keys.gen_ed25519(b"\x31" * 32))
    else:
        from tendermint_tpu.crypto.keys import gen_ed25519
        from tendermint_tpu.privval.file_pv import FilePV
        from tendermint_tpu.privval.remote import SignerServer

        pv = FilePV(gen_ed25519(b"\x31" * 32))
    srv = SignerServer(pv, "harness-chain", port=0)
    srv.start()
    try:
        rc, text = run_cli(T, ["signer-harness", "--addr",
                               f"tcp://{srv.addr[0]}:{srv.addr[1]}"])
    finally:
        srv.stop()
    res = json.loads(text)
    assert rc == 0 and res["passed"], res
    assert res["results"]["pubkey"] == pv.get_pub_key().bytes().hex()
    assert {k for k, v in res["results"].items() if v == "ok"} == {
        "ping", "sign_vote", "double_sign_guard", "sign_proposal"}


def free_ports(n: int) -> list:
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def test_two_node_net_from_testnet_output(tmp_path):
    """tests/test_cli.py's localnet story on port nodes from the port's
    `testnet` output."""
    from tendermint_tpu_torch.node.node import Node
    from tendermint_tpu_torch.privval.file_pv import FilePV
    from tendermint_tpu_torch.types.genesis import GenesisDoc

    p0, p1 = free_ports(2)
    out = T.make_testnet(str(tmp_path / "net"), 2, chain_id="localnet", starting_port=p0)

    async def run():
        nodes = []
        for i, entry in enumerate(out):
            cfg = T.load_home(entry["home"])
            cfg.base.db_backend = "memdb"
            cfg.rpc.laddr = ""
            cfg.instrumentation.forensics_dir = ""
            if i == 1:  # the second node's p2p port: a free one, its peer entry to match
                cfg.p2p.laddr = f"tcp://127.0.0.1:{p1}"
            else:
                cfg.p2p.persistent_peers = cfg.p2p.persistent_peers.replace(
                    f":{p0 + 2}", f":{p1}")
            cfg.consensus.timeout_propose = 0.4
            cfg.consensus.timeout_prevote = 0.2
            cfg.consensus.timeout_precommit = 0.2
            cfg.consensus.timeout_commit = 0.1
            with open(cfg.genesis_path()) as f:
                gen = GenesisDoc.from_json(f.read())
            pv = FilePV.load(cfg.path(cfg.base.priv_validator_key_file),
                             cfg.path(cfg.base.priv_validator_state_file))
            nodes.append(Node(cfg, gen, priv_validator=pv, device="cpu"))
        try:
            for n in nodes:
                await n.start()
            for n in nodes:
                await n.wait_for_height(3, timeout=90)
            assert nodes[0].block_store.load_block(3).hash() == \
                nodes[1].block_store.load_block(3).hash()
        finally:
            for n in nodes:
                await n.stop()

    asyncio.run(run())


def cli_proc(argv, log, env=None):
    e = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_"))}
    e.update(env or {})
    return subprocess.Popen([sys.executable, "-m", "tendermint_tpu_torch.cli"] + argv,
                            cwd=ROOT, env=e, stdout=log, stderr=subprocess.STDOUT)


def test_localnet_passes_the_device_to_its_children(tmp_path, capsys):
    """`--device cpu localnet`: a fresh testnet, one `start` process a
    validator, given the parent's --device, run until it reaches the height,
    then stopped. One validator: a net of several fresh nodes can wait in
    blocksync's handoff until its peers connect (the reference's rule),
    which chip_smoke.py's cli_localnet waits out with four."""
    base = free_ports(1)[0]
    out = str(tmp_path / "net")
    with mock.patch.dict(os.environ, {"TMTPU_CRYPTO_BACKEND": "cpu"}):
        assert T.main(["--device", "cpu", "localnet", "--v", "1", "--output-dir", out,
                       "--starting-port", str(base), "--blocks", "2"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1])["localnet"] == "ok"
    assert all(h >= 2 for h in json.loads(lines[-1])["heights"])
    with pytest.raises(SystemExit, match="not empty"):
        T.run_localnet(out, 1, "", base, 2, device="cpu")


def test_start_without_device_exits_before_writing(tmp_path):
    """ROADMAP D1: on this card-less host `start` resolves the card first
    and exits 1 with device.resolve's error; the home is untouched."""
    home = str(tmp_path / "h")
    T.init_files(home, "nodev")
    before = {p: read(home, p) for p in FILES}
    listing = sorted(os.listdir(os.path.join(home, "data")))
    res = subprocess.run([sys.executable, "-m", "tendermint_tpu_torch.cli", "--home", home,
                          "start"], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert res.returncode == 1
    assert "no CUDA device is available" in res.stderr
    assert sorted(os.listdir(os.path.join(home, "data"))) == listing
    assert {p: read(home, p) for p in FILES} == before


@pytest.mark.skipif(not T_keys._HAVE_OPENSSL, reason="needs OpenSSL-speed host crypto")
def test_init_then_cpu_start_commits_and_serves(tmp_path):
    """`init`, then `--device cpu start` in a process of its own: it commits
    blocks, answers `debug` and a `load-test --signed` against its
    signed_kvstore app over RPC (a signed-tx envelope per tx, admitted and
    committed), and exits 0 on SIGINT."""
    home = str(tmp_path / "h")
    assert run_cli(T, ["--home", home, "init", "--chain-id", "cli-start"])[0] == 0
    p2p, rpc, prom = free_ports(3)
    cfg = T.load_home(home)
    cfg.base.abci = "signed_kvstore"
    cfg.p2p.laddr = f"tcp://127.0.0.1:{p2p}"
    cfg.rpc.laddr = f"tcp://127.0.0.1:{rpc}"
    cfg.instrumentation.prometheus = True
    cfg.instrumentation.prometheus_listen_addr = f"127.0.0.1:{prom}"
    cfg.consensus.timeout_commit = 0.2
    from tendermint_tpu_torch.config.toml import save_config

    save_config(cfg, os.path.join(home, "config", "config.toml"))
    url = f"http://127.0.0.1:{rpc}"
    with open(tmp_path / "node.log", "w") as log:
        proc = cli_proc(["--home", home, "--device", "cpu", "start"], log)
    try:
        deadline = time.time() + 90
        height = 0
        while height < 2:
            assert proc.poll() is None, (tmp_path / "node.log").read_text()[-2000:]
            assert time.time() < deadline, (tmp_path / "node.log").read_text()[-2000:]
            try:
                height = int(_rpc(rpc, "status")["sync_info"]["latest_block_height"])
            except OSError:
                pass
            time.sleep(0.2)
        rc, text = run_cli(T, ["load-test", "--endpoints", url, "--signed", "--rate", "60",
                               "--duration", "1.5", "--connections", "1", "--method", "sync",
                               "--settle", "1.5"])
        report = json.loads(text)
        assert rc == 0 and report["signed"] and report["errors"] == 0, report
        assert report["sent"] > 20 and report["rejected"] == 0, report
        assert 0 < report["committed_txs"] <= report["sent"], report
        assert report["chain_metrics"] is not None, report
        zpath = str(tmp_path / "dump.zip")
        rc, text = run_cli(T, ["--home", home, "debug", "--rpc", url, "--output", zpath])
        assert rc == 0 and json.loads(text) == {"dump": zpath}
        names = zipfile.ZipFile(zpath).namelist()
        assert {"status.json", "config/config.toml", "config/genesis.json"} <= set(names)
        assert any(n.startswith("wal/") for n in names)
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            code = proc.wait(60)
        except subprocess.TimeoutExpired:
            proc.kill()
            raise
    assert code == 0, (tmp_path / "node.log").read_text()[-2000:]
    log = (tmp_path / "node.log").read_text()
    assert "started; chain cli-start" in log


def _rpc(port: int, method: str) -> dict:
    import urllib.request

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}",
        json.dumps({"jsonrpc": "2.0", "id": 1, "method": method, "params": {}}).encode(),
        {"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=5) as resp:
        return json.load(resp)["result"]


def test_start_ends_with_exit_1_on_a_stored_failure(tmp_path, monkeypatch, capsys):
    """ROADMAP D1: the reference's `start` waits only for a signal; the
    port's also ends on the node's first stored failure, here a failed
    prewarm (the card arm's prewarm with the routing variable unset)."""
    from tendermint_tpu_torch.crypto import batch

    home = str(tmp_path / "h")
    T.init_files(home, "fail-chain")
    cfg = T.load_home(home)
    cfg.rpc.laddr, cfg.p2p.laddr = "", ""
    cfg.instrumentation.forensics_dir = ""
    from tendermint_tpu_torch.config.toml import save_config

    save_config(cfg, os.path.join(home, "config", "config.toml"))
    monkeypatch.delenv("TMTPU_CRYPTO_BACKEND", raising=False)

    def broken(*a, **k):
        raise RuntimeError("injected prewarm failure")

    monkeypatch.setattr(batch, "prewarm", broken)
    t0 = time.time()
    assert T.main(["--home", home, "--device", "cpu", "start"]) == 1
    assert time.time() - t0 < 60
    err = capsys.readouterr().err
    assert "crypto prewarm failed" in err and "injected prewarm failure" in err

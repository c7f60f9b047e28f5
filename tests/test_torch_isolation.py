"""The port imports nothing of JAX and nothing of the JAX package.

Checked in a fresh subprocess (this test process already holds jax, which
tests/conftest.py imports): import every module of tendermint_tpu_torch and
chip_smoke.py's own imports, then assert no jax* / tendermint_tpu.* module
was loaded. Also: the default device is the card and, without one, an entry
point raises instead of running on the CPU. No tolerance applies.
"""

import os
import re
import subprocess
import sys

import pytest
import torch

from tendermint_tpu_torch.crypto import batch as tbatch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "tendermint_tpu_torch")

_PROBE = r"""
import importlib, pkgutil, sys
import tendermint_tpu_torch as pkg
mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for m in mods:
    importlib.import_module(m)
import chip_smoke  # its module-level imports
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib")) or m == "tendermint_tpu"
             or m.startswith("tendermint_tpu."))
print(len(mods), bad, " ".join(mods))
assert not bad, bad
"""


@pytest.fixture(autouse=True)
def _port_memo_off():
    """The port's verified-row memo is off, as tests/conftest.py turns the
    reference's off: a row verified twice takes its route twice."""
    from tendermint_tpu_torch.crypto import batch

    prev, batch._MEMO = batch._MEMO, batch.VerifiedRowMemo(0)
    yield
    batch._MEMO = prev


def test_package_and_smoke_import_no_jax():
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_"))}
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    n_mods = int(res.stdout.split()[0])
    assert n_mods >= 112
    for mod in ("ops.cuda_fe", "ops.cuda_msm", "ops.msm_geometry", "ops.msm_torch",
                "crypto.batch", "ops.fp381", "ops.cuda_bls", "ops.bls12_torch",
                "ops.tower", "ops.pairing_torch", "crypto.bls_ref", "crypto.keys", "types.validator_set",
                "crypto.merlin", "crypto.sr25519", "native", "crypto.merkle", "types.light",
                "light", "light.verifier", "light.client", "light.store", "light.provider",
                "libs.kvdb", "types.vote", "types.evidence", "types.vote_set", "types.part_set",
                "blocksync", "blocksync.verify", "config", "libs.trace", "libs.txtrace",
                "crypto.provenance", "crypto.scheduler", "light.coalescer", "light.service",
                "ops.ristretto_torch", "libs.metrics", "libs.slo", "libs.profiler",
                "tools.profile_report",
                "libs.hotstats", "libs.fail", "libs.pubsub", "abci", "abci.types",
                "abci.client", "abci.kvstore", "proxy", "proxy.multi", "types.params",
                "types.genesis", "types.proposal", "types.event_bus", "state",
                "state.sm_state", "state.store", "store", "store.blockstore",
                "state.execution", "evidence", "evidence.pool", "mempool",
                "mempool.mempool", "privval", "privval.file_pv", "consensus",
                "consensus.messages", "consensus.round_state", "consensus.wal",
                "consensus.replay", "consensus.cs_state",
                "node", "node.node", "node.overload", "config.config", "config.toml",
                "types.signed_tx", "consensus.timeline", "libs.forensics", "libs.service",
                "libs.log", "state.txindex", "rpc", "rpc.server", "rpc.client",
                "rpc.grpc_api", "libs.prometheus_server", "crypto.proof_ops", "abci.wire",
                "light.proxy"):
        assert f"tendermint_tpu_torch.{mod}" in res.stdout.split(), mod


_NO_GRPC = r"""
import sys
sys.modules["grpc"] = None  # an import of grpc now raises ImportError
import tendermint_tpu_torch.node.node, tendermint_tpu_torch.rpc.server
import tendermint_tpu_torch.rpc.client, tendermint_tpu_torch.light.proxy
import tendermint_tpu_torch.light.provider
print(sorted(m for m in sys.modules if m.startswith("grpc")))
"""


def test_rpc_path_needs_no_grpc():
    """The node, the RPC server and clients, HTTPProvider and LightProxy
    import without grpc: only rpc/grpc_api.py needs it, and the node imports
    that module only when rpc.grpc_laddr is set. Their transport is aiohttp,
    which the card machine has."""
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_"))}
    res = subprocess.run([sys.executable, "-c", _NO_GRPC], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.split("\n")[-2] == "['grpc']"


def test_no_jax_reference_in_sources():
    pat = re.compile(r"^\s*(import jax|from jax)|tendermint_tpu\.", re.M)
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(PKG):
        files += [os.path.join(d, n) for n in names if n.endswith((".py", ".cu", ".cuh", ".c"))]
    hits = []
    for path in files:
        with open(path) as f:
            text = f.read()
        hits += [f"{path}: {m.group(0)!r}" for m in pat.finditer(text)]
    assert not hits, hits


def test_default_device_is_the_card(monkeypatch):
    """device=None means CUDA; on a host without a card a card call raises.
    A call that names no backend runs fewer than 256 rows on the host (the
    reference's routing, by row count, not by whether a card is present).
    TMTPU_CRYPTO_BACKEND is unset: it would pick the arm."""
    monkeypatch.delenv("TMTPU_CRYPTO_BACKEND", raising=False)
    if torch.cuda.is_available():
        assert tbatch.verify_batch([], [], [], device=None).shape == (0,)
        return
    n = 256
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbatch.verify_batch([b"\0" * 32] * n, [b""] * n, [b"\0" * 64] * n)
    assert tbatch.verify_batch([b"\0" * 32], [b""], [b"\0" * 64]).shape == (1,)
    assert tbatch.LAST_FLUSH["path"] == "cpu"

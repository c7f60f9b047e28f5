"""The example applications (reference abci/example/kvstore, counter): the
port's copy of tendermint_tpu/abci/kvstore.py.

Transactions are `key=value` (or a bare key, stored as its own value); the
app hash is the big-endian tx count (reference kvstore.go:66, :113); state
sync snapshots are a JSON dump in chunks. SignedKVStoreApplication takes a
signed-tx envelope on every tx and consumes the node's admission-lane
verdict (RequestCheckTx.sig_precheck) in place of its own serial verify;
PersistentKVStoreApplication adds validator-update txs
("val:pubkeyhex!power"); CounterApplication checks serial nonces (reference
abci/example/counter/counter.go:11); MerkleKVStoreApplication's app hash is
the SimpleMap root of its pairs, and it answers `prove=true` queries with
ValueOps (crypto/proof_ops.py).
"""

from __future__ import annotations

import json
import struct
from typing import Dict, List, Optional

from tendermint_tpu_torch.abci import types as abci
from tendermint_tpu_torch.libs.kvdb import KVDB, MemDB

VALIDATOR_TX_PREFIX = b"val:"


SNAPSHOT_CHUNK_SIZE = 65536


class KVStoreApplication(abci.Application):
    def __init__(self, db: Optional[KVDB] = None, snapshot_interval: int = 0,
                 snapshot_keep: int = 5):
        self.db = db or MemDB()
        self.size = int.from_bytes(self.db.get(b"__size__") or b"\x00", "big")
        self.height = int.from_bytes(self.db.get(b"__height__") or b"\x00", "big")
        self.app_hash = self.db.get(b"__apphash__") or b""
        self.staged: List[tuple] = []
        # state-sync snapshots: height -> (Snapshot, [chunk bytes])
        self.snapshot_interval = snapshot_interval
        self.snapshot_keep = snapshot_keep
        self._snapshots: Dict[int, tuple] = {}
        self._restore: Optional[dict] = None  # in-flight restore

    def info(self, req: abci.RequestInfo) -> abci.ResponseInfo:
        return abci.ResponseInfo(
            data=json.dumps({"size": self.size}),
            version="0.1.0",
            app_version=1,
            last_block_height=self.height,
            last_block_app_hash=self.app_hash,
        )

    def check_tx(self, req: abci.RequestCheckTx) -> abci.ResponseCheckTx:
        if not req.tx:
            return abci.ResponseCheckTx(code=1, log="empty tx")
        return abci.ResponseCheckTx(code=abci.CODE_TYPE_OK, gas_wanted=1)

    def deliver_tx(self, req: abci.RequestDeliverTx) -> abci.ResponseDeliverTx:
        if b"=" in req.tx:
            key, value = req.tx.split(b"=", 1)
        else:
            key = value = req.tx
        self.staged.append((key, value))
        events = [
            abci.Event(
                type="app",
                attributes=[(b"creator", b"tendermint_tpu", True), (b"key", key, True)],
            )
        ]
        return abci.ResponseDeliverTx(code=abci.CODE_TYPE_OK, events=events)

    def _compute_app_hash(self) -> bytes:
        # app hash = encoded size (mirrors reference kvstore.go:113)
        return struct.pack(">Q", self.size)

    def commit(self) -> abci.ResponseCommit:
        for key, value in self.staged:
            self.db.set(b"kv/" + key, value)
            self.size += 1
        self.staged.clear()
        self.height += 1
        self.app_hash = self._compute_app_hash()
        self.db.set(b"__size__", self.size.to_bytes(8, "big"))
        self.db.set(b"__height__", self.height.to_bytes(8, "big"))
        self.db.set(b"__apphash__", self.app_hash)
        if self.snapshot_interval and self.height % self.snapshot_interval == 0:
            self._take_snapshot()
        return abci.ResponseCommit(data=self.app_hash)

    # -- state-sync snapshots (reference: the ABCI snapshot protocol the
    # reference kvstore leaves unimplemented; format 1 = JSON dump) ---------

    def _take_snapshot(self) -> None:
        import hashlib

        payload = json.dumps(
            {
                "height": self.height,
                "size": self.size,
                "app_hash": self.app_hash.hex(),
                "items": [
                    [k[len(b"kv/"):].hex(), v.hex()]
                    for k, v in sorted(self.db.iterate_prefix(b"kv/"))
                ],
            },
            separators=(",", ":"),
        ).encode()
        chunks = [
            payload[i : i + SNAPSHOT_CHUNK_SIZE]
            for i in range(0, len(payload), SNAPSHOT_CHUNK_SIZE)
        ] or [b""]
        snap = abci.Snapshot(
            height=self.height,
            format=1,
            chunks=len(chunks),
            hash=hashlib.sha256(payload).digest(),
        )
        self._snapshots[self.height] = (snap, chunks)
        while len(self._snapshots) > self.snapshot_keep:
            del self._snapshots[min(self._snapshots)]

    def list_snapshots(self) -> abci.ResponseListSnapshots:
        return abci.ResponseListSnapshots(
            snapshots=[s for s, _ in self._snapshots.values()]
        )

    def load_snapshot_chunk(self, req: abci.RequestLoadSnapshotChunk) -> abci.ResponseLoadSnapshotChunk:
        entry = self._snapshots.get(req.height)
        if entry is None or entry[0].format != req.format:
            return abci.ResponseLoadSnapshotChunk()
        snap, chunks = entry
        if not (0 <= req.chunk < len(chunks)):
            return abci.ResponseLoadSnapshotChunk()
        return abci.ResponseLoadSnapshotChunk(chunk=chunks[req.chunk])

    def offer_snapshot(self, req: abci.RequestOfferSnapshot) -> abci.ResponseOfferSnapshot:
        s = req.snapshot
        if s is None:
            return abci.ResponseOfferSnapshot(result=abci.OFFER_SNAPSHOT_REJECT)
        if s.format != 1:
            return abci.ResponseOfferSnapshot(result=abci.OFFER_SNAPSHOT_REJECT_FORMAT)
        self._restore = {"snapshot": s, "app_hash": req.app_hash, "chunks": {}}
        return abci.ResponseOfferSnapshot(result=abci.OFFER_SNAPSHOT_ACCEPT)

    def apply_snapshot_chunk(self, req: abci.RequestApplySnapshotChunk) -> abci.ResponseApplySnapshotChunk:
        import hashlib

        if self._restore is None:
            return abci.ResponseApplySnapshotChunk(result=abci.APPLY_SNAPSHOT_CHUNK_ABORT)
        self._restore["chunks"][req.index] = req.chunk
        snap = self._restore["snapshot"]
        if len(self._restore["chunks"]) < snap.chunks:
            return abci.ResponseApplySnapshotChunk(result=abci.APPLY_SNAPSHOT_CHUNK_ACCEPT)

        payload = b"".join(self._restore["chunks"][i] for i in range(snap.chunks))
        if hashlib.sha256(payload).digest() != snap.hash:
            self._restore = None
            return abci.ResponseApplySnapshotChunk(
                result=abci.APPLY_SNAPSHOT_CHUNK_REJECT_SNAPSHOT
            )
        doc = json.loads(payload.decode())
        # the payload's claimed app hash must match the light-client-trusted
        # hash tendermint handed us in OfferSnapshot — a self-consistent but
        # forged payload fails here
        trusted = self._restore["app_hash"]
        if trusted and bytes.fromhex(doc["app_hash"]) != trusted:
            self._restore = None
            return abci.ResponseApplySnapshotChunk(
                result=abci.APPLY_SNAPSHOT_CHUNK_REJECT_SNAPSHOT
            )
        for k, _ in list(self.db.iterate_prefix(b"kv/")):
            self.db.delete(k)
        for k_hex, v_hex in doc["items"]:
            self.db.set(b"kv/" + bytes.fromhex(k_hex), bytes.fromhex(v_hex))
        self.size = doc["size"]
        self.height = doc["height"]
        self.app_hash = bytes.fromhex(doc["app_hash"])
        self.db.set(b"__size__", self.size.to_bytes(8, "big"))
        self.db.set(b"__height__", self.height.to_bytes(8, "big"))
        self.db.set(b"__apphash__", self.app_hash)
        self._restore = None
        return abci.ResponseApplySnapshotChunk(result=abci.APPLY_SNAPSHOT_CHUNK_ACCEPT)

    def query(self, req: abci.RequestQuery) -> abci.ResponseQuery:
        if req.path == "/store" or req.path == "":
            value = self.db.get(b"kv/" + req.data)
            return abci.ResponseQuery(
                code=abci.CODE_TYPE_OK,
                key=req.data,
                value=value or b"",
                height=self.height,
                log="exists" if value is not None else "does not exist",
            )
        return abci.ResponseQuery(code=1, log=f"unknown path {req.path}")


class SignedKVStoreApplication(KVStoreApplication):
    """KVStore requiring a signed-tx envelope (types/signed_tx.py) on every
    tx — the stub application behind device-batched CheckTx admission.

    CheckTx is the ABCI split in action: when the node pre-verified the
    envelope's signature through the scheduler's admission lane, the
    request carries `sig_precheck` = OK|BAD and the app CONSUMES the
    verdict; with no verdict (NONE — plain node, remote submitter,
    precheck disabled) it verifies serially on the host, which is exactly
    the per-tx loop the admission lane replaces (and the serial arm the
    `tx_admission` phase of chip_smoke.py measures).

    DeliverTx unwraps the payload and applies it as a normal key=value tx.
    It trusts CheckTx-gated admission and does not re-verify — fine for a
    stub/bench app; a production app distrusting proposers would check
    `sig_precheck` at DeliverTx too (the envelope rides in the block, so
    anyone can)."""

    CODE_BAD_ENVELOPE = 10
    CODE_BAD_SIGNATURE = 11

    def __init__(self, db: Optional[KVDB] = None, **kw):
        super().__init__(db, **kw)
        self.serial_verifies = 0  # host verifies paid (no precheck verdict)
        self.precheck_consumed = 0  # verdicts consumed from the node

    def check_tx(self, req: abci.RequestCheckTx) -> abci.ResponseCheckTx:
        from tendermint_tpu_torch.types import signed_tx as stx

        env = stx.decode_signed_tx(req.tx)
        if env is None:
            return abci.ResponseCheckTx(
                code=self.CODE_BAD_ENVELOPE, log="not a signed-tx envelope"
            )
        if req.sig_precheck == abci.SIG_PRECHECK_OK:
            self.precheck_consumed += 1
            ok = True
        elif req.sig_precheck == abci.SIG_PRECHECK_BAD:
            self.precheck_consumed += 1
            ok = False
        else:
            self.serial_verifies += 1
            ok = stx.verify_signed_tx(env)
        if not ok:
            return abci.ResponseCheckTx(
                code=self.CODE_BAD_SIGNATURE, log="invalid tx signature"
            )
        return abci.ResponseCheckTx(code=abci.CODE_TYPE_OK, gas_wanted=1)

    def deliver_tx(self, req: abci.RequestDeliverTx) -> abci.ResponseDeliverTx:
        from tendermint_tpu_torch.types import signed_tx as stx

        env = stx.decode_signed_tx(req.tx)
        if env is None:
            return abci.ResponseDeliverTx(
                code=self.CODE_BAD_ENVELOPE, log="not a signed-tx envelope"
            )
        return super().deliver_tx(abci.RequestDeliverTx(tx=env.payload))


class PersistentKVStoreApplication(KVStoreApplication):
    """Adds validator updates via "val:<pubkey_hex>!<power>" txs
    (reference: abci/example/kvstore/persistent_kvstore.go)."""

    def __init__(self, db: Optional[KVDB] = None):
        super().__init__(db)
        self.val_updates: List[abci.ValidatorUpdate] = []

    def init_chain(self, req: abci.RequestInitChain) -> abci.ResponseInitChain:
        for v in req.validators:
            self._set_validator(v)
        return abci.ResponseInitChain()

    def _set_validator(self, v: abci.ValidatorUpdate) -> None:
        key = b"valkey/" + v.pub_key_bytes
        if v.power == 0:
            self.db.delete(key)
        else:
            self.db.set(key, str(v.power).encode())

    def deliver_tx(self, req: abci.RequestDeliverTx) -> abci.ResponseDeliverTx:
        if req.tx.startswith(VALIDATOR_TX_PREFIX):
            body = req.tx[len(VALIDATOR_TX_PREFIX):]
            try:
                pubkey_hex, power_s = body.split(b"!", 1)
                pubkey = bytes.fromhex(pubkey_hex.decode())
                power = int(power_s)
            except Exception:
                return abci.ResponseDeliverTx(code=2, log="invalid validator tx")
            if len(pubkey) != 32 or power < 0:
                return abci.ResponseDeliverTx(code=2, log="invalid validator tx")
            update = abci.ValidatorUpdate("ed25519", pubkey, power)
            self.val_updates.append(update)
            self._set_validator(update)
            return abci.ResponseDeliverTx(code=abci.CODE_TYPE_OK)
        return super().deliver_tx(req)

    def end_block(self, req: abci.RequestEndBlock) -> abci.ResponseEndBlock:
        updates, self.val_updates = self.val_updates, []
        return abci.ResponseEndBlock(validator_updates=updates)


class CounterApplication(abci.Application):
    """Serial-nonce app (reference: abci/example/counter/counter.go)."""

    def __init__(self, serial: bool = True):
        self.serial = serial
        self.tx_count = 0
        self.height = 0

    def info(self, req: abci.RequestInfo) -> abci.ResponseInfo:
        return abci.ResponseInfo(
            data=f"txs:{self.tx_count}", last_block_height=self.height,
            last_block_app_hash=(
                struct.pack(">Q", self.tx_count) if self.height else b""
            ),
        )

    def _check_value(self, tx: bytes, expected: int) -> bool:
        if len(tx) > 8:
            return False
        value = int.from_bytes(tx, "big")
        return value == expected

    def check_tx(self, req: abci.RequestCheckTx) -> abci.ResponseCheckTx:
        if self.serial and not self._check_value(req.tx, self.tx_count):
            return abci.ResponseCheckTx(code=2, log="invalid nonce")
        return abci.ResponseCheckTx()

    def deliver_tx(self, req: abci.RequestDeliverTx) -> abci.ResponseDeliverTx:
        if self.serial and not self._check_value(req.tx, self.tx_count):
            return abci.ResponseDeliverTx(code=2, log="invalid nonce")
        self.tx_count += 1
        return abci.ResponseDeliverTx()

    def commit(self) -> abci.ResponseCommit:
        self.height += 1
        if self.tx_count == 0:
            return abci.ResponseCommit()
        return abci.ResponseCommit(data=struct.pack(">Q", self.tx_count))


class MerkleKVStoreApplication(KVStoreApplication):
    """KVStore whose app hash is the SimpleMap merkle root over its pairs,
    with `prove=true` queries answered by ValueOp proofs that chain to the
    header's app_hash — the tree shape crypto/merkle/proof_value.go:14
    verifies. This is what the light proxy's verified abci_query runs
    against (light/rpc/client.go:116)."""

    def _pairs(self) -> Dict[bytes, bytes]:
        return {
            k[len(b"kv/"):]: v for k, v in sorted(self.db.iterate_prefix(b"kv/"))
        }

    def _compute_app_hash(self) -> bytes:
        from tendermint_tpu_torch.crypto.proof_ops import simple_map_proofs

        # One tree build per commit; proved queries reuse the per-key
        # ValueOps until the next commit replaces them.
        root, ops = simple_map_proofs(self._pairs())
        self._proof_cache = (self.height, ops)
        return root

    def _proofs(self):
        cache = getattr(self, "_proof_cache", None)
        if cache is None or cache[0] != self.height:
            from tendermint_tpu_torch.crypto.proof_ops import simple_map_proofs

            _, ops = simple_map_proofs(self._pairs())
            cache = self._proof_cache = (self.height, ops)
        return cache[1]

    def query(self, req: abci.RequestQuery) -> abci.ResponseQuery:
        res = super().query(req)
        if req.prove and res.code == abci.CODE_TYPE_OK and res.value:
            vop = self._proofs().get(req.data)
            if vop is not None:
                res.proof_ops = [vop.proof_op()]
        return res

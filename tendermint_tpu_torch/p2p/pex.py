"""PEX (peer exchange) reactor + address book.

reference: p2p/pex/pex_reactor.go:24 (channel 0x00, request/provide addrs,
ensure-peers routine, seed bootstrap), p2p/pex/addrbook.go:28-29,97-98,135-140
(new/old buckets, hashed placement, mark good/bad/attempt), p2p/pex/file.go
(JSON persistence).

The port's copy of tendermint_tpu/p2p/pex.py.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import random
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from tendermint_tpu_torch.crypto import tmhash
from tendermint_tpu_torch.libs import protowire as pw
from tendermint_tpu_torch.p2p.base_reactor import Reactor
from tendermint_tpu_torch.p2p.conn.connection import ChannelDescriptor
from tendermint_tpu_torch.p2p.node_info import parse_addr

logger = logging.getLogger("tendermint_tpu_torch.pex")

PEX_CHANNEL = 0x00  # reference: p2p/pex/pex_reactor.go:33

# reference: p2p/pex/addrbook.go params
NEW_BUCKET_COUNT = 256
OLD_BUCKET_COUNT = 64
BUCKET_SIZE = 64
# a peer must survive this long / attempts before promotion to "old"
OLD_AFTER_ATTEMPTS = 1

MAX_MSG_SIZE = 64 * 1024  # bounds a PexAddrs payload
MAX_ADDRS_PER_MSG = 100
MIN_REQUEST_INTERVAL = 5.0  # per-peer anti-spam (reference: ensurePeersPeriod/3)


@dataclass
class KnownAddress:
    """reference: p2p/pex/known_address.go."""

    addr: str  # "id@host:port"
    src: str  # peer id we learned it from
    attempts: int = 0
    last_attempt: float = 0.0
    last_success: float = 0.0
    is_old: bool = False
    bucket: int = -1

    @property
    def id(self) -> str:
        return parse_addr(self.addr)[0]

    def to_json(self) -> dict:
        return {
            "addr": self.addr,
            "src": self.src,
            "attempts": self.attempts,
            "last_attempt": self.last_attempt,
            "last_success": self.last_success,
            "is_old": self.is_old,
        }

    @classmethod
    def from_json(cls, o: dict) -> "KnownAddress":
        return cls(
            addr=o["addr"],
            src=o.get("src", ""),
            attempts=o.get("attempts", 0),
            last_attempt=o.get("last_attempt", 0.0),
            last_success=o.get("last_success", 0.0),
            is_old=o.get("is_old", False),
        )


class AddrBook:
    """New/old-bucketed address book (reference: p2p/pex/addrbook.go:97).

    New addresses (heard about, never connected) live in buckets hashed by
    (source-group, addr-group); old addresses (connected at least once) in
    buckets hashed by addr-group. One entry per node id."""

    def __init__(self, file_path: Optional[str] = None, key: Optional[bytes] = None):
        self.file_path = file_path
        # random key so remote peers can't engineer bucket collisions
        # (reference: addrbook.go a.key)
        self.key = key or os.urandom(8)
        self._addrs: Dict[str, KnownAddress] = {}  # node id -> ka
        self._new_buckets: List[List[str]] = [[] for _ in range(NEW_BUCKET_COUNT)]
        self._old_buckets: List[List[str]] = [[] for _ in range(OLD_BUCKET_COUNT)]
        if file_path and os.path.exists(file_path):
            self._load()

    # -- bucket math --------------------------------------------------------

    def _bucket_for(self, ka: KnownAddress) -> int:
        _, host, _ = parse_addr(ka.addr)
        if ka.is_old:
            h = tmhash.sum256(self.key + host.encode())
            return int.from_bytes(h[:4], "big") % OLD_BUCKET_COUNT
        h = tmhash.sum256(self.key + ka.src.encode() + host.encode())
        return int.from_bytes(h[:4], "big") % NEW_BUCKET_COUNT

    def _buckets(self, ka: KnownAddress) -> List[List[str]]:
        return self._old_buckets if ka.is_old else self._new_buckets

    def _place(self, ka: KnownAddress) -> None:
        bucket = self._bucket_for(ka)
        blist = self._buckets(ka)[bucket]
        if ka.id in blist:
            ka.bucket = bucket
            return
        if len(blist) >= BUCKET_SIZE:
            # evict the stalest entry of the bucket (reference: pickOldest)
            stalest = min(blist, key=lambda i: self._addrs[i].last_attempt)
            blist.remove(stalest)
            self._addrs.pop(stalest, None)
        blist.append(ka.id)
        ka.bucket = bucket

    def _unplace(self, ka: KnownAddress) -> None:
        if ka.bucket >= 0:
            blist = self._buckets(ka)[ka.bucket]
            if ka.id in blist:
                blist.remove(ka.id)
        ka.bucket = -1

    # -- public API ---------------------------------------------------------

    def add_address(self, addr: str, src: str = "") -> bool:
        """Record a new address (reference: addrbook.go:135 AddAddress)."""
        try:
            node_id, host, port = parse_addr(addr)
        except (ValueError, TypeError):
            return False
        if not node_id or not (0 < port < 65536):
            return False
        if node_id in self._addrs:
            return False
        ka = KnownAddress(addr=addr, src=src)
        self._addrs[node_id] = ka
        self._place(ka)
        return True

    def remove_address(self, node_id: str) -> None:
        ka = self._addrs.pop(node_id, None)
        if ka is not None:
            self._unplace(ka)

    def mark_attempt(self, node_id: str) -> None:
        ka = self._addrs.get(node_id)
        if ka is not None:
            ka.attempts += 1
            ka.last_attempt = time.time()

    def mark_good(self, node_id: str) -> None:
        """Successful connection: promote to an old bucket
        (reference: addrbook.go MarkGood)."""
        ka = self._addrs.get(node_id)
        if ka is None:
            return
        ka.attempts = 0
        ka.last_success = time.time()
        ka.last_attempt = ka.last_success
        if not ka.is_old:
            self._unplace(ka)
            ka.is_old = True
            self._place(ka)

    def mark_bad(self, node_id: str) -> None:
        """reference: addrbook.go MarkBad — we simply drop it."""
        self.remove_address(node_id)

    def has(self, node_id: str) -> bool:
        return node_id in self._addrs

    def is_empty(self) -> bool:
        return not self._addrs

    def size(self) -> int:
        return len(self._addrs)

    def pick_address(self, new_bias_pct: int = 50) -> Optional[KnownAddress]:
        """Random address, biased between new/old (reference: PickAddress)."""
        news = [ka for ka in self._addrs.values() if not ka.is_old]
        olds = [ka for ka in self._addrs.values() if ka.is_old]
        pools = []
        if news:
            pools.append((new_bias_pct, news))
        if olds:
            pools.append((100 - new_bias_pct, olds))
        if not pools:
            return None
        total = sum(wt for wt, _ in pools)
        r = random.uniform(0, total)
        for wt, pool in pools:
            if r < wt:
                return random.choice(pool)
            r -= wt
        return random.choice(pools[-1][1])

    def get_selection(self, max_addrs: int = MAX_ADDRS_PER_MSG) -> List[str]:
        """Random selection for a PEX response (reference: GetSelection)."""
        addrs = [ka.addr for ka in self._addrs.values()]
        random.shuffle(addrs)
        return addrs[: min(max_addrs, max(len(addrs) * 23 // 100 + 1, 10))]

    # -- persistence (reference: p2p/pex/file.go) ---------------------------

    def save(self) -> None:
        if not self.file_path:
            return
        data = {
            "key": self.key.hex(),
            "addrs": [ka.to_json() for ka in self._addrs.values()],
        }
        tmp = self.file_path + ".tmp"
        os.makedirs(os.path.dirname(self.file_path) or ".", exist_ok=True)
        with open(tmp, "w") as f:
            json.dump(data, f)
        os.replace(tmp, self.file_path)

    def _load(self) -> None:
        try:
            with open(self.file_path) as f:
                data = json.load(f)
        except (OSError, json.JSONDecodeError):
            logger.warning("could not load addrbook %s", self.file_path)
            return
        try:
            self.key = bytes.fromhex(data.get("key", "")) or self.key
        except ValueError:
            logger.warning("addrbook key corrupt; regenerating")
        for o in data.get("addrs", []):
            # a single corrupt entry must not prevent node startup
            try:
                ka = KnownAddress.from_json(o)
                if ka.id and ka.id not in self._addrs:
                    self._addrs[ka.id] = ka
                    self._place(ka)
            except (KeyError, ValueError, TypeError) as e:
                logger.warning("skipping corrupt addrbook entry %r: %s", o, e)


# ---------------------------------------------------------------- wire msgs


def encode_pex_request() -> bytes:
    w = pw.Writer()
    w.message_field(1, b"", always=True)
    return w.bytes()


def encode_pex_addrs(addrs: List[str]) -> bytes:
    body = pw.Writer()
    for a in addrs[:MAX_ADDRS_PER_MSG]:
        body.string_field(1, a, emit_empty=True)
    w = pw.Writer()
    w.message_field(2, body.bytes(), always=True)
    return w.bytes()


def decode_pex_message(data: bytes):
    """Returns None for a request, or the list of addr strings."""
    if len(data) > MAX_MSG_SIZE:
        raise ValueError("pex message too large")
    for f, _, v in pw.Reader(data):
        if f == 1:
            return None
        if f == 2:
            addrs = []
            for ff, _, vv in pw.Reader(v):
                if ff == 1:
                    addrs.append(vv.decode("utf-8"))
            if len(addrs) > MAX_ADDRS_PER_MSG:
                raise ValueError("too many addrs in pex message")
            return addrs
    raise ValueError("empty pex message")


# ------------------------------------------------------------------ reactor


class PexReactor(Reactor):
    """reference: p2p/pex/pex_reactor.go:24."""

    def __init__(
        self,
        book: AddrBook,
        seeds: Optional[List[str]] = None,
        ensure_period: float = 30.0,
        max_outbound: int = 10,
        seed_mode: bool = False,
    ):
        super().__init__("PEX")
        self.book = book
        self.seeds = seeds or []
        self.ensure_period = ensure_period
        self.max_outbound = max_outbound
        self.seed_mode = seed_mode
        self._last_request: Dict[str, float] = {}  # peer id -> ts (anti-spam)
        self._last_sent: Dict[str, float] = {}  # our own request cadence
        self._requested: set = set()  # peers we asked (only they may reply)
        self._task: Optional[asyncio.Task] = None

    def get_channels(self) -> List[ChannelDescriptor]:
        # sheddable + small capacity: a pex message is a bounded address
        # list (reference: p2p/pex/pex_reactor.go maxMsgSize 64KB-ish)
        return [
            ChannelDescriptor(
                PEX_CHANNEL, priority=1, send_queue_capacity=10,
                recv_message_capacity=65536, sheddable=True,
            )
        ]

    async def start(self) -> None:
        self._task = asyncio.create_task(self._ensure_peers_routine(), name="pex-ensure")

    async def stop(self) -> None:
        if self._task:
            self._task.cancel()
        self.book.save()

    # -- peers --------------------------------------------------------------

    async def add_peer(self, peer) -> None:
        """reference: pex_reactor.go:180 AddPeer."""
        if peer.outbound:
            # outbound peers are proven good addresses
            self.book.add_address(f"{peer.id}@{peer.socket_addr}", src=peer.id)
            self.book.mark_good(peer.id)
            if self._need_more_peers():
                await self._request_addrs(peer)
        # inbound peers' self-reported listen addr is NOT trusted (the
        # reference only records it via the dial-back in seed mode)

    async def remove_peer(self, peer, reason) -> None:
        self._requested.discard(peer.id)
        self._last_request.pop(peer.id, None)
        self._last_sent.pop(peer.id, None)

    # -- receive ------------------------------------------------------------

    async def receive(self, chan_id: int, peer, msg_bytes: bytes) -> None:
        try:
            addrs = decode_pex_message(msg_bytes)
        except ValueError as e:
            await self.switch.stop_peer_for_error(peer, e)
            return
        if addrs is None:  # PexRequest
            now = time.monotonic()
            last = self._last_request.get(peer.id)
            # the FIRST request after connect is always allowed; after that
            # anything under the interval is a flood (reference:
            # pex_reactor.go receiveRequest lastReceivedRequests)
            if last is not None and now - last < MIN_REQUEST_INTERVAL:
                await self.switch.stop_peer_for_error(peer, "pex request flood")
                return
            self._last_request[peer.id] = now
            await peer.send(PEX_CHANNEL, encode_pex_addrs(self.book.get_selection()))
            if self.seed_mode:
                # seeds hand out addresses and hang up to free slots for
                # other crawlers (reference: pex_reactor.go:308 seed flow)
                await asyncio.sleep(0.1)
                await self.switch.stop_peer_for_error(peer, "seed: served addrs")
        else:  # PexAddrs
            # unsolicited address dumps are an attack vector
            # (reference: pex_reactor.go:260 ReceiveAddrs requestsSent check)
            if peer.id not in self._requested:
                await self.switch.stop_peer_for_error(peer, "unsolicited pex addrs")
                return
            self._requested.discard(peer.id)
            for a in addrs:
                try:
                    node_id, _, _ = parse_addr(a)
                except (ValueError, TypeError):
                    continue
                if node_id and node_id != self.switch.node_info.node_id:
                    self.book.add_address(a, src=peer.id)

    async def _request_addrs(self, peer) -> None:
        """reference: pex_reactor.go:240 RequestAddrs. Rate-limited on OUR
        side too, so our own cadence never trips the peer's flood guard."""
        now = time.monotonic()
        if peer.id in self._requested:
            return
        if now - self._last_sent.get(peer.id, -1e9) < MIN_REQUEST_INTERVAL * 1.5:
            return
        self._last_sent[peer.id] = now
        self._requested.add(peer.id)
        await peer.send(PEX_CHANNEL, encode_pex_request())

    # -- ensure peers -------------------------------------------------------

    def _need_more_peers(self) -> int:
        out = sum(1 for p in self.switch.peers.list() if p.outbound)
        return max(0, self.max_outbound - out)

    async def _ensure_peers_routine(self) -> None:
        """Keep dialing until we have enough outbound peers
        (reference: pex_reactor.go:375 ensurePeersRoutine)."""
        # jittered start so a fleet doesn't thunder in step
        await asyncio.sleep(random.uniform(0, self.ensure_period / 10 + 0.01))
        while True:
            try:
                await self._ensure_peers()
            except asyncio.CancelledError:
                return
            except Exception:
                logger.exception("ensure_peers failed")
            await asyncio.sleep(self.ensure_period)

    async def _ensure_peers(self) -> None:
        need = self._need_more_peers()
        if need <= 0:
            return
        if self.book.is_empty() and self.seeds:
            await self._dial_seeds()
            return
        tried = 0
        for _ in range(need * 3):
            if tried >= need:
                break
            ka = self.book.pick_address()
            if ka is None:
                break
            if self.switch.peers.has(ka.id) or ka.id == self.switch.node_info.node_id:
                continue
            # exponential backoff per failed attempt (reference: ka.isBad)
            if ka.attempts > 0 and time.time() - ka.last_attempt < min(
                30.0 * (2 ** min(ka.attempts, 6)), 3600
            ):
                continue
            tried += 1
            self.book.mark_attempt(ka.id)
            try:
                await self.switch.dial_peer(ka.addr)
                self.book.mark_good(ka.id)
            except Exception as e:
                logger.debug("pex dial %s failed: %s", ka.addr, e)
                if ka.attempts >= 5:
                    self.book.mark_bad(ka.id)
        # also ask a random connected peer for more addresses
        peers = self.switch.peers.list()
        if peers and self.book.size() < 2 * self.max_outbound:
            await self._request_addrs(random.choice(peers))

    async def _dial_seeds(self) -> None:
        """reference: pex_reactor.go:500 dialSeeds."""
        seeds = list(self.seeds)
        random.shuffle(seeds)
        for seed in seeds:
            try:
                peer = await self.switch.dial_peer(seed)
                if peer is not None:
                    await self._request_addrs(peer)
                    return
            except Exception as e:
                logger.info("seed dial %s failed: %s", seed, e)

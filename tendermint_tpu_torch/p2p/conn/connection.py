"""MConnection: one connection per peer multiplexing N priority channels
(reference: p2p/conn/connection.go:77).

Shape mirrors the reference: per-channel send queues with priorities and a
most-starved-first scheduler (recentlySent EWMA, reference: :740-830), packets
of <=1024B payload batched up to 10 per flush (reference: :28-30), flow
limiting on send+recv (reference: :43-44,507,567), ping/pong keepalive
(reference: :46-47). Transport is any object with `write(bytes)` /
`read(n)` coroutines — a SecretConnection or a plain stream adapter.

The port's copy of tendermint_tpu/p2p/conn/connection.py.
"""

from __future__ import annotations

import asyncio
import logging
import time
from dataclasses import dataclass, field
from typing import Awaitable, Callable, Dict, List, Optional, Sequence

from tendermint_tpu_torch.libs import protowire as pw
from tendermint_tpu_torch.libs.flowrate import Monitor

logger = logging.getLogger("tendermint_tpu_torch.p2p")

MAX_PACKET_MSG_PAYLOAD_SIZE = 1024
NUM_BATCH_PACKET_MSGS = 10
DEFAULT_SEND_RATE = 512000
DEFAULT_RECV_RATE = 512000
PING_INTERVAL = 60.0
PONG_TIMEOUT = 45.0
# first ping fires shortly after start (not after a full PING_INTERVAL) so a
# fresh connection has a clock-skew estimate before consensus traffic needs
# one (the chain observatory's propagation latencies are skew-corrected)
PING_PRIME_DELAY = 0.25
FLUSH_THROTTLE = 0.1

# packet envelope fields (oneof): 1=ping 2=pong 3=msg{1:channel,2:eof,3:data}
_F_PING, _F_PONG, _F_MSG = 1, 2, 3


@dataclass
class ChannelDescriptor:
    """(reference: p2p/conn/connection.go ChannelDescriptor)"""

    id: int
    priority: int = 1
    send_queue_capacity: int = 64
    recv_message_capacity: int = 22020096  # 21MB, reference default maxMsgSize
    # Sheddable channels (mempool/pex/evidence) run their inbound messages
    # through a per-peer token bucket; when the bucket is empty the message
    # is dropped before reactor dispatch instead of backpressuring the whole
    # connection. Consensus channels stay False: votes/proposals are NEVER
    # rate-limited (the overload shed order is txs -> gossip -> never votes).
    sheddable: bool = False


@dataclass
class RecvRateLimit:
    """Per-channel inbound budget for sheddable channels ([p2p] recv_rate_*).

    bytes_per_s / msgs_per_s of 0 disable that bucket. strikes/strike_window
    bound how long a peer may flood before it is reported for misbehavior
    (the switch routes the report to the trust scorer, which disconnects)."""

    bytes_per_s: int = 1_048_576
    msgs_per_s: int = 2000
    strikes: int = 200
    strike_window: float = 10.0


class TokenBucket:
    """Dual-rate (bytes/s + msgs/s) token bucket with a one-window burst cap
    — idle time never banks unbounded credit (same policy as
    libs/flowrate.Monitor.limit, but drop-based instead of sleep-based:
    inbound shed must not stall the read loop that also carries votes)."""

    __slots__ = ("bytes_per_s", "msgs_per_s", "_bytes", "_msgs", "_ts")

    def __init__(self, bytes_per_s: int, msgs_per_s: int):
        self.bytes_per_s = bytes_per_s
        self.msgs_per_s = msgs_per_s
        self._bytes = float(bytes_per_s)
        self._msgs = float(msgs_per_s)
        self._ts = time.monotonic()

    def admit(self, nbytes: int) -> bool:
        now = time.monotonic()
        dt = now - self._ts
        self._ts = now
        if self.bytes_per_s > 0:
            self._bytes = min(float(self.bytes_per_s), self._bytes + self.bytes_per_s * dt)
        if self.msgs_per_s > 0:
            self._msgs = min(float(self.msgs_per_s), self._msgs + self.msgs_per_s * dt)
        # a message LARGER than one window's burst must still be admissible
        # from a full bucket (a max-size tx on a budget == its own size would
        # otherwise be permanently shed); the balance goes negative and the
        # connection pays it back through refill time
        need = min(float(nbytes), float(self.bytes_per_s))
        ok = (self.bytes_per_s <= 0 or self._bytes >= need) and (
            self.msgs_per_s <= 0 or self._msgs >= 1.0
        )
        if ok:
            self._bytes -= nbytes
            self._msgs -= 1.0
        return ok


@dataclass
class _Channel:
    desc: ChannelDescriptor
    send_queue: asyncio.Queue = field(init=False)
    sending: bytes = b""
    sent_pos: int = 0
    recently_sent: float = 0.0  # EWMA for priority scheduling
    recving: bytearray = field(default_factory=bytearray)

    def __post_init__(self):
        self.send_queue = asyncio.Queue(maxsize=self.desc.send_queue_capacity)

    def is_send_pending(self) -> bool:
        return self.sent_pos < len(self.sending) or not self.send_queue.empty()

    def next_packet(self) -> Optional[bytes]:
        """Pop the next <=1024B packet body for this channel, or None."""
        if self.sent_pos >= len(self.sending):
            if self.send_queue.empty():
                return None
            self.sending = self.send_queue.get_nowait()
            self.sent_pos = 0
        chunk = self.sending[self.sent_pos : self.sent_pos + MAX_PACKET_MSG_PAYLOAD_SIZE]
        self.sent_pos += len(chunk)
        eof = self.sent_pos >= len(self.sending)
        w = pw.Writer()
        w.varint_field(1, self.desc.id)
        w.varint_field(2, 1 if eof else 0)
        w.bytes_field(3, chunk, emit_empty=True)
        body = w.bytes()
        self.recently_sent += len(chunk)
        return body


class MConnection:
    """on_receive(channel_id, msg_bytes) is called for each complete message;
    on_error(exc) once when the connection dies."""

    def __init__(
        self,
        transport,
        channels: List[ChannelDescriptor],
        on_receive: Callable[[int, bytes], Awaitable[None]],
        on_error: Callable[[Exception], Awaitable[None]],
        send_rate: int = DEFAULT_SEND_RATE,
        recv_rate: int = DEFAULT_RECV_RATE,
        recv_limit: Optional[RecvRateLimit] = None,
        metrics=None,
        on_rate_limit_exceeded: Optional[Callable[[], Awaitable[None]]] = None,
    ):
        self._t = transport
        self._channels: Dict[int, _Channel] = {
            d.id: _Channel(d) for d in channels
        }
        self._on_receive = on_receive
        self._on_error = on_error
        self._send_monitor = Monitor()
        self._recv_monitor = Monitor()
        self._send_rate = send_rate
        self._recv_rate = recv_rate
        self._send_event = asyncio.Event()
        self._pong_pending = False
        self._last_pong = time.monotonic()
        # Clock-skew estimation (NTP-style, from timestamped ping/pong):
        # ping carries our wall clock t0; the pong echoes it and adds the
        # remote wall clock t2; at pong receipt t3 the remote-minus-local
        # offset is t2 - (t0+t3)/2, uncertain by ±RTT/2. The minimum-RTT
        # sample is kept (smallest uncertainty); later samples at equal-or-
        # better RTT replace it, worse-RTT samples nudge it by EWMA so slow
        # drift is still tracked. Legacy peers send empty ping/pong bodies —
        # no sample, skew stays None, consumers fall back to uncorrected
        # (clamped) latencies.
        self._skew_s: Optional[float] = None
        self._skew_rtt_s: Optional[float] = None
        self._skew_samples = 0
        self._ping_sent: Optional[tuple] = None  # (t0_us, monotonic at send)
        self._tasks: List[asyncio.Task] = []
        self._stopped = False
        # inbound admission control: one token bucket per SHEDDABLE channel
        self.metrics = metrics  # P2PMetrics or None
        self._recv_limit = recv_limit
        self._recv_buckets: Dict[int, TokenBucket] = {}
        if recv_limit is not None:
            for d in channels:
                if d.sheddable:
                    self._recv_buckets[d.id] = TokenBucket(
                        recv_limit.bytes_per_s, recv_limit.msgs_per_s
                    )
        self._on_rate_limit_exceeded = on_rate_limit_exceeded
        self._shed_window_start = time.monotonic()
        self._shed_in_window = 0
        self.shed_msgs = 0  # total inbound messages dropped by the buckets
        # chan_id -> dropped count; consensus channel ids must never appear
        # here (pinned by the vote-path guard test)
        self.shed_by_channel: Dict[int, int] = {}

    def start(self) -> None:
        self._tasks = [
            asyncio.create_task(self._send_routine(), name="mconn-send"),
            asyncio.create_task(self._recv_routine(), name="mconn-recv"),
            asyncio.create_task(self._ping_routine(), name="mconn-ping"),
        ]

    async def stop(self) -> None:
        self._stopped = True
        for t in self._tasks:
            t.cancel()
        for t in self._tasks:
            try:
                await t
            except (asyncio.CancelledError, Exception):
                pass
        try:
            self._t.close()
        except Exception:
            pass

    async def send(self, channel_id: int, msg: bytes) -> bool:
        """Queue msg on the channel; blocks on a full queue (backpressure)
        (reference: connection.go:350 Send)."""
        ch = self._channels.get(channel_id)
        if ch is None or self._stopped:
            return False
        await ch.send_queue.put(msg)
        self._send_event.set()
        return True

    async def write_burst(self, channel_id: int, msgs: Sequence[bytes]) -> bool:
        """Write whole messages on a channel in one write, past the channel's
        send queue and the send rate: the flooding peer of the chaos harness
        (chaos/byzantine.py poison_votes), which ignores its own
        backpressure. Each message goes as one packet, so none may exceed
        MAX_PACKET_MSG_PAYLOAD_SIZE bytes; a message the send routine has
        half sent on the channel is let finish first, so the receiver's
        reassembly never interleaves two messages."""
        ch = self._channels.get(channel_id)
        if ch is None or self._stopped:
            return False
        out = bytearray()
        for m in msgs:
            if len(m) > MAX_PACKET_MSG_PAYLOAD_SIZE:
                raise ValueError(f"a burst message of {len(m)} bytes exceeds one packet")
            w = pw.Writer()
            w.varint_field(1, channel_id)
            w.varint_field(2, 1)
            w.bytes_field(3, m, emit_empty=True)
            env = pw.Writer()
            env.message_field(_F_MSG, w.bytes(), always=True)
            e = env.bytes()
            out += pw.encode_varint(len(e)) + e
        while ch.sent_pos < len(ch.sending) and not self._stopped:
            await asyncio.sleep(0.001)
        if self._stopped:
            return False
        await self._t.write(bytes(out))
        return True

    def try_send(self, channel_id: int, msg: bytes) -> bool:
        """Non-blocking send; False if the queue is full (reference: :379)."""
        ch = self._channels.get(channel_id)
        if ch is None or self._stopped:
            return False
        try:
            ch.send_queue.put_nowait(msg)
        except asyncio.QueueFull:
            return False
        self._send_event.set()
        return True

    def status(self) -> dict:
        """Flowrate + queue-depth snapshot (reference: connection.go:270
        Status/ConnectionStatus): the per-peer read side of the Monitors
        that previously only throttled. Feeds net_info's connection_status
        and the switch's p2p flowrate gauges."""
        return {
            "send_rate_bytes": round(self._send_monitor.status_rate(), 1),
            "recv_rate_bytes": round(self._recv_monitor.status_rate(), 1),
            "send_bytes_total": self._send_monitor.total,
            "recv_bytes_total": self._recv_monitor.total,
            "clock_skew_s": (
                round(self._skew_s, 6) if self._skew_s is not None else None
            ),
            "clock_skew_rtt_s": (
                round(self._skew_rtt_s, 6) if self._skew_rtt_s is not None else None
            ),
            "clock_skew_samples": self._skew_samples,
            "shed_msgs_total": self.shed_msgs,
            "shed_by_channel": {
                f"{cid:#x}": n for cid, n in self.shed_by_channel.items()
            },
            "channels": [
                {
                    "id": ch.desc.id,
                    "priority": ch.desc.priority,
                    "pending_messages": ch.send_queue.qsize()
                    + (1 if ch.sent_pos < len(ch.sending) else 0),
                    "recently_sent": round(ch.recently_sent, 1),
                }
                for ch in self._channels.values()
            ],
        }

    def clock_skew(self) -> Optional[float]:
        """Estimated REMOTE-minus-LOCAL wall-clock offset in seconds, or
        None before the first timestamped pong (or against a legacy peer).
        Cross-node propagation latencies subtract this so a peer with a
        fast clock doesn't fabricate latency (and a slow one doesn't hide
        it); the residual uncertainty is ±RTT/2 of the kept sample."""
        return self._skew_s

    def _record_skew_sample(self, t0_s: float, t2_s: float, t3_s: float, rtt_s: float) -> None:
        """Fold one timestamped pong into the skew estimate (pure bookkeeping,
        unit-tested directly): offset = t2 - (t0+t3)/2."""
        offset = t2_s - (t0_s + t3_s) / 2.0
        self._skew_samples += 1
        if self._skew_rtt_s is None or rtt_s <= self._skew_rtt_s:
            # better (or first) uncertainty bound: take the sample outright
            self._skew_s = offset
            self._skew_rtt_s = rtt_s
        else:
            # worse RTT: blend lightly so long-run clock DRIFT still moves
            # the estimate without a lucky old sample pinning it forever
            self._skew_s += 0.1 * (offset - self._skew_s)

    # -- internals ---------------------------------------------------------

    def _pick_channel(self) -> Optional[_Channel]:
        """Least (recently_sent / priority) among channels with pending data
        (reference: connection.go sendPacketMsg channel selection)."""
        best, best_ratio = None, None
        for ch in self._channels.values():
            if not ch.is_send_pending():
                continue
            ratio = ch.recently_sent / max(ch.desc.priority, 1)
            if best_ratio is None or ratio < best_ratio:
                best, best_ratio = ch, ratio
        return best

    async def _send_routine(self) -> None:
        try:
            while not self._stopped:
                await self._send_event.wait()
                self._send_event.clear()
                batch = bytearray()
                n_packets = 0
                while n_packets < NUM_BATCH_PACKET_MSGS:
                    ch = self._pick_channel()
                    if ch is None:
                        break
                    body = ch.next_packet()
                    if body is None:
                        continue
                    w = pw.Writer()
                    w.message_field(_F_MSG, body, always=True)
                    env = w.bytes()
                    batch += pw.encode_varint(len(env)) + env
                    n_packets += 1
                if batch:
                    await self._send_monitor.limit(len(batch), self._send_rate)
                    await self._t.write(bytes(batch))
                    # decay EWMAs
                    for ch in self._channels.values():
                        ch.recently_sent *= 0.8
                if any(c.is_send_pending() for c in self._channels.values()):
                    self._send_event.set()
        except asyncio.CancelledError:
            raise
        except Exception as e:
            await self._die(e)

    async def _read_varint(self) -> int:
        out = 0
        shift = 0
        while True:
            b = (await self._t.read(1))[0]
            out |= (b & 0x7F) << shift
            if not (b & 0x80):
                return out
            shift += 7
            if shift > 63:
                raise ValueError("varint too long")

    async def _recv_routine(self) -> None:
        try:
            while not self._stopped:
                ln = await self._read_varint()
                if ln > 8192:
                    raise ValueError("packet too large")
                env = await self._t.read(ln)
                await self._recv_monitor.limit(ln, self._recv_rate)
                await self._handle_packet(env)
        except asyncio.CancelledError:
            raise
        except (asyncio.IncompleteReadError, ConnectionError) as e:
            await self._die(e)
        except Exception as e:
            await self._die(e)

    async def _handle_packet(self, env: bytes) -> None:
        for f, _, v in pw.Reader(env):
            if f == _F_PING:
                # echo the ping's timestamp (field 1) and add our wall clock
                # (field 2) so the pinger can estimate clock skew; a legacy
                # empty ping gets a legacy empty pong
                t0_us = 0
                for ff, _, vv in pw.Reader(v):
                    if ff == 1:
                        t0_us = pw.int64_from_varint(vv)
                body = pw.Writer()
                if t0_us:
                    body.varint_field(1, t0_us)
                    body.varint_field(2, int(time.time() * 1e6))
                w = pw.Writer()
                w.message_field(_F_PONG, body.bytes(), always=True)
                out = w.bytes()
                await self._t.write(pw.encode_varint(len(out)) + out)
            elif f == _F_PONG:
                self._last_pong = time.monotonic()
                self._pong_pending = False
                t0_us = t2_us = 0
                for ff, _, vv in pw.Reader(v):
                    if ff == 1:
                        t0_us = pw.int64_from_varint(vv)
                    elif ff == 2:
                        t2_us = pw.int64_from_varint(vv)
                sent = self._ping_sent
                if t0_us and t2_us and sent is not None and sent[0] == t0_us:
                    self._ping_sent = None
                    rtt = max(0.0, time.monotonic() - sent[1])
                    self._record_skew_sample(
                        t0_us / 1e6, t2_us / 1e6, time.time(), rtt
                    )
            elif f == _F_MSG:
                chan_id, eof, data = 0, 0, b""
                for ff, _, vv in pw.Reader(v):
                    if ff == 1:
                        chan_id = vv
                    elif ff == 2:
                        eof = vv
                    elif ff == 3:
                        data = vv
                ch = self._channels.get(chan_id)
                if ch is None:
                    raise ValueError(f"unknown channel {chan_id}")
                ch.recving += data
                if len(ch.recving) > ch.desc.recv_message_capacity:
                    # per-channel assembled-message cap: reactors declare how
                    # large a legitimate message on their channel can be; a
                    # peer exceeding it is malformed or malicious and dies
                    # loudly (counted first so the flood is visible)
                    if self.metrics is not None:
                        self.metrics.oversized_msgs.labels(f"{chan_id:#x}").inc()
                    raise ValueError(
                        f"message on channel {chan_id:#x} exceeds recv capacity "
                        f"({len(ch.recving)} > {ch.desc.recv_message_capacity})"
                    )
                if eof:
                    msg = bytes(ch.recving)
                    ch.recving.clear()
                    if not self._admit(chan_id, len(msg)):
                        continue  # shed THIS frame only, not the envelope
                    await self._on_receive(chan_id, msg)

    def _admit(self, chan_id: int, nbytes: int) -> bool:
        """Inbound admission for sheddable channels: True = dispatch to the
        reactor, False = drop. Channels without a bucket (consensus, or
        limiting disabled) always admit."""
        bucket = self._recv_buckets.get(chan_id)
        if bucket is None or bucket.admit(nbytes):
            return True
        self.shed_msgs += 1
        self.shed_by_channel[chan_id] = self.shed_by_channel.get(chan_id, 0) + 1
        if self.metrics is not None:
            self.metrics.rate_limited_msgs.labels(f"{chan_id:#x}").inc()
        lim = self._recv_limit
        now = time.monotonic()
        if now - self._shed_window_start > lim.strike_window:
            self._shed_window_start = now
            self._shed_in_window = 0
        self._shed_in_window += 1
        if self._shed_in_window >= lim.strikes and self._on_rate_limit_exceeded is not None:
            self._shed_in_window = 0
            self._shed_window_start = now
            # fire-and-forget: the report path may disconnect (and thereby
            # cancel) this very receive loop — do not await it mid-packet
            asyncio.get_running_loop().create_task(self._on_rate_limit_exceeded())
        return False

    async def _ping_routine(self) -> None:
        try:
            first = True
            while not self._stopped:
                await asyncio.sleep(PING_PRIME_DELAY if first else PING_INTERVAL)
                first = False
                t0_us = int(time.time() * 1e6)
                body = pw.Writer()
                body.varint_field(1, t0_us)
                w = pw.Writer()
                w.message_field(_F_PING, body.bytes(), always=True)
                out = w.bytes()
                self._ping_sent = (t0_us, time.monotonic())
                # Arm the flag BEFORE the write: the pong can arrive while the
                # write awaits, and must not be lost (it would look like a
                # timeout on a healthy connection).
                self._pong_pending = True
                await self._t.write(pw.encode_varint(len(out)) + out)
                await asyncio.sleep(PONG_TIMEOUT)
                if self._pong_pending:
                    raise TimeoutError("pong timeout")
        except asyncio.CancelledError:
            raise
        except Exception as e:
            await self._die(e)

    async def _die(self, e: Exception) -> None:
        if self._stopped:
            return
        self._stopped = True
        try:
            await self._on_error(e)
        except Exception:
            logger.exception("on_error callback failed")


class StreamTransport:
    """Plain (unencrypted) adapter with the transport interface MConnection
    expects — used by tests and in-process nets."""

    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        self._reader = reader
        self._writer = writer

    async def write(self, data: bytes) -> None:
        self._writer.write(data)
        await self._writer.drain()

    async def read(self, n: int) -> bytes:
        return await self._reader.readexactly(n)

    def close(self) -> None:
        try:
            self._writer.close()
        except Exception:
            pass

"""Query-indexed pub/sub (reference libs/pubsub/pubsub.go:91 and its query
language): the port's copy of tendermint_tpu/libs/pubsub.py.

Events are (type, attributes) maps; a subscription carries a Query of
composite key=value conditions (reference libs/pubsub/query/query.go):
`key = 'value'`, the numeric comparisons =, <, <=, >, >=, CONTAINS, EXISTS,
conjunctions with AND, and comparisons against `TIME <RFC3339>` /
`DATE <YYYY-MM-DD>` operands (e.g. `block.timestamp >= TIME
2013-05-03T14:45:00Z`). A full subscriber buffer drops its oldest event and
counts it in `Subscription.dropped` and, given `metrics=`
(libs/metrics.PubSubMetrics on the owner's registry), in
tendermint_pubsub_dropped_messages_total.
"""

from __future__ import annotations

import asyncio
import re
from dataclasses import dataclass
from datetime import date, datetime, timezone
from typing import Dict, List, Optional, Tuple

_CONDITION_RE = re.compile(
    r"\s*([\w.]+)\s*(=|<=|>=|<|>|CONTAINS|EXISTS)\s*"
    r"((?:TIME|DATE)\s+[\w.:+\-]+|'(?:[^']*)'|\"(?:[^\"]*)\"|[\w.\-+]+)?\s*"
)


def _parse_rfc3339(raw: str) -> datetime:
    """RFC3339 timestamp or bare date -> aware datetime (UTC default)."""
    s = raw.strip()
    if s.endswith(("Z", "z")):
        s = s[:-1] + "+00:00"
    dt = datetime.fromisoformat(s)
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=timezone.utc)
    return dt


@dataclass(frozen=True)
class Condition:
    key: str
    op: str
    value: str = ""
    # chronological operand: datetime parsed from TIME/DATE literals
    # (reference: libs/pubsub/query/query.go time/date conditions)
    time_value: Optional[datetime] = None


class Query:
    """Parsed conjunction of conditions."""

    def __init__(self, query_str: str):
        self.query_str = query_str.strip()
        self.conditions: List[Condition] = []
        if self.query_str:
            for clause in self.query_str.split(" AND "):
                m = _CONDITION_RE.fullmatch(clause)
                if not m:
                    raise ValueError(f"invalid query clause: {clause!r}")
                key, op, raw = m.group(1), m.group(2), m.group(3)
                if op == "EXISTS":
                    self.conditions.append(Condition(key, op))
                    continue
                if raw is None:
                    raise ValueError(f"missing value in clause: {clause!r}")
                if raw.startswith(("TIME ", "TIME\t", "DATE ", "DATE\t")):
                    kind, _, lit = raw.partition(raw[4])
                    try:
                        if kind == "DATE":
                            d = date.fromisoformat(lit.strip())
                            tv = datetime(d.year, d.month, d.day, tzinfo=timezone.utc)
                        else:
                            tv = _parse_rfc3339(lit)
                    except ValueError as e:
                        raise ValueError(f"invalid {kind} literal in {clause!r}: {e}")
                    self.conditions.append(Condition(key, op, lit.strip(), tv))
                    continue
                if raw[0] in "'\"":
                    raw = raw[1:-1]
                self.conditions.append(Condition(key, op, raw))

    def matches(self, events: Dict[str, List[str]]) -> bool:
        for cond in self.conditions:
            values = events.get(cond.key)
            if values is None:
                return False
            if cond.op == "EXISTS":
                continue
            if cond.time_value is not None:
                ok = False
                for v in values:
                    try:
                        ev = _parse_rfc3339(v)
                    except ValueError:
                        continue
                    if (
                        (cond.op == "=" and ev == cond.time_value)
                        or (cond.op == "<" and ev < cond.time_value)
                        or (cond.op == "<=" and ev <= cond.time_value)
                        or (cond.op == ">" and ev > cond.time_value)
                        or (cond.op == ">=" and ev >= cond.time_value)
                    ):
                        ok = True
                        break
                if not ok:
                    return False
                continue
            if cond.op == "=":
                if cond.value not in values:
                    return False
            elif cond.op == "CONTAINS":
                if not any(cond.value in v for v in values):
                    return False
            else:
                ok = False
                for v in values:
                    try:
                        fv, cv = float(v), float(cond.value)
                    except ValueError:
                        continue
                    if (
                        (cond.op == "<" and fv < cv)
                        or (cond.op == "<=" and fv <= cv)
                        or (cond.op == ">" and fv > cv)
                        or (cond.op == ">=" and fv >= cv)
                    ):
                        ok = True
                        break
                if not ok:
                    return False
        return True

    def __str__(self) -> str:
        return self.query_str

    def __eq__(self, other) -> bool:
        return isinstance(other, Query) and self.query_str == other.query_str

    def __hash__(self) -> int:
        return hash(self.query_str)


@dataclass
class Message:
    data: object
    events: Dict[str, List[str]]


class Subscription:
    """Buffered subscription. Overflow policy: DROP-OLDEST with a counter —
    a slow subscriber loses its stalest messages (counted in `self.dropped`
    and the server's `tendermint_pubsub_dropped_messages_total`) but
    stays subscribed; the old cancel-on-overflow policy turned one slow RPC
    client into a silent permanent detach."""

    def __init__(self, out_capacity: int = 100):
        self.queue: asyncio.Queue = asyncio.Queue(maxsize=out_capacity)
        self.cancelled = False
        self.cancel_reason = ""
        self.dropped = 0  # messages dropped oldest-first on overflow

    async def next(self) -> Message:
        msg = await self.queue.get()
        if msg is None:
            raise RuntimeError(f"subscription cancelled: {self.cancel_reason}")
        return msg


# The composite key the subscriber index keys on — same convention as
# types/event_bus.py EVENT_TYPE_KEY (duplicated here so the generic pubsub
# layer does not import the typed event layer built on top of it).
EVENT_TYPE_KEY = "tm.event"

# trailing per-connection id in subscriber names ('ws-140…', 'btc-9f3a…'):
# a separator followed by >=4 hex digits, to end of string
_SUBSCRIBER_ID_SUFFIX = re.compile(r"[-_][0-9a-fA-F]{4,}$")


class PubSubServer:
    """In-process server. publish() is non-blocking (drop-oldest on a full
    subscriber buffer, see Subscription) and maintains an index of
    subscriptions by their `tm.event = '<X>'` equality condition so the hot
    path can skip ALL per-event work when nobody could possibly match —
    consensus publishes a Vote event per verified vote whether or not
    anyone is listening, and the zero-subscriber case must cost ~nothing."""

    def __init__(self, index_key: str = EVENT_TYPE_KEY, metrics=None):
        """metrics: a libs/metrics.PubSubMetrics for the drop counter, or None."""
        self.metrics = metrics
        self._subs: Dict[Tuple[str, str], Tuple[Query, Subscription]] = {}
        self._index_key = index_key
        # sub key -> indexed event-type value (None = not indexable)
        self._sub_event_type: Dict[Tuple[str, str], Optional[str]] = {}
        # event-type value -> sub keys with exactly that equality condition
        self._by_event_type: Dict[str, set] = {}
        # sub keys whose query has no single tm.event equality condition
        # (must be consulted for every publish)
        self._unindexed: set = set()

    def _index_value(self, query: Query) -> Optional[str]:
        vals = [
            c.value
            for c in query.conditions
            if c.key == self._index_key and c.op == "=" and c.time_value is None
        ]
        return vals[0] if len(vals) == 1 else None

    def subscribe(self, subscriber: str, query: Query, out_capacity: int = 100) -> Subscription:
        key = (subscriber, query.query_str)
        if key in self._subs:
            raise ValueError("already subscribed")
        sub = Subscription(out_capacity)
        self._subs[key] = (query, sub)
        val = self._index_value(query)
        self._sub_event_type[key] = val
        if val is None:
            self._unindexed.add(key)
        else:
            self._by_event_type.setdefault(val, set()).add(key)
        return sub

    def _drop_index(self, key: Tuple[str, str]) -> None:
        val = self._sub_event_type.pop(key, None)
        if val is None:
            self._unindexed.discard(key)
        else:
            keys = self._by_event_type.get(val)
            if keys is not None:
                keys.discard(key)
                if not keys:
                    del self._by_event_type[val]

    @staticmethod
    def _cancel(sub: Subscription, reason: str) -> None:
        sub.cancelled = True
        sub.cancel_reason = reason
        try:
            sub.queue.put_nowait(None)
        except asyncio.QueueFull:
            # make room so the cancellation sentinel always lands
            try:
                sub.queue.get_nowait()
            except asyncio.QueueEmpty:
                pass
            try:
                sub.queue.put_nowait(None)
            except asyncio.QueueFull:
                pass

    def unsubscribe(self, subscriber: str, query: Query) -> None:
        key = (subscriber, query.query_str)
        entry = self._subs.pop(key, None)
        if entry is None:
            raise ValueError("subscription not found")
        self._drop_index(key)
        self._cancel(entry[1], "unsubscribed")

    def unsubscribe_all(self, subscriber: str) -> None:
        for key in [k for k in self._subs if k[0] == subscriber]:
            _, sub = self._subs.pop(key)
            self._drop_index(key)
            self._cancel(sub, "unsubscribed")

    # -- publishing ---------------------------------------------------------

    def has_subscribers(self, event_type: Optional[str] = None) -> bool:
        """True if a publish for `event_type` could reach anyone. The
        zero-subscriber fast path: callers check this BEFORE building the
        event map/payload (types/event_bus.py publish_vote)."""
        if not self._subs:
            return False
        if event_type is None or self._unindexed:
            return True
        return event_type in self._by_event_type

    def _candidates(self, events: Dict[str, List[str]]) -> list:
        """Subscription keys whose indexed condition could match `events`
        (plus every unindexed one). Deduplicated — an app-emitted attribute
        can legally collide with the index key (e.g. an ABCI event typed
        'tm' with key 'event'), putting the same value in the list twice,
        and a subscriber must still receive each publish exactly once."""
        keys: dict = {}
        etvals = events.get(self._index_key)
        if etvals:
            for v in etvals:
                for k in self._by_event_type.get(v, ()):
                    keys[k] = None
        for k in self._unindexed:
            keys[k] = None
        return list(keys)

    @staticmethod
    def _metric_label(subscriber: str) -> str:
        """Stable, bounded-cardinality label for the drop counter: strip
        per-connection id suffixes ('ws-140…', 'btc-9f3a…') down to their
        class prefix — every reconnecting websocket must NOT mint a fresh
        series in the never-pruned global registry."""
        return _SUBSCRIBER_ID_SUFFIX.sub("", subscriber) or "other"

    def _deliver(self, subscriber: str, sub: Subscription, msg: Message) -> None:
        try:
            sub.queue.put_nowait(msg)
        except asyncio.QueueFull:
            # Drop-oldest: evict the stalest message, count it, deliver the
            # new one. Never blocks, never raises, never silently detaches.
            try:
                sub.queue.get_nowait()
            except asyncio.QueueEmpty:
                pass
            sub.dropped += 1
            if self.metrics is not None:
                self.metrics.dropped.labels(self._metric_label(subscriber)).inc()
            try:
                sub.queue.put_nowait(msg)
            except asyncio.QueueFull:
                pass

    def publish(self, data: object, events: Dict[str, List[str]]) -> None:
        if not self._subs:
            return
        for key in self._candidates(events):
            entry = self._subs.get(key)
            if entry is None:
                continue
            query, sub = entry
            if not query.matches(events):
                continue
            self._deliver(key[0], sub, Message(data, events))

    def publish_many(self, datas, events: Dict[str, List[str]]) -> None:
        """Publish a homogeneous batch: every item in `datas` shares the
        same `events` map, so subscriber matching runs ONCE for the whole
        batch instead of once per item (the consensus vote drain publishes
        hundreds of Vote events per flush)."""
        if not self._subs or not datas:
            return
        matched = []
        for key in self._candidates(events):
            entry = self._subs.get(key)
            if entry is None:
                continue
            query, sub = entry
            if query.matches(events):
                matched.append((key[0], sub))
        if not matched:
            return
        for data in datas:
            msg = Message(data, events)
            for subscriber, sub in matched:
                self._deliver(subscriber, sub, msg)

    def num_clients(self) -> int:
        return len({k[0] for k in self._subs})

    def num_client_subscriptions(self, subscriber: str) -> int:
        return sum(1 for k in self._subs if k[0] == subscriber)

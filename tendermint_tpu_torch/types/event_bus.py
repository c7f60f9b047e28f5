"""EventBus — typed wrapper over pubsub (reference: types/event_bus.go:33).

Composite keys follow the reference convention: `tm.event` for the event type,
`tx.hash`/`tx.height` for txs, and app-emitted `<event_type>.<attr_key>`.

The port's copy of tendermint_tpu/types/event_bus.py, the same encodings byte for byte.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

from tendermint_tpu_torch.crypto import tmhash
from tendermint_tpu_torch.libs import hotstats as _hotstats
from tendermint_tpu_torch.libs.pubsub import PubSubServer, Query, Subscription

EVENT_NEW_BLOCK = "NewBlock"
EVENT_NEW_BLOCK_HEADER = "NewBlockHeader"
EVENT_NEW_ROUND = "NewRound"
EVENT_NEW_ROUND_STEP = "NewRoundStep"
EVENT_COMPLETE_PROPOSAL = "CompleteProposal"
EVENT_POLKA = "Polka"
EVENT_LOCK = "Lock"
EVENT_RELOCK = "Relock"
EVENT_TIMEOUT_PROPOSE = "TimeoutPropose"
EVENT_TIMEOUT_WAIT = "TimeoutWait"
EVENT_VOTE = "Vote"
EVENT_VALID_BLOCK = "ValidBlock"
EVENT_VALIDATOR_SET_UPDATES = "ValidatorSetUpdates"
EVENT_TX = "Tx"

EVENT_TYPE_KEY = "tm.event"
TX_HASH_KEY = "tx.hash"
TX_HEIGHT_KEY = "tx.height"


def query_for_event(event_type: str) -> Query:
    return Query(f"{EVENT_TYPE_KEY} = '{event_type}'")


@dataclass
class EventDataTx:
    height: int
    index: int
    tx: bytes
    result: object  # abci.ResponseDeliverTx


@dataclass
class EventDataNewBlock:
    block: object
    block_id: object
    result_begin_block: object
    result_end_block: object


@dataclass
class EventDataRoundState:
    height: int
    round: int
    step: str


@dataclass
class EventDataVote:
    vote: object


class EventBus:
    def __init__(self, metrics=None):
        """metrics: a libs/metrics.PubSubMetrics for the subscribers' drop
        counter, or None."""
        self.pubsub = PubSubServer(metrics=metrics)

    def subscribe(self, subscriber: str, query: Query, out_capacity: int = 100) -> Subscription:
        return self.pubsub.subscribe(subscriber, query, out_capacity)

    def unsubscribe(self, subscriber: str, query: Query) -> None:
        self.pubsub.unsubscribe(subscriber, query)

    def unsubscribe_all(self, subscriber: str) -> None:
        self.pubsub.unsubscribe_all(subscriber)

    def _publish(self, event_type: str, data: object, extra: Optional[Dict[str, List[str]]] = None) -> None:
        hs = _hotstats.stats if _hotstats.stats.enabled else None
        t0 = _hotstats.perf_counter() if hs is not None else 0.0
        self._publish_untimed(event_type, data, extra)
        if hs is not None:
            hs.add("pubsub", _hotstats.perf_counter() - t0, n=0)

    def _publish_untimed(self, event_type: str, data: object, extra: Optional[Dict[str, List[str]]] = None) -> None:
        # Zero-subscriber fast path: consensus publishes events for every
        # vote/step whether or not anyone listens; skip the event-map build
        # and the query walk when nothing could match.
        if not self.pubsub.has_subscribers(event_type):
            return
        events = {EVENT_TYPE_KEY: [event_type]}
        if extra:
            for k, v in extra.items():
                events.setdefault(k, []).extend(v)
        self.pubsub.publish(data, events)

    @staticmethod
    def _abci_events_to_map(abci_events) -> Dict[str, List[str]]:
        out: Dict[str, List[str]] = {}
        for ev in abci_events or []:
            for key, value, index in ev.attributes:
                if not index:
                    continue
                k = f"{ev.type}.{key.decode(errors='replace')}"
                out.setdefault(k, []).append(value.decode(errors="replace"))
        return out

    def publish_new_block(self, block, block_id, abci_responses) -> None:
        if not self.pubsub.has_subscribers(EVENT_NEW_BLOCK):
            return
        extra: Dict[str, List[str]] = {}
        if abci_responses.begin_block is not None:
            extra.update(self._abci_events_to_map(abci_responses.begin_block.events))
        if abci_responses.end_block is not None:
            extra.update(self._abci_events_to_map(abci_responses.end_block.events))
        self._publish(
            EVENT_NEW_BLOCK,
            EventDataNewBlock(block, block_id, abci_responses.begin_block, abci_responses.end_block),
            extra,
        )

    def publish_tx(self, height: int, index: int, tx: bytes, result) -> None:
        if not self.pubsub.has_subscribers(EVENT_TX):
            return
        extra = {
            TX_HASH_KEY: [tmhash.sum256(tx).hex().upper()],
            TX_HEIGHT_KEY: [str(height)],
        }
        extra.update(self._abci_events_to_map(getattr(result, "events", None)))
        self._publish(EVENT_TX, EventDataTx(height, index, tx, result), extra)

    def publish_validator_set_updates(self, updates) -> None:
        self._publish(EVENT_VALIDATOR_SET_UPDATES, updates)

    def publish_vote(self, vote) -> None:
        hs = _hotstats.stats if _hotstats.stats.enabled else None
        t0 = _hotstats.perf_counter() if hs is not None else 0.0
        # explicit check (not just _publish's) so the EventDataVote wrapper
        # is never allocated on the zero-subscriber path
        if self.pubsub.has_subscribers(EVENT_VOTE):
            self._publish_untimed(EVENT_VOTE, EventDataVote(vote))
        if hs is not None:
            hs.add("pubsub", _hotstats.perf_counter() - t0)

    def publish_votes(self, votes) -> None:
        """Batch publish for the deferred-vote drain: one subscriber-match
        pass for the whole flush (pubsub.publish_many)."""
        if not votes:
            return
        hs = _hotstats.stats if _hotstats.stats.enabled else None
        t0 = _hotstats.perf_counter() if hs is not None else 0.0
        if self.pubsub.has_subscribers(EVENT_VOTE):
            self.pubsub.publish_many(
                [EventDataVote(v) for v in votes], {EVENT_TYPE_KEY: [EVENT_VOTE]}
            )
        if hs is not None:
            hs.add("pubsub", _hotstats.perf_counter() - t0, n=len(votes))

    def publish_round_state(self, event_type: str, height: int, round_: int, step: str) -> None:
        self._publish(event_type, EventDataRoundState(height, round_, step))

"""Event bus: typed node events fanned out over query-filtered pubsub.

A copy of ``tendermint_tpu/eventbus.py``, whole. It mirrors the
reference's eventbus (internal/eventbus/event_bus.go:84-194) and event
data types (types/events.go): every committed block, tx,
vote, round transition, and validator-set update is published with
composite-key attributes (``tm.event = 'NewBlock'``, ``tx.height``,
plus every ABCI event emitted by the application as ``<type>.<key>``),
so RPC subscribers and the tx/block indexer can filter with the same
query language.

A sliding-window :class:`EventLog` (internal/eventlog/eventlog.go:25)
retains recent items for the ``/events`` long-poll endpoint.
"""

from __future__ import annotations

import hashlib
import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from tendermint_tpu_torch.abci import types as abci
from tendermint_tpu_torch.libs.pubsub import Events, PubSubServer, Query, Subscription

# Event type names (types/events.go:103-127).
EVENT_NEW_BLOCK = "NewBlock"
EVENT_NEW_BLOCK_HEADER = "NewBlockHeader"
EVENT_NEW_EVIDENCE = "NewEvidence"
EVENT_TX = "Tx"
EVENT_VOTE = "Vote"
EVENT_NEW_ROUND = "NewRound"
EVENT_NEW_ROUND_STEP = "NewRoundStep"
EVENT_COMPLETE_PROPOSAL = "CompleteProposal"
EVENT_VALIDATOR_SET_UPDATES = "ValidatorSetUpdates"
EVENT_BLOCK_SYNC_STATUS = "BlockSyncStatus"
EVENT_STATE_SYNC_STATUS = "StateSyncStatus"

TYPE_KEY = "tm.event"
TX_HASH_KEY = "tx.hash"
TX_HEIGHT_KEY = "tx.height"


def query_for_event(event_type: str) -> str:
    return f"{TYPE_KEY} = '{event_type}'"


QUERY_NEW_BLOCK = query_for_event(EVENT_NEW_BLOCK)
QUERY_TX = query_for_event(EVENT_TX)


@dataclass
class EventDataNewBlock:
    block: object  # types.Block
    block_id: object
    result_finalize_block: Optional[abci.ResponseFinalizeBlock] = None


@dataclass
class EventDataNewBlockHeader:
    header: object
    num_txs: int = 0


@dataclass
class EventDataTx:
    height: int
    index: int
    tx: bytes
    result: abci.ExecTxResult


@dataclass
class EventDataVote:
    vote: object


@dataclass
class EventDataNewRound:
    height: int
    round: int
    step: str
    proposer_address: bytes = b""


@dataclass
class EventDataRoundState:
    height: int
    round: int
    step: str


@dataclass
class EventDataCompleteProposal:
    height: int
    round: int
    step: str
    block_id: object = None


@dataclass
class EventDataValidatorSetUpdates:
    validator_updates: List[object] = field(default_factory=list)


@dataclass
class EventDataNewEvidence:
    height: int
    evidence: object = None


@dataclass
class EventDataBlockSyncStatus:
    complete: bool
    height: int


@dataclass
class EventDataStateSyncStatus:
    complete: bool
    height: int


def _abci_events_to_map(events: List[abci.Event], into: Events) -> None:
    """Flatten ABCI events to composite keys (reference events.go)."""
    for ev in events or []:
        if not ev.type:
            continue
        for attr in ev.attributes or []:
            key = f"{ev.type}.{attr.key}"
            into.setdefault(key, []).append(attr.value)


class EventBus:
    """Typed publish API over the pubsub server (event_bus.go:84-194)."""

    def __init__(self, eventlog_size: int = 1000):
        self.pubsub = PubSubServer()
        self.eventlog = EventLog(max_items=eventlog_size)

    # -- subscription surface -------------------------------------------------

    def subscribe(
        self, subscriber: str, query: str | Query, capacity: int = 100
    ) -> Subscription:
        return self.pubsub.subscribe(subscriber, query, capacity)

    def unsubscribe(self, subscriber: str, query: str) -> None:
        self.pubsub.unsubscribe(subscriber, query)

    def unsubscribe_all(self, subscriber: str) -> None:
        self.pubsub.unsubscribe_all(subscriber)

    def num_clients(self) -> int:
        return self.pubsub.num_clients()

    def num_subscriptions(self) -> int:
        return self.pubsub.num_subscriptions()

    # -- publish --------------------------------------------------------------

    def _publish(self, event_type: str, data: object, extra: Optional[Events] = None):
        events: Events = {TYPE_KEY: [event_type]}
        if extra:
            for k, v in extra.items():
                events.setdefault(k, []).extend(v)
        self.pubsub.publish(data, events)
        self.eventlog.add(event_type, data, events)

    def publish_event_new_block(self, data: EventDataNewBlock) -> None:
        extra: Events = {}
        if data.result_finalize_block is not None:
            _abci_events_to_map(data.result_finalize_block.events, extra)
        self._publish(EVENT_NEW_BLOCK, data, extra)

    def publish_event_new_block_header(self, data: EventDataNewBlockHeader) -> None:
        self._publish(EVENT_NEW_BLOCK_HEADER, data)

    def publish_event_tx(self, data: EventDataTx) -> None:
        extra: Events = {
            TX_HASH_KEY: [hashlib.sha256(data.tx).hexdigest().upper()],
            TX_HEIGHT_KEY: [str(data.height)],
        }
        _abci_events_to_map(data.result.events, extra)
        self._publish(EVENT_TX, data, extra)

    def publish_event_vote(self, data: EventDataVote) -> None:
        self._publish(EVENT_VOTE, data)

    def publish_event_new_round(self, data: EventDataNewRound) -> None:
        self._publish(EVENT_NEW_ROUND, data)

    def publish_event_new_round_step(self, data: EventDataRoundState) -> None:
        self._publish(EVENT_NEW_ROUND_STEP, data)

    def publish_event_complete_proposal(self, data: EventDataCompleteProposal) -> None:
        self._publish(EVENT_COMPLETE_PROPOSAL, data)

    def publish_event_validator_set_updates(
        self, data: EventDataValidatorSetUpdates
    ) -> None:
        self._publish(EVENT_VALIDATOR_SET_UPDATES, data)

    def publish_event_new_evidence(self, data: EventDataNewEvidence) -> None:
        self._publish(EVENT_NEW_EVIDENCE, data)

    def publish_event_block_sync_status(self, data: EventDataBlockSyncStatus) -> None:
        self._publish(EVENT_BLOCK_SYNC_STATUS, data)

    def publish_event_state_sync_status(self, data: EventDataStateSyncStatus) -> None:
        self._publish(EVENT_STATE_SYNC_STATUS, data)


@dataclass
class LogItem:
    cursor: int
    type: str
    data: object
    events: Events
    ts: float


class EventLog:
    """Sliding window of recent events for /events long-poll
    (internal/eventlog/eventlog.go:25)."""

    def __init__(self, max_items: int = 1000):
        self._lock = threading.Condition()
        self._items: List[LogItem] = []
        self._max = max_items
        self._cursor = itertools.count(1)

    def add(self, event_type: str, data: object, events: Events) -> None:
        with self._lock:
            self._items.append(
                LogItem(next(self._cursor), event_type, data, events, time.time())
            )
            if len(self._items) > self._max:
                del self._items[: len(self._items) - self._max]
            self._lock.notify_all()

    def scan(
        self,
        query: Optional[Query] = None,
        after: int = 0,
        max_items: int = 100,
        wait: float = 0.0,
    ) -> Tuple[List[LogItem], bool, int]:
        """(items, more, resume_cursor): matching items with cursor >
        after, oldest first, truncated to max_items. ``more`` says the
        truncation dropped newer matches; ``resume_cursor`` is what the
        client passes as ``after`` next time — the cursor of the last
        RETURNED item when truncated (so nothing is skipped), else the
        log's newest cursor. Blocks up to ``wait`` seconds when empty."""
        deadline = time.time() + wait
        with self._lock:
            while True:
                matched = [
                    it
                    for it in self._items
                    if it.cursor > after and (query is None or query.matches(it.events))
                ]
                newest = self._items[-1].cursor if self._items else 0
                out = matched[:max_items]
                more = len(matched) > len(out)
                if out or wait <= 0:
                    resume = out[-1].cursor if more and out else newest
                    return out, more, resume
                remaining = deadline - time.time()
                if remaining <= 0:
                    return [], False, newest
                self._lock.wait(remaining)

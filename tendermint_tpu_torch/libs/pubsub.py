"""Query-filtered publish/subscribe for the event bus.

A copy of ``tendermint_tpu/libs/pubsub.py``, whole. The reference's pubsub (internal/pubsub/pubsub.go:92, query language in
internal/pubsub/query/) delivers every published message to each
subscription whose query matches the message's event attributes. This
is the in-process analog: a ``Server`` holds named subscriptions, each
with a bounded queue; ``publish`` fans out synchronously under a lock
(publishers are the consensus/execution threads, subscribers drain from
their own queues, mirroring the buffered-channel design).

Query syntax (internal/pubsub/query/syntax): conditions joined by AND,
each ``key op value`` with ops =, <, <=, >, >=, CONTAINS, EXISTS.
Values are single-quoted strings or bare numbers; string equality is
exact, numeric comparisons apply when both sides parse as numbers.
"""

from __future__ import annotations

import queue
import re
import threading
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple

Events = Dict[str, List[str]]  # composite key -> values, e.g. "tx.height" -> ["5"]


# --- query language ---------------------------------------------------------

_TOKEN_RE = re.compile(
    r"""\s*(?:
        (?P<and>AND\b)
      | (?P<op><=|>=|=|<|>)
      | (?P<contains>CONTAINS\b)
      | (?P<exists>EXISTS\b)
      | (?P<str>'(?:[^'])*')
      | (?P<num>-?\d+(?:\.\d+)?)
      | (?P<key>[A-Za-z_][A-Za-z0-9_.\-]*)
    )""",
    re.VERBOSE,
)


@dataclass(frozen=True)
class Condition:
    key: str
    op: str  # '=', '<', '<=', '>', '>=', 'CONTAINS', 'EXISTS'
    value: str = ""

    def matches(self, events: Events) -> bool:
        values = events.get(self.key)
        if values is None:
            return False
        if self.op == "EXISTS":
            return True
        if self.op == "CONTAINS":
            return any(self.value in v for v in values)
        if self.op == "=":
            num = _as_num(self.value)
            for v in values:
                if v == self.value:
                    return True
                if num is not None:
                    vn = _as_num(v)
                    if vn is not None and vn == num:
                        return True
            return False
        # numeric comparisons
        num = _as_num(self.value)
        if num is None:
            return False
        for v in values:
            vn = _as_num(v)
            if vn is None:
                continue
            if self.op == "<" and vn < num:
                return True
            if self.op == "<=" and vn <= num:
                return True
            if self.op == ">" and vn > num:
                return True
            if self.op == ">=" and vn >= num:
                return True
        return False


def _as_num(s: str) -> Optional[float]:
    try:
        return float(s)
    except ValueError:
        return None


class QueryError(ValueError):
    pass


@dataclass(frozen=True)
class Query:
    """A parsed query: AND of conditions (reference Query.Matches)."""

    conditions: Tuple[Condition, ...]
    source: str = ""

    @staticmethod
    def parse(s: str) -> "Query":
        tokens = _tokenize(s)
        conds: List[Condition] = []
        i = 0
        while i < len(tokens):
            kind, val = tokens[i]
            if kind != "key":
                raise QueryError(f"expected key at token {i} in {s!r}")
            if i + 1 >= len(tokens):
                raise QueryError(f"dangling key {val!r} in {s!r}")
            okind, oval = tokens[i + 1]
            if okind == "exists":
                conds.append(Condition(val, "EXISTS"))
                i += 2
            elif okind in ("op", "contains"):
                if i + 2 >= len(tokens):
                    raise QueryError(f"missing value in {s!r}")
                vkind, vval = tokens[i + 2]
                if vkind not in ("str", "num"):
                    raise QueryError(f"bad value {vval!r} in {s!r}")
                op = "CONTAINS" if okind == "contains" else oval
                conds.append(Condition(val, op, vval))
                i += 3
            else:
                raise QueryError(f"expected operator after {val!r} in {s!r}")
            if i < len(tokens):
                kind, _ = tokens[i]
                if kind != "and":
                    raise QueryError(f"expected AND at token {i} in {s!r}")
                i += 1
        if not conds:
            raise QueryError(f"empty query: {s!r}")
        return Query(tuple(conds), s)

    def matches(self, events: Events) -> bool:
        return all(c.matches(events) for c in self.conditions)

    def __str__(self) -> str:
        return self.source


def _tokenize(s: str) -> List[Tuple[str, str]]:
    out: List[Tuple[str, str]] = []
    pos = 0
    while pos < len(s):
        m = _TOKEN_RE.match(s, pos)
        if not m or m.end() == pos:
            if s[pos:].strip() == "":
                break
            raise QueryError(f"bad token at {pos} in {s!r}")
        pos = m.end()
        for kind in ("and", "op", "contains", "exists", "str", "num", "key"):
            val = m.group(kind)
            if val is not None:
                if kind == "str":
                    val = val[1:-1]
                out.append((kind, val))
                break
    return out


# --- pubsub server ----------------------------------------------------------


@dataclass
class Message:
    """A delivered pubsub message (reference pubsub.Message)."""

    data: object
    events: Events
    subscription_id: str = ""


class Subscription:
    """A subscriber's bounded queue of matching messages."""

    def __init__(self, subscriber: str, query: Query, capacity: int = 100):
        self.subscriber = subscriber
        self.query = query
        self._q: "queue.Queue[Message]" = queue.Queue(maxsize=capacity)
        self.cancelled = threading.Event()

    def next(self, timeout: Optional[float] = None) -> Optional[Message]:
        """Blocking pop; None on timeout or cancellation."""
        try:
            return self._q.get(timeout=timeout)
        except queue.Empty:
            return None

    def drain(self) -> List[Message]:
        out = []
        while True:
            try:
                out.append(self._q.get_nowait())
            except queue.Empty:
                return out

    def _offer(self, msg: Message) -> bool:
        try:
            self._q.put_nowait(msg)
            return True
        except queue.Full:
            return False


class PubSubServer:
    """Fan-out hub (pubsub.go:92). Slow subscribers are *dropped from*,
    not blocked on: a full queue loses the message for that subscriber
    (the reference terminates such subscriptions; callers that need
    lossless streams use the indexer/eventlog instead)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._subs: Dict[Tuple[str, str], Subscription] = {}

    def subscribe(
        self, subscriber: str, query: str | Query, capacity: int = 100
    ) -> Subscription:
        q = Query.parse(query) if isinstance(query, str) else query
        sub = Subscription(subscriber, q, capacity)
        with self._lock:
            key = (subscriber, str(q))
            if key in self._subs:
                raise ValueError(f"already subscribed: {key}")
            self._subs[key] = sub
        return sub

    def unsubscribe(self, subscriber: str, query: str) -> None:
        with self._lock:
            sub = self._subs.pop((subscriber, query), None)
        if sub is not None:
            sub.cancelled.set()

    def unsubscribe_all(self, subscriber: str) -> None:
        with self._lock:
            keys = [k for k in self._subs if k[0] == subscriber]
            for k in keys:
                self._subs.pop(k).cancelled.set()

    def publish(self, data: object, events: Events) -> None:
        with self._lock:
            subs = list(self._subs.values())
        for sub in subs:
            if sub.query.matches(events):
                sub._offer(Message(data, events, sub.subscriber))

    def num_clients(self) -> int:
        with self._lock:
            return len({k[0] for k in self._subs})

    def num_subscriptions(self) -> int:
        with self._lock:
            return len(self._subs)

"""Pluggable per-peer send-queue disciplines; a copy of
``tendermint_tpu/p2p/pqueue.py``.

The reference router offers three queue disciplines selected by config
(internal/p2p/router.go:216-238): plain ``fifo``, a WDRR scheduler
(``priority``, pqueue.go), and a priority heap (``simple-priority``,
rqueue.go). Their purpose is backpressure POLICY: when a slow or
stalled peer lets its send queue fill, which traffic is dropped and
which is protected. With one FIFO, a flooding blocksync transfer can
starve consensus votes; with a priority discipline, consensus traffic
keeps its lane.

All three share one contract used by the router's per-peer plumbing:

- ``put(env) -> bool`` — False means the envelope was dropped (either
  the incoming one, or — for the priority disciplines — a lower-priority
  queued envelope was evicted to admit it, in which case True);
- ``get(timeout) -> Optional[Envelope]`` — None on timeout or close;
- ``close()`` — wakes blocked getters permanently.

Priorities come from the reference's channel descriptors (consensus
reactor.go:78-81 and friends): Data 12, Vote 10, State 8, Evidence 6,
Snapshot 6, Mempool 5, Blocksync 5, VoteSetBits 5, Chunk 3,
LightBlock 2, Params 2, PEX 1.
"""

from __future__ import annotations

import heapq
import threading
from collections import deque
from typing import Dict, Optional

# channel id -> priority (reference channel descriptor priorities)
DEFAULT_PRIORITIES: Dict[int, int] = {
    0x20: 8,   # consensus state
    0x21: 12,  # consensus data (proposals + block parts)
    0x22: 10,  # consensus votes
    0x23: 5,   # vote set bits
    0x30: 5,   # mempool
    0x38: 6,   # evidence
    0x40: 5,   # blocksync
    0x60: 6,   # statesync snapshot
    0x61: 3,   # statesync chunk
    0x62: 2,   # statesync light block
    0x63: 2,   # statesync params
    0x00: 1,   # pex
}
DEFAULT_PRIORITY = 1

QUEUE_TYPES = ("fifo", "priority", "simple-priority")


def make_send_queue(
    queue_type: str,
    capacity: int,
    priorities: Optional[Dict[int, int]] = None,
):
    """router.go:216-238 queue factory."""
    if queue_type == "fifo":
        return FIFOQueue(capacity)
    if queue_type == "priority":
        return WDRRQueue(capacity, priorities)
    if queue_type == "simple-priority":
        return SimplePriorityQueue(capacity, priorities)
    raise ValueError(
        f"unknown queue type {queue_type!r} (expected one of {QUEUE_TYPES})"
    )


class FIFOQueue:
    """The original discipline: first in, first out, drop new on full."""

    def __init__(self, capacity: int):
        self._cap = capacity
        self._q: deque = deque()
        self._cv = threading.Condition()
        self._closed = False

    def put(self, env) -> bool:
        with self._cv:
            if self._closed or len(self._q) >= self._cap:
                return False
            self._q.append(env)
            self._cv.notify()
            return True

    def get(self, timeout: Optional[float] = None):
        with self._cv:
            if not self._q and not self._closed:
                self._cv.wait(timeout=timeout)
            if self._q:
                return self._q.popleft()
            return None

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    def __len__(self) -> int:
        with self._cv:
            return len(self._q)

    @property
    def closed(self) -> bool:
        return self._closed


class WDRRQueue:
    """Weighted round-robin over per-channel buckets (the unit-size
    specialisation of pqueue.go's deficit round robin — envelopes count
    1 each, so the deficit quantum degenerates to "serve up to
    ``priority`` envelopes per bucket per round").

    Backpressure policy under overflow: evict the OLDEST envelope of
    the LOWEST-priority non-empty bucket when the incoming envelope
    outranks it; drop the incoming one otherwise. A stalled peer
    flooded with blocksync traffic therefore never evicts queued
    consensus votes — the blocksync envelopes cannibalise each other.
    """

    def __init__(self, capacity: int, priorities: Optional[Dict[int, int]] = None):
        self._cap = capacity
        self._prio = dict(DEFAULT_PRIORITIES if priorities is None else priorities)
        self._buckets: Dict[int, deque] = {}  # priority -> envelopes
        self._size = 0
        self._cv = threading.Condition()
        self._closed = False
        # round-robin cursor state: (sorted priorities desc, served count)
        self._round: deque = deque()
        self._served = 0
        # observability for tests/metrics
        self.dropped: Dict[int, int] = {}

    def _priority_of(self, env) -> int:
        return self._prio.get(env.channel_id, DEFAULT_PRIORITY)

    def put(self, env) -> bool:
        p = self._priority_of(env)
        with self._cv:
            if self._closed:
                return False
            if self._size >= self._cap:
                low = min((q for q in self._buckets if self._buckets[q]),
                          default=None)
                if low is None or low >= p:
                    self.dropped[env.channel_id] = (
                        self.dropped.get(env.channel_id, 0) + 1
                    )
                    return False  # incoming is lowest: drop it
                victim = self._buckets[low].popleft()
                self.dropped[victim.channel_id] = (
                    self.dropped.get(victim.channel_id, 0) + 1
                )
                self._size -= 1
            self._buckets.setdefault(p, deque()).append(env)
            self._size += 1
            self._cv.notify()
            return True

    def _next_locked(self):
        """One WRR step: walk priorities high→low, serving up to
        ``priority`` envelopes from each before yielding the lane."""
        while True:
            if not self._round:
                prios = sorted(
                    (p for p, b in self._buckets.items() if b), reverse=True
                )
                if not prios:
                    return None
                self._round = deque(prios)
                self._served = 0
            p = self._round[0]
            bucket = self._buckets.get(p)
            if not bucket or self._served >= p:
                self._round.popleft()
                self._served = 0
                continue
            self._served += 1
            self._size -= 1
            return bucket.popleft()

    def get(self, timeout: Optional[float] = None):
        with self._cv:
            env = self._next_locked()
            if env is None and not self._closed:
                self._cv.wait(timeout=timeout)
                env = self._next_locked()
            return env

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    def __len__(self) -> int:
        with self._cv:
            return self._size

    @property
    def closed(self) -> bool:
        return self._closed


class SimplePriorityQueue:
    """Strict priority heap, FIFO within a priority class (rqueue.go):
    the highest-priority envelope always dequeues first; overflow evicts
    the lowest-priority queued envelope when the incoming one outranks
    it. Simpler than WDRR but can starve low-priority channels under
    sustained high-priority load — the trade rqueue.go documents."""

    def __init__(self, capacity: int, priorities: Optional[Dict[int, int]] = None):
        self._cap = capacity
        self._prio = dict(DEFAULT_PRIORITIES if priorities is None else priorities)
        self._heap: list = []  # (-priority, seq, env)
        self._seq = 0
        self._cv = threading.Condition()
        self._closed = False
        self.dropped: Dict[int, int] = {}

    def put(self, env) -> bool:
        p = self._prio.get(env.channel_id, DEFAULT_PRIORITY)
        with self._cv:
            if self._closed:
                return False
            if len(self._heap) >= self._cap:
                worst = max(self._heap)  # largest -priority = lowest priority,
                # ties broken toward the NEWEST entry (largest seq)
                if -worst[0] >= p:
                    self.dropped[env.channel_id] = (
                        self.dropped.get(env.channel_id, 0) + 1
                    )
                    return False
                self._heap.remove(worst)
                heapq.heapify(self._heap)
                self.dropped[worst[2].channel_id] = (
                    self.dropped.get(worst[2].channel_id, 0) + 1
                )
            heapq.heappush(self._heap, (-p, self._seq, env))
            self._seq += 1
            self._cv.notify()
            return True

    def get(self, timeout: Optional[float] = None):
        with self._cv:
            if not self._heap and not self._closed:
                self._cv.wait(timeout=timeout)
            if self._heap:
                return heapq.heappop(self._heap)[2]
            return None

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    def __len__(self) -> int:
        with self._cv:
            return len(self._heap)

    @property
    def closed(self) -> bool:
        return self._closed

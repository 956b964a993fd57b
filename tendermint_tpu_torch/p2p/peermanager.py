"""PeerManager: address book, scoring, connection lifecycle.

A copy of ``tendermint_tpu/p2p/peermanager.py``.

Mirrors internal/p2p/peermanager.go:286-1100 in API and policy: persisted
address book, peer scores with persistent-peer pinning, dial candidates
ordered by score, retry backoff, connected/max-connection accounting, and
subscriber notification of peer up/down updates.
"""

from __future__ import annotations

import json
import threading
import time as _time
from dataclasses import dataclass, field as dc_field
from typing import Callable, Dict, List, Optional

from tendermint_tpu_torch.p2p.key import NodeID
from tendermint_tpu_torch.storage.kv import KVStore, MemDB

PEER_SCORE_PERSISTENT = 100  # peermanager.go PeerScorePersistent
MAX_PEER_SCORE = PEER_SCORE_PERSISTENT
MIN_RETRY_TIME = 0.5
MAX_RETRY_TIME = 30.0


@dataclass
class PeerAddress:
    """node_id@host:port."""

    node_id: NodeID
    addr: str

    def __str__(self) -> str:
        return f"{self.node_id}@{self.addr}"

    @classmethod
    def parse(cls, s: str) -> "PeerAddress":
        node_id, _, addr = s.partition("@")
        if not node_id or not addr:
            raise ValueError(f"invalid peer address {s!r}")
        return cls(node_id, addr)


@dataclass
class _PeerInfo:
    node_id: NodeID
    addresses: List[str] = dc_field(default_factory=list)
    persistent: bool = False
    last_connected: float = 0.0
    dial_failures: int = 0
    mutable_score: int = 0
    connected: bool = False
    inbound: bool = False

    def score(self) -> int:
        """peermanager.go peerInfo.Score."""
        if self.persistent:
            return PEER_SCORE_PERSISTENT
        return max(-100, min(MAX_PEER_SCORE - 1, self.mutable_score))


@dataclass
class PeerUpdate:
    node_id: NodeID
    status: str  # "up" | "down"


class PeerManager:
    def __init__(
        self,
        self_id: NodeID,
        db: Optional[KVStore] = None,
        max_connected: int = 16,
        now: Optional[Callable[[], float]] = None,
    ):
        self.self_id = self_id
        self._db = db or MemDB()
        self.max_connected = max_connected
        self._now = now or _time.monotonic
        self._mtx = threading.RLock()
        self._peers: Dict[NodeID, _PeerInfo] = {}
        self._dialing: set = set()
        self._retry_at: Dict[NodeID, float] = {}
        self._subscribers: List[Callable[[PeerUpdate], None]] = []
        self._load()

    # --- persistence ---------------------------------------------------------

    def _load(self) -> None:
        raw = self._db.get(b"peermanager/peers")
        if raw is None:
            return
        for doc in json.loads(raw.decode()):
            self._peers[doc["node_id"]] = _PeerInfo(
                node_id=doc["node_id"],
                addresses=doc.get("addresses", []),
                persistent=doc.get("persistent", False),
                mutable_score=doc.get("mutable_score", 0),
            )

    def _save(self) -> None:
        docs = [
            {
                "node_id": p.node_id,
                "addresses": p.addresses,
                "persistent": p.persistent,
                "mutable_score": p.mutable_score,
            }
            for p in self._peers.values()
        ]
        self._db.set(b"peermanager/peers", json.dumps(docs).encode())

    # --- address book --------------------------------------------------------

    def add_address(self, address: PeerAddress, persistent: bool = False) -> bool:
        """peermanager.go Add: returns True if new information was added."""
        if address.node_id == self.self_id:
            return False
        with self._mtx:
            peer = self._peers.get(address.node_id)
            if peer is None:
                peer = _PeerInfo(node_id=address.node_id)
                self._peers[address.node_id] = peer
            changed = False
            if address.addr not in peer.addresses:
                peer.addresses.append(address.addr)
                changed = True
            if persistent and not peer.persistent:
                peer.persistent = True
                changed = True
            if changed:
                self._save()
            return changed

    def addresses(self, node_id: NodeID) -> List[str]:
        with self._mtx:
            peer = self._peers.get(node_id)
            return list(peer.addresses) if peer else []

    def num_addresses(self) -> int:
        """Total known addresses (cheap count, no materialization)."""
        with self._mtx:
            return sum(len(p.addresses) for p in self._peers.values())

    def sample_addresses(self, limit: int = 10) -> List[PeerAddress]:
        """For PEX: a sample of known (id, addr) pairs."""
        with self._mtx:
            out = []
            for p in self._peers.values():
                for a in p.addresses:
                    out.append(PeerAddress(p.node_id, a))
            return out[:limit]

    # --- dialing -------------------------------------------------------------

    def dial_next(self) -> Optional[PeerAddress]:
        """peermanager.go DialNext: best unconnected candidate by score,
        honoring retry backoff; None if at capacity or nothing to dial."""
        with self._mtx:
            if self._num_connected() + len(self._dialing) >= self.max_connected:
                return None
            now = self._now()
            candidates = [
                p
                for p in self._peers.values()
                if not p.connected
                and p.node_id not in self._dialing
                and p.addresses
                and self._retry_at.get(p.node_id, 0.0) <= now
            ]
            if not candidates:
                return None
            best = max(candidates, key=lambda p: p.score())
            self._dialing.add(best.node_id)
            return PeerAddress(best.node_id, best.addresses[0])

    def dial_failed(self, address: PeerAddress) -> None:
        with self._mtx:
            self._dialing.discard(address.node_id)
            peer = self._peers.get(address.node_id)
            if peer is None:
                return
            peer.dial_failures += 1
            backoff = min(
                MAX_RETRY_TIME, MIN_RETRY_TIME * (2 ** min(peer.dial_failures, 10))
            )
            self._retry_at[address.node_id] = self._now() + backoff

    def dialed(self, address: PeerAddress) -> None:
        """Outbound connection established."""
        with self._mtx:
            self._dialing.discard(address.node_id)
            peer = self._peers.setdefault(
                address.node_id, _PeerInfo(node_id=address.node_id)
            )
            peer.connected = True
            peer.inbound = False
            peer.dial_failures = 0
            peer.last_connected = self._now()
            self._save()

    def accepted(self, node_id: NodeID) -> None:
        """Inbound connection established (peermanager.go Accepted);
        raises if over capacity or already connected."""
        with self._mtx:
            if node_id == self.self_id:
                raise ValueError("rejecting connection from self")
            peer = self._peers.setdefault(node_id, _PeerInfo(node_id=node_id))
            if peer.connected:
                raise ValueError(f"peer {node_id} is already connected")
            if self._num_connected() >= self.max_connected and not peer.persistent:
                raise ValueError("already connected to maximum number of peers")
            peer.connected = True
            peer.inbound = True
            peer.last_connected = self._now()
            self._save()

    def ready(self, node_id: NodeID) -> None:
        """Channel routing is live: notify subscribers (peermanager.go Ready)."""
        self._notify(PeerUpdate(node_id, "up"))

    def disconnected(self, node_id: NodeID) -> None:
        with self._mtx:
            peer = self._peers.get(node_id)
            if peer is not None and peer.connected:
                peer.connected = False
                self._retry_at[node_id] = self._now() + MIN_RETRY_TIME
        self._notify(PeerUpdate(node_id, "down"))

    def errored(self, node_id: NodeID, err: str = "") -> None:
        """Reactor reported a peer error: score down, mark for eviction."""
        with self._mtx:
            peer = self._peers.get(node_id)
            if peer is not None:
                peer.mutable_score -= 10

    def evict_next(self) -> Optional[NodeID]:
        """Lowest-scoring connected peer when over capacity."""
        with self._mtx:
            if self._num_connected() <= self.max_connected:
                return None
            connected = [p for p in self._peers.values() if p.connected]
            worst = min(connected, key=lambda p: p.score())
            return worst.node_id

    def connected_peers(self) -> List[NodeID]:
        with self._mtx:
            return [p.node_id for p in self._peers.values() if p.connected]

    def _num_connected(self) -> int:
        return sum(1 for p in self._peers.values() if p.connected)

    # --- subscriptions -------------------------------------------------------

    def subscribe(self, fn: Callable[[PeerUpdate], None]) -> None:
        self._subscribers.append(fn)

    def _notify(self, update: PeerUpdate) -> None:
        for fn in list(self._subscribers):
            try:
                fn(update)
            except Exception:
                pass

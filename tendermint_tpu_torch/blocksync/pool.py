"""BlockPool: the fetch scheduler for block sync.

A copy of ``tendermint_tpu/blocksync/pool.py``, mirroring internal/blocksync/pool.go:70-656: per-height requesters (up to
``MAX_TOTAL_REQUESTERS`` in flight, ``MAX_PENDING_REQUESTS_PER_PEER`` per
peer), peer height ranges, ban on timeout/bad blocks, and ordered
delivery to the apply loop. Scheduling here is pull-based
(``make_requests`` returns (height, peer) assignments) instead of one
goroutine per requester — the syncer thread drives it.
"""

from __future__ import annotations

import threading
import time as _time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from tendermint_tpu_torch.types.block import Block

MAX_TOTAL_REQUESTERS = 600  # pool.go:32-35
MAX_PENDING_REQUESTS_PER_PEER = 20
REQUEST_TIMEOUT_SECONDS = 15.0


@dataclass
class PeerInfo:
    peer_id: str
    base: int
    height: int
    num_pending: int = 0
    timeout_at: Optional[float] = None
    did_timeout: bool = False


@dataclass
class _Requester:
    height: int
    peer_id: Optional[str] = None
    block: Optional[Block] = None
    ext_commit_bytes: Optional[bytes] = None
    requested_at: float = 0.0


class BlockPool:
    def __init__(self, start_height: int, now: Optional[Callable[[], float]] = None):
        self.height = start_height  # next height to sync
        self._start_height = start_height
        self._peers: Dict[str, PeerInfo] = {}
        self._requesters: Dict[int, _Requester] = {}
        self._mtx = threading.RLock()
        self._now = now or _time.monotonic
        self._banned: set = set()
        self.on_peer_error: Optional[Callable[[str, str], None]] = None

    # --- peers ---------------------------------------------------------------

    def set_peer_range(self, peer_id: str, base: int, height: int) -> None:
        """pool.go SetPeerRange: add or update a peer's served range."""
        with self._mtx:
            if peer_id in self._banned:
                return
            peer = self._peers.get(peer_id)
            if peer is None:
                self._peers[peer_id] = PeerInfo(peer_id, base, height)
            else:
                peer.base = base
                peer.height = height

    def remove_peer(self, peer_id: str) -> None:
        with self._mtx:
            self._remove_peer(peer_id)

    def _remove_peer(self, peer_id: str) -> None:
        for r in self._requesters.values():
            if r.peer_id == peer_id and r.block is None:
                r.peer_id = None  # reschedule
        self._peers.pop(peer_id, None)

    def ban_peer(self, peer_id: str, reason: str = "") -> None:
        with self._mtx:
            self._banned.add(peer_id)
            self._remove_peer(peer_id)
        if self.on_peer_error is not None:
            self.on_peer_error(peer_id, reason)

    def max_peer_height(self) -> int:
        with self._mtx:
            return max((p.height for p in self._peers.values()), default=0)

    def is_caught_up(self) -> bool:
        """pool.go IsCaughtUp: within one block of the best peer."""
        with self._mtx:
            if not self._peers:
                return False
            return self.height >= self.max_peer_height()

    # --- scheduling ----------------------------------------------------------

    def make_requests(self) -> List[Tuple[int, str]]:
        """Assign unrequested heights to available peers; returns
        (height, peer_id) pairs the caller must dispatch."""
        out: List[Tuple[int, str]] = []
        with self._mtx:
            max_height = self.max_peer_height()
            # spawn requesters up to the cap
            next_h = self.height
            while (
                len(self._requesters) < MAX_TOTAL_REQUESTERS
                and next_h <= max_height
            ):
                if next_h not in self._requesters:
                    self._requesters[next_h] = _Requester(next_h)
                next_h += 1
            now = self._now()
            for r in sorted(self._requesters.values(), key=lambda r: r.height):
                if r.peer_id is not None or r.block is not None:
                    continue
                peer = self._pick_peer(r.height)
                if peer is None:
                    continue
                r.peer_id = peer.peer_id
                r.requested_at = now
                peer.num_pending += 1
                if peer.timeout_at is None:
                    peer.timeout_at = now + REQUEST_TIMEOUT_SECONDS
                out.append((r.height, peer.peer_id))
        return out

    def _pick_peer(self, height: int) -> Optional[PeerInfo]:
        """pool.go pickIncrAvailablePeer: any peer serving the height with
        pending capacity."""
        for peer in self._peers.values():
            if peer.did_timeout:
                continue
            if peer.num_pending >= MAX_PENDING_REQUESTS_PER_PEER:
                continue
            if peer.base <= height <= peer.height:
                return peer
        return None

    def check_timeouts(self) -> List[str]:
        """Ban peers whose oldest outstanding request exceeded the timeout
        (pool.go:153 requester timeout → error)."""
        timed_out = []
        with self._mtx:
            now = self._now()
            for peer in list(self._peers.values()):
                if (
                    peer.num_pending > 0
                    and peer.timeout_at is not None
                    and now > peer.timeout_at
                ):
                    peer.did_timeout = True
                    timed_out.append(peer.peer_id)
        for pid in timed_out:
            self.ban_peer(pid, "request timeout")
        return timed_out

    # --- delivery ------------------------------------------------------------

    def add_block(
        self, peer_id: str, block: Block, ext_commit_bytes: Optional[bytes] = None
    ) -> bool:
        """pool.go AddBlock: accept only from the assigned peer."""
        with self._mtx:
            height = block.header.height
            r = self._requesters.get(height)
            if r is None or r.peer_id != peer_id or r.block is not None:
                return False
            r.block = block
            r.ext_commit_bytes = ext_commit_bytes
            peer = self._peers.get(peer_id)
            if peer is not None:
                peer.num_pending -= 1
                peer.timeout_at = (
                    None
                    if peer.num_pending == 0
                    else self._now() + REQUEST_TIMEOUT_SECONDS
                )
            return True

    def peek_blocks(self, window: int) -> List[Block]:
        """Consecutive delivered blocks starting at self.height (the batch
        the pipelined verifier consumes); [] if the next one is missing."""
        with self._mtx:
            out = []
            h = self.height
            while len(out) < window:
                r = self._requesters.get(h)
                if r is None or r.block is None:
                    break
                out.append(r.block)
                h += 1
            return out

    def pop_request(self) -> None:
        """Advance past the applied height (pool.go PopRequest)."""
        with self._mtx:
            self._requesters.pop(self.height, None)
            self.height += 1

    def redo_request(self, height: int) -> Optional[str]:
        """Block at height was bad: forget the block, ban the sender, and
        reschedule (pool.go RedoRequest)."""
        with self._mtx:
            r = self._requesters.get(height)
            if r is None:
                return None
            bad_peer = r.peer_id
        # Every requester holding a block from this peer is suspect.
        with self._mtx:
            for req in self._requesters.values():
                if req.peer_id == bad_peer:
                    req.block = None
                    req.ext_commit_bytes = None
                    req.peer_id = None
        if bad_peer is not None:
            self.ban_peer(bad_peer, f"bad block at height {height}")
        return bad_peer

    def num_pending(self) -> int:
        with self._mtx:
            return sum(1 for r in self._requesters.values() if r.block is None)

"""Verified-header cache with trust-path memoization (lightd tier).

Counterpart of ``tendermint_tpu/light/cache.py``, whole. The serving
tier (``light/lightd.py``) fronts a LightClient whose skipping
verification costs scheduler super-batches. Once a height is verified
the proof never changes (headers are immutable), so lightd memoizes the
result: the verified LightBlock, the bisection trust path that proved
it, and the pre-built JSON-RPC result dict. A warm request is a pure
dict lookup: no store round-trip, no re-encoding, no device work.

Invalidation: on fork evidence (``DivergedHeaderError``) the whole
chain's entries are dropped, since a proven attack makes every memoized
trust path anchored in that chain suspect. Eviction is plain LRU with a
bounded capacity; both paths count into
``tendermint_light_cache_evictions_total``.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Optional, Tuple

from tendermint_tpu_torch.libs.metrics import LightMetrics

DEFAULT_CAPACITY = 10_000


class CacheEntry:
    """One verified height: the block, the memoized proof, the payload."""

    __slots__ = ("chain_id", "height", "header_hash", "block", "trust_path",
                 "payload")

    def __init__(self, chain_id: str, height: int, header_hash: bytes,
                 block, trust_path: Tuple[int, ...] = (), payload=None):
        self.chain_id = chain_id
        self.height = height
        self.header_hash = header_hash
        self.block = block
        # Heights of the pivots (ending at `height`) whose verification
        # proved this entry: the memoized skipping trust path.
        self.trust_path = tuple(trust_path)
        # Pre-built JSON-RPC result dict, served verbatim on a hit.
        self.payload = payload


class HeaderCache:
    """Bounded LRU over (chain_id, height) -> CacheEntry.

    ``get`` optionally pins the header hash, so a caller holding an
    expected hash can never be served a stale entry after an
    invalidate/re-verify cycle.
    """

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 metrics: Optional[LightMetrics] = None):
        if capacity <= 0:
            raise ValueError("cache capacity must be positive")
        self.capacity = capacity
        self.metrics = metrics or LightMetrics.nop()
        self._mtx = threading.Lock()
        self._entries: "OrderedDict[Tuple[str, int], CacheEntry]" = (
            OrderedDict()
        )  # guarded-by: _mtx
        self.hits = 0  # guarded-by: _mtx
        self.misses = 0  # guarded-by: _mtx
        self.evictions = 0  # guarded-by: _mtx

    def get(self, chain_id: str, height: int,
            header_hash: Optional[bytes] = None) -> Optional[CacheEntry]:
        key = (chain_id, height)
        with self._mtx:
            entry = self._entries.get(key)
            if entry is not None and (
                header_hash is None or entry.header_hash == header_hash
            ):
                self._entries.move_to_end(key)
                self.hits += 1
                hit = entry
            else:
                self.misses += 1
                hit = None
        if hit is None:
            self.metrics.cache_misses.inc()
        else:
            self.metrics.cache_hits.inc()
        return hit

    def put(self, chain_id: str, block, trust_path: Tuple[int, ...] = (),
            payload=None) -> CacheEntry:
        entry = CacheEntry(
            chain_id, block.height, block.hash(), block, trust_path, payload
        )
        key = (chain_id, block.height)
        evicted = 0
        with self._mtx:
            self._entries[key] = entry
            self._entries.move_to_end(key)
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
                evicted += 1
            self.evictions += evicted
        if evicted:
            self.metrics.cache_evictions.inc(evicted)
        return entry

    def invalidate_chain(self, chain_id: str) -> int:
        """Drop every entry for `chain_id` (fork evidence: the memoized
        trust paths can no longer be trusted). Returns the count."""
        with self._mtx:
            doomed = [k for k in self._entries if k[0] == chain_id]
            for k in doomed:
                del self._entries[k]
            self.evictions += len(doomed)
        if doomed:
            self.metrics.cache_evictions.inc(len(doomed))
        return len(doomed)

    def invalidate(self, chain_id: str, height: int) -> bool:
        with self._mtx:
            gone = self._entries.pop((chain_id, height), None) is not None
            if gone:
                self.evictions += 1
        if gone:
            self.metrics.cache_evictions.inc()
        return gone

    def __len__(self) -> int:
        with self._mtx:
            return len(self._entries)

    def stats(self) -> dict:
        with self._mtx:
            total = self.hits + self.misses
            return {
                "entries": len(self._entries),
                "capacity": self.capacity,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "hit_rate": (self.hits / total) if total else 0.0,
            }

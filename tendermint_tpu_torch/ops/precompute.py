"""Validator-set-aware precompute and result caches for the verify path.

Counterpart of ``tendermint_tpu/ops/precompute.py`` without its env
knobs. ``bind_metrics`` mirrors both caches' counters into
an ``OpsMetrics`` (table hits, misses, builds, evictions, invalidations
and build seconds; verdict-cache hits and misses), and a table gather
runs in a ``gather_tables`` span.

- :class:`PrecomputeCache`: a bounded, thread-safe LRU keyed by raw
  pubkey bytes, holding the host-built table column ``(8, 4, 32)``
  uint8 of ``[1..8](-A)`` in cached form ``(Y+X, Y-X, Z, 2dT)`` plus the
  decompression verdict. ``verify_batch`` gathers the columns into the
  ``(8, 4, 32, N)`` input of the table kernel, which then skips the
  decompression of A and the table build.
- :class:`ResultCache`: a bounded LRU over ``(pubkey, sign-bytes
  digest, sig)`` verdicts, so a vote verified once is not verified
  again.

Only keys of an *activated* validator set, or keys pinned with
:func:`pin_pubkeys` (the verify service pins repeat signers of set-less
traffic, ``ops/resident.py`` ``note_hot_keys``), get host-built tables,
so one-off keys from ad-hoc batches cannot thrash the cache; activating
a new set drops entries of keys that left every active set and are not
pinned.

Observers (:func:`register_observer`) hear of every entry that leaves
the cache: ``fn(kind, payload)`` with kind ``"rotation"`` (keys that left
every live set), ``"evict"`` (an LRU eviction) or ``"clear"``, and
payload the tuple of affected pubkeys (empty for ``"clear"``). Events are
queued under the cache lock and delivered outside it, in order; the
device-resident store (ops/resident.py) drops its copy on them. An
observer's exception propagates to the caller that triggered the event.
"""

from __future__ import annotations

import hashlib
import threading
import time
from collections import OrderedDict
from typing import Callable, Dict, FrozenSet, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from tendermint_tpu_torch.crypto import ed25519_ref as ref
from tendermint_tpu_torch.libs import tracing

TABLE_WIDTH = 8  # signed 4-bit windows select from [1..8](-A)
NLIMBS = 32
TABLE_CAP = 16384  # cached keys
RESULT_CAP = 65536  # cached verdicts
_ACTIVE_SETS_CAP = 8  # distinct validator sets considered live at once

Entry = Tuple[np.ndarray, bool]

_observers_lock = threading.Lock()
_observers: List[Callable[[str, tuple], None]] = []  # guarded-by: _observers_lock


def register_observer(fn: Callable[[str, tuple], None]) -> None:
    """Subscribe ``fn(kind, payload)`` to table-cache invalidation events."""
    with _observers_lock:
        if fn not in _observers:
            _observers.append(fn)


def _limbs(v: int) -> np.ndarray:
    """Canonical integer < 2^256 -> (32,) uint8 radix-2^8 limbs (LE)."""
    return np.frombuffer(v.to_bytes(32, "little"), dtype=np.uint8)


def _identity_table() -> np.ndarray:
    """(8, 4, 32) table of cached-form identities (1, 1, 1, 0)."""
    tab = np.zeros((TABLE_WIDTH, 4, NLIMBS), dtype=np.uint8)
    tab[:, 0:3, 0] = 1
    return tab


def build_table(pk: bytes) -> Entry:
    """Host-side table build: pubkey bytes -> ((8, 4, 32) uint8, decompress ok).

    Entry ``i`` is ``(i+1) * (-A)`` in cached form with Z normalized to 1,
    ``(y+x, y-x, 1, 2dxy)`` as canonical-integer limbs. Invalid encodings
    get identity entries and ``ok=False`` (the kernel masks the lane).
    """
    p = ref.P
    a_pt = ref.pt_decompress_liberal(pk) if len(pk) == 32 else None
    if a_pt is None:
        return _identity_table(), False
    neg_a = ref.pt_neg(a_pt)
    tab = np.zeros((TABLE_WIDTH, 4, NLIMBS), dtype=np.uint8)
    acc = neg_a
    for i in range(TABLE_WIDTH):
        if i:
            acc = ref.pt_add(acc, neg_a)
        x_, y_, z_, _ = acc
        zinv = pow(z_, p - 2, p)
        x = x_ * zinv % p
        y = y_ * zinv % p
        tab[i, 0] = _limbs((y + x) % p)
        tab[i, 1] = _limbs((y - x) % p)
        tab[i, 2, 0] = 1
        tab[i, 3] = _limbs(2 * ref.D * x * y % p)
    return tab, True


def _vset_ed25519_keys(vset) -> FrozenSet[bytes]:
    """Raw 32-byte ed25519 pubkeys of a ValidatorSet."""
    return frozenset(
        v.pub_key.bytes()
        for v in vset.validators
        if v.pub_key.type == "ed25519" and len(v.pub_key.bytes()) == 32
    )


class PrecomputeCache:
    """Bounded thread-safe LRU of per-validator signed-window tables."""

    def __init__(self, cap: int = TABLE_CAP) -> None:
        self.cap = cap
        self._lock = threading.Lock()
        self._entries: "OrderedDict[bytes, Entry]" = OrderedDict()  # guarded-by: _lock
        self._active_sets: "OrderedDict[bytes, FrozenSet[bytes]]" = OrderedDict()  # guarded-by: _lock
        self._pinned: set = set()  # guarded-by: _lock
        self._eligible: FrozenSet[bytes] = frozenset()  # guarded-by: _lock
        self._pending_events: List[Tuple[str, tuple]] = []  # guarded-by: _lock
        self._metrics = None  # guarded-by: _lock
        self._zero_counts()

    def _zero_counts(self) -> None:
        self.hits = 0  # guarded-by: _lock
        self.misses = 0  # guarded-by: _lock
        self.builds = 0  # host table builds; guarded-by: _lock
        self.evictions = 0  # guarded-by: _lock
        self.invalidations = 0  # guarded-by: _lock
        self.build_seconds = 0.0  # guarded-by: _lock

    def bind_metrics(self, metrics) -> None:
        """Mirror the counters into an ``OpsMetrics`` (None unbinds)."""
        with self._lock:
            self._metrics = metrics

    def _flush_events(self) -> None:
        """Deliver the queued events to the observers, outside the lock.

        Every event reaches every observer, as in the reference
        (``tendermint_tpu/ops/precompute.py:207-229``); an observer that
        raises does not stop the others. The reference then swallows the
        error; the port raises the first one once all are delivered, so
        a resident store that failed to drop or upload its columns is
        not hidden."""
        with self._lock:
            events, self._pending_events = self._pending_events, []
        if not events:
            return
        with _observers_lock:
            observers = list(_observers)
        first_error = None
        for kind, payload in events:
            for fn in observers:
                try:
                    fn(kind, payload)
                except Exception as exc:  # delivered to the rest, raised below
                    if first_error is None:
                        first_error = exc
        if first_error is not None:
            raise first_error

    def activate_validator_set(self, vset) -> bool:
        """Mark a validator set live: its keys become table-eligible.

        Re-activating a known set is an LRU touch. A new set retires the
        oldest live set beyond the bound and drops cached tables of keys
        that belong to no live set (committee rotation, a ``"rotation"``
        event). Returns True when the set was newly registered.
        """
        keys = _vset_ed25519_keys(vset)
        digest = hashlib.sha256(b"".join(sorted(keys))).digest()
        with self._lock:
            if digest in self._active_sets:
                self._active_sets.move_to_end(digest)
                return False
            self._active_sets[digest] = keys
            while len(self._active_sets) > _ACTIVE_SETS_CAP:
                self._active_sets.popitem(last=False)
            self._recompute_eligible_locked()
        self._flush_events()
        return True

    def pin(self, pubkeys) -> None:
        """Make specific keys table-eligible outside any validator set."""
        with self._lock:
            self._pinned.update(bytes(pk) for pk in pubkeys)
            self._recompute_eligible_locked()
        self._flush_events()

    def _recompute_eligible_locked(self) -> None:
        self._eligible = frozenset(self._pinned).union(*self._active_sets.values())
        stale = tuple(pk for pk in self._entries if pk not in self._eligible)
        for pk in stale:
            del self._entries[pk]
        if stale:
            self.invalidations += len(stale)
            self._pending_events.append(("rotation", stale))
            if self._metrics is not None:
                self._metrics.precompute_invalidations.inc(len(stale))

    def insert(self, pk: bytes, table: np.ndarray, ok: bool) -> None:
        with self._lock:
            self._insert_locked(pk, table, ok)
        self._flush_events()

    def _insert_locked(self, pk: bytes, table: np.ndarray, ok: bool) -> None:
        self._entries[pk] = (table, ok)
        self._entries.move_to_end(pk)
        while len(self._entries) > self.cap:
            old_pk, _ = self._entries.popitem(last=False)
            self.evictions += 1
            self._pending_events.append(("evict", (old_pk,)))
            if self._metrics is not None:
                self._metrics.precompute_evictions.inc()

    def snapshot_eligible(self) -> List[Tuple[bytes, np.ndarray, bool]]:
        """``(pk, table, ok)`` of every cached key of a live set, in
        the cache's order: the slice the resident store uploads. No LRU
        touch: this is a replication read, not a lookup."""
        with self._lock:
            return [(pk, tab, ok) for pk, (tab, ok) in self._entries.items()
                    if pk in self._eligible]

    def gather(self, pubkeys: Sequence[bytes]) -> Tuple[Optional[List[Optional[Entry]]], np.ndarray]:
        """Per-lane table lookup/build for a batch.

        Returns ``(entries, has_table)``: ``entries[i]`` is lane i's
        ``(table, ok)`` (None when the lane takes the build-on-device
        kernel) and ``has_table`` the (N,) bool partition mask; entries
        is None when no lane has a table. Eligible miss lanes are built
        on the host and inserted; a key repeated in one batch is built
        once.
        """
        n = len(pubkeys)
        has_table = np.zeros(n, dtype=bool)
        entries: List[Optional[Entry]] = [None] * n
        with tracing.span("gather_tables", stage="gather", engine="ed25519", lanes=n) as tspan:
            with self._lock:
                metrics = self._metrics
                hits = misses = builds = 0
                build_time = 0.0
                seen: Dict[bytes, int] = {}
                for i, pk in enumerate(pubkeys):
                    pk = bytes(pk)
                    entry = self._entries.get(pk)
                    if entry is not None:
                        self._entries.move_to_end(pk)
                        hits += 1
                    elif pk in seen:
                        # a key repeated in the batch and not cached: one
                        # build serves every lane, and only the first
                        # lane counts as a miss
                        entry = entries[seen[pk]]
                        if entry is None:
                            continue
                    elif pk in self._eligible:
                        misses += 1
                        t0 = time.perf_counter()
                        entry = build_table(pk)
                        build_time += time.perf_counter() - t0
                        builds += 1
                        self._insert_locked(pk, *entry)
                    else:
                        misses += 1
                        seen.setdefault(pk, i)
                        continue
                    entries[i] = entry
                    has_table[i] = True
                    seen.setdefault(pk, i)
                self.hits += hits
                self.misses += misses
                self.builds += builds
                self.build_seconds += build_time
            tspan.set(hits=hits, misses=misses, builds=builds)
            if metrics is not None:
                if hits:
                    metrics.precompute_hits.inc(hits)
                if misses:
                    metrics.precompute_misses.inc(misses)
                if builds:
                    metrics.precompute_builds.inc(builds)
                    metrics.table_build_seconds.observe(build_time)
        self._flush_events()
        if not has_table.any():
            return None, has_table
        return entries, has_table

    def stats(self) -> Dict[str, float]:
        with self._lock:
            return {
                "entries": len(self._entries),
                "active_sets": len(self._active_sets),
                "pinned": len(self._pinned),
                "hits": self.hits,
                "misses": self.misses,
                "builds": self.builds,
                "evictions": self.evictions,
                "invalidations": self.invalidations,
                "build_seconds": self.build_seconds,
            }

    def clear(self) -> None:
        """Drop every entry, set and pin (a ``"clear"`` event)."""
        with self._lock:
            self._entries.clear()
            self._active_sets.clear()
            self._pinned.clear()
            self._eligible = frozenset()
            self._zero_counts()
            self._pending_events.append(("clear", ()))
        self._flush_events()


class ResultCache:
    """Bounded LRU of (pubkey, sign-bytes digest, sig) -> bool verdicts.

    Verification is a pure function of the triple, so both verdicts are
    cacheable; the digest keeps large sign-bytes out of the key.
    """

    def __init__(self, cap: int = RESULT_CAP) -> None:
        self.cap = cap
        self._lock = threading.Lock()
        self._entries: "OrderedDict[bytes, bool]" = OrderedDict()  # guarded-by: _lock
        # lookups answered and not answered, so a caller can tell the
        # lanes a verifier really checked from those the cache answered
        self.hits = 0  # guarded-by: _lock
        self.misses = 0  # guarded-by: _lock
        self._metrics = None  # guarded-by: _lock

    def bind_metrics(self, metrics) -> None:
        with self._lock:
            self._metrics = metrics

    @staticmethod
    def _key(pk: bytes, msg: bytes, sig: bytes) -> bytes:
        return b"".join((pk, hashlib.sha256(msg).digest(), sig))

    def get(self, pk: bytes, msg: bytes, sig: bytes) -> Optional[bool]:
        key = self._key(pk, msg, sig)
        with self._lock:
            verdict = self._entries.get(key)
            if verdict is not None:
                self._entries.move_to_end(key)
                self.hits += 1
            else:
                self.misses += 1
            metrics = self._metrics
        if metrics is not None:
            (metrics.result_cache_misses if verdict is None else metrics.result_cache_hits).inc()
        return verdict

    def stats(self) -> dict:
        with self._lock:
            return {"entries": len(self._entries), "hits": self.hits, "misses": self.misses}

    def put(self, pk: bytes, msg: bytes, sig: bytes, verdict: bool) -> None:
        key = self._key(pk, msg, sig)
        with self._lock:
            self._entries[key] = bool(verdict)
            self._entries.move_to_end(key)
            while len(self._entries) > self.cap:
                self._entries.popitem(last=False)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()


# --- process-wide singletons -------------------------------------------------

tables = PrecomputeCache()
results = ResultCache()


def activate_validator_set(vset) -> bool:
    return tables.activate_validator_set(vset)


def pin_pubkeys(pubkeys) -> None:
    tables.pin(pubkeys)


def bind_metrics(metrics) -> None:
    tables.bind_metrics(metrics)
    results.bind_metrics(metrics)


def stats() -> Dict[str, Dict[str, float]]:
    return {"precompute": tables.stats(), "result_cache": results.stats()}


def from_reference_tables(np_tables: Mapping[bytes, Entry]) -> int:
    """Load per-validator tables built by the reference package.

    ``np_tables`` maps pubkey bytes to ``(table, ok)`` with ``table`` an
    ``(8, 4, 32)`` array of canonical radix-2^8 limbs, as
    ``tendermint_tpu.ops.precompute.build_table`` returns it. The tables
    are checked and inserted into :data:`tables`; returns the count.
    """
    for pk, (table, ok) in np_tables.items():
        arr = np.asarray(table)
        if len(pk) != 32 or arr.shape != (TABLE_WIDTH, 4, NLIMBS):
            raise ValueError(f"bad reference table for key {bytes(pk).hex()}: shape {arr.shape}")
        if arr.min() < 0 or arr.max() > 255 or not np.array_equal(arr, np.round(arr)):
            raise ValueError(f"reference table for key {bytes(pk).hex()} is not byte limbs")
        tables.insert(bytes(pk), np.ascontiguousarray(arr, dtype=np.uint8), bool(ok))
    return len(np_tables)


def reset() -> None:
    """Drop all cached state and counters (tests, benchmark isolation);
    the observers hear ``"clear"``."""
    tables.clear()
    results.clear()

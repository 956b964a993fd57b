"""Key-value store abstraction (the tm-db seam).

The part of ``tendermint_tpu/storage/kv.py`` the light, block and state
stores use: the ``KVStore`` interface with its write ``Batch``, applied
at once on ``write()`` (the block store saves a block in one batch), and
``MemDB``, its sorted in-memory store, with ``prefix_end`` and
``ordered_key``. Keys iterate in ascending byte order; iterators see a
snapshot of the keys at creation.
"""

from __future__ import annotations

import bisect
import threading
from typing import Dict, Iterator, List, Optional, Tuple


class KVStore:
    def get(self, key: bytes) -> Optional[bytes]:
        raise NotImplementedError

    def set(self, key: bytes, value: bytes) -> None:
        raise NotImplementedError

    def delete(self, key: bytes) -> None:
        raise NotImplementedError

    def iterator(
        self, start: Optional[bytes] = None, end: Optional[bytes] = None
    ) -> Iterator[Tuple[bytes, bytes]]:
        """Ascending [start, end) iteration."""
        raise NotImplementedError

    def reverse_iterator(
        self, start: Optional[bytes] = None, end: Optional[bytes] = None
    ) -> Iterator[Tuple[bytes, bytes]]:
        """Descending iteration over [start, end)."""
        raise NotImplementedError

    def new_batch(self) -> "Batch":
        return Batch(self)

    def apply_batch(self, ops) -> None:
        for op, key, value in ops:
            if op == "set":
                self.set(key, value)
            else:
                self.delete(key)


class Batch:
    """Write batch applied at once on write() (tm-db Batch)."""

    def __init__(self, db: KVStore):
        self._db = db
        self._ops: List[Tuple[str, bytes, Optional[bytes]]] = []

    def set(self, key: bytes, value: bytes) -> "Batch":
        self._ops.append(("set", bytes(key), bytes(value)))
        return self

    def delete(self, key: bytes) -> "Batch":
        self._ops.append(("del", bytes(key), None))
        return self

    def write(self) -> None:
        self._db.apply_batch(self._ops)
        self._ops = []


class MemDB(KVStore):
    """Sorted in-memory store (tm-db memdb)."""

    def __init__(self):
        self._data: Dict[bytes, bytes] = {}  # guarded-by: _lock
        self._keys: List[bytes] = []  # sorted; guarded-by: _lock
        self._lock = threading.RLock()

    def get(self, key: bytes) -> Optional[bytes]:
        with self._lock:
            return self._data.get(key)

    def set(self, key: bytes, value: bytes) -> None:
        with self._lock:
            key = bytes(key)
            if key not in self._data:
                bisect.insort(self._keys, key)
            self._data[key] = bytes(value)

    def delete(self, key: bytes) -> None:
        with self._lock:
            if key in self._data:
                del self._data[key]
                idx = bisect.bisect_left(self._keys, key)
                del self._keys[idx]

    def apply_batch(self, ops) -> None:
        with self._lock:
            super().apply_batch(ops)

    def _range(self, start: Optional[bytes], end: Optional[bytes]) -> List[bytes]:
        with self._lock:
            lo = 0 if start is None else bisect.bisect_left(self._keys, start)
            hi = len(self._keys) if end is None else bisect.bisect_left(self._keys, end)
            return self._keys[lo:hi]

    def iterator(self, start=None, end=None):
        for k in self._range(start, end):
            v = self.get(k)
            if v is not None:
                yield k, v

    def reverse_iterator(self, start=None, end=None):
        for k in reversed(self._range(start, end)):
            v = self.get(k)
            if v is not None:
                yield k, v


def prefix_end(prefix: bytes) -> Optional[bytes]:
    """Smallest byte string greater than every key with this prefix."""
    out = bytearray(prefix)
    while out:
        if out[-1] < 0xFF:
            out[-1] += 1
            return bytes(out)
        out.pop()
    return None


def ordered_key(prefix: int, *parts: int) -> bytes:
    """Height-ordered key: one prefix byte + big-endian uint64 parts, so
    byte order == numeric order (the role of orderedcode in
    internal/store/store.go:651-737)."""
    out = bytearray([prefix])
    for p in parts:
        out += p.to_bytes(8, "big")
    return bytes(out)

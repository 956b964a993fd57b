"""The seen-tx cache (internal/mempool/cache.go), a copy of
``tendermint_tpu/mempool/cache.py``: an LRU of tx keys that dedupes
CheckTx traffic and remembers recently committed txs, and its no-op."""

from __future__ import annotations

import threading
from collections import OrderedDict


class LRUTxCache:
    def __init__(self, size: int):
        self._size = size
        self._map: "OrderedDict[bytes, None]" = OrderedDict()  # guarded-by: _lock
        self._lock = threading.Lock()

    def reset(self) -> None:
        with self._lock:
            self._map.clear()

    def push(self, key: bytes) -> bool:
        """True if the key was added; False if it was there (a seen tx)."""
        with self._lock:
            if key in self._map:
                self._map.move_to_end(key)
                return False
            self._map[key] = None
            if len(self._map) > self._size:
                self._map.popitem(last=False)
            return True

    def remove(self, key: bytes) -> None:
        with self._lock:
            self._map.pop(key, None)

    def has(self, key: bytes) -> bool:
        with self._lock:
            return key in self._map


class NopTxCache:
    def reset(self) -> None: ...

    def push(self, key: bytes) -> bool:
        return True

    def remove(self, key: bytes) -> None: ...

    def has(self, key: bytes) -> bool:
        return False

"""Per-IP inbound connection limiting (internal/p2p/conn_tracker.go);
a copy of ``tendermint_tpu/p2p/conn_tracker.py``.

Caps concurrent inbound connections per remote IP so one address cannot
exhaust the node's peer slots or accept loop. ``add`` reserves a slot
(False = over the limit, reject the connection); ``remove`` releases it
when the connection dies at any stage — handshake failure included.
"""

from __future__ import annotations

import threading
from typing import Dict


class ConnTracker:
    def __init__(self, max_per_ip: int = 16):
        self.max_per_ip = max_per_ip
        self._counts: Dict[str, int] = {}
        self._mtx = threading.Lock()

    def add(self, ip: str) -> bool:
        with self._mtx:
            n = self._counts.get(ip, 0)
            if n >= self.max_per_ip:
                return False
            self._counts[ip] = n + 1
            return True

    def remove(self, ip: str) -> None:
        with self._mtx:
            n = self._counts.get(ip, 0)
            if n <= 1:
                self._counts.pop(ip, None)
            else:
                self._counts[ip] = n - 1

    def count(self, ip: str) -> int:
        with self._mtx:
            return self._counts.get(ip, 0)

    def total(self) -> int:
        with self._mtx:
            return sum(self._counts.values())

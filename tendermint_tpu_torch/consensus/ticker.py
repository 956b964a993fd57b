"""TimeoutTicker (internal/consensus/ticker.go): one timer, HRS-monotonic.

A copy of ``tendermint_tpu/consensus/ticker.py``. ``schedule_timeout``
replaces a pending timer; a fire puts the TimeoutInfo on the state
machine's timeout queue. The receiver drops stale timeouts (an older
height, round or step), as in the reference (ticker.go:18-50, state.go
handleTimeout).
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

from tendermint_tpu_torch.consensus.wal import TimeoutInfo


class TimeoutTicker:
    def __init__(self, on_timeout: Callable[[TimeoutInfo], None]):
        self._on_timeout = on_timeout
        self._timer: Optional[threading.Timer] = None
        self._lock = threading.Lock()
        self._stopped = False

    def schedule_timeout(self, duration: float, height: int, round_: int, step: int) -> None:
        ti = TimeoutInfo(duration, height, round_, step)
        with self._lock:
            if self._stopped:
                return
            if self._timer is not None:
                self._timer.cancel()
            self._timer = threading.Timer(max(0.0, duration), self._fire, args=(ti,))
            self._timer.daemon = True
            self._timer.start()

    def _fire(self, ti: TimeoutInfo) -> None:
        with self._lock:
            if self._stopped:
                return
        self._on_timeout(ti)

    def stop(self) -> None:
        with self._lock:
            self._stopped = True
            if self._timer is not None:
                self._timer.cancel()
                self._timer = None

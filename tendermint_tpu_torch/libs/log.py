"""Structured key-value logging (libs/log zerolog analog).

Counterpart of ``tendermint_tpu/libs/log.py``, whole: the logger the
gRPC transport and the event loop log through.

A logger is a level filter plus a bound field set; ``with_fields``
derives children carrying extra context (module=consensus, peer=...),
so call sites log events and key-values, never formatted strings:

    logger = Logger(level="info", moniker="node0")
    log = logger.with_fields(module="consensus")
    log.info("entering new round", height=5, round=0)
    # 2026-07-30T05:40:01Z INF entering new round height=5 round=0
    #   module=consensus moniker=node0

Output is one line per event to a stream (stderr by default) behind a
lock; a test can inject any ``write(str)``-able sink. NOP_LOGGER drops
everything — the default for library construction so embedding the
framework stays silent unless the operator asks for logs
(reference: libs/log/default.go levels, node wiring node/node.go).
"""

from __future__ import annotations

import sys
import threading
import time
from typing import Any, Dict, Optional, TextIO

_LEVELS = {"debug": 0, "info": 1, "warn": 2, "error": 3, "none": 9}
_TAGS = {0: "DBG", 1: "INF", 2: "WRN", 3: "ERR"}


class Logger:
    __slots__ = ("_level", "_fields", "_sink", "_lock")

    def __init__(
        self,
        level: str = "info",
        sink: Optional[TextIO] = None,
        _fields: Optional[Dict[str, Any]] = None,
        _lock: Optional[threading.Lock] = None,
        **fields: Any,
    ):
        if level not in _LEVELS:
            raise ValueError(
                f"log level must be one of {sorted(_LEVELS)}, got {level!r}"
            )
        self._level = _LEVELS[level]
        self._sink = sink if sink is not None else sys.stderr
        merged = dict(_fields or {})
        merged.update(fields)
        self._fields = merged
        self._lock = _lock or threading.Lock()

    def with_fields(self, **fields: Any) -> "Logger":
        child = Logger.__new__(Logger)
        child._level = self._level
        child._sink = self._sink
        merged = dict(self._fields)
        merged.update(fields)
        child._fields = merged
        child._lock = self._lock  # shared: interleaved writes stay whole-line
        return child

    def _emit(self, level: int, msg: str, kv: Dict[str, Any]) -> None:
        if level < self._level:
            return
        ts = time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())
        parts = [ts, _TAGS[level], msg]
        for k, v in kv.items():
            parts.append(f"{k}={_render(v)}")
        for k, v in self._fields.items():
            if k not in kv:
                parts.append(f"{k}={_render(v)}")
        line = " ".join(parts) + "\n"
        with self._lock:
            try:
                self._sink.write(line)
            except Exception:
                pass  # a dead sink must never take the node down

    def debug(self, msg: str, **kv: Any) -> None:
        self._emit(0, msg, kv)

    def info(self, msg: str, **kv: Any) -> None:
        self._emit(1, msg, kv)

    def warn(self, msg: str, **kv: Any) -> None:
        self._emit(2, msg, kv)

    def error(self, msg: str, **kv: Any) -> None:
        self._emit(3, msg, kv)


def _render(v: Any) -> str:
    if isinstance(v, bytes):
        return v.hex()[:16]
    s = str(v)
    if " " in s:
        return '"' + s.replace('"', "'") + '"'
    return s


class _NopLogger(Logger):
    def __init__(self):
        super().__init__(level="none")

    def with_fields(self, **fields: Any) -> "Logger":
        return self


NOP_LOGGER = _NopLogger()

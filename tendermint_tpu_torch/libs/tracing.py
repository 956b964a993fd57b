"""Span tracing for the verify scheduler and the light client's rounds.

The part of ``tendermint_tpu/libs/tracing.py`` that
``crypto/scheduler.py`` and ``light/batch.py`` call: nestable spans
(``span``, with a remote ``parent_ctx`` and mid-span ``.set``),
zero-duration ``instant`` events, ``attach`` and ``current_context``
for a :class:`TraceContext` carried across threads, and a process-wide
:class:`Tracer` with two modes:

- ``off`` (the default): spans are one shared no-op object; nothing is
  timed or stored;
- ``ring``: completed spans and instants accumulate in a bounded ring,
  read back with :meth:`Tracer.events`.

:func:`configure` sets the mode; no environment variable does (the
reference's ``TENDERMINT_TPU_TRACE`` has no port counterpart until a
ported caller needs one). Nesting is per thread (a thread-local span
stack); the ring append takes the tracer lock. The Chrome-trace dump,
the metrics observer and the fleet merge of the reference are not part
of the port yet.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Dict, List, NamedTuple, Optional

DEFAULT_CAP = 4096

OFF = "off"
RING = "ring"

# Span IDs: a per-process random prefix and an increasing suffix
# (itertools.count is atomic under the GIL).
_ID_PREFIX = os.urandom(4).hex()
_ID_COUNTER = itertools.count(1)


def _new_span_id() -> str:
    return "%s%08x" % (_ID_PREFIX, next(_ID_COUNTER) & 0xFFFFFFFF)


def _new_trace_id() -> str:
    return os.urandom(8).hex()


class TraceContext(NamedTuple):
    """Propagation context: 16-hex-character trace and span IDs and a
    flags byte (bit 0 = sampled)."""

    trace_id: str
    span_id: str
    flags: int = 1


class _RemoteAnchor:
    """A remote parent spliced into the thread's span stack by
    ``attach()``: children link under it; it records no event itself."""

    __slots__ = ("name", "trace_id", "span_id")

    def __init__(self, ctx: TraceContext):
        self.name = "remote"
        self.trace_id = ctx.trace_id
        self.span_id = ctx.span_id


class _NopSpan:
    """The one span the ``off`` tracer hands out: no allocation, no clock
    read."""

    __slots__ = ()

    def __enter__(self) -> "_NopSpan":
        return self

    def __exit__(self, *exc: Any) -> bool:
        return False

    def set(self, **tags: Any) -> None:
        pass


NOP_SPAN = _NopSpan()


class _Span:
    """One live span; a context manager recording on exit."""

    __slots__ = ("_tracer", "name", "args", "parent", "_t0", "trace_id", "span_id",
                 "parent_span_id", "_remote")

    def __init__(self, tracer: "Tracer", name: str, args: Dict[str, Any],
                 remote: Optional[TraceContext] = None):
        self._tracer = tracer
        self.name = name
        self.args = args
        self.parent = ""
        self._t0 = 0.0
        self.trace_id = ""
        self.span_id = ""
        self.parent_span_id = ""
        self._remote = remote

    def set(self, **tags: Any) -> None:
        """Attach tags found mid-span (counts, verdicts)."""
        self.args.update(tags)

    def __enter__(self) -> "_Span":
        stack = self._tracer._stack()
        if self._remote is not None:
            # an explicit remote parent beats local nesting
            self.parent = "remote"
            self.trace_id = self._remote.trace_id
            self.parent_span_id = self._remote.span_id
        elif stack:
            top = stack[-1]
            self.parent = top.name
            self.trace_id = top.trace_id
            self.parent_span_id = top.span_id
        else:
            self.trace_id = _new_trace_id()
        self.span_id = _new_span_id()
        stack.append(self)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc: Any) -> bool:
        t1 = time.perf_counter()
        stack = self._tracer._stack()
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:
            stack.remove(self)
        self._tracer._complete(self, t1)
        return False


class Tracer:
    """Thread-safe span recorder with a bounded ring of completed spans."""

    def __init__(self, cap: int = DEFAULT_CAP):
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._ring: deque = deque(maxlen=cap)  # guarded-by: _lock
        # read without the lock on the hot path: a span started during
        # configure() lands in the old mode or the new one
        self._mode = OFF
        self._recording = False
        self._epoch = time.perf_counter()
        self._pid = os.getpid()
        self.recorded = 0  # guarded-by: _lock
        self.dropped = 0  # guarded-by: _lock

    def configure(self, mode: str = OFF) -> "Tracer":
        """Set the mode, ``off`` or ``ring``."""
        mode = mode.strip()
        if mode not in (OFF, RING):
            raise ValueError(f"trace mode must be {OFF!r} or {RING!r}, got {mode!r}")
        with self._lock:
            self._mode = mode
            self._recording = mode == RING
        return self

    @property
    def mode(self) -> str:
        return self._mode

    def _stack(self) -> List[Any]:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def span(self, name: str, parent_ctx: Optional[TraceContext] = None, **args: Any) -> Any:
        """``with tracer.span("sched_flush", lanes=n):``; nested spans
        take this one as parent (per thread), ``parent_ctx`` puts the
        span under a remote caller's context instead."""
        if not self._recording:
            return NOP_SPAN
        return _Span(self, name, args, remote=parent_ctx)

    @contextmanager
    def attach(self, ctx: Optional[TraceContext]):
        """Make ``ctx`` the parent of every span this thread opens inside
        the block (nothing when ``ctx`` is None)."""
        if ctx is None or not self._recording:
            yield None
            return
        stack = self._stack()
        anchor = _RemoteAnchor(ctx)
        stack.append(anchor)
        try:
            yield anchor
        finally:
            if stack and stack[-1] is anchor:
                stack.pop()
            elif anchor in stack:
                stack.remove(anchor)

    def current_context(self) -> Optional[TraceContext]:
        """The context of this thread's innermost open span (None when
        none is open or the tracer is off)."""
        if not self._recording:
            return None
        stack = self._stack()
        if not stack or not stack[-1].trace_id:
            return None
        top = stack[-1]
        return TraceContext(top.trace_id, top.span_id, 1)

    def instant(self, name: str, **args: Any) -> None:
        """A zero-duration event."""
        if not self._recording:
            return
        ev = {
            "name": name,
            "ph": "i",
            "s": "p",
            "pid": self._pid,
            "tid": threading.get_ident(),
            "ts": round((time.perf_counter() - self._epoch) * 1e6, 3),
            "args": args,
        }
        stack = self._stack()
        if stack and stack[-1].trace_id:
            ev["trace_id"] = stack[-1].trace_id
            ev["parent_span_id"] = stack[-1].span_id
        self._append(ev)

    def _complete(self, span: _Span, t1: float) -> None:
        if not self._recording:
            return
        args = span.args
        if span.parent:
            args.setdefault("parent", span.parent)
        ev = {
            "name": span.name,
            "ph": "X",
            "pid": self._pid,
            "tid": threading.get_ident(),
            "ts": round((span._t0 - self._epoch) * 1e6, 3),
            "dur": round((t1 - span._t0) * 1e6, 3),
            "args": args,
        }
        if span.trace_id:
            ev["trace_id"] = span.trace_id
            ev["span_id"] = span.span_id
            if span.parent_span_id:
                ev["parent_span_id"] = span.parent_span_id
        self._append(ev)

    def _append(self, ev: Dict[str, Any]) -> None:
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                self.dropped += 1
            self._ring.append(ev)
            self.recorded += 1

    def events(self) -> List[Dict[str, Any]]:
        """The ring's events, oldest first (the reference's
        ``export()["traceEvents"]`` without the thread-name records)."""
        with self._lock:
            return list(self._ring)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self.dropped = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)


# The process-wide instance every instrumentation site uses.
tracer = Tracer()


def configure(mode: str = OFF) -> Tracer:
    return tracer.configure(mode)


def span(name: str, parent_ctx: Optional[TraceContext] = None, **args: Any) -> Any:
    return tracer.span(name, parent_ctx=parent_ctx, **args)


def instant(name: str, **args: Any) -> None:
    tracer.instant(name, **args)


def attach(ctx: Optional[TraceContext]):
    """``with tracing.attach(ctx): ...``: splice a remote parent."""
    return tracer.attach(ctx)


def current_context() -> Optional[TraceContext]:
    return tracer.current_context()

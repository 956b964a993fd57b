"""Span tracing for the verify path: Chrome-trace export, per-stage
timing, and the sinks that feed the metrics and the kernel profiler.

Counterpart of ``tendermint_tpu/libs/tracing.py``. Every hot stage of
batch verification (scheduler assembly and flush, cache lookup, table
gather, host prep, kernel dispatch, read-back, host fallback) and the
commit and light-client entry points open a nestable span on the
process-wide :class:`Tracer`. Completed spans and zero-duration
``instant`` events land in a bounded ring and export as Chrome
``trace_events`` JSON (``export``, ``export_chunks``), which opens in
``chrome://tracing`` or https://ui.perfetto.dev. Modes, set by
:func:`configure` (no environment variable sets them):

- ``off`` (the default): a span is one shared no-op object, unless a
  sink is set; then spans are timed for the sinks but not stored;
- ``ring``: completed spans accumulate in the ring, read back with
  :meth:`Tracer.events`, ``export`` or ``GET /debug/traces``;
- a file path: ``ring``, plus the Chrome trace written to the path at
  interpreter exit and on :meth:`Tracer.flush`.

Two sink slots see every completed span, in any mode:
``set_metrics_observer`` (:func:`metrics_observer` feeds spans tagged
``stage`` and ``engine`` into ``tendermint_ops_verify_stage_seconds``,
so the histogram and the trace count the same spans on one clock) and
``set_profile_sink`` (the kernel profiler of ``ops/introspect.py``). A
sink that raises never fails the traced operation.

Every span carries a ``trace_id``, ``span_id`` and ``parent_span_id``;
a :class:`TraceContext` (``to_header`` for a JSON-RPC request's
``trace`` member, ``to_bytes`` for a 17-byte wire form) carries a
caller's span across threads and processes, ``attach`` splices it into
this thread's span stack and ``current_context`` reads the innermost
open span. Each export records ``epoch_unix_us``, the wall-clock
instant of its clock's epoch, which ``scripts/trace_merge.py`` uses to
put several processes' exports on one timeline. Nesting is per thread
(a thread-local span stack); the ring append takes the tracer lock.
"""

from __future__ import annotations

import atexit
import itertools
import json
import os
import struct
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Callable, Dict, Iterator, List, NamedTuple, Optional, Tuple

DEFAULT_CAP = 4096

OFF = "off"
RING = "ring"

Sink = Callable[[str, Dict[str, Any], float], None]

_CTX_STRUCT = struct.Struct("<8s8sB")  # trace_id, span_id, flags
CTX_WIRE_LEN = _CTX_STRUCT.size  # 17 bytes

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
    flags byte (bit 0 = sampled). ``to_bytes`` is the 17-byte wire form,
    ``to_header`` the string a JSON-RPC request carries."""

    trace_id: str
    span_id: str
    flags: int = 1

    def to_bytes(self) -> bytes:
        return _CTX_STRUCT.pack(bytes.fromhex(self.trace_id), bytes.fromhex(self.span_id), self.flags)

    @classmethod
    def from_bytes(cls, raw: bytes) -> Optional["TraceContext"]:
        if len(raw) != CTX_WIRE_LEN:
            return None
        tid, sid, flags = _CTX_STRUCT.unpack(raw)
        if tid == b"\x00" * 8:
            return None
        return cls(tid.hex(), sid.hex(), flags)

    def to_header(self) -> str:
        return "%s-%s-%02x" % (self.trace_id, self.span_id, self.flags)

    @classmethod
    def from_header(cls, header: Any) -> Optional["TraceContext"]:
        if not isinstance(header, str):
            return None
        parts = header.split("-")
        if len(parts) != 3 or len(parts[0]) != 16 or len(parts[1]) != 16:
            return None
        try:
            bytes.fromhex(parts[0])
            bytes.fromhex(parts[1])
            flags = int(parts[2], 16)
        except ValueError:
            return None
        return cls(parts[0], parts[1], flags)


class _RemoteAnchor:
    """A remote parent spliced into the thread's span stack by
    ``attach()``: children link under it; it records no event itself."""

    __slots__ = ("name", "trace_id", "span_id")

    def __init__(self, ctx: TraceContext):
        self.name = "remote"
        self.trace_id = ctx.trace_id
        self.span_id = ctx.span_id


class _NopSpan:
    """The one span handed out while nothing records: no allocation, no
    clock read."""

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

    def context(self) -> TraceContext:
        """The context naming this span as a remote parent."""
        return TraceContext(self.trace_id, self.span_id, 1)

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
        # Written under _lock, read without it on the hot path: a span
        # started during configure() lands in the old mode or the new one.
        self._mode = OFF
        self._path: Optional[str] = None
        self._recording = False
        self._observer: Optional[Sink] = None
        self._profile: Optional[Sink] = None
        self._epoch = time.perf_counter()
        self._pid = os.getpid()
        self._thread_names: Dict[int, str] = {}  # guarded-by: _lock
        self._atexit_registered = False  # guarded-by: _lock
        self.recorded = 0  # guarded-by: _lock
        self.dropped = 0  # guarded-by: _lock

    # --- configuration -------------------------------------------------------

    def configure(self, mode: str = OFF, cap: Optional[int] = None) -> "Tracer":
        """Set the mode: ``off``, ``ring`` or a file path (``ring`` and a
        dump at exit). ``cap`` resizes the ring, keeping its newest
        events."""
        mode = mode.strip()
        if not mode:
            raise ValueError("trace mode must be 'off', 'ring' or a file path")
        with self._lock:
            self._mode = mode
            self._path = None if mode in (OFF, RING) else mode
            self._recording = mode != OFF
            if cap is not None and self._ring.maxlen != max(1, int(cap)):
                self._ring = deque(self._ring, maxlen=max(1, int(cap)))
            if self._path and not self._atexit_registered:
                self._atexit_registered = True
                atexit.register(self.flush)
        return self

    @property
    def mode(self) -> str:
        return self._mode

    @property
    def enabled(self) -> bool:
        return self._recording

    @property
    def cap(self) -> int:
        return self._ring.maxlen

    def set_metrics_observer(self, observer: Optional[Sink]) -> None:
        """One observer slot (the last binder wins): called with (name,
        args, seconds) for every completed span, in any mode."""
        with self._lock:
            self._observer = observer

    def set_profile_sink(self, sink: Optional[Sink]) -> None:
        """One profiler slot (``ops/introspect.py`` installs itself
        here): called like the observer. None uninstalls it."""
        with self._lock:
            self._profile = sink

    @property
    def metrics_observer(self) -> Optional[Sink]:
        return self._observer

    @property
    def profile_sink(self) -> Optional[Sink]:
        return self._profile

    # --- recording -----------------------------------------------------------

    def _stack(self) -> List[Any]:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def span(self, name: str, parent_ctx: Optional[TraceContext] = None, **args: Any) -> Any:
        """``with tracer.span("prep_chunk", lanes=n):``; nested spans
        take this one as parent (per thread), ``parent_ctx`` puts the
        span under a remote caller's context instead."""
        if not self._recording and self._observer is None and self._profile is None:
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
        none is open or the ring is off)."""
        if not self._recording:
            return None
        stack = self._stack()
        if not stack or not stack[-1].trace_id:
            return None
        top = stack[-1]
        return TraceContext(top.trace_id, top.span_id, 1)

    def instant(self, name: str, **args: Any) -> None:
        """A zero-duration event (a health transition, a flush reason)."""
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
        duration = t1 - span._t0
        for sink in (self._observer, self._profile):
            if sink is not None:
                try:
                    sink(span.name, span.args, duration)
                except Exception:
                    pass  # a broken metrics binding or profiler must not fail the traced op
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
            "dur": round(duration * 1e6, 3),
            "args": args,
        }
        if span.trace_id:
            ev["trace_id"] = span.trace_id
            ev["span_id"] = span.span_id
            if span.parent_span_id:
                ev["parent_span_id"] = span.parent_span_id
        self._append(ev)

    def _append(self, ev: Dict[str, Any]) -> None:
        tid = ev["tid"]
        name = threading.current_thread().name
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                self.dropped += 1
            self._ring.append(ev)
            self.recorded += 1
            self._thread_names.setdefault(tid, name)

    # --- export --------------------------------------------------------------

    def events(self) -> List[Dict[str, Any]]:
        """The ring's events, oldest first (``export()["traceEvents"]``
        without the thread-name records)."""
        with self._lock:
            return list(self._ring)

    def epoch_unix_us(self) -> float:
        """The wall-clock instant (unix microseconds) of the clock epoch
        every event's ``ts`` counts from."""
        return (time.time() - (time.perf_counter() - self._epoch)) * 1e6

    def to_perf_counter(self, ts_us: float) -> float:
        """An event's ``ts`` as a ``time.perf_counter()`` reading."""
        return self._epoch + ts_us / 1e6

    def _snapshot(self, limit: Optional[int], clear: bool
                  ) -> Tuple[List[Dict[str, Any]], List[Dict[str, Any]], Dict[str, Any]]:
        """(thread-name records, events, otherData): only the ring copy
        runs under the tracer lock."""
        with self._lock:
            events = list(self._ring)
            recorded, dropped = self.recorded, self.dropped
            names = dict(self._thread_names)
            if clear:
                self._ring.clear()
                self.dropped = 0
        if limit is not None and len(events) > limit:
            events = events[-limit:] if limit > 0 else []
        meta = [{"name": "thread_name", "ph": "M", "pid": self._pid, "tid": tid,
                 "args": {"name": tname}} for tid, tname in sorted(names.items())]
        other = {"mode": self._mode, "recorded": recorded, "dropped": dropped, "pid": self._pid,
                 "epoch_unix_us": round(self.epoch_unix_us(), 1)}
        return meta, events, other

    @staticmethod
    def _other(other: Dict[str, Any], fmt: str) -> Dict[str, Any]:
        """``otherData`` of an export: all of it, or for ``chrome`` only
        the epoch anchor. (The reference's chrome export drops the
        anchor too, and ``scripts/trace_merge.py`` then skips it.)"""
        if fmt == "chrome":
            return {"epoch_unix_us": other["epoch_unix_us"]}
        return other

    def export(self, limit: Optional[int] = None, clear: bool = False,
               fmt: str = "full") -> Dict[str, Any]:
        """The Chrome ``trace_events`` object; ``limit`` keeps the newest
        events; ``fmt="chrome"`` keeps only ``epoch_unix_us`` of
        ``otherData``."""
        meta, events, other = self._snapshot(limit, clear)
        return {"traceEvents": meta + events, "displayTimeUnit": "ms",
                "otherData": self._other(other, fmt)}

    def export_chunks(self, limit: Optional[int] = None, clear: bool = False,
                      fmt: str = "full") -> Iterator[bytes]:
        """The export streamed in bounded chunks: the lock is held for
        the ring copy only, the JSON is written outside it. ``fmt`` as
        for :meth:`export`."""
        meta, events, other = self._snapshot(limit, clear)
        yield b'{"traceEvents": ['
        first = True
        batch: List[str] = []
        for ev in meta + events:
            batch.append(("" if first else ",") + json.dumps(ev))
            first = False
            if len(batch) >= 256:
                yield "".join(batch).encode()
                batch = []
        if batch:
            yield "".join(batch).encode()
        tail = '], "displayTimeUnit": "ms", "otherData": %s}' % json.dumps(self._other(other, fmt))
        yield tail.encode()

    def summary(self) -> Dict[str, Dict[str, float]]:
        """p50, p95 and total per stage over the ring's completed spans,
        grouped by the ``stage`` tag (else the span name)."""
        with self._lock:
            events = [e for e in self._ring if e.get("ph") == "X"]
        groups: Dict[str, List[float]] = {}
        for ev in events:
            groups.setdefault(str(ev["args"].get("stage") or ev["name"]), []).append(ev["dur"])
        out: Dict[str, Dict[str, float]] = {}
        for key in sorted(groups):
            durs = sorted(groups[key])
            n = len(durs)
            out[key] = {
                "count": n,
                "p50_ms": round(durs[n // 2] / 1e3, 4),
                "p95_ms": round(durs[min(n - 1, int(n * 0.95))] / 1e3, 4),
                "total_ms": round(sum(durs) / 1e3, 4),
            }
        return out

    def flush(self, path: Optional[str] = None) -> Optional[str]:
        """Write the Chrome trace to ``path`` (default: the file mode's
        path); returns the path written, or None."""
        path = path or self._path
        if not path:
            return None
        try:
            with open(path, "w") as f:
                json.dump(self.export(), f)
        except OSError:
            return None
        return path

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self.dropped = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)


def metrics_observer(ops=None, consensus=None) -> Sink:
    """The span-to-histogram bridge: spans tagged ``stage`` and
    ``engine`` feed ``ops.verify_stage_seconds``. The consensus half
    (spans tagged ``step``) waits for the port's consensus state."""
    if consensus is not None:
        raise NotImplementedError("the consensus step histogram has no port yet")

    def observe(name: str, args: Dict[str, Any], seconds: float) -> None:
        stage = args.get("stage")
        engine = args.get("engine")
        if ops is not None and stage and engine:
            ops.verify_stage_seconds.labels(stage=str(stage), engine=str(engine)).observe(seconds)

    return observe


# The process-wide instance every instrumentation site uses.
tracer = Tracer()


def configure(mode: str = OFF, cap: Optional[int] = None) -> Tracer:
    return tracer.configure(mode, cap=cap)


def span(name: str, parent_ctx: Optional[TraceContext] = None, **args: Any) -> Any:
    return tracer.span(name, parent_ctx=parent_ctx, **args)


def instant(name: str, **args: Any) -> None:
    tracer.instant(name, **args)


def attach(ctx: Optional[TraceContext]):
    """``with tracing.attach(ctx): ...``: splice a remote parent."""
    return tracer.attach(ctx)


def current_context() -> Optional[TraceContext]:
    return tracer.current_context()

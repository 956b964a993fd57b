"""Fault flight recorder: an always-on bounded binary ring that turns a
wedge or a fault into a post-mortem.

Counterpart of ``tendermint_tpu/libs/flightrec.py``. The recorder takes
the telemetry every subsystem already emits (completed spans and
instants through the tracer's flight sink, counter and gauge writes
through the metrics flight sink, device-health transitions, brownout
and admission events) into a byte-bounded ring of binary-packed
records. Each event costs one pack and one deque append; nothing is
serialized to JSON until a dump is needed. Records and dumps are the
reference's: the same ``_REC_HDR`` packing, the same decoded rows and
the dump schema ``tendermint-tpu-flightrec/1``.

Dump triggers (:func:`install`):

- an ``instant`` named in :data:`AUTO_DUMP_INSTANTS` arriving through
  the sink (the reference's ``bench_watchdog_kill``; its bench is not
  ported, so nothing in the port emits it);
- a ``device_health_transition`` instant escalating to COOLDOWN or
  DISABLED (``ops/device_policy.py`` emits it), dumped with reason
  ``device_cooldown`` or ``device_disabled``;
- an unhandled exception (the ``sys.excepthook`` chain);
- SIGTERM (a handler chained to the previous one, which still runs).

A dump writes the last ``window_s`` seconds of records atomically (tmp
and rename) to a timestamped JSON file under the dump directory. The
port reads no environment variable: ``install(dump_dir=, window_s=,
cap_bytes=, signals=)`` chooses, with the reference's defaults (256
KiB, 30 s, ``<tempdir>/tendermint_tpu_flightrec``).

Concurrency: every producer thread shares the ring; the ring and the
dump bookkeeping are guarded by ``_mtx``.
"""

from __future__ import annotations

import json
import os
import signal
import struct
import sys
import tempfile
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

DEFAULT_CAP_BYTES = 256 * 1024
DEFAULT_WINDOW_S = 30.0
MAX_PAYLOAD_BYTES = 512  # one record's packed JSON payload cap
MAX_DUMPS = 16  # per-process disk-spam guard

DUMP_SCHEMA = "tendermint-tpu-flightrec/1"

# kind, unix-seconds timestamp, duration (us), payload length
_REC_HDR = struct.Struct("<BdIH")

KIND_SPAN = 1
KIND_INSTANT = 2
KIND_METRIC = 3
KIND_MARK = 4
KIND_NAMES = {
    KIND_SPAN: "span",
    KIND_INSTANT: "instant",
    KIND_METRIC: "metric",
    KIND_MARK: "mark",
}

# Instants whose arrival is the fault: the sink dumps with the mapped
# reason the moment one lands in the ring.
AUTO_DUMP_INSTANTS = {"bench_watchdog_kill": "watchdog_kill"}
# device_health_transition escalations that dump.
AUTO_DUMP_HEALTH_STATES = ("cooldown", "disabled")


def default_dump_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "tendermint_tpu_flightrec")


class FlightRecorder:
    """Byte-bounded ring of binary-packed telemetry records."""

    def __init__(
        self,
        cap_bytes: int = DEFAULT_CAP_BYTES,
        window_s: float = DEFAULT_WINDOW_S,
        dump_dir: Optional[str] = None,
    ):
        self._mtx = threading.Lock()
        self.cap_bytes = max(4096, int(cap_bytes))
        self.window_s = max(0.1, float(window_s))
        self.dump_dir = dump_dir or default_dump_dir()
        self._ring: deque = deque()  # guarded-by: _mtx (packed records)
        self._bytes = 0  # guarded-by: _mtx
        self.recorded = 0  # guarded-by: _mtx
        self.evicted = 0  # guarded-by: _mtx
        self.dumps = 0  # guarded-by: _mtx
        self._installed = False  # guarded-by: _mtx
        self._prev_excepthook = None  # guarded-by: _mtx
        self._prev_sigterm = None  # guarded-by: _mtx
        self._last_dump_path: Optional[str] = None  # guarded-by: _mtx

    # --- recording -----------------------------------------------------------

    def record(
        self,
        kind: int,
        name: str,
        fields: Optional[Dict[str, Any]] = None,
        dur_s: float = 0.0,
    ) -> None:
        """Pack one record into the ring; a payload that will not
        serialize is cut to its name (telemetry never fails the op)."""
        try:
            payload = json.dumps({"name": name, **(fields or {})}, default=str).encode()
        except (TypeError, ValueError):
            payload = json.dumps({"name": name}).encode()
        if len(payload) > MAX_PAYLOAD_BYTES:
            payload = payload[:MAX_PAYLOAD_BYTES]
        dur_us = min(0xFFFFFFFF, max(0, int(dur_s * 1e6)))
        rec = _REC_HDR.pack(kind, time.time(), dur_us, len(payload)) + payload
        with self._mtx:
            self._ring.append(rec)
            self._bytes += len(rec)
            self.recorded += 1
            while self._bytes > self.cap_bytes and len(self._ring) > 1:
                self._bytes -= len(self._ring.popleft())
                self.evicted += 1

    def flight_sink(self, kind: str, name: str, args: Dict[str, Any], ts: float,
                    dur: float) -> None:
        """The tracer's flight-sink slot (``tracing.set_flight_sink``):
        takes every completed span and instant, and dumps on the fault
        instants."""
        self.record(KIND_SPAN if kind == "span" else KIND_INSTANT, name, args, dur)
        if kind != "instant":
            return
        reason = AUTO_DUMP_INSTANTS.get(name)
        if reason is None and name == "device_health_transition":
            to_state = str(args.get("to_state", "")).lower()
            if to_state in AUTO_DUMP_HEALTH_STATES:
                reason = "device_%s" % to_state
        if reason is not None:
            self.dump(reason)

    def metric_sink(self, name: str, labels: Any, delta: float) -> None:
        """The metrics flight-sink slot (``metrics.set_flight_sink``):
        counter increments and gauge sets as (name, labels, value)."""
        fields: Dict[str, Any] = {"v": round(delta, 6)}
        if labels:
            fields["labels"] = dict(labels)
        self.record(KIND_METRIC, name, fields)

    def mark(self, name: str, **fields: Any) -> None:
        """An explicit application mark."""
        self.record(KIND_MARK, name, fields)

    # --- snapshot / dump -----------------------------------------------------

    def snapshot(self, window_s: Optional[float] = None) -> List[Dict[str, Any]]:
        """Decode the records of the last ``window_s`` seconds."""
        if window_s is None:
            window_s = self.window_s
        cutoff = time.time() - window_s
        with self._mtx:
            raw = list(self._ring)
        out: List[Dict[str, Any]] = []
        for rec in raw:
            kind, ts, dur_us, plen = _REC_HDR.unpack_from(rec)
            if ts < cutoff:
                continue
            payload = rec[_REC_HDR.size:_REC_HDR.size + plen]
            try:
                fields = json.loads(payload)
            except ValueError:
                fields = {"name": "<truncated>"}
            row = {
                "kind": KIND_NAMES.get(kind, str(kind)),
                "ts": round(ts, 6),
                "name": fields.pop("name", ""),
            }
            if dur_us:
                row["dur_us"] = dur_us
            if fields:
                row["fields"] = fields
            out.append(row)
        return out

    def dump(self, reason: str, window_s: Optional[float] = None) -> Optional[str]:
        """Write the last ``window_s`` seconds atomically to a timestamped
        file under ``dump_dir``; returns the path (None past the dump
        budget or when the write fails)."""
        with self._mtx:
            if self.dumps >= MAX_DUMPS:
                return None
            self.dumps += 1
            d = self.dump_dir
        records = self.snapshot(window_s)
        path = os.path.join(
            d,
            "flightrec-%d-%s-%d.json"
            % (os.getpid(), reason.replace("/", "_"), int(time.time() * 1e3)),
        )
        doc = {
            "schema": DUMP_SCHEMA,
            "pid": os.getpid(),
            "reason": reason,
            "dumped_at": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
            "window_s": window_s if window_s is not None else self.window_s,
            "records": records,
            "memstats": self._memstats_section(),
        }
        tmp = "%s.tmp.%d" % (path, os.getpid())
        try:
            os.makedirs(d, exist_ok=True)
            with open(tmp, "w") as f:
                json.dump(doc, f, indent=1)
                f.write("\n")
            os.replace(tmp, path)
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass  # tmp may never have been created; the dump is best-effort
            return None
        with self._mtx:
            self._last_dump_path = path
        return path

    def _memstats_section(self) -> Dict[str, Any]:
        """The device-tier snapshot for the dump, bounded to a quarter of
        the ring's budget (at most 64 KiB): ``introspect.memstats_json``
        drops the profiler digests, then collapses to totals, before it
        lets one dump grow past that."""
        try:
            from tendermint_tpu_torch.ops import introspect

            limit = min(self.cap_bytes // 4, 64 * 1024)
            return json.loads(introspect.memstats_json(limit_bytes=limit))
        except Exception:
            return {}  # the post-mortem dump must not fail on accounting

    def last_dump_path(self) -> Optional[str]:
        with self._mtx:
            return self._last_dump_path

    def stats(self) -> Dict[str, Any]:
        with self._mtx:
            return {
                "recorded": self.recorded,
                "evicted": self.evicted,
                "bytes": self._bytes,
                "cap_bytes": self.cap_bytes,
                "dumps": self.dumps,
                "installed": self._installed,
            }

    def __len__(self) -> int:
        with self._mtx:
            return len(self._ring)

    # --- fault-handler installation ------------------------------------------

    def install(self, signals: bool = True) -> bool:
        """Wire the recorder into the tracer's and the metrics' flight
        sinks, the excepthook chain and (main thread only) SIGTERM.
        Idempotent; returns True."""
        from tendermint_tpu_torch.libs import metrics, tracing

        with self._mtx:
            already = self._installed
            self._installed = True
        if already:
            return True
        tracing.tracer.set_flight_sink(self.flight_sink)
        metrics.set_flight_sink(self.metric_sink)

        prev_hook = sys.excepthook

        def hook(exc_type, exc, tb):
            self.record(
                KIND_MARK,
                "unhandled_exception",
                {"type": getattr(exc_type, "__name__", str(exc_type)), "message": str(exc)[:200]},
            )
            self.dump("unhandled_exception")
            prev_hook(exc_type, exc, tb)

        with self._mtx:
            self._prev_excepthook = prev_hook
        sys.excepthook = hook

        if signals and threading.current_thread() is threading.main_thread():
            try:
                prev = signal.getsignal(signal.SIGTERM)

                def on_sigterm(signum, frame):
                    self.record(KIND_MARK, "sigterm", {})
                    self.dump("sigterm")
                    if callable(prev) and prev not in (signal.SIG_IGN, signal.SIG_DFL):
                        prev(signum, frame)
                    else:
                        signal.signal(signal.SIGTERM, signal.SIG_DFL)
                        os.kill(os.getpid(), signal.SIGTERM)

                signal.signal(signal.SIGTERM, on_sigterm)
                with self._mtx:
                    self._prev_sigterm = prev
            except (ValueError, OSError):
                pass  # embedded interpreter or another platform: no signal hook
        return True

    def uninstall(self) -> None:
        """Detach the sinks and restore the chained handlers."""
        from tendermint_tpu_torch.libs import metrics, tracing

        with self._mtx:
            if not self._installed:
                return
            self._installed = False
            prev_hook = self._prev_excepthook
            prev_sig = self._prev_sigterm
            self._prev_excepthook = None
            self._prev_sigterm = None
        tracing.tracer.set_flight_sink(None)
        metrics.set_flight_sink(None)
        if prev_hook is not None:
            sys.excepthook = prev_hook
        if prev_sig is not None:
            try:
                signal.signal(signal.SIGTERM, prev_sig)
            except (ValueError, OSError):
                pass  # not the main thread, or a torn-down interpreter: keep ours


# The process-wide instance (as ``tracing.tracer``: the instrumentation
# sites have no handle to pass one around).
recorder = FlightRecorder()


def install(
    dump_dir: Optional[str] = None,
    window_s: Optional[float] = None,
    cap_bytes: Optional[int] = None,
    signals: bool = True,
) -> bool:
    """Configure the process-wide recorder and install it. Arguments
    left None keep the recorder's current setting."""
    with recorder._mtx:
        if dump_dir is not None:
            recorder.dump_dir = dump_dir
        if window_s is not None:
            recorder.window_s = max(0.1, float(window_s))
        if cap_bytes is not None:
            recorder.cap_bytes = max(4096, int(cap_bytes))
    return recorder.install(signals=signals)


def mark(name: str, **fields: Any) -> None:
    recorder.mark(name, **fields)


def dump(reason: str) -> Optional[str]:
    return recorder.dump(reason)

"""Prometheus-style metrics: registry, instruments, text exposition.

The part of ``tendermint_tpu/libs/metrics.py`` the light client's
serving tier uses: ``Counter`` and ``Histogram`` with labels, a
``Registry`` that renders the text exposition format (served by
``rpc/server.py`` at ``GET /metrics``), the shared no-op instance of a
metrics struct (``nop()``), and ``LightMetrics``. The other subsystems'
structs, gauges, exemplars and the flight-recorder sink are left out.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

NAMESPACE = "tendermint"

DEFAULT_BUCKETS = (
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


def _fmt(v: float) -> str:
    if v == int(v):
        return str(int(v))
    return repr(v)


def _label_key(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted(labels.items()))


def _escape(v: str) -> str:
    # Prometheus text format: label values escape backslash, quote, LF.
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _label_str(key: Tuple[Tuple[str, str], ...]) -> str:
    if not key:
        return ""
    return "{" + ",".join(f'{k}="{_escape(v)}"' for k, v in key) + "}"


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help_: str, label_names: Sequence[str] = ()):
        self.name = name
        self.help = help_
        self.label_names = tuple(label_names)
        self._lock = threading.Lock()

    def collect(self) -> List[str]:  # exposition lines
        raise NotImplementedError


class Counter(_Metric):
    kind = "counter"

    def __init__(self, name: str, help_: str, label_names: Sequence[str] = ()):
        super().__init__(name, help_, label_names)
        self._values: Dict[Tuple, float] = {}  # guarded-by: _lock

    def labels(self, **labels: str) -> "_BoundCounter":
        return _BoundCounter(self, _label_key(labels))

    def inc(self, n: float = 1.0) -> None:
        self.labels().inc(n)

    def collect(self) -> List[str]:
        with self._lock:
            items = sorted(self._values.items())
        if not items:
            # A labeled metric with no samples exposes no series: a
            # synthetic unlabeled `name 0` line would be invalid for it.
            if self.label_names:
                return []
            items = [((), 0.0)]
        return [f"{self.name}{_label_str(k)} {_fmt(v)}" for k, v in items]


class _BoundCounter:
    __slots__ = ("_m", "_k")

    def __init__(self, metric: Counter, key: Tuple):
        self._m = metric
        self._k = key

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError("counters only go up")
        with self._m._lock:
            self._m._values[self._k] = self._m._values.get(self._k, 0.0) + n


class Histogram(_Metric):
    kind = "histogram"

    def __init__(
        self,
        name: str,
        help_: str,
        label_names: Sequence[str] = (),
        buckets: Sequence[float] = DEFAULT_BUCKETS,
    ):
        super().__init__(name, help_, label_names)
        self.buckets = tuple(sorted(buckets))
        # per label key: (bucket counts, sum, count)
        self._values: Dict[Tuple, Tuple[List[int], float, int]] = {}  # guarded-by: _lock

    def labels(self, **labels: str) -> "_BoundHistogram":
        return _BoundHistogram(self, _label_key(labels))

    def observe(self, v: float) -> None:
        self.labels().observe(v)

    def collect(self) -> List[str]:
        with self._lock:
            # copy the counts: observe() mutates the list in place, and a
            # torn snapshot gives non-monotonic buckets
            items = sorted((k, (list(c), t, n)) for k, (c, t, n) in self._values.items())
        out: List[str] = []
        for key, (counts, total, n) in items:
            cum = 0
            for b, c in zip(self.buckets, counts):
                cum += c
                out.append(f"{self.name}_bucket{_label_str(_label_key({**dict(key), 'le': _fmt(b)}))} {cum}")
            out.append(f"{self.name}_bucket{_label_str(_label_key({**dict(key), 'le': '+Inf'}))} {n}")
            out.append(f"{self.name}_sum{_label_str(key)} {_fmt(total)}")
            out.append(f"{self.name}_count{_label_str(key)} {n}")
        return out


class _BoundHistogram:
    __slots__ = ("_m", "_k")

    def __init__(self, metric: Histogram, key: Tuple):
        self._m = metric
        self._k = key

    def observe(self, v: float) -> None:
        m = self._m
        with m._lock:
            counts, total, n = m._values.get(self._k, ([0] * len(m.buckets), 0.0, 0))
            for i, b in enumerate(m.buckets):
                if v <= b:
                    counts[i] += 1
                    break
            m._values[self._k] = (counts, total + v, n + 1)


class Registry:
    """Collects metrics and renders the text exposition format."""

    def __init__(self):
        self._metrics: List[_Metric] = []  # guarded-by: _lock
        self._lock = threading.Lock()

    def register(self, metric: _Metric) -> _Metric:
        with self._lock:
            if any(m.name == metric.name for m in self._metrics):
                raise ValueError(f"duplicate metric {metric.name}")
            self._metrics.append(metric)
        return metric

    def counter(self, name: str, help_: str, labels: Sequence[str] = ()) -> Counter:
        return self.register(Counter(name, help_, labels))  # type: ignore[return-value]

    def histogram(
        self,
        name: str,
        help_: str,
        labels: Sequence[str] = (),
        buckets: Sequence[float] = DEFAULT_BUCKETS,
    ) -> Histogram:
        return self.register(Histogram(name, help_, labels, buckets))  # type: ignore[return-value]

    def expose(self) -> str:
        """Text exposition."""
        lines: List[str] = []
        with self._lock:
            metrics = list(self._metrics)
        for m in metrics:
            lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            lines.extend(m.collect())
        return "\n".join(lines) + "\n"


def _name(subsystem: str, name: str) -> str:
    return f"{NAMESPACE}_{subsystem}_{name}"


class _NopMixin:
    """Shared, cached no-op instance per metrics class: construction
    without a registry costs one allocation in all, not a throwaway
    registry per component."""

    @classmethod
    def nop(cls):
        inst = cls.__dict__.get("_nop_instance")
        if inst is None:
            inst = cls(None)
            cls._nop_instance = inst
        return inst


class LightMetrics(_NopMixin):
    """The light-client serving tier (light/cache.py, lightd): verified-
    header cache traffic, bisection depth, and end-to-end serve latency."""

    def __init__(self, reg: Optional[Registry]):
        reg = reg or Registry()
        s = "light"
        self.cache_hits = reg.counter(
            _name(s, "cache_hits_total"),
            "Verified-header cache hits.",
        )
        self.cache_misses = reg.counter(
            _name(s, "cache_misses_total"),
            "Verified-header cache misses.",
        )
        self.cache_evictions = reg.counter(
            _name(s, "cache_evictions_total"),
            "Verified-header cache entries evicted (LRU or invalidation).",
        )
        self.bisection_rounds = reg.histogram(
            _name(s, "bisection_rounds"),
            "Scheduler super-batch rounds per skipping verification.",
            buckets=(1, 2, 3, 4, 6, 8, 12, 16, 24, 32),
        )
        self.serve_latency_seconds = reg.histogram(
            _name(s, "serve_latency_seconds"),
            "End-to-end light_header serve latency, seconds.",
            labels=("outcome",),
        )

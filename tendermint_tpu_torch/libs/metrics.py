"""Prometheus-style metrics: registry, instruments, text exposition.

The part of ``tendermint_tpu/libs/metrics.py`` the port's verify path
and the light client's serving tier use: ``Counter``, ``Gauge`` and
``Histogram`` with labels (a histogram keeps one exemplar a bucket, a
trace ID, rendered OpenMetrics-style when asked for), a ``Registry``
that renders the text exposition format (served by ``rpc/server.py`` at
``GET /metrics``), the shared no-op instance of a metrics struct
(``nop()``), ``OpsMetrics`` (the verify path: the health machine, the
caches, the resident store, the challenge hash, the stage timings and
the device-byte ledger), ``VerifydMetrics`` and ``EvloopMetrics`` (the
verify service and its event loop), ``LightMetrics`` and ``StateMetrics``
(the block executor). Family names, help texts
and label sets are the reference's, so both expositions compare line by
line. The other subsystems' structs and the flight-recorder sink are
left out.
"""

from __future__ import annotations

import threading
import time
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

    def value(self, **labels: str) -> float:
        """The current value of one series (0 when it has none)."""
        with self._lock:
            return self._values.get(_label_key(labels), 0.0)

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


class Gauge(_Metric):
    kind = "gauge"

    def __init__(self, name: str, help_: str, label_names: Sequence[str] = ()):
        super().__init__(name, help_, label_names)
        self._values: Dict[Tuple, float] = {}  # guarded-by: _lock

    def labels(self, **labels: str) -> "_BoundGauge":
        return _BoundGauge(self, _label_key(labels))

    def set(self, v: float) -> None:
        self.labels().set(v)

    def inc(self, n: float = 1.0) -> None:
        self.labels().inc(n)

    def dec(self, n: float = 1.0) -> None:
        self.labels().inc(-n)

    def value(self, **labels: str) -> float:
        """The current value of one series (0 when it has none)."""
        with self._lock:
            return self._values.get(_label_key(labels), 0.0)

    def collect(self) -> List[str]:
        with self._lock:
            items = sorted(self._values.items())
        if not items:
            if self.label_names:
                return []
            items = [((), 0.0)]
        return [f"{self.name}{_label_str(k)} {_fmt(v)}" for k, v in items]


class _BoundGauge:
    __slots__ = ("_m", "_k")

    def __init__(self, metric: Gauge, key: Tuple):
        self._m = metric
        self._k = key

    def set(self, v: float) -> None:
        with self._m._lock:
            self._m._values[self._k] = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._m._lock:
            self._m._values[self._k] = self._m._values.get(self._k, 0.0) + n

    def dec(self, n: float = 1.0) -> None:
        self.inc(-n)


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
        # per (label key, bucket index): the last (exemplar labels, value,
        # unix time), bounded by keys x (buckets + 1)
        self._exemplars: Dict[Tuple[Tuple, int], Tuple[Dict[str, str], float, float]] = {}  # guarded-by: _lock

    def labels(self, **labels: str) -> "_BoundHistogram":
        return _BoundHistogram(self, _label_key(labels))

    def observe(self, v: float, exemplar: Optional[Dict[str, str]] = None) -> None:
        self.labels().observe(v, exemplar=exemplar)

    def has_exemplars(self) -> bool:
        with self._lock:
            return bool(self._exemplars)

    def count(self, **labels: str) -> int:
        """The observation count of one series (0 when it has none)."""
        with self._lock:
            entry = self._values.get(_label_key(labels))
        return 0 if entry is None else entry[2]

    def counts(self) -> Dict[Tuple[Tuple[str, str], ...], int]:
        """{label key: observation count} of every series."""
        with self._lock:
            return {k: n for k, (_, _, n) in self._values.items()}

    def collect(self, exemplars: bool = False) -> List[str]:
        with self._lock:
            # copy the counts: observe() mutates the list in place, and a
            # torn snapshot gives non-monotonic buckets
            items = sorted((k, (list(c), t, n)) for k, (c, t, n) in self._values.items())
            exem = dict(self._exemplars) if exemplars else {}
        out: List[str] = []
        for key, (counts, total, n) in items:
            cum = 0
            for i, (b, c) in enumerate(zip(self.buckets, counts)):
                cum += c
                line = f"{self.name}_bucket{_label_str(_label_key({**dict(key), 'le': _fmt(b)}))} {cum}"
                out.append(line + _exemplar_suffix(exem.get((key, i))))
            line = f"{self.name}_bucket{_label_str(_label_key({**dict(key), 'le': '+Inf'}))} {n}"
            out.append(line + _exemplar_suffix(exem.get((key, len(self.buckets)))))
            out.append(f"{self.name}_sum{_label_str(key)} {_fmt(total)}")
            out.append(f"{self.name}_count{_label_str(key)} {n}")
        return out


def _exemplar_suffix(ex: Optional[Tuple[Dict[str, str], float, float]]) -> str:
    """OpenMetrics exemplar: `` # {trace_id="..."} v ts``; empty for a
    bucket without one, so the plain exposition is unchanged."""
    if ex is None:
        return ""
    labels, v, ts = ex
    inner = ",".join(f'{k}="{_escape(val)}"' for k, val in sorted(labels.items()))
    return " # {%s} %s %s" % (inner, _fmt(round(v, 9)), _fmt(round(ts, 3)))


class _BoundHistogram:
    __slots__ = ("_m", "_k")

    def __init__(self, metric: Histogram, key: Tuple):
        self._m = metric
        self._k = key

    def observe(self, v: float, exemplar: Optional[Dict[str, str]] = None) -> None:
        m = self._m
        bucket = len(m.buckets)  # +Inf
        with m._lock:
            counts, total, n = m._values.get(self._k, ([0] * len(m.buckets), 0.0, 0))
            for i, b in enumerate(m.buckets):
                if v <= b:
                    counts[i] += 1
                    bucket = i
                    break
            m._values[self._k] = (counts, total + v, n + 1)
            if exemplar:
                m._exemplars[(self._k, bucket)] = (dict(exemplar), v, time.time())


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

    def gauge(self, name: str, help_: str, labels: Sequence[str] = ()) -> Gauge:
        return self.register(Gauge(name, help_, labels))  # type: ignore[return-value]

    def histogram(
        self,
        name: str,
        help_: str,
        labels: Sequence[str] = (),
        buckets: Sequence[float] = DEFAULT_BUCKETS,
    ) -> Histogram:
        return self.register(Histogram(name, help_, labels, buckets))  # type: ignore[return-value]

    def expose(self, exemplars: bool = False) -> str:
        """Text exposition; ``exemplars=True`` appends each histogram
        bucket's exemplar, OpenMetrics-style."""
        lines: List[str] = []
        with self._lock:
            metrics = list(self._metrics)
        for m in metrics:
            lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            if exemplars and isinstance(m, Histogram):
                lines.extend(m.collect(exemplars=True))
            else:
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


class OpsMetrics(_NopMixin):
    """The verify path: the device health machine
    (ops/device_policy.py), per-engine host fallbacks, probe latency,
    the caches, the resident store, the challenge hash, the stage
    timings and the device-byte ledger. The ``autotune_*`` and ``mesh_*``
    families have no feeder in the port yet and read zero."""

    def __init__(self, reg: Optional[Registry]):
        reg = reg or Registry()
        s = "ops"
        self.device_health_state = reg.gauge(
            _name(s, "device_health_state"),
            "Device health state: 0=healthy 1=degraded 2=cooldown 3=disabled.",
        )
        self.device_transitions = reg.counter(
            _name(s, "device_health_transitions_total"),
            "Device health state transitions.",
            labels=("from_state", "to_state"),
        )
        self.device_failures = reg.counter(
            _name(s, "device_failures_total"),
            "Device-path failures by classification.",
            labels=("kind",),
        )
        self.device_fallbacks = reg.counter(
            _name(s, "device_fallbacks_total"),
            "Batches (or chunks) served by the CPU fallback path.",
            labels=("engine",),
        )
        self.device_fallback_lanes = reg.counter(
            _name(s, "device_fallback_lanes_total"),
            "Signature lanes served by the CPU fallback path.",
            labels=("engine",),
        )
        self.device_probe_seconds = reg.histogram(
            _name(s, "device_probe_seconds"),
            "Latency of half-open re-probe attempts, seconds.",
        )
        # Validator-set precompute cache (ops/precompute.py).
        self.precompute_hits = reg.counter(
            _name(s, "precompute_hits_total"),
            "Lanes served from the per-validator precompute table cache.",
        )
        self.precompute_misses = reg.counter(
            _name(s, "precompute_misses_total"),
            "Lanes that needed an in-kernel table build (cache miss).",
        )
        self.precompute_builds = reg.counter(
            _name(s, "precompute_builds_total"),
            "Host-side precompute table builds.",
        )
        self.precompute_evictions = reg.counter(
            _name(s, "precompute_evictions_total"),
            "Precompute table entries evicted by the LRU bound.",
        )
        self.precompute_invalidations = reg.counter(
            _name(s, "precompute_invalidations_total"),
            "Precompute table entries dropped on validator-set rotation.",
        )
        self.table_build_seconds = reg.histogram(
            _name(s, "table_build_seconds"),
            "Latency of host-side precompute table builds, seconds.",
            buckets=(0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.05),
        )
        # Digest-keyed verification result cache (ops/precompute.py).
        self.result_cache_hits = reg.counter(
            _name(s, "result_cache_hits_total"),
            "Verifications answered from the digest-keyed result cache.",
        )
        self.result_cache_misses = reg.counter(
            _name(s, "result_cache_misses_total"),
            "Verifications that missed the digest-keyed result cache.",
        )
        # Device-resident table store (ops/resident.py) and the fused
        # kernel campaign: per-batch table shipping vs resident gather,
        # on-device challenge hashing, autotuned field-mul selection.
        self.table_resident_hits = reg.counter(
            _name(s, "table_resident_hits_total"),
            "Lanes served by the device-resident table store "
            "(gather indices shipped, no per-batch table H2D).",
        )
        self.table_resident_misses = reg.counter(
            _name(s, "table_resident_misses_total"),
            "Cached-table lanes absent from the resident store "
            "(shipped via the per-batch gathered path).",
        )
        self.table_h2d_bytes = reg.counter(
            _name(s, "table_h2d_bytes_total"),
            "Precompute table bytes shipped host-to-device "
            "(resident uploads plus per-batch gathered tensors).",
        )
        self.hash_device_lanes = reg.counter(
            _name(s, "hash_device_lanes_total"),
            "Challenge scalars computed by the on-device SHA-512 kernel.",
        )
        self.autotune_selections = reg.counter(
            _name(s, "autotune_selections_total"),
            "Field-mul impl selections adopted by the autotuner, "
            "per (platform, batch-bucket) key.",
            labels=("impl",),
        )
        # Mesh-sharded verify engine (parallel/mesh.py): which mesh the
        # sharded path is running on and how lanes spread across it.
        self.mesh_devices = reg.gauge(
            _name(s, "mesh_devices"),
            "Devices in the most recently dispatched verify mesh "
            "(0 = sharding unused).",
        )
        self.mesh_dispatches = reg.counter(
            _name(s, "mesh_dispatches_total"),
            "Lane-sharded chunk dispatches, by mesh size.",
            labels=("devices",),
        )
        self.mesh_lanes = reg.counter(
            _name(s, "mesh_lanes_total"),
            "Padded signature lanes dispatched per device of the mesh.",
            labels=("device",),
        )
        self.mesh_exclusions = reg.counter(
            _name(s, "mesh_exclusions_total"),
            "Devices excluded from the mesh after an attributed failure.",
            labels=("device",),
        )
        self.mesh_readmissions = reg.counter(
            _name(s, "mesh_readmissions_total"),
            "Excluded devices re-admitted after a successful probe.",
            labels=("device",),
        )
        # Per-stage pipeline timing, fed by the tracer's metrics
        # observer (libs/tracing.py): every span tagged stage+engine
        # lands exactly one observation here.
        self.verify_stage_seconds = reg.histogram(
            _name(s, "verify_stage_seconds"),
            "Per-stage latency of the batch verify pipeline, seconds.",
            labels=("stage", "engine"),
            buckets=(
                0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005,
                0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0,
            ),
        )
        self.inflight_lanes = reg.gauge(
            _name(s, "inflight_lanes"),
            "Signature lanes currently dispatched to the device.",
            labels=("engine",),
        )
        # Device-tier introspection (ops/introspect.py). Owner values are
        # a closed set (resident_tables) and bucket labels come only from
        # introspect.bucket_label (powers of two, "other" past the cap),
        # so the families are bounded. Help texts are the reference's; a
        # port compile event is a kernel's first launch in the process,
        # its library's nvcc build or load included.
        self.device_bytes = reg.gauge(
            _name(s, "device_bytes"),
            "Device-resident bytes currently held, by owner.",
            labels=("owner",),
        )
        self.compile_events = reg.counter(
            _name(s, "compile_events_total"),
            "XLA kernel (re)compilations observed, by engine.",
            labels=("engine",),
        )
        self.kernel_bucket_seconds = reg.histogram(
            _name(s, "kernel_bucket_seconds"),
            "Kernel dispatch wall time by engine and power-of-two"
            " batch bucket (continuous profiler).",
            labels=("engine", "bucket"),
            buckets=(
                0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005,
                0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0,
            ),
        )


class VerifydMetrics(_NopMixin):
    """The verifyd verification service (verifyd/server.py): shared-
    scheduler serving metrics — queue depth and sheds by priority
    class, batch occupancy, flush reasons, wire latency. No reference
    analog; the shape follows inference-serving practice. The ``shm_*``
    families have no feeder in the port (its shm ingress is not ported)
    and read zero."""

    def __init__(self, reg: Optional[Registry]):
        reg = reg or Registry()
        s = "verifyd"
        self.queue_depth = reg.gauge(
            _name(s, "queue_depth"),
            "Lanes pending in the shared scheduler, by priority class.",
            labels=("klass",),
        )
        self.admission_rejections = reg.counter(
            _name(s, "admission_rejections_total"),
            "Requests shed by the admission controller.",
            labels=("klass", "reason"),
        )
        self.requests = reg.counter(
            _name(s, "requests_total"),
            "Wire requests served, by request kind and response status.",
            labels=("kind", "status"),
        )
        self.lanes = reg.counter(
            _name(s, "lanes_total"),
            "Signature lanes accepted into the scheduler, by class.",
            labels=("klass",),
        )
        self.request_seconds = reg.histogram(
            _name(s, "request_seconds"),
            "Wire latency per request (decode to respond), seconds.",
            labels=("kind",),
        )
        self.batch_occupancy = reg.histogram(
            _name(s, "batch_occupancy"),
            "Lanes per scheduler flush (cross-client batch size).",
            buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024),
        )
        self.flushes = reg.counter(
            _name(s, "flushes_total"),
            "Scheduler flushes, by trigger reason (size/deadline/shutdown).",
            labels=("reason",),
        )
        self.cross_client_flushes = reg.counter(
            _name(s, "cross_client_flushes_total"),
            "Flushes whose lanes came from more than one client connection.",
            labels=("reason",),
        )
        self.dispatch_occupancy = reg.histogram(
            _name(s, "dispatch_occupancy"),
            "Outstanding dispatches (queued + in flight) at each"
            " scheduler hand-off — the continuous-batching pipeline"
            " depth.",
            buckets=(1, 2, 3, 4, 6, 8),
        )
        self.brownout_level = reg.gauge(
            _name(s, "brownout_level"),
            "Current degradation-ladder rung (0=normal .."
            " 5=host_consensus).",
        )
        self.brownout_transitions = reg.counter(
            _name(s, "brownout_transitions_total"),
            "Degradation-ladder moves, by direction (up/down).",
            labels=("direction",),
        )
        # tenant labels are sanitized AND capped server-side (at most
        # max_tenants distinct values, overflow collapses to "other"),
        # so this family's cardinality is bounded by construction
        self.tenant_lanes = reg.counter(
            _name(s, "tenant_lanes_total"),
            "Signature lanes admitted, by tenant namespace.",
            labels=("tenant",),
        )
        self.tenant_rejections = reg.counter(
            _name(s, "tenant_rejections_total"),
            "Requests shed, by tenant namespace and shed reason.",
            labels=("tenant", "reason"),
        )
        self.tenant_queue_depth = reg.gauge(
            _name(s, "tenant_queue_depth"),
            "Outstanding (admitted, unresolved) lanes, by tenant.",
            labels=("tenant",),
        )
        self.tenant_request_seconds = reg.histogram(
            _name(s, "tenant_request_seconds"),
            "Wire latency per request, by tenant namespace.",
            labels=("tenant",),
        )
        # Client-side end-to-end latency attribution (verifyd/client.py):
        # the server's per-response stage-time vector observed one
        # histogram sample per stage, with trace-ID exemplars linking a
        # bucket back to the causal trace.
        self.e2e_stage_seconds = reg.histogram(
            _name(s, "e2e_stage_seconds"),
            "Per-stage share of verifyd request latency as attributed"
            " by the server's stage-time vector, seconds.",
            labels=("stage",),
            buckets=(
                0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005,
                0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0,
            ),
        )
        self.host_direct_lanes = reg.counter(
            _name(s, "host_direct_lanes_total"),
            "Consensus lanes verified on the host oracle by the"
            " brownout ladder's shrink_shares/host_consensus rungs.",
        )
        # shared-memory slab-ring ingress (verifyd/shm.py)
        self.shm_lanes = reg.counter(
            _name(s, "shm_lanes_total"),
            "Signature lanes that arrived through the shared-memory"
            " slab-ring transport (before admission).",
        )
        self.shm_fallbacks = reg.counter(
            _name(s, "shm_fallbacks_total"),
            "Shm attach/session failures that pushed a caller back onto"
            " the TCP path.",
        )
        self.shm_torn_slabs = reg.counter(
            _name(s, "shm_torn_slabs_total"),
            "Committed slabs rejected by the seqlock generation check"
            " (writer died or raced mid-write); each one is answered"
            " with an explicit INVALID, never dropped silently.",
        )
        self.shm_ring_occupancy = reg.gauge(
            _name(s, "shm_ring_occupancy"),
            "Lanes committed to slab rings and not yet drained into the"
            " scheduler, summed over live shm sessions.",
        )


class EvloopMetrics(_NopMixin):
    """The shared selector event loop (libs/evloop.py): connection
    gauge per server so operators can see 10k sockets multiplexing onto
    one loop thread. No reference analog — the reference is
    thread-per-connection."""

    def __init__(self, reg: Optional[Registry]):
        reg = reg or Registry()
        s = "evloop"
        self.connections = reg.gauge(
            _name(s, "connections"),
            "Open connections multiplexed on the event loop, per server.",
            labels=("server",),
        )


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


class StateMetrics(_NopMixin):
    """internal/state/metrics.gen.go."""

    def __init__(self, reg: Optional[Registry]):
        reg = reg or Registry()
        s = "state"
        self.block_processing_time = reg.histogram(
            _name(s, "block_processing_time"),
            "Time spent processing FinalizeBlock, seconds.",
        )
        self.consensus_param_updates = reg.counter(
            _name(s, "consensus_param_updates"),
            "Number of consensus parameter updates by the application.",
        )
        self.validator_set_updates = reg.counter(
            _name(s, "validator_set_updates"),
            "Number of validator set updates by the application.",
        )

"""Device-tier introspection: the device-byte ledger and the kernel
profiler.

Counterpart of ``tendermint_tpu/ops/introspect.py`` for the CUDA card,
without shard identity and the fleet roll-up. Two units, one
process-wide instance each:

:class:`DeviceMemAccountant`
    Device-resident bytes by owner. ``resident_tables`` is the resident
    store's ``(8, 4, 32, K)`` uint8 tensor, set to its exact ``nbytes``
    by ``ops/resident.py`` when it installs a store and to 0 when it
    drops one; ``resident_tables/<tenant>`` splits those bytes among
    the verify service's tenants by their hot-key pins
    (:func:`set_tenant_bytes`). Owners are *set*, not incremented, by the subsystem that
    knows the size, so the ledger cannot drift from the allocation.
    Compile events ride along: a kernel's first launch in the process
    (its library's nvcc build or load included), counted per engine
    under the reference's names (``ed25519`` for K1-K3 and K4,
    ``sr25519`` for K5, and ``pallas`` beside ``ed25519`` for K1 and K2,
    the ports of its two Pallas kernels). Mirrored into
    ``tendermint_ops_device_bytes{owner}`` and
    ``tendermint_ops_compile_events_total{engine}`` when metrics are
    bound, and snapshotted by :func:`memstats` for ``GET
    /debug/memstats``.

:class:`KernelProfiler`
    Fed from the tracer's profile sink: per (engine, batch bucket)
    rolling windows of ``dispatch_chunk`` span times (the host's time
    to launch a chunk; CUDA launches are asynchronous, so this is not
    kernel time) and ``kernel_compile`` span times, as p50/p95/p99
    digests. Buckets are powers of two, capped, with an ``other``
    overflow (:func:`bucket_label`), so label cardinality is bounded.

The profiler is off until :func:`install`, and
``profiler.configure("on" | "off")`` turns it on or off; while it is
off the tracer's sink slot is empty and the hot path pays nothing. No
environment variable is read. A hook into the ledger or a metric never
raises into the operation that called it.
"""

from __future__ import annotations

import json
import threading
from collections import deque
from contextlib import ExitStack, contextmanager
from typing import Any, Dict, Optional, Sequence, Tuple

from tendermint_tpu_torch.libs import tracing

# Power-of-two lane buckets up to this cap; larger batches are "other".
_BUCKET_CAP = 1 << 14
_WINDOW = 512  # samples kept a (engine, bucket) series

# The engines whose kernels each CUDA library holds.
_LIBRARY_ENGINES = {
    "ed25519_verify": ("ed25519", "pallas", "sr25519"),
    "sha512_challenge": ("ed25519",),
}


def bucket_label(lanes: Any) -> str:
    """The one batch-bucket labeller: a lane count rounded up to a power
    of two, ``other`` past the cap or for anything not a positive
    integer."""
    try:
        n = int(lanes)
    except (TypeError, ValueError):
        return "other"
    if n <= 0:
        return "other"
    b = 1
    while b < n:
        b <<= 1
    if b > _BUCKET_CAP:
        return "other"
    return str(b)


def _percentile(sorted_vals, q: float) -> float:
    """Nearest-rank percentile of a sorted list."""
    if not sorted_vals:
        return 0.0
    return sorted_vals[min(len(sorted_vals) - 1, max(0, int(q * len(sorted_vals))))]


class _Series:
    """One rolling window; the profiler's lock guards it."""

    __slots__ = ("samples", "count", "total_s")

    def __init__(self) -> None:
        self.samples: deque = deque(maxlen=_WINDOW)
        self.count = 0
        self.total_s = 0.0

    def add(self, seconds: float) -> None:
        self.samples.append(seconds)
        self.count += 1
        self.total_s += seconds

    def digest(self) -> Dict[str, float]:
        vals = sorted(self.samples)
        return {
            "count": self.count,
            "total_ms": round(self.total_s * 1e3, 3),
            "p50_ms": round(_percentile(vals, 0.50) * 1e3, 4),
            "p95_ms": round(_percentile(vals, 0.95) * 1e3, 4),
            "p99_ms": round(_percentile(vals, 0.99) * 1e3, 4),
        }


class KernelProfiler:
    """Rolling (engine, bucket) digests of dispatch and compile spans.

    Its sink is the whole hot-path cost: for a ``dispatch_chunk`` or
    ``kernel_compile`` span, one dict lookup and a deque append under a
    lock; any other span returns after one compare."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._kernel: Dict[Tuple[str, str], _Series] = {}  # guarded-by: _lock
        self._compile: Dict[Tuple[str, str], _Series] = {}  # guarded-by: _lock
        self._enabled = False  # read without the lock
        self._metrics = None  # read without the lock

    @property
    def enabled(self) -> bool:
        return self._enabled

    def configure(self, mode: str) -> None:
        """``on`` or ``off``; sets the tracer's profile sink to match."""
        if mode not in ("on", "off"):
            raise ValueError(f"profiler mode must be 'on' or 'off', got {mode!r}")
        self._enabled = mode == "on"
        tracing.tracer.set_profile_sink(self.sink if self._enabled else None)

    def bind_metrics(self, metrics) -> None:
        self._metrics = metrics

    def sink(self, name: str, args: Dict[str, Any], seconds: float) -> None:
        """The tracer's profile sink: (name, args, seconds) of every
        completed span."""
        if name not in ("dispatch_chunk", "kernel_compile"):
            return
        engine = str(args.get("engine", "unknown"))
        bucket = bucket_label(args.get("lanes"))
        key = (engine, bucket)
        with self._lock:
            table = self._kernel if name == "dispatch_chunk" else self._compile
            series = table.get(key)
            if series is None:
                series = table[key] = _Series()
            series.add(seconds)
        metrics = self._metrics
        if metrics is not None and name == "dispatch_chunk":
            try:
                metrics.kernel_bucket_seconds.labels(engine=engine, bucket=bucket).observe(seconds)
            except Exception:
                pass  # a broken metrics binding must not fail the dispatch

    def snapshot(self) -> Dict[str, Any]:
        """Digests keyed ``<engine>/b<bucket>``."""
        with self._lock:
            kernel = {k: s.digest() for k, s in self._kernel.items()}
            comp = {k: s.digest() for k, s in self._compile.items()}
        return {
            "enabled": self._enabled,
            "kernel": {"%s/b%s" % key: d for key, d in sorted(kernel.items())},
            "compile": {"%s/b%s" % key: d for key, d in sorted(comp.items())},
        }

    def clear(self) -> None:
        with self._lock:
            self._kernel.clear()
            self._compile.clear()


class DeviceMemAccountant:
    """Process-wide ledger of device-resident bytes by owner, and of
    compile events by engine."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._bytes: Dict[str, int] = {}  # guarded-by: _lock
        self._compiles: Dict[str, int] = {}  # guarded-by: _lock
        self._metrics = None  # read without the lock

    def bind_metrics(self, metrics) -> None:
        """The last binder wins; the current ledger is mirrored at once,
        so a late binding starts true."""
        self._metrics = metrics
        with self._lock:
            snap = dict(self._bytes)
            compiles = dict(self._compiles)
        for owner, n in snap.items():
            self._mirror(owner, n)
        if metrics is not None:
            for engine in compiles:
                try:
                    metrics.compile_events.labels(engine=engine).inc(0)
                except Exception:
                    pass  # a broken metrics binding must not fail the bind

    def _mirror(self, owner: str, nbytes: int) -> None:
        metrics = self._metrics
        if metrics is None:
            return
        try:
            metrics.device_bytes.labels(owner=owner).set(nbytes)
        except Exception:
            pass  # accounting must never fail the op that allocated

    def set_bytes(self, owner: str, nbytes: int) -> None:
        """Set the owner's entry (0 removes it from the snapshot; the
        gauge reads 0, so a scrape sees the release)."""
        nbytes = max(0, int(nbytes))
        with self._lock:
            if nbytes == 0:
                self._bytes.pop(owner, None)
            else:
                self._bytes[owner] = nbytes
        self._mirror(owner, nbytes)

    def add_bytes(self, owner: str, delta: int) -> None:
        """Delta accounting, for an owner of many live allocations."""
        with self._lock:
            n = max(0, self._bytes.get(owner, 0) + int(delta))
            if n == 0:
                self._bytes.pop(owner, None)
            else:
                self._bytes[owner] = n
        self._mirror(owner, n)

    def bytes_for(self, owner: str) -> int:
        with self._lock:
            return self._bytes.get(owner, 0)

    def set_tenant_bytes(self, total: int, pins: Dict[str, int]) -> None:
        """``resident_tables/<tenant>`` rows from the pin table: the
        store's ``total`` bytes split in proportion to each tenant's
        pins. Tenants that no longer hold pins are zeroed."""
        total = max(0, int(total))
        pinned = sum(pins.values())
        with self._lock:
            stale = [o for o in self._bytes
                     if o.startswith("resident_tables/") and o.split("/", 1)[1] not in pins]
        for owner in stale:
            self.set_bytes(owner, 0)
        for tenant, count in pins.items():
            self.set_bytes("resident_tables/%s" % tenant, total * count // pinned if pinned else 0)

    def note_compile(self, engine: str) -> None:
        """One compile event on ``engine``."""
        engine = str(engine)
        with self._lock:
            self._compiles[engine] = self._compiles.get(engine, 0) + 1
        metrics = self._metrics
        if metrics is not None:
            try:
                metrics.compile_events.labels(engine=engine).inc()
            except Exception:
                pass  # accounting must never fail the compiling op

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "device_bytes": dict(sorted(self._bytes.items())),
                "device_bytes_total": sum(self._bytes.values()),
                "compile_events": dict(sorted(self._compiles.items())),
            }

    def clear(self) -> None:
        """Forget everything (tests); gauges are left as they are."""
        with self._lock:
            self._bytes.clear()
            self._compiles.clear()


accountant = DeviceMemAccountant()
profiler = KernelProfiler()


def install() -> None:
    """Turn the profiler on: it becomes the tracer's profile sink."""
    profiler.configure("on")


def uninstall() -> None:
    """Turn the profiler off and empty the tracer's profile slot."""
    profiler.configure("off")


def bind_metrics(metrics) -> None:
    accountant.bind_metrics(metrics)
    profiler.bind_metrics(metrics)


def set_bytes(owner: str, nbytes: int) -> None:
    accountant.set_bytes(owner, nbytes)


def add_bytes(owner: str, delta: int) -> None:
    accountant.add_bytes(owner, delta)


def set_tenant_bytes(total: int, pins: Dict[str, int]) -> None:
    accountant.set_tenant_bytes(total, pins)


def note_compile(engine: str) -> None:
    accountant.note_compile(engine)


@contextmanager
def first_launch(engines: Sequence[str], kernel: str, lanes: int):
    """Around a kernel's first launch in the process: one compile event
    for each of ``engines`` and a ``kernel_compile`` span for each,
    nested in order (the second and later tagged ``impl``, as the
    reference's inner Pallas call is)."""
    with ExitStack() as stack:
        for i, engine in enumerate(engines):
            note_compile(engine)
            tags = {"impl": engine} if i else {}
            stack.enter_context(
                tracing.tracer.span("kernel_compile", engine=engine, kernel=kernel, lanes=lanes, **tags)
            )
        yield


def _exec_cache_entries() -> Dict[str, int]:
    """{engine: CUDA libraries loaded in this process that hold one of
    its kernels}."""
    from tendermint_tpu_torch.ops import _build

    out: Dict[str, int] = {}
    for stem in _build.loaded():
        for engine in _LIBRARY_ENGINES.get(stem, ()):
            out[engine] = out.get(engine, 0) + 1
    return dict(sorted(out.items()))


def memstats() -> Dict[str, Any]:
    """The device-tier snapshot served at ``GET /debug/memstats``: the
    ledger, the libraries loaded (``exec_cache_entries``) and their
    build events, the resident store's own counters (so the byte claim
    can be checked against its uploads) and the profiler's digests."""
    from tendermint_tpu_torch.ops import _build, resident

    out = accountant.snapshot()
    out["exec_cache_entries"] = _exec_cache_entries()
    out["builds"] = _build.build_events()
    out["resident"] = resident.stats()
    out["profile"] = profiler.snapshot()
    return out


def memstats_json(limit_bytes: Optional[int] = None) -> str:
    """:func:`memstats` as compact JSON, at most ``limit_bytes`` long when
    given: the profiler digests go first, then everything but the byte
    total."""
    doc = memstats()
    blob = json.dumps(doc, sort_keys=True, separators=(",", ":"))
    if limit_bytes is None or len(blob) <= limit_bytes:
        return blob
    doc.pop("profile", None)
    blob = json.dumps(doc, sort_keys=True, separators=(",", ":"))
    if len(blob) <= limit_bytes:
        return blob
    slim = {"device_bytes_total": doc.get("device_bytes_total", 0), "truncated": True}
    return json.dumps(slim, sort_keys=True, separators=(",", ":"))

"""Device health state machine shared by both signature engines.

Counterpart of ``tendermint_tpu/ops/device_policy.py``: one
process-wide answer to "is the card usable?", shared by
``ops/ed25519_batch.py`` and ``ops/sr25519_batch.py``, so a card one
engine found broken is known broken to the other at once::

    HEALTHY --transient--> DEGRADED --budget spent--> COOLDOWN
       ^                      |                          |
       |<------ success ------+            backoff expires: ONE caller
       |                                   becomes the half-open probe
       +--------- probe batch succeeds <-----------------+

    any state --permanent failure--> DISABLED (terminal)

- **Retry budget**: transient failures ride through DEGRADED until
  ``retry_budget`` consecutive failures, then the path cools down.
- **Exponential backoff**: each COOLDOWN entry doubles the next cooldown
  up to ``cooldown_max``; a success resets it.
- **Half-open probe**: in COOLDOWN callers are turned away at once;
  once the backoff expires exactly one caller's batch is admitted as
  the probe. Its success re-promotes the card for everyone, its failure
  re-arms the cooldown.

**Host fallback is off unless asked for.** By default an engine records
a device failure here and then re-raises it, and a batch the machine
does not admit raises :class:`DeviceRefused`: no signature is answered
on the host while the caller believes the kernels ran. A caller that
wants the reference's behaviour (the failed chunk, or the refused batch,
answered by the host oracle and counted) sets ``host_fallback``::

    device_policy.shared.host_fallback = True

Every transition is kept in ``transitions`` and emitted as a
``device_health_transition`` trace instant; ``snapshot()`` reports the
state, the failure counts and the host-fallback batches and lanes per
engine. :meth:`DeviceHealth.bind_metrics` mirrors them into an
``OpsMetrics``: the state gauge, transitions, failures by kind,
fallbacks and fallback lanes per engine, probe seconds, and the lanes
in flight on the card per engine (``note_inflight``).

Classification (:func:`classify_failure`): an explicit boolean
``permanent`` attribute wins (injected faults, and the wrappers'
``CudaError``, which sets it from the CUDA error code). Otherwise an
``ImportError`` is permanent, an out-of-memory error transient, and a
``RuntimeError`` permanent only when its text is one of CUDA's
no-device signatures or one of the sticky errors after which every CUDA
call of the process fails (illegal address, launch timeout, device-side
assert, hardware stack error, illegal instruction, misaligned address,
invalid PC, launch failure). Everything else is transient. A kernel that
does not build (``_build.KernelBuildError``) is never handed to this
machine: the engines re-raise it.
"""

from __future__ import annotations

import re
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from tendermint_tpu_torch.libs import tracing

HEALTHY = "healthy"
DEGRADED = "degraded"
COOLDOWN = "cooldown"
DISABLED = "disabled"

TRANSIENT = "transient"
PERMANENT = "permanent"

ENGINES = ("ed25519", "sr25519")
STATE_CODES = {HEALTHY: 0, DEGRADED: 1, COOLDOWN: 2, DISABLED: 3}


class DeviceRefused(RuntimeError):
    """The machine did not admit a device batch (DISABLED, or cooling
    down) and ``host_fallback`` is off."""


class DeviceStallError(RuntimeError):
    """A device call that never returned (a wedge, not an exception),
    reported by a watchdog such as the vote pre-verifier's deadline
    tracking so other callers stop feeding a hung card. Always
    transient."""

    permanent = False

# The texts PyTorch and the CUDA runtime raise when no card can come up in
# this process, and torch's "CUDA error: <cudaGetErrorString>" of the
# sticky codes (700, 702, 710, 714, 715, 716, 718, 719). Each pins a whole
# error string, not a keyword, so a transient error that merely mentions
# "cuda" or "launch" stays transient.
_PERMANENT_PATTERNS = [
    re.compile(p)
    for p in (
        r"no cuda gpus are available",
        r"found no nvidia driver on your system",
        r"cuda driver version is insufficient for cuda runtime version",
        r"cuda error: an illegal memory access was encountered",
        r"cuda error: the launch timed out and was terminated",
        r"cuda error: device-side assert triggered",
        r"cuda error: hardware stack error",
        r"cuda error: an illegal instruction was encountered",
        r"cuda error: misaligned address",
        r"cuda error: invalid program counter",
        r"cuda error: unspecified launch failure",
    )
]


def classify_failure_text(text: str) -> str:
    """TRANSIENT or PERMANENT for a failure known only by its text."""
    lowered = text.lower()
    if any(p.search(lowered) for p in _PERMANENT_PATTERNS):
        return PERMANENT
    return TRANSIENT


def classify_failure(exc: BaseException) -> str:
    """TRANSIENT or PERMANENT for a device-path exception (module note)."""
    flagged = getattr(exc, "permanent", None)
    if isinstance(flagged, bool):
        return PERMANENT if flagged else TRANSIENT
    if isinstance(exc, ImportError):
        return PERMANENT
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return TRANSIENT
    if isinstance(exc, RuntimeError):
        return classify_failure_text(str(exc))
    return TRANSIENT


class Attempt:
    """Token for one admitted device attempt: whether it is the half-open
    probe, so its outcome re-arms or clears the cooldown, and when it
    was admitted (the probe's latency)."""

    __slots__ = ("engine", "probe", "started")

    def __init__(self, engine: str, probe: bool, started: float = 0.0):
        self.engine = engine
        self.probe = probe
        self.started = started


class DeviceHealth:
    """Thread-safe device health state machine (see the module note)."""

    def __init__(
        self,
        retry_budget: int = 3,
        cooldown_base: float = 0.25,
        cooldown_max: float = 30.0,
        clock: Callable[[], float] = time.monotonic,
        host_fallback: bool = False,
    ):
        self._mtx = threading.Lock()
        self._clock = clock
        self.host_fallback = host_fallback  # a setting: reset() keeps it
        self.retry_budget = retry_budget
        self.cooldown_base = cooldown_base
        self.cooldown_max = cooldown_max
        self._state = HEALTHY  # guarded-by: _mtx
        self._consecutive_failures = 0  # guarded-by: _mtx
        self._cooldown = cooldown_base  # the next cooldown  # guarded-by: _mtx
        self._cooldown_until = 0.0  # guarded-by: _mtx
        self._probe_inflight = False  # guarded-by: _mtx
        self.transitions: List[Tuple[str, str]] = []  # guarded-by: _mtx
        self.fallback_batches = 0  # guarded-by: _mtx
        self.fallback_lanes: Dict[str, int] = dict.fromkeys(ENGINES, 0)  # guarded-by: _mtx
        self.failure_counts = {TRANSIENT: 0, PERMANENT: 0}  # guarded-by: _mtx
        self._metrics = None  # an OpsMetrics; guarded-by: _mtx

    def bind_metrics(self, metrics) -> None:
        """Mirror the machine into an ``OpsMetrics`` (None unbinds). The
        machine is process-wide: the last binder wins."""
        with self._mtx:
            self._metrics = metrics
            state = self._state
        if metrics is not None:
            metrics.device_health_state.set(STATE_CODES[state])

    def reset(self) -> None:
        """Back to a pristine HEALTHY machine (tests, operator reset);
        ``host_fallback`` is a setting and stays as it is."""
        with self._mtx:
            self._state = HEALTHY
            self._consecutive_failures = 0
            self._cooldown = self.cooldown_base
            self._cooldown_until = 0.0
            self._probe_inflight = False
            self.transitions.clear()
            self.fallback_batches = 0
            self.fallback_lanes = dict.fromkeys(ENGINES, 0)
            self.failure_counts = {TRANSIENT: 0, PERMANENT: 0}
            metrics = self._metrics
        if metrics is not None:
            metrics.device_health_state.set(STATE_CODES[HEALTHY])

    @property
    def state(self) -> str:
        with self._mtx:
            return self._state

    def snapshot(self) -> dict:
        with self._mtx:
            return {
                "state": self._state,
                "host_fallback": self.host_fallback,
                "consecutive_failures": self._consecutive_failures,
                "cooldown_until": self._cooldown_until,
                "next_cooldown": self._cooldown,
                "probe_inflight": self._probe_inflight,
                "transitions": list(self.transitions),
                "fallback_batches": self.fallback_batches,
                "fallback_lanes": dict(self.fallback_lanes),
                "failures": dict(self.failure_counts),
            }

    def _transition_locked(self, to: str) -> Optional[Tuple[str, str]]:
        if self._state == to:
            return None
        edge = (self._state, to)
        self.transitions.append(edge)
        self._state = to
        return edge

    def _emit(self, edge: Optional[Tuple[str, str]], metrics) -> None:
        """A transition, outside the lock: a trace instant (it lines up
        with the verify spans of the same timeline) and the metrics."""
        if edge is None:
            return
        tracing.instant("device_health_transition", from_state=edge[0], to_state=edge[1])
        if metrics is None:
            return
        metrics.device_health_state.set(STATE_CODES[edge[1]])
        metrics.device_transitions.labels(from_state=edge[0], to_state=edge[1]).inc()

    def begin_attempt(self, engine: str = "ed25519") -> Optional[Attempt]:
        """Admission for one device batch: an Attempt to hand back to
        record_success / record_failure, or None when the batch may not
        use the device (DISABLED, or cooling down with the backoff
        running or another probe in flight). Never blocks."""
        now = self._clock()
        with self._mtx:
            if self._state in (HEALTHY, DEGRADED):
                return Attempt(engine, probe=False, started=now)
            if self._state == DISABLED:
                return None
            if now < self._cooldown_until or self._probe_inflight:
                return None
            self._probe_inflight = True
            return Attempt(engine, probe=True, started=now)

    def record_success(self, attempt: Optional[Attempt] = None) -> None:
        """A device batch (or probe) completed: back to HEALTHY, with the
        retry budget and the backoff reset."""
        with self._mtx:
            if attempt is not None and attempt.probe:
                self._probe_inflight = False
            if self._state == DISABLED:
                return  # terminal: a late success changes nothing
            self._consecutive_failures = 0
            self._cooldown = self.cooldown_base
            edge = self._transition_locked(HEALTHY)
            metrics = self._metrics
        self._emit(edge, metrics)
        if metrics is not None and attempt is not None and attempt.probe:
            metrics.device_probe_seconds.observe(max(0.0, self._clock() - attempt.started))

    def release_probe(self, attempt: Optional[Attempt]) -> None:
        """Give back a probe reservation without an outcome: the attempt
        never reached the card (the engine raised before its launch)."""
        if attempt is None or not attempt.probe:
            return
        with self._mtx:
            self._probe_inflight = False

    def record_failure(self, exc: BaseException, attempt: Optional[Attempt] = None) -> str:
        """Classify and absorb one device failure; returns the class.
        Permanent -> DISABLED. Transient -> DEGRADED until the retry
        budget is spent (or the failure was the probe), then COOLDOWN
        with the backoff doubled."""
        kind = classify_failure(exc)
        edge = None
        probe_latency = None
        with self._mtx:
            was_probe = attempt is not None and attempt.probe
            if was_probe:
                self._probe_inflight = False
                probe_latency = max(0.0, self._clock() - attempt.started)
            self.failure_counts[kind] += 1
            metrics = self._metrics
            if self._state == DISABLED:
                pass  # terminal: the failure is counted, no transition
            elif kind == PERMANENT:
                edge = self._transition_locked(DISABLED)
            else:
                self._consecutive_failures += 1
                if was_probe or self._consecutive_failures >= self.retry_budget:
                    self._cooldown_until = self._clock() + self._cooldown
                    self._cooldown = min(self._cooldown * 2, self.cooldown_max)
                    self._consecutive_failures = 0
                    edge = self._transition_locked(COOLDOWN)
                else:
                    edge = self._transition_locked(DEGRADED)
        self._emit(edge, metrics)
        if metrics is not None:
            metrics.device_failures.labels(kind=kind).inc()
            if probe_latency is not None:
                metrics.device_probe_seconds.observe(probe_latency)
        return kind

    def refuse(self, engine: str, lanes: int) -> None:
        """A batch of ``lanes`` that begin_attempt did not admit: counted
        for the host to answer when ``host_fallback`` is on, else
        :class:`DeviceRefused`."""
        if not self.host_fallback:
            raise DeviceRefused(
                f"{engine}: {lanes} lanes not admitted to the device (state={self.state}) "
                "and host fallback is off"
            )
        self.count_fallback(engine, lanes)

    def count_fallback(self, engine: str, lanes: int) -> None:
        """One batch (or chunk) of ``lanes`` signatures answered on the
        host because the card failed or was not admitted."""
        with self._mtx:
            self.fallback_batches += 1
            self.fallback_lanes[engine] = self.fallback_lanes.get(engine, 0) + lanes
            metrics = self._metrics
        if metrics is not None:
            metrics.device_fallbacks.labels(engine=engine).inc()
            metrics.device_fallback_lanes.labels(engine=engine).inc(lanes)

    def note_inflight(self, engine: str, delta: int) -> None:
        """The in-flight lanes gauge: + a chunk's lanes at its launch,
        - them once its verdicts are read back (or fail to be)."""
        with self._mtx:
            metrics = self._metrics
        if metrics is not None:
            metrics.inflight_lanes.labels(engine=engine).inc(delta)


# The process-wide instance both engines share.
shared = DeviceHealth()

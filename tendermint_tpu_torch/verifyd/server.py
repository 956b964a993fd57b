"""verifyd server: one shared scheduler, many tenants, many connections.

Counterpart of ``tendermint_tpu/verifyd/server.py`` on the port's
engines, without the shared-memory ingress (``shm`` takes only
``"off"``) and its environment knobs: ``dyn_batch`` defaults to on, as
the reference's does with ``TENDERMINT_TPU_DYN_BATCH`` unset, and
``continuous`` to the scheduler's pipeline. The server takes
``device=`` (default: the package's, which is CUDA).

The daemon owns the card and serves batched verification over the
gRPC transport (``libs/grpc.py``). Every connection's lanes funnel
into ONE ``VerifyScheduler`` per algorithm, so batches form ACROSS
clients — a lone light client's header check rides the same kernel
launch as a validator's commit. Scheduling behavior:

- continuous batching: the scheduler's dispatch workers overlap batch
  prep with the launch in flight, so newly arrived lanes join the NEXT
  dispatch; ``verifyd_dispatch_occupancy`` observes the pipeline depth
  at every hand-off;
- deadline-aware flush: each lane carries ``flush_by`` derived from the
  request's wire deadline (minus a respond margin);
- priority-ordered dequeue: consensus < blocksync < light/rpc decides
  who flushes first when more lanes are pending than one batch holds;
- tenants: requests carry a tenant/chain id (protocol field 6).
  Admission budgets, resident-table pin quotas and
  ``tendermint_verifyd_*{tenant=...}`` metrics are kept per tenant; at
  most ``max_tenants`` distinct labels, later tenants collapse into
  ``other``;
- admission control: ``light``/``rpc`` requests are shed with an
  explicit RESOURCE_EXHAUSTED response when the tenant budget, queue
  depth or estimated service time is past budget. ``consensus`` and
  ``blocksync`` are never shed by admission; they land in the
  scheduler's ``max_pending`` backstop instead;
- per-tenant SLO budgets: a tenant's declared p99 target (server
  config or protocol field 8, the tightest wins, the operator's beats
  the wire's); a sustained breach sheds that tenant's sheddable
  classes before the load-based ladder moves.

Brownout ladder (the reference's documented degradation contract):
under sustained overload — or a device in COOLDOWN — the server walks

    0 normal          everything admitted (per-tenant budgets apply)
    1 shed_rpc        rpc requests shed
    2 shed_light      + light shed
    3 shed_blocksync  + blocksync shed
    4 shrink_shares   per-tenant budgets shrink to 1/4; consensus past
                      a tenant's shrunken share verifies on the host
    5 host_consensus  ALL consensus verifies host-direct

Consensus is never shed at any rung; its worst case is the host oracle,
or a refusal while the card cools with host fallback off.
Host-direct lanes are counted in ``host_direct_lanes`` and in the
health machine's fallback lanes (``device_policy.shared``).

Where the port differs from the reference (ROADMAP §C):

- a flush whose verifier raised and whose fallback did not answer
  (the port's fallback answers only with ``device_policy.shared.
  host_fallback`` on) fails closed in the scheduler with the error on
  each lane's handle; the server answers such a request
  ``STATUS_INTERNAL`` with the error's text, where the reference
  answers ``STATUS_OK`` with every verdict False. A verdict wait that
  times out is ``STATUS_DEADLINE_EXCEEDED``, never a False verdict;
- a card in COOLDOWN or DISABLED pins the ladder at host_consensus as
  in the reference, but with ``host_fallback`` off its consensus
  requests get ``STATUS_INTERNAL`` naming the device refusal, where the
  reference answers them on the host; rungs reached by load or
  ``force`` stay host-direct;
- the hot-key hook (``resident.note_hot_keys``) counts its errors in
  ``stats()["pin_errors"]`` instead of swallowing them.
"""

from __future__ import annotations

import functools
import hashlib
import json
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from tendermint_tpu_torch import resolve_device
from tendermint_tpu_torch.crypto import batch as crypto_batch
from tendermint_tpu_torch.crypto.scheduler import (
    DEFAULT_PIPELINE_DEPTH,
    SchedulerSaturatedError,
    VerifyScheduler,
)
from tendermint_tpu_torch.libs import tracing
from tendermint_tpu_torch.libs.grpc import GrpcServer, current_conn_tag
from tendermint_tpu_torch.libs.metrics import VerifydMetrics
from tendermint_tpu_torch.ops import cuda_hash, cuda_verify, device_policy, introspect, resident
from tendermint_tpu_torch.verifyd import protocol
from tendermint_tpu_torch.verifyd.protocol import (
    ALGO_ED25519,
    ALGO_NAMES,
    ALGO_SR25519,
    CLASS_BLOCKSYNC,
    CLASS_CONSENSUS,
    CLASS_LIGHT,
    CLASS_NAMES,
    CLASS_RPC,
    DEFAULT_TENANT,
    KIND_NAMES,
    SHEDDABLE_CLASSES,
    STATS_PATH,
    STATUS_DEADLINE_EXCEEDED,
    STATUS_INTERNAL,
    STATUS_INVALID,
    STATUS_NAMES,
    STATUS_OK,
    STATUS_RESOURCE_EXHAUSTED,
    VERIFY_PATH,
)

DEFAULT_ADMISSION_CAP = 1024  # pending-lane ceiling for sheddable classes
DEFAULT_MAX_PENDING = 4096  # hard scheduler cap (all classes)
DEFAULT_SERVICE_BUDGET = 0.5  # seconds of estimated queue service time
DEFAULT_WAIT = 10.0  # verdict wait for requests without a deadline
DEFAULT_TENANT_CAP = 512  # outstanding sheddable lanes per tenant
DEFAULT_PIN_QUOTA = 256  # resident-table pins per tenant
DEFAULT_MAX_TENANTS = 16  # distinct tenant label/budget buckets
_EWMA_ALPHA = 0.2
_SHRINK_DIVISOR = 4  # tenant share divisor at the shrink_shares rung

# Per-tenant SLO budgets: a bounded ring of attributed server-side
# latencies per tenant; a p99 past the target for ``slo_breach_after``
# seconds sheds the tenant's sheddable classes, released after
# ``slo_recover_after`` with the ring reset.
SLO_BREACH_AFTER = 0.25
SLO_RECOVER_AFTER = 1.0
_SLO_RING = 512  # latency samples kept per tenant
_SLO_RECOMPUTE = 16  # recompute the cached p99 every N samples
_SLO_MIN_SAMPLES = 20  # no verdicts from a cold sketch

# --- brownout ladder ---------------------------------------------------------

LEVEL_NORMAL = 0
LEVEL_SHED_RPC = 1
LEVEL_SHED_LIGHT = 2
LEVEL_SHED_BLOCKSYNC = 3
LEVEL_SHRINK_SHARES = 4
LEVEL_HOST_CONSENSUS = 5
LEVEL_NAMES = {
    LEVEL_NORMAL: "normal",
    LEVEL_SHED_RPC: "shed_rpc",
    LEVEL_SHED_LIGHT: "shed_light",
    LEVEL_SHED_BLOCKSYNC: "shed_blocksync",
    LEVEL_SHRINK_SHARES: "shrink_shares",
    LEVEL_HOST_CONSENSUS: "host_consensus",
}
# the declared shed order: rpc first, light next, blocksync last;
# consensus has NO entry — no rung ever sheds it
_CLASS_SHED_LEVEL = {
    CLASS_RPC: LEVEL_SHED_RPC,
    CLASS_LIGHT: LEVEL_SHED_LIGHT,
    CLASS_BLOCKSYNC: LEVEL_SHED_BLOCKSYNC,
}


def level_sheds_class(level: int, klass: int) -> bool:
    """True when the ladder rung ``level`` sheds priority class
    ``klass``. Consensus is never shed at any level."""
    at = _CLASS_SHED_LEVEL.get(klass)
    return at is not None and level >= at


def _device_cooling() -> bool:
    """The shared health machine says the card is cooling down (or
    disabled): pin the ladder at host_consensus."""
    return device_policy.shared.state in (device_policy.COOLDOWN, device_policy.DISABLED)


class BrownoutController:
    """Walks the degradation ladder on sustained pressure.

    Fed one boolean load sample per request (``observe``): pressure
    sustained for ``escalate_after`` seconds climbs one rung (and
    restarts the clock); calm sustained for ``recover_after`` descends
    one. ``cooldown_fn`` (default: the shared health machine) pins the
    EFFECTIVE level at host_consensus while the card is in
    COOLDOWN/DISABLED. ``force`` overrides the level outright.
    """

    def __init__(
        self,
        escalate_after: float = 0.25,
        recover_after: float = 1.0,
        cooldown_fn: Optional[Callable[[], bool]] = _device_cooling,
    ):
        self.escalate_after = escalate_after
        self.recover_after = recover_after
        self._cooldown_fn = cooldown_fn
        self._mtx = threading.Lock()
        self._level = LEVEL_NORMAL  # guarded-by: _mtx
        self._forced: Optional[int] = None  # guarded-by: _mtx
        self._pressure_since: Optional[float] = None  # guarded-by: _mtx
        self._calm_since: Optional[float] = None  # guarded-by: _mtx
        self.transitions = {"up": 0, "down": 0}  # guarded-by: _mtx

    def force(self, level: Optional[int]) -> None:
        """Pin the effective level (None releases the pin)."""
        with self._mtx:
            self._forced = level

    @property
    def level(self) -> int:
        """The organic (load-driven) level, ignoring force/cooldown."""
        with self._mtx:
            return self._level

    def effective(self) -> int:
        with self._mtx:
            return self._effective_locked()

    def cooling(self) -> bool:
        """True while ``cooldown_fn`` says the card is out of the loop."""
        if self._cooldown_fn is None:
            return False
        try:
            return bool(self._cooldown_fn())
        except Exception:
            return False  # a broken probe must not change policy

    def _effective_locked(self) -> int:
        lvl = self._level if self._forced is None else self._forced
        if self.cooling():
            lvl = max(lvl, LEVEL_HOST_CONSENSUS)
        return lvl

    def snapshot(self) -> dict:
        with self._mtx:
            return {
                "level": self._level,
                "forced": self._forced,
                "effective": self._effective_locked(),
                "transitions": dict(self.transitions),
            }

    def observe(self, pressure: bool, now: Optional[float] = None) -> Tuple[int, int]:
        """Feed one load sample; returns ``(effective_level, delta)``
        where delta is +1/-1 when this sample moved the organic level."""
        now = time.monotonic() if now is None else now
        delta = 0
        with self._mtx:
            if pressure:
                self._calm_since = None
                if self._pressure_since is None:
                    self._pressure_since = now
                elif (
                    now - self._pressure_since >= self.escalate_after
                    and self._level < LEVEL_HOST_CONSENSUS
                ):
                    self._level += 1
                    self.transitions["up"] += 1
                    self._pressure_since = now
                    delta = 1
            else:
                self._pressure_since = None
                if self._level == LEVEL_NORMAL:
                    self._calm_since = None
                elif self._calm_since is None:
                    self._calm_since = now
                elif now - self._calm_since >= self.recover_after:
                    self._level -= 1
                    self.transitions["down"] += 1
                    self._calm_since = now
                    delta = -1
            return self._effective_locked(), delta


# --- tenants -----------------------------------------------------------------

TENANT_OVERFLOW_LABEL = "other"


def sanitize_tenant_label(name: str) -> str:
    """Metrics-safe tenant label: alnum/dash/underscore/dot, max 32
    chars. Names that don't survive sanitization intact become a stable
    hash so distinct ugly ids don't collide with each other."""
    safe = "".join(c for c in name if c.isalnum() or c in "-_.")[:32]
    if safe == name and safe:
        return safe
    return "t" + hashlib.sha1(name.encode("utf-8")).hexdigest()[:8]


class _TenantState:
    """Per-tenant accounting, guarded by the server's ``_tenant_mtx``."""

    __slots__ = (
        "label", "depth", "lanes", "sheds", "host_direct",
        "slo_ms", "slo_pinned", "lat_ring", "lat_idx", "lat_new",
        "p99", "slo_breach_since", "slo_shed_since", "slo_shedding",
        "slo_sheds",
    )

    def __init__(self, label: str):
        self.label = label
        self.depth = 0  # outstanding (admitted, unresolved) lanes
        self.lanes = 0  # total lanes admitted
        self.sheds = 0  # total requests shed
        self.host_direct = 0  # lanes verified on the host oracle
        self.slo_ms = 0  # declared p99 target; 0 = no SLO
        self.slo_pinned = False  # server-config target beats the wire's
        self.lat_ring: List[float] = []  # bounded latency samples (s)
        self.lat_idx = 0  # ring write cursor
        self.lat_new = 0  # samples since the last p99 recompute
        self.p99 = 0.0  # cached ring p99 (seconds)
        self.slo_breach_since: Optional[float] = None
        self.slo_shed_since: Optional[float] = None
        self.slo_shedding = False
        self.slo_sheds = 0  # requests shed by the SLO gate


# --- admission ---------------------------------------------------------------


class AdmissionController:
    """Sheds sheddable-class load when the queue is past budget.

    Two trip-wires, both checked at enqueue time: unresolved depth past
    ``cap`` lanes, or estimated service time for the queue (EWMA
    per-lane flush cost x depth) past ``service_budget`` seconds. The
    estimate learns from real flushes via ``observe_flush``.
    """

    def __init__(self, cap: int = DEFAULT_ADMISSION_CAP,
                 service_budget: float = DEFAULT_SERVICE_BUDGET):
        self.cap = cap
        self.service_budget = service_budget
        self._mtx = threading.Lock()
        self._lane_ewma = 0.0  # seconds per lane, learned; guarded-by: _mtx

    def observe_flush(self, lanes: int, seconds: float) -> None:
        if lanes <= 0 or seconds <= 0:
            return
        per_lane = seconds / lanes
        with self._mtx:
            if self._lane_ewma == 0.0:
                self._lane_ewma = per_lane
            else:
                self._lane_ewma += _EWMA_ALPHA * (per_lane - self._lane_ewma)

    def estimated_service_time(self, depth: int) -> float:
        with self._mtx:
            return depth * self._lane_ewma

    def pressure(self, depth: int) -> bool:
        """Load sample for the brownout controller."""
        if depth > self.cap:
            return True
        return self.estimated_service_time(depth) > self.service_budget

    def admit(self, klass: int, lanes: int, depth: int) -> Optional[str]:
        """None = admitted; else the shed reason. Only sheddable
        classes (light/rpc) are ever refused here."""
        if klass not in SHEDDABLE_CLASSES:
            return None
        if depth + lanes > self.cap:
            return "queue_depth"
        if self.estimated_service_time(depth + lanes) > self.service_budget:
            return "service_time"
        return None


# --- verify functions ----------------------------------------------------------


def _host_sr25519_verify(pks, msgs, sigs) -> List[bool]:
    from tendermint_tpu_torch.crypto.sr25519 import verify as sr_verify

    return [sr_verify(p, m, s) for p, m, s in zip(pks, msgs, sigs)]


class VerifydServer:
    """The verification daemon. ``verify_fn`` defaults to the tiered
    host/device ed25519 dispatch on ``device``; tests inject a host
    oracle."""

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        max_batch: Optional[int] = None,
        max_delay: float = 0.002,
        admission_cap: int = DEFAULT_ADMISSION_CAP,
        max_pending: int = DEFAULT_MAX_PENDING,
        service_budget: float = DEFAULT_SERVICE_BUDGET,
        verify_fn: Optional[Callable[..., List[bool]]] = None,
        sr25519_verify_fn: Optional[Callable[..., List[bool]]] = None,
        metrics: Optional[VerifydMetrics] = None,
        evloop_metrics=None,
        continuous: Optional[bool] = None,
        pipeline_depth: int = DEFAULT_PIPELINE_DEPTH,
        tenant_cap: int = DEFAULT_TENANT_CAP,
        tenant_pin_quota: int = DEFAULT_PIN_QUOTA,
        max_tenants: int = DEFAULT_MAX_TENANTS,
        brownout: Optional[BrownoutController] = None,
        shm: str = "off",
        dyn_batch: bool = True,
        tenant_slos: Optional[Dict[str, int]] = None,
        slo_breach_after: float = SLO_BREACH_AFTER,
        slo_recover_after: float = SLO_RECOVER_AFTER,
        shard_id: int = -1,
        device=None,
        evloop: bool = True,
    ):
        if shm != "off":
            raise ValueError(
                f"shm={shm!r}: the shared-memory ingress is not ported (ROADMAP §A item 6); "
                "only 'off' is accepted"
            )
        self.device = resolve_device(device)
        self.metrics = metrics or VerifydMetrics.nop()
        # federation identity: -1 = standalone (response field 6 omitted)
        self.shard_id = int(shard_id)
        if self.shard_id > protocol.MAX_SHARD_ID:
            raise ValueError(f"shard id too large: {self.shard_id}")
        self.max_delay = max_delay
        self.admission = AdmissionController(admission_cap, service_budget)
        self.brownout = brownout or BrownoutController()
        self.tenant_cap = tenant_cap
        self.tenant_pin_quota = tenant_pin_quota
        self.max_tenants = max(1, max_tenants)
        self.slo_breach_after = slo_breach_after
        self.slo_recover_after = slo_recover_after
        self.dyn_batch = bool(dyn_batch)
        self._verify_fns = {
            ALGO_ED25519: (
                verify_fn or functools.partial(crypto_batch.tiered_verify_ed25519, device=self.device),
                crypto_batch.host_verify_ed25519,
            ),
            ALGO_SR25519: (sr25519_verify_fn or self._tiered_sr25519, _host_sr25519_verify),
        }
        self._sched_args = dict(
            max_batch=max_batch,
            max_delay=max_delay,
            max_pending=max_pending,
            continuous=continuous,
            pipeline_depth=pipeline_depth,
            dyn_batch=self.dyn_batch,
        )
        self._schedulers: Dict[int, VerifyScheduler] = {}  # guarded-by: _sched_mtx
        self._sched_mtx = threading.Lock()
        self._depth_mtx = threading.Lock()
        self._class_depth: Dict[int, int] = {}  # guarded-by: _depth_mtx
        self._tenant_mtx = threading.Lock()
        self._tenants: Dict[str, _TenantState] = {}  # guarded-by: _tenant_mtx
        # plain counters for tests and the smoke run; handler threads and
        # the schedulers' dispatch threads all write them
        self._stats_mtx = threading.Lock()
        self.cross_client_flushes: Dict[str, int] = {
            "size": 0, "deadline": 0, "shutdown": 0,
        }  # guarded-by: _stats_mtx
        self.admission_rejections = 0  # guarded-by: _stats_mtx
        self.deadline_expired = 0  # guarded-by: _stats_mtx
        self.requests_served = 0  # guarded-by: _stats_mtx
        self.host_direct_lanes = 0  # guarded-by: _stats_mtx
        self.failed_closed = 0  # requests answered INTERNAL by a failed flush; guarded-by: _stats_mtx
        self.device_refused = 0  # consensus refused while the card cools, fallback off; guarded-by: _stats_mtx
        self.pin_errors = 0  # guarded-by: _stats_mtx
        # requests stamped for a different shard: served, counted
        self.misroutes = 0  # guarded-by: _stats_mtx
        self.route_epoch_seen = 0  # guarded-by: _stats_mtx
        self._grpc = GrpcServer(
            {VERIFY_PATH: self._handle, STATS_PATH: self._handle_stats},
            host, port,
            evloop=evloop,
            evloop_metrics=evloop_metrics,
        )
        # operator-declared p99 targets: pinned, so a wire-declared
        # target (protocol field 8) never loosens them
        for name, slo_ms in (tenant_slos or {}).items():
            ts = self._tenant_for(name)
            with self._tenant_mtx:
                ts.slo_ms = max(0, int(slo_ms))
                ts.slo_pinned = True

    def _tiered_sr25519(self, pks, msgs, sigs) -> List[bool]:
        """Tiered sr25519 dispatch, the ed25519 policy: below the device
        threshold on the host, else K5 on the server's device."""
        if len(pks) < crypto_batch.DEVICE_THRESHOLD:
            return _host_sr25519_verify(pks, msgs, sigs)
        from tendermint_tpu_torch.ops.sr25519_batch import verify_batch_sr

        return list(verify_batch_sr(pks, msgs, sigs, device=self.device))

    # --- lifecycle ----------------------------------------------------------

    @property
    def address(self) -> Tuple[str, int]:
        return self._grpc.address

    @property
    def max_batch(self) -> int:
        return self.scheduler.max_batch

    @property
    def scheduler(self) -> VerifyScheduler:
        """The ed25519 scheduler (the common case; tests poke it)."""
        return self._scheduler_for(ALGO_ED25519)

    def start(self) -> None:
        self._scheduler_for(ALGO_ED25519)  # eager: first request is hot
        self._grpc.start()

    def stop(self) -> None:
        self._grpc.stop()
        with self._sched_mtx:
            scheds, self._schedulers = dict(self._schedulers), {}
        for sched in scheds.values():
            sched.stop()

    def _scheduler_for(self, algo: int) -> VerifyScheduler:
        with self._sched_mtx:
            sched = self._schedulers.get(algo)
            if sched is None:
                verify_fn, host_fn = self._verify_fns[algo]
                sched = VerifyScheduler(
                    verify_fn,
                    fallback_fn=functools.partial(crypto_batch.gated_host_verify,
                                                  ALGO_NAMES[algo], host_fn),
                    on_flush=(
                        lambda reason, batch, seconds, _algo=algo: (
                            self._on_flush(reason, batch, seconds, _algo)
                        )
                    ),
                    on_dispatch=self._on_dispatch,
                    **self._sched_args,
                )
                sched.start()
                self._schedulers[algo] = sched
            return sched

    # --- tenants ------------------------------------------------------------

    def _tenant_for(self, name: str) -> _TenantState:
        """Registry lookup with bounded cardinality: once
        ``max_tenants`` distinct states exist, every unseen tenant maps
        to one shared ``other`` bucket (label and budget both)."""
        with self._tenant_mtx:
            ts = self._tenants.get(name)
            if ts is not None:
                return ts
            distinct = len(set(id(t) for t in self._tenants.values()))
            if distinct >= self.max_tenants:
                ts = self._tenants.get(TENANT_OVERFLOW_LABEL)
                if ts is None:
                    ts = _TenantState(TENANT_OVERFLOW_LABEL)
                    self._tenants[TENANT_OVERFLOW_LABEL] = ts
            else:
                ts = _TenantState(sanitize_tenant_label(name))
            self._tenants[name] = ts
            return ts

    def stats(self) -> Dict[str, object]:
        """Locked snapshot of the wire counters (read here, not from the
        attributes: handler threads write them while requests fly)."""
        with self._sched_mtx:
            sched = self._schedulers.get(ALGO_ED25519)
        knobs = sched.resolved_knobs() if sched is not None else None
        ledger = introspect.accountant.snapshot()
        with self._stats_mtx:
            return {
                "shard_id": self.shard_id,
                "misroutes": self.misroutes,
                "route_epoch_seen": self.route_epoch_seen,
                "requests_served": self.requests_served,
                "admission_rejections": self.admission_rejections,
                "deadline_expired": self.deadline_expired,
                "host_direct_lanes": self.host_direct_lanes,
                "failed_closed": self.failed_closed,
                "device_refused": self.device_refused,
                "pin_errors": self.pin_errors,
                "cross_client_flushes": dict(self.cross_client_flushes),
                "scheduler": knobs,
                "device_bytes": ledger["device_bytes"],
                "compile_events": ledger["compile_events"],
            }

    def scheduler_stats(self) -> Dict[str, dict]:
        """Each live scheduler's counters, by algorithm name."""
        with self._sched_mtx:
            scheds = dict(self._schedulers)
        return {ALGO_NAMES[a]: s.stats() for a, s in sorted(scheds.items())}

    def tenant_stats(self) -> Dict[str, Dict[str, int]]:
        """Per-label accounting snapshot."""
        out: Dict[str, Dict[str, int]] = {}
        with self._tenant_mtx:
            for ts in self._tenants.values():
                if ts.label not in out:
                    out[ts.label] = {
                        "depth": ts.depth,
                        "lanes": ts.lanes,
                        "sheds": ts.sheds,
                        "host_direct": ts.host_direct,
                        "slo_ms": ts.slo_ms,
                        "slo_sheds": ts.slo_sheds,
                        "slo_shedding": ts.slo_shedding,
                        "p99_ms": round(ts.p99 * 1000.0, 3),
                    }
        return out

    def _tenant_shed(self, ts: _TenantState, reason: str) -> None:
        with self._tenant_mtx:
            ts.sheds += 1
        self.metrics.tenant_rejections.labels(tenant=ts.label, reason=reason).inc()

    def _tenant_admit(self, ts: _TenantState, n: int) -> None:
        with self._tenant_mtx:
            ts.depth += n
            ts.lanes += n
            depth = ts.depth
        self.metrics.tenant_lanes.labels(tenant=ts.label).inc(n)
        self.metrics.tenant_queue_depth.labels(tenant=ts.label).set(depth)

    def _tenant_release(self, ts: _TenantState, n: int) -> None:
        with self._tenant_mtx:
            ts.depth = max(0, ts.depth - n)
            depth = ts.depth
        self.metrics.tenant_queue_depth.labels(tenant=ts.label).set(depth)

    def _tenant_budget(self, level: int) -> int:
        """Effective per-tenant outstanding-lane budget at this rung."""
        if level >= LEVEL_SHRINK_SHARES:
            return max(1, self.tenant_cap // _SHRINK_DIVISOR)
        return self.tenant_cap

    # --- per-tenant SLO budgets ---------------------------------------------

    def _tenant_declare_slo(self, ts: _TenantState, slo_ms: int) -> None:
        """Wire-declared target: adopted unless the operator pinned one;
        the tightest wire value wins."""
        if slo_ms <= 0:
            return
        with self._tenant_mtx:
            if ts.slo_pinned:
                return
            if ts.slo_ms == 0 or slo_ms < ts.slo_ms:
                ts.slo_ms = slo_ms

    def _tenant_observe_latency(self, ts: _TenantState, seconds: float,
                                now: Optional[float] = None) -> None:
        """Fold one attributed server-side latency into the tenant's
        sketch and run the breach hysteresis (``now`` injectable)."""
        now = time.monotonic() if now is None else now
        with self._tenant_mtx:
            if len(ts.lat_ring) < _SLO_RING:
                ts.lat_ring.append(seconds)
            else:
                ts.lat_ring[ts.lat_idx] = seconds
                ts.lat_idx = (ts.lat_idx + 1) % _SLO_RING
            ts.lat_new += 1
            if ts.lat_new >= _SLO_RECOMPUTE or ts.p99 == 0.0:
                ts.lat_new = 0
                ordered = sorted(ts.lat_ring)
                ts.p99 = ordered[max(0, int(len(ordered) * 0.99) - 1)]
            if ts.slo_ms <= 0 or ts.slo_shedding:
                return
            if len(ts.lat_ring) >= _SLO_MIN_SAMPLES and ts.p99 > ts.slo_ms / 1000.0:
                if ts.slo_breach_since is None:
                    ts.slo_breach_since = now
                elif now - ts.slo_breach_since >= self.slo_breach_after:
                    ts.slo_shedding = True
                    ts.slo_shed_since = now
                    ts.slo_breach_since = None
                    tracing.instant(
                        "verifyd_tenant_slo_breach",
                        tenant=ts.label,
                        p99_ms=round(ts.p99 * 1000.0, 3),
                        slo_ms=ts.slo_ms,
                    )
            else:
                ts.slo_breach_since = None

    def _tenant_slo_gate(self, ts: _TenantState, now: Optional[float] = None) -> bool:
        """True while the tenant's sheddable classes are SLO-shed; after
        ``slo_recover_after`` the gate opens and the ring resets."""
        now = time.monotonic() if now is None else now
        with self._tenant_mtx:
            if not ts.slo_shedding:
                return False
            if ts.slo_shed_since is not None and now - ts.slo_shed_since >= self.slo_recover_after:
                ts.slo_shedding = False
                ts.slo_shed_since = None
                ts.lat_ring = []
                ts.lat_idx = 0
                ts.lat_new = 0
                ts.p99 = 0.0
                return False
            ts.slo_sheds += 1
            return True

    # --- flush / dispatch observers -----------------------------------------

    def _on_dispatch(self, depth: int, lanes: int, reason: str) -> None:
        self.metrics.dispatch_occupancy.observe(depth)

    def _on_flush(self, reason: str, batch: list, seconds: float, algo: int = ALGO_ED25519) -> None:
        lanes = len(batch)
        self.admission.observe_flush(lanes, seconds)
        self.metrics.flushes.labels(reason=reason).inc()
        self.metrics.batch_occupancy.observe(lanes)
        if algo == ALGO_ED25519:
            # Repeat signers of set-less traffic feed the resident
            # store's hot-key pins, capped per tenant. An error here is
            # counted: silently lost pins would send every lane to K1.
            try:
                by_tenant: Dict[Optional[str], list] = {}
                for p in batch:
                    by_tenant.setdefault(p.tenant, []).append(p.pubkey)
                for tname, pks in by_tenant.items():
                    resident.note_hot_keys(pks, tenant=tname or DEFAULT_TENANT,
                                           quota=self.tenant_pin_quota)
            except Exception as exc:
                with self._stats_mtx:
                    self.pin_errors += 1
                tracing.instant("verifyd_pin_error", error=repr(exc))
        if len({p.tag for p in batch}) > 1:
            with self._stats_mtx:
                self.cross_client_flushes[reason] = self.cross_client_flushes.get(reason, 0) + 1
            self.metrics.cross_client_flushes.labels(reason=reason).inc()

    def _track_depth(self, klass: int, delta: int) -> None:
        with self._depth_mtx:
            depth = self._class_depth.get(klass, 0) + delta
            self._class_depth[klass] = max(0, depth)
            self.metrics.queue_depth.labels(klass=CLASS_NAMES[klass]).set(self._class_depth[klass])

    # --- request handler ----------------------------------------------------

    def _respond(
        self,
        status: int,
        verdicts: List[bool],
        message: str,
        t0: float,
        kind_name: str,
        queue_depth: int = 0,
        tenant_label: str = "",
        stages: Optional[Dict[str, float]] = None,
    ) -> protocol.VerifyResponse:
        with tracing.span("verifyd_respond", status=STATUS_NAMES[status]):
            with self._stats_mtx:
                self.requests_served += 1
            self.metrics.requests.labels(kind=kind_name, status=STATUS_NAMES[status]).inc()
            self.metrics.request_seconds.labels(kind=kind_name).observe(time.monotonic() - t0)
            if tenant_label:
                self.metrics.tenant_request_seconds.labels(tenant=tenant_label).observe(
                    time.monotonic() - t0
                )
            return protocol.VerifyResponse(
                status=status,
                verdicts=verdicts,
                message=message,
                queue_depth=queue_depth,
                stages=protocol.pack_stages(stages) if stages else b"",
                shard_id=self.shard_id,
            )

    def _shed(self, ts: _TenantState, klass_name: str, reason: str, n: int, message: str,
              t0: float, kind_name: str, depth: int) -> protocol.VerifyResponse:
        """Every shed path funnels here: explicit RESOURCE_EXHAUSTED on
        the wire and a reasoned rejection metric per class and tenant."""
        with self._stats_mtx:
            self.admission_rejections += 1
        self._tenant_shed(ts, reason)
        self.metrics.admission_rejections.labels(klass=klass_name, reason=reason).inc()
        tracing.instant("verifyd_shed", klass=klass_name, reason=reason, lanes=n, tenant=ts.label)
        return self._respond(STATUS_RESOURCE_EXHAUSTED, [], message, t0, kind_name, depth,
                             tenant_label=ts.label)

    def _host_direct(self, req, ts: _TenantState, t0: float, kind_name: str,
                     level: int) -> protocol.VerifyResponse:
        """Brownout rungs 4-5: consensus lanes bypass the device
        scheduler and verify on the host oracle — slower, sound, and
        immune to whatever took the card out. Counted here and in the
        health machine's fallback lanes.

        A rung reached by load or by ``force`` is policy. A rung reached
        because the card is cooling down is a device refusal: the host
        answers it only with ``device_policy.shared.host_fallback`` on,
        as the in-process engines would; otherwise the request gets
        ``STATUS_INTERNAL`` naming the refusal (the reference answers it
        on the host)."""
        n = len(req)
        engine = ALGO_NAMES[req.algo]
        if self.brownout.cooling():
            try:
                device_policy.shared.refuse(engine, n)  # counts the fallback when on
            except device_policy.DeviceRefused as exc:
                with self._stats_mtx:
                    self.device_refused += 1
                return self._respond(STATUS_INTERNAL, [], f"verify failed: DeviceRefused: {exc}",
                                     t0, kind_name, 0, tenant_label=ts.label)
        else:
            device_policy.shared.count_fallback(engine, n)
        _verify_fn, host_fn = self._verify_fns[req.algo]
        t_dev0 = time.monotonic()
        with tracing.span("verifyd_host_direct", lanes=n, tenant=ts.label, level=level):
            verdicts = list(host_fn(req.pks, req.msgs, req.sigs))
        t_dev1 = time.monotonic()
        with self._stats_mtx:
            self.host_direct_lanes += n
        with self._tenant_mtx:
            ts.host_direct += n
            ts.lanes += n
        self.metrics.host_direct_lanes.inc(n)
        self.metrics.tenant_lanes.labels(tenant=ts.label).inc(n)
        return self._respond(
            STATUS_OK, verdicts, "", t0, kind_name, 0, tenant_label=ts.label,
            stages={
                "admission": t_dev0 - t0,
                "device": t_dev1 - t_dev0,
                "collect": time.monotonic() - t_dev1,
            },
        )

    def _handle_stats(self, payload: bytes) -> bytes:
        """STATS_PATH unary: one JSON snapshot — wire counters, tenants,
        brownout level, the resident store and its pinned keys, and the
        port's own: each scheduler's counters, the health machine and the
        kernel launch counts of this process. The request payload is
        ignored."""
        del payload
        snap = {
            "shard_id": self.shard_id,
            "stats": self.stats(),
            "tenants": self.tenant_stats(),
            "brownout": self.brownout.snapshot(),
            "resident": resident.stats(),
            "pinned_keys": resident.pinned_keys(),
            "tenant_pins": resident.tenant_pins(),
            "schedulers": self.scheduler_stats(),
            "health": device_policy.shared.snapshot(),
            "launches": {**cuda_verify.LAUNCHES, **cuda_hash.LAUNCHES},
        }
        return json.dumps(snap, sort_keys=True).encode("utf-8")

    def _handle(self, payload: bytes) -> bytes:
        """Decode the wire frame, serve, re-encode."""
        t0 = time.monotonic()
        with tracing.span("verifyd_decode", nbytes=len(payload)):
            try:
                req = protocol.decode_request(payload)
            except ValueError as exc:
                return protocol.encode_response(self._respond(STATUS_INVALID, [], str(exc), t0, "raw"))
        # connection identity for cross-client batching stats: under the
        # event loop many connections share few worker threads, so the
        # transport's per-connection tag is authoritative
        tag = current_conn_tag(threading.get_ident())
        return protocol.encode_response(self._serve(req, t0, tag=tag))

    def _serve(self, req: protocol.VerifyRequest, t0: float,
               tag: Optional[object] = None) -> protocol.VerifyResponse:
        """The serving path under the client's trace context, when the
        request carries one (protocol field 7)."""
        ctx = tracing.TraceContext.from_bytes(req.trace) if req.trace else None
        if ctx is None:
            return self._serve_inner(req, t0, tag, None)
        with tracing.attach(ctx):
            return self._serve_inner(req, t0, tag, ctx)

    def _serve_inner(self, req: protocol.VerifyRequest, t0: float, tag: Optional[object],
                     ctx: Optional[tracing.TraceContext]) -> protocol.VerifyResponse:
        kind_name = "raw"
        t_entry = time.monotonic()
        try:
            kind_name = KIND_NAMES[req.kind]
            klass_name = CLASS_NAMES[req.klass]
            if req.route_epoch:
                with self._stats_mtx:
                    if req.route_epoch > self.route_epoch_seen:
                        self.route_epoch_seen = req.route_epoch
            if req.shard_id >= 0 and self.shard_id >= 0 and req.shard_id != self.shard_id:
                with self._stats_mtx:
                    self.misroutes += 1
                tracing.instant("verifyd_misroute", want=req.shard_id, got=self.shard_id,
                                epoch=req.route_epoch)
            ts = self._tenant_for(req.tenant)
            if req.slo_ms:
                self._tenant_declare_slo(ts, req.slo_ms)
            n = len(req)
            if n == 0:
                return self._respond(STATUS_OK, [], "", t0, kind_name, tenant_label=ts.label)
            sched = self._scheduler_for(req.algo)
            # the caller-observed wire/decode wait is the adaptive
            # controller's shrink signal
            sched.note_queue_wait(t_entry - t0)
            deadline_s = req.deadline_ms / 1000.0 if req.deadline_ms else 0.0

            # load_depth counts in-flight lanes too: on the continuous
            # path lanes leave the accumulator while their dispatch
            # still occupies the card
            depth = sched.load_depth()
            level, moved = self.brownout.observe(self.admission.pressure(depth))
            self.metrics.brownout_level.set(level)
            if moved:
                direction = "up" if moved > 0 else "down"
                self.metrics.brownout_transitions.labels(direction=direction).inc()
                tracing.instant("verifyd_brownout", level=LEVEL_NAMES[level], direction=direction)

            # per-tenant SLO gate, before the load-based ladder
            if req.klass in SHEDDABLE_CLASSES and self._tenant_slo_gate(ts):
                return self._shed(
                    ts, klass_name, "slo", n,
                    f"tenant {ts.label} over SLO budget ({ts.slo_ms}ms p99 target)",
                    t0, kind_name, depth,
                )
            # ladder rungs 1-3: whole-class sheds (rpc -> light ->
            # blocksync; consensus never)
            if level_sheds_class(level, req.klass):
                return self._shed(
                    ts, klass_name, "brownout", n,
                    f"{klass_name} shed (brownout {LEVEL_NAMES[level]})",
                    t0, kind_name, depth,
                )
            # ladder rung 5: the card is out of the loop
            if level >= LEVEL_HOST_CONSENSUS and req.klass == CLASS_CONSENSUS:
                return self._host_direct(req, ts, t0, kind_name, level)

            # per-tenant budget: all-or-nothing for the WHOLE request
            budget = self._tenant_budget(level)
            if req.klass in SHEDDABLE_CLASSES:
                with self._tenant_mtx:
                    over = ts.depth + n > budget
                if over:
                    return self._shed(
                        ts, klass_name, "tenant_budget", n,
                        f"tenant {ts.label} over budget ({budget} lanes)",
                        t0, kind_name, depth,
                    )
            elif level >= LEVEL_SHRINK_SHARES and req.klass == CLASS_CONSENSUS:
                # shrink_shares rung: consensus past the tenant's
                # shrunken share rides the host oracle
                with self._tenant_mtx:
                    over = ts.depth + n > budget
                if over:
                    return self._host_direct(req, ts, t0, kind_name, level)

            shed = self.admission.admit(req.klass, n, depth)
            if shed is not None:
                return self._shed(
                    ts, klass_name, shed, n,
                    f"{klass_name} load shed ({shed}, {depth} pending)",
                    t0, kind_name, depth,
                )

            # the wire deadline (minus a respond margin) becomes the
            # lanes' flush_by
            flush_by = None
            if deadline_s:
                margin = max(0.001, 0.2 * deadline_s)
                flush_by = t0 + max(0.0, deadline_s - margin)
            if tag is None:
                tag = threading.get_ident()
            try:
                with tracing.span("verifyd_enqueue", lanes=n, klass=klass_name, tenant=ts.label):
                    # atomic against max_pending: the group lands whole
                    # or not at all
                    entries = sched.submit_many(
                        list(zip(req.pks, req.msgs, req.sigs)),
                        priority=req.klass,
                        flush_by=flush_by,
                        tag=tag,
                        tenant=ts.label,
                        trace=tracing.current_context() or ctx,
                    )
            except SchedulerSaturatedError as exc:
                return self._shed(ts, klass_name, "saturated", n, str(exc), t0, kind_name,
                                  sched.pending_depth())
            t_submit = time.monotonic()
            self._track_depth(req.klass, n)
            self._tenant_admit(ts, n)
            self.metrics.lanes.labels(klass=klass_name).inc(n)

            try:
                wait_s = deadline_s or DEFAULT_WAIT
                with tracing.span("verifyd_wait", lanes=n):
                    for entry in entries:
                        left = wait_s - (time.monotonic() - t0)
                        if left <= 0 or not entry.done.wait(timeout=left):
                            with self._stats_mtx:
                                self.deadline_expired += 1
                            return self._respond(
                                STATUS_DEADLINE_EXCEEDED, [],
                                f"deadline ({req.deadline_ms or int(DEFAULT_WAIT * 1000)}ms)"
                                " expired awaiting flush",
                                t0, kind_name, sched.pending_depth(), tenant_label=ts.label,
                            )
                errors = [e.error for e in entries if e.error is not None]
                if errors:
                    # the flush failed closed: its False verdicts say
                    # "not verified", so none of them goes on the wire
                    with self._stats_mtx:
                        self.failed_closed += 1
                    err = errors[0]
                    return self._respond(
                        STATUS_INTERNAL, [], f"verify failed: {type(err).__name__}: {err}",
                        t0, kind_name, sched.pending_depth(), tenant_label=ts.label,
                    )
                verdicts = [e.ok for e in entries]
            finally:
                self._track_depth(req.klass, -n)
                self._tenant_release(ts, n)
            # latency attribution: the stage vector tiles the server
            # wall t0 -> now with real span boundaries
            disp = [e.t_dispatch for e in entries if e.t_dispatch > 0.0]
            fin = [e.t_done for e in entries if e.t_done > 0.0]
            t_disp = min(disp) if disp else t_submit
            t_fin = max(fin) if fin else t_disp
            now = time.monotonic()
            stages = {
                "wire_wait": t_entry - t0,
                "admission": t_submit - t_entry,
                "batch_residency": t_disp - t_submit,
                "device": t_fin - t_disp,
                "collect": now - t_fin,
            }
            self._tenant_observe_latency(ts, now - t0, now)
            return self._respond(STATUS_OK, verdicts, "", t0, kind_name, sched.pending_depth(),
                                 tenant_label=ts.label, stages=stages)
        except Exception as exc:  # never tear the stream on a handler bug
            return self._respond(STATUS_INTERNAL, [], repr(exc), t0, kind_name)


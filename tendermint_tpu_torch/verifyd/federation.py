"""Verifyd federation: digest-routed shards, client-side routing.

Counterpart of ``tendermint_tpu/verifyd/federation.py`` without the
reference's lock-checker instrumentation and its environment knob
(``TENDERMINT_TPU_VERIFY_SHARDS``): :func:`set_federation` chooses the
shards. Where the port differs (ROADMAP §C): the last rung of the
failover ladder answers on the host oracle only when host fallback is
on (``device_policy.shared.host_fallback`` or the client's
``fallback=True``); otherwise the group raises
:class:`VerifydUnavailableError`, counted in ``unanswered_lanes``. The
reference answers there on the host in any case.

One verifyd per host was the ceiling: every co-located caller funneled
into a single process and resident precompute tables REPLICATED across
the mesh, so the aggregate device-table budget never grew with the
fleet. This module scales the verification tier out: N verifyd shards
(same host first; the addresses generalise to multi-host) with
**client-side consistent-hash routing keyed by validator-set digest**.

Routing key. ``note_validator_set`` (forwarded from
``crypto/batch.note_validator_set``) digests each activated committee
(sha256 over its sorted pubkeys) and remembers which digest owns each
key. A verify batch is partitioned by owning digest — every lane of a
committee rides to the SAME shard, so that shard's ``note_hot_keys``
pinning sees the committee repeatedly and pins exactly its slice of
resident tables. Keys never seen in a committee route by their own
pk digest. Partitioned, not replicated: each shard's resident tensor
holds a disjoint slice and the fleet's aggregate table budget grows
linearly with shard count (the introspect ledger shows it, owner
``resident_tables`` on device and ``resident_tables_host`` on CPU).

Failover ladder. On a shed (RESOURCE_EXHAUSTED after the shard
client's own shed-retry budget) or a dead shard (transport failure),
the group's keys re-route with jittered exponential backoff down the
ladder: next shard in the ring's preference order for that digest,
then the host oracle as the last rung (only with host fallback on in
the port; otherwise an error) — never a silent drop. A dead
shard is quarantined for ``dead_retry_s`` and re-probed; every
membership flip bumps ``route_epoch`` (protocol field 10) so servers
can count stale-map misroutes.

Transports. Each shard gets its own ``VerifydClient``; the shm
negotiation makes a LOCAL shard ride the slab ring and remote shards
ride TCP, with the 17-byte trace context on every hop.

Health gossip. ``refresh()`` polls each shard's STATS_PATH snapshot
(brownout level, tenant SLO view, pinned slice) and ``stats()`` merges
the per-shard tenant views into ONE fleet view — a tenant's ``p99_ms``
is the fleet max and its ``slo_sheds`` the fleet sum, so an SLO budget
spans the fleet instead of resetting per shard.
"""

from __future__ import annotations

import hashlib
import json
import random
import threading
import time
from bisect import bisect_right
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from tendermint_tpu_torch.libs import tracing
from tendermint_tpu_torch.ops import device_policy
from tendermint_tpu_torch.verifyd.client import (
    VerifydClient,
    VerifydRejectedError,
    VerifydUnavailableError,
    _host_verify,
    current_class,
)
from tendermint_tpu_torch.verifyd.protocol import (
    ALGO_ED25519,
    CLASS_RPC,
    DEFAULT_TENANT,
)

# virtual nodes per shard on the hash ring: enough that a 2-4 shard
# fleet splits key space near-evenly, cheap enough to rebuild on every
# membership change
DEFAULT_VNODES = 64

# quarantine after a transport failure before the shard is re-probed
DEFAULT_DEAD_RETRY_S = 2.0

# first-rung failover pause; doubles per rung, jittered, deadline-capped
DEFAULT_FAILOVER_BACKOFF_S = 0.02

# pk -> owning-digest index bound: a federation client tracking more
# distinct keys than this rebuilds from scratch (committees rotate;
# unbounded growth would be a leak, stale entries only cost locality)
_OWNER_INDEX_CAP = 16384

# gossip snapshot bounds: a misbehaving shard's STATS reply must not be
# able to balloon every peer's fleet view. Oversized snapshots are
# dropped whole (and counted in gossip_rejects) rather than truncated —
# a partial health view is worse than a missing one.
MAX_GOSSIP_TENANTS = 1024  # tenant entries per snapshot
MAX_GOSSIP_SNAPSHOT_BYTES = 256 * 1024  # JSON-encoded snapshot size


def _hash64(data: bytes) -> int:
    return int.from_bytes(hashlib.sha256(data).digest()[:8], "big")


def digest_validator_set(pubkeys: Sequence[bytes]) -> bytes:
    """The routing key of one committee: sha256 over its SORTED pubkeys
    (order-independent — the same set always yields the same digest, so
    the same shard, regardless of vote order)."""
    h = hashlib.sha256()
    for pk in sorted(bytes(p) for p in pubkeys):
        h.update(pk)
    return h.digest()


class HashRing:
    """Consistent-hash ring over shard ids with virtual nodes.

    ``preference(key)`` is the failover ladder order: the vnode walk
    from the key's ring position, deduplicated to distinct shards.
    Because a key's walk never changes, removing a shard moves ONLY
    that shard's keys (each to its next rung) — the minimal-remap
    property the federation tests pin.
    """

    def __init__(self, shard_ids: Sequence[int], vnodes: int = DEFAULT_VNODES):
        if not shard_ids:
            raise ValueError("hash ring needs at least one shard")
        self.shard_ids = tuple(sorted(set(int(s) for s in shard_ids)))
        self.vnodes = max(1, int(vnodes))
        points: List[Tuple[int, int]] = []
        for sid in self.shard_ids:
            for v in range(self.vnodes):
                points.append((_hash64(b"shard:%d:%d" % (sid, v)), sid))
        points.sort()
        self._points = points
        self._hashes = [h for h, _ in points]

    def preference(self, key: bytes) -> List[int]:
        """Distinct shard ids in ring-walk order from ``key``'s
        position — index 0 is the primary, the rest the failover order."""
        start = bisect_right(self._hashes, _hash64(key))
        seen: List[int] = []
        n = len(self._points)
        for i in range(n):
            sid = self._points[(start + i) % n][1]
            if sid not in seen:
                seen.append(sid)
                if len(seen) == len(self.shard_ids):
                    break
        return seen

    def route(self, key: bytes, dead: Optional[set] = None) -> int:
        """Primary shard for ``key`` among live shards: the first rung
        of ``preference`` not in ``dead``. With every shard dead the
        primary is returned anyway — the caller's ladder will fail it
        over to the host oracle."""
        pref = self.preference(key)
        if dead:
            for sid in pref:
                if sid not in dead:
                    return sid
        return pref[0]


class FederationClient:
    """Client-side router over N verifyd shards.

    Call shape matches ``VerifydClient.verify`` — (pks, msgs, sigs) ->
    List[bool] — so it drops into every verify_fn seam. Lanes are
    partitioned by owning validator-set digest, each group rides its
    primary shard, and failures walk the ladder (next shard -> host
    oracle, or an error with host fallback off) with jittered backoff.
    Verdicts merge back in submission order; every lane gets a verdict
    or the call raises — never a silent drop.
    """

    def __init__(
        self,
        shards: Sequence[str],
        tenant: str = DEFAULT_TENANT,
        slo_ms: int = 0,
        timeout: float = 10.0,
        shm: Optional[str] = None,
        vnodes: int = DEFAULT_VNODES,
        dead_retry_s: float = DEFAULT_DEAD_RETRY_S,
        failover_backoff_s: float = DEFAULT_FAILOVER_BACKOFF_S,
        shed_retries: int = 1,
        fallback: bool = False,
    ):
        addrs = [a.strip() for a in shards if a and a.strip()]
        if not addrs:
            raise ValueError("federation needs at least one shard address")
        self.tenant = tenant or DEFAULT_TENANT
        # the last rung answers on the host only when this or the
        # shared health machine's host fallback is on
        self.fallback = bool(fallback)
        self.dead_retry_s = dead_retry_s
        self.failover_backoff_s = failover_backoff_s
        self._clients: List[VerifydClient] = [
            VerifydClient(
                addr,
                timeout=timeout,
                # the federation owns the ladder: a shard client must
                # surface sheds/deaths instead of host-falling-back
                # itself, or keys would silently stop re-routing
                fallback=False,
                tenant=self.tenant,
                slo_ms=slo_ms,
                shm=shm,
                shard_id=i,
                # one in-place shed retry per shard; further patience is
                # the ladder's call (other shards may be idle)
                shed_retries=shed_retries,
            )
            for i, addr in enumerate(addrs)
        ]
        self.ring = HashRing(range(len(addrs)), vnodes=vnodes)
        self._mtx = threading.Lock()
        # shard id -> monotonic re-probe time; present = quarantined
        self._dead: Dict[int, float] = {}  # guarded-by: _mtx
        # pk -> owning validator-set digest (routing locality index)
        self._owner: Dict[bytes, bytes] = {}  # guarded-by: _mtx
        # bumped on every membership flip; rides protocol field 10
        self.route_epoch = 1  # guarded-by: _mtx
        # last refresh()'s per-shard gossip snapshots (health view)
        self._gossip: Dict[int, dict] = {}  # guarded-by: _mtx
        # counters (introspection)
        self.routed_calls = 0  # guarded-by: _mtx
        self.failovers = 0  # guarded-by: _mtx
        self.rerouted_lanes = 0  # guarded-by: _mtx
        self.host_fallback_lanes = 0  # guarded-by: _mtx
        self.unanswered_lanes = 0  # last rung reached, fallback off; guarded-by: _mtx
        self.gossip_rejects = 0  # guarded-by: _mtx
        self._push_epoch(self.route_epoch)

    # --- membership ---------------------------------------------------------

    def _push_epoch(self, epoch: int) -> None:
        for c in self._clients:
            c.route_epoch = epoch

    def _bump_epoch_locked(self) -> None:
        self.route_epoch += 1
        self._push_epoch(self.route_epoch)

    def _mark_dead(self, sid: int) -> None:
        with self._mtx:
            if sid not in self._dead:
                self._bump_epoch_locked()
            self._dead[sid] = time.monotonic() + self.dead_retry_s
        tracing.instant("federation_shard_dead", shard=sid)

    def _mark_alive(self, sid: int) -> None:
        with self._mtx:
            if self._dead.pop(sid, None) is not None:
                self._bump_epoch_locked()
                tracing.instant("federation_shard_alive", shard=sid)

    def _dead_set(self) -> set:
        """Quarantined shards whose re-probe time has NOT passed; an
        expired quarantine lets the shard take primary traffic again
        (the probe — success revives it, failure re-quarantines)."""
        now = time.monotonic()
        with self._mtx:
            return {s for s, t in self._dead.items() if now < t}

    def alive_shards(self) -> List[int]:
        dead = self._dead_set()
        return [i for i in range(len(self._clients)) if i not in dead]

    # --- routing ------------------------------------------------------------

    def note_validator_set(self, pubkeys: Sequence[bytes]) -> bytes:
        """Register a committee: its digest becomes the routing key of
        every member, so a later mixed batch keeps whole committees on
        one shard. Returns the digest (tests pin determinism)."""
        keys = [bytes(p) for p in pubkeys]
        digest = digest_validator_set(keys)
        with self._mtx:
            if len(self._owner) + len(keys) > _OWNER_INDEX_CAP:
                # rotation churn outgrew the index: locality resets,
                # correctness doesn't (unknown keys route by pk digest)
                self._owner.clear()
            for pk in keys:
                self._owner[pk] = digest
        return digest

    def routing_key(self, pk: bytes) -> bytes:
        pk = bytes(pk)
        with self._mtx:
            return self._owner.get(pk, pk)

    def shard_for(self, pk: bytes) -> int:
        """Primary shard for one key right now."""
        return self.ring.route(self.routing_key(pk), dead=self._dead_set())

    # --- the verify seam ----------------------------------------------------

    def verify(
        self,
        pks: Sequence[bytes],
        msgs: Sequence[bytes],
        sigs: Sequence[bytes],
        *,
        algo: int = ALGO_ED25519,
        klass: Optional[int] = None,
        kind: Optional[int] = None,
        deadline: Optional[float] = None,
    ) -> List[bool]:
        if not pks:
            return []
        if klass is None:
            klass = current_class()
            if klass is None:
                klass = CLASS_RPC
        # partition lanes by routing key digest, preserving submission
        # order inside each group so verdicts merge back positionally
        groups: Dict[bytes, List[int]] = {}
        for i, pk in enumerate(pks):
            groups.setdefault(self.routing_key(pk), []).append(i)
        verdicts: List[bool] = [False] * len(pks)
        errors: List[BaseException] = []

        def dispatch(key: bytes, idxs: List[int]) -> None:
            try:
                out = self._verify_group(
                key,
                    [pks[i] for i in idxs],
                    [msgs[i] for i in idxs],
                    [sigs[i] for i in idxs],
                    algo=algo,
                    klass=klass,
                    kind=kind,
                    deadline=deadline,
                )
            except BaseException as exc:  # re-raised on the caller's thread
                errors.append(exc)
                return
            # disjoint index slices per group: no write overlaps
            for i, v in zip(idxs, out):
                verdicts[i] = v

        items = list(groups.items())
        with tracing.span(
            "federation_verify", lanes=len(pks), groups=len(items)
        ):
            if len(items) > 1 and len(self._clients) > 1:
                # a mixed batch spans committees that live on DIFFERENT
                # shards: dispatching the groups concurrently is what
                # makes aggregate throughput scale with the fleet
                # instead of serializing on one client thread; a group's
                # error is raised below, on this thread
                workers = [
                    threading.Thread(
                        target=dispatch, args=(k, ix), daemon=True
                    )
                    for k, ix in items
                ]
                for t in workers:
                    t.start()
                for t in workers:
                    t.join()
            else:
                for k, ix in items:
                    dispatch(k, ix)
        if errors:
            raise errors[0]
        return verdicts

    def _verify_group(
        self,
        key: bytes,
        pks: List[bytes],
        msgs: List[bytes],
        sigs: List[bytes],
        *,
        algo: int,
        klass: int,
        kind: Optional[int],
        deadline: Optional[float],
    ) -> List[bool]:
        """One routing group down the ladder: preference-ordered shards
        (alive first, quarantined last-resort), jittered backoff between
        rungs, the host oracle at the bottom when host fallback is on;
        with it off, a group that no shard answered raises
        ``VerifydUnavailableError``."""
        t0 = time.monotonic()
        budget = deadline if deadline is not None else self._clients[0].timeout
        pref = self.ring.preference(key)
        dead = self._dead_set()
        # alive shards first in ring order, then quarantined ones as a
        # desperation rung before the host oracle (a stale quarantine
        # beats burning host CPU when the shard already recovered)
        ladder = [s for s in pref if s not in dead] + [
            s for s in pref if s in dead
        ]
        delay = self.failover_backoff_s
        for rung, sid in enumerate(ladder):
            remaining = budget - (time.monotonic() - t0)
            if remaining <= 0:
                break
            client = self._clients[sid]
            try:
                out = client.verify(
                    pks, msgs, sigs,
                    algo=algo, klass=klass, kind=kind, deadline=remaining,
                )
            except VerifydUnavailableError:
                self._mark_dead(sid)
            except VerifydRejectedError as exc:
                # a shed (or expired deadline) from a live shard: the
                # shard is up but browning out — walk the ladder
                tracing.instant(
                    "federation_reroute",
                    shard=sid,
                    status=exc.status,
                    lanes=len(pks),
                )
            else:
                self._mark_alive(sid)
                with self._mtx:
                    self.routed_calls += 1
                    if rung > 0:
                        self.failovers += 1
                        self.rerouted_lanes += len(pks)
                return out
            # jittered exponential backoff before the next rung,
            # bounded by the remaining budget
            remaining = budget - (time.monotonic() - t0)
            pause = min(
                delay * (0.5 + random.random() * 0.5), max(0.0, remaining)
            )
            delay *= 2
            if pause > 0:
                time.sleep(pause)
        # last rung: the host oracle, only with host fallback on
        if not (self.fallback or device_policy.shared.host_fallback):
            with self._mtx:
                self.unanswered_lanes += len(pks)
            tracing.instant("federation_unanswered", lanes=len(pks))
            raise VerifydUnavailableError(
                f"no shard of {len(self._clients)} answered {len(pks)} lanes "
                "(host fallback off)"
            )
        with self._mtx:
            self.host_fallback_lanes += len(pks)
        with tracing.span("federation_host_fallback", lanes=len(pks)):
            return _host_verify(algo, pks, msgs, sigs)

    @property
    def verify_fn(self) -> Callable[..., List[bool]]:
        return self.verify

    # --- gossip / fleet stats ----------------------------------------------

    def refresh(self, timeout: float = 2.0) -> Dict[int, dict]:
        """Poll every shard's STATS_PATH snapshot: health, brownout
        level, tenant SLO view, pinned slice. A shard that answers is
        revived; one that doesn't is quarantined. Returns the per-shard
        snapshots (shard id -> gossip dict, absent = unreachable)."""
        snaps: Dict[int, dict] = {}
        for sid, client in enumerate(self._clients):
            try:
                snap = client.server_stats(timeout=timeout)
            except VerifydUnavailableError:
                self._mark_dead(sid)
                continue
            # the shard answered, so it is alive either way; but an
            # oversized snapshot is dropped before it can reach the
            # merged fleet view
            self._mark_alive(sid)
            try:
                snaps[sid] = self._sanitize_snapshot(snap)
            except ValueError:
                with self._mtx:
                    self.gossip_rejects += 1
        with self._mtx:
            self._gossip = dict(snaps)
        return snaps

    @staticmethod
    def _sanitize_snapshot(snap: dict) -> dict:
        """Bound one shard's gossip snapshot before it joins the fleet
        view; raises ValueError when any cap is exceeded."""
        if not isinstance(snap, dict):
            raise ValueError("gossip snapshot is not a dict")
        tenants = snap.get("tenants")
        if isinstance(tenants, dict) and len(tenants) > MAX_GOSSIP_TENANTS:
            raise ValueError(
                f"gossip snapshot lists {len(tenants)} tenants "
                f"> {MAX_GOSSIP_TENANTS}"
            )
        encoded = len(json.dumps(snap, default=str))
        if encoded > MAX_GOSSIP_SNAPSHOT_BYTES:
            raise ValueError(
                f"gossip snapshot {encoded}B > {MAX_GOSSIP_SNAPSHOT_BYTES}B"
            )
        return snap

    def fleet_tenants(self) -> Dict[str, Dict[str, float]]:
        """Merge the last refresh()'s per-shard tenant views into ONE
        fleet view: ``p99_ms`` is the fleet max (the budget verdict a
        tenant actually experiences), counters (``slo_sheds``, ``sheds``,
        ``lanes``, ``host_direct``) sum, ``slo_ms`` keeps the tightest
        declared target, and ``slo_shedding`` is true if ANY shard is
        currently shedding the tenant."""
        with self._mtx:
            gossip = dict(self._gossip)
        fleet: Dict[str, Dict[str, float]] = {}
        for snap in gossip.values():
            tenants = snap.get("tenants")
            if not isinstance(tenants, dict):
                continue
            for label, ts in tenants.items():
                if not isinstance(ts, dict):
                    continue
                agg = fleet.setdefault(
                    label,
                    {
                        "p99_ms": 0.0,
                        "slo_ms": 0,
                        "slo_sheds": 0,
                        "slo_shedding": 0,
                        "sheds": 0,
                        "lanes": 0,
                        "host_direct": 0,
                    },
                )
                agg["p99_ms"] = max(agg["p99_ms"], ts.get("p99_ms", 0.0))
                slo = int(ts.get("slo_ms", 0) or 0)
                if slo and (not agg["slo_ms"] or slo < agg["slo_ms"]):
                    agg["slo_ms"] = slo
                for k in ("slo_sheds", "sheds", "lanes", "host_direct"):
                    agg[k] += int(ts.get(k, 0) or 0)
                if ts.get("slo_shedding"):
                    agg["slo_shedding"] = 1
        return fleet

    def stats(self) -> dict:
        """Fleet snapshot: router counters + per-shard client stats +
        the merged tenant view (a tenant's SLO accounting spans the
        fleet)."""
        with self._mtx:
            dead = set(self._dead)
            gossip = dict(self._gossip)
            out = {
                "shards": len(self._clients),
                "route_epoch": self.route_epoch,
                "routed_calls": self.routed_calls,
                "failovers": self.failovers,
                "rerouted_lanes": self.rerouted_lanes,
                "host_fallback_lanes": self.host_fallback_lanes,
                "unanswered_lanes": self.unanswered_lanes,
                "gossip_rejects": self.gossip_rejects,
                "owner_index_keys": len(self._owner),
            }
        per_shard = []
        for sid, client in enumerate(self._clients):
            snap = gossip.get(sid) or {}
            per_shard.append(
                {
                    "shard_id": sid,
                    "addr": client.addr,
                    "alive": sid not in dead,
                    "transport": client.transport,
                    "client": client.stats(),
                    "brownout": snap.get("brownout"),
                }
            )
        out["per_shard"] = per_shard
        out["fleet_tenants"] = self.fleet_tenants()
        return out

    def memstats_rows(self, timeout: float = 2.0) -> Dict[str, dict]:
        """Fleet roll-up rows for ``ops.introspect.set_fleet_provider``:
        one row per reachable shard, carrying the shard's device-byte
        ledger under the SAME owner labels as the local ledger plus its
        pinned-slice summary — so ``/debug/memstats`` and ``verifyd
        stats`` show partitioned vs replicated placement at a glance."""
        rows: Dict[str, dict] = {}
        for sid, snap in self.refresh(timeout=timeout).items():
            stats = snap.get("stats") if isinstance(snap, dict) else None
            stats = stats if isinstance(stats, dict) else {}
            resident = snap.get("resident") if isinstance(snap, dict) else None
            resident = resident if isinstance(resident, dict) else {}
            rows["shard%d" % sid] = {
                "addr": self._clients[sid].addr,
                "device_bytes": stats.get("device_bytes") or {},
                "pinned_keys": resident.get("pinned_keys", 0),
                "host_staged_bytes": resident.get("host_staged_bytes", 0),
                "requests_served": stats.get("requests_served", 0),
                "misroutes": stats.get("misroutes", 0),
            }
        return rows

    def close(self) -> None:
        for client in self._clients:
            client.close()


# --- process-wide federation backend ----------------------------------------

_fed_mtx = threading.Lock()
_fed_shards: Tuple[str, ...] = ()  # guarded-by: _fed_mtx
_fed_client: Optional[FederationClient] = None  # guarded-by: _fed_mtx
_fed_client_key: Tuple[str, ...] = ()  # guarded-by: _fed_mtx


def _parse_shards(spec: str) -> Tuple[str, ...]:
    return tuple(a.strip() for a in spec.split(",") if a.strip())


def set_federation(shards) -> None:
    """The shard list: a comma-separated string or a sequence of
    ``host:port``; empty clears it."""
    global _fed_shards
    if isinstance(shards, str):
        parsed = _parse_shards(shards)
    else:
        parsed = tuple(a.strip() for a in (shards or ()) if a and a.strip())
    with _fed_mtx:
        _fed_shards = parsed


def reset_federation() -> None:
    """Drop the shard list and the cached client."""
    global _fed_shards, _fed_client, _fed_client_key
    with _fed_mtx:
        _fed_shards = ()
        if _fed_client is not None:
            _fed_client.close()
        _fed_client = None
        _fed_client_key = ()


def federation_backend() -> Optional[Callable[..., List[bool]]]:
    """The configured federation's verify_fn, or None when fewer than
    two shards are configured (a single address is the plain remote
    client's job — ``client.remote_backend``)."""
    client = federation_client()
    return client.verify if client is not None else None


def federation_client() -> Optional[FederationClient]:
    """The process-wide FederationClient, cached and rebuilt when the
    shard list changes; None when unconfigured (< 2 shards)."""
    global _fed_client, _fed_client_key
    with _fed_mtx:
        shards = _fed_shards
        if len(shards) < 2:
            return None
        if _fed_client is None or _fed_client_key != shards:
            if _fed_client is not None:
                _fed_client.close()
            _fed_client = FederationClient(shards)
            _fed_client_key = shards
        return _fed_client


def note_validator_set(pubkeys: Sequence[bytes]) -> None:
    """Routing hook for ``crypto/batch.note_validator_set``: keep the
    committee's keys on one shard. No-op when unfederated."""
    client = federation_client()
    if client is not None:
        client.note_validator_set(pubkeys)

"""verifyd client: pooled, retrying, deadline-propagating.

Counterpart of ``tendermint_tpu/verifyd/client.py`` without the
environment knobs (``TENDERMINT_TPU_VERIFY_REMOTE``, ``_SHM``):
:func:`set_remote_addr` chooses the remote, and ``VerifydClient(shm=)``
(else ``shm.shm_mode()``, ``"auto"`` by default) the transport.

Transport: a client that shares a host with its server attaches to the
server's zero-copy shared-memory ingress (``verifyd/shm.py``) when the
mode is ``auto`` or ``on`` and the server advertises one; ``transport``
then says ``"shm"``. A request rides the slab ring, cut into slab-sized
requests where it is larger than one slab or one TCP request holds
(the reference sends such a request over TCP instead). A full ring or a lost session sends
the request over TCP: a transport retry, counted in ``shm_fallbacks``,
never a verdict answered on the host.

``VerifydClient.verify`` is the wire analog of
``ops.verify_batch(pks, msgs, sigs) -> List[bool]``, so it drops into
every seam that takes a verify_fn: the shared ``VerifyScheduler``
(``crypto/batch.get_shared_scheduler``) and ``Ed25519BatchVerifier``
(and through it ``types/validation.verify_commit``).

Failure semantics: connection loss retries with exponential backoff
across a small channel pool. An admission rejection
(RESOURCE_EXHAUSTED) is a *shed*: the client retries it with jittered
exponential backoff against the REMAINING deadline, up to
``shed_retries``. When the budget or the deadline is spent, or the
server is unreachable, the call raises :class:`VerifydRejectedError`
(with the server's status) or :class:`VerifydUnavailableError`. A
request over :data:`protocol.MAX_LANES` lanes is split into requests of
at most that many, sent one after another, and the verdicts merged.

Where the port differs from the reference (ROADMAP §C): the host
fallback is opt-in. ``VerifydClient(fallback=True)`` answers a failed
call on the host oracle and counts it in ``fallback_calls``, the
reference's default; the port's default is ``False``, the rule its
health machine and shared scheduler follow.

Workload classes ride a thread-local set by :func:`classify` at the
call sites that know the work's nature (consensus commit verification,
blocksync, light-client header checks); the outermost wins.
"""

from __future__ import annotations

import json
import random
import threading
import time
from contextlib import contextmanager
from typing import Callable, List, Optional, Sequence, Tuple

from tendermint_tpu_torch.libs import tracing
from tendermint_tpu_torch.libs.grpc import GrpcChannel, GrpcError, H2ProtocolError
from tendermint_tpu_torch.libs.metrics import VerifydMetrics
from tendermint_tpu_torch.verifyd import protocol
from tendermint_tpu_torch.verifyd import shm as shm_transport
from tendermint_tpu_torch.verifyd.protocol import (
    ALGO_ED25519,
    ALGO_SR25519,
    CLASS_BLOCKSYNC,
    CLASS_CONSENSUS,
    CLASS_LIGHT,
    CLASS_RPC,
    DEFAULT_TENANT,
    KIND_COMMIT,
    KIND_HEADER,
    KIND_RAW,
    STATS_PATH,
    STATUS_NAMES,
    STATUS_OK,
    VERIFY_PATH,
    VerifyRequest,
)

# which request kind a class implies when the caller sets none
_CLASS_KIND = {
    CLASS_CONSENSUS: KIND_COMMIT,
    CLASS_BLOCKSYNC: KIND_COMMIT,
    CLASS_LIGHT: KIND_HEADER,
    CLASS_RPC: KIND_RAW,
}


class VerifydUnavailableError(ConnectionError):
    """Server unreachable after retries (and fallback disabled)."""


class VerifydRejectedError(RuntimeError):
    """Server answered non-OK (admission shed, expired deadline, a
    failed flush)."""

    def __init__(self, status: int, message: str = ""):
        self.status = status
        super().__init__(f"verifyd {STATUS_NAMES.get(status, status)}: {message}")


# --- workload classification (thread-local, outermost wins) ----------------

_tls = threading.local()


@contextmanager
def classify(klass: int):
    """Tag verification work on this thread with a priority class. The
    OUTERMOST classification wins."""
    if getattr(_tls, "klass", None) is not None:
        yield
        return
    _tls.klass = klass
    try:
        yield
    finally:
        _tls.klass = None


def current_class() -> Optional[int]:
    return getattr(_tls, "klass", None)


# --- the client -------------------------------------------------------------


def _host_verify(algo: int, pks, msgs, sigs) -> List[bool]:
    if algo == ALGO_SR25519:
        from tendermint_tpu_torch.crypto.sr25519 import verify as sr_verify

        return [sr_verify(p, m, s) for p, m, s in zip(pks, msgs, sigs)]
    from tendermint_tpu_torch.crypto.ed25519_ref import verify_zip215

    return [verify_zip215(p, m, s) for p, m, s in zip(pks, msgs, sigs)]


class VerifydClient:
    """Pooled blocking client for one verifyd server.

    A small pool of HTTP/2 channels (each carries one call at a time)
    lets concurrent caller threads overlap their wire round-trips,
    which is what gives the server cross-client batches.
    """

    def __init__(
        self,
        addr: str,
        pool_size: int = 4,
        timeout: float = 10.0,
        retries: int = 3,
        backoff: float = 0.05,
        fallback: bool = False,
        tenant: str = DEFAULT_TENANT,
        shed_retries: int = 2,
        shed_backoff: float = 0.02,
        shm: Optional[str] = None,
        metrics: Optional[VerifydMetrics] = None,
        slo_ms: int = 0,
        shard_id: int = -1,
    ):
        host, _, port = addr.rpartition(":")
        if not host or not port.isdigit():
            raise ValueError(f"verifyd address must be host:port, got {addr!r}")
        self.addr = addr
        self._host = host
        self._port = int(port)
        self.timeout = timeout
        self.retries = retries
        self.backoff = backoff
        self.fallback = fallback
        self.tenant = tenant or DEFAULT_TENANT
        # declared p99 target for this tenant's traffic (field 8, 0 = none)
        self.slo_ms = max(0, int(slo_ms))
        # routing identity: the shard this client believes it talks to
        # (-1 = unfederated: fields 9/10 stay off the wire)
        self.shard_id = int(shard_id)
        self.route_epoch = 0
        self.shed_retries = max(0, shed_retries)
        self.shed_backoff = shed_backoff
        self._mtx = threading.Lock()
        self._pool: List[GrpcChannel] = []  # guarded-by: _mtx
        self._free: List[GrpcChannel] = []  # guarded-by: _mtx
        self._pool_size = max(1, pool_size)
        self._available = threading.Condition(self._mtx)
        self.metrics = metrics or VerifydMetrics.nop()
        # counters, written by every caller thread
        self._stats_mtx = threading.Lock()
        self.calls = 0  # guarded-by: _stats_mtx
        self.transport_retries = 0  # guarded-by: _stats_mtx
        self.fallback_calls = 0  # guarded-by: _stats_mtx
        self.shed_retries_used = 0  # guarded-by: _stats_mtx
        self.rejected: dict = {}  # status -> count; guarded-by: _stats_mtx
        # cumulative per-stage seconds from the server's stage vectors
        self.stage_totals: dict = {}  # guarded-by: _stats_mtx
        self.stage_calls = 0  # guarded-by: _stats_mtx
        # zero-copy ingress, attached at the first call when the server
        # shares this host and advertises an endpoint
        if shm is not None and shm not in ("auto", "on", "off"):
            raise ValueError(f"bad shm mode {shm!r}")
        self._shm_param = shm
        self._shm_local = shm_transport.is_local(host)
        self._shm_mtx = threading.Lock()
        self._shm: Optional[shm_transport.ShmClientTransport] = None  # guarded-by: _shm_mtx
        self._shm_next_retry = 0.0  # guarded-by: _shm_mtx
        self.shm_calls = 0  # guarded-by: _shm_mtx
        self.shm_fallbacks = 0  # guarded-by: _shm_mtx
        self.shm_lanes = 0  # guarded-by: _shm_mtx
        self.shm_bytes_avoided = 0  # guarded-by: _shm_mtx

    def shm_mode(self) -> str:
        """The constructor's mode, else the process-wide one (read at
        each call, so ``set_shm_mode`` reaches cached clients too)."""
        return self._shm_param or shm_transport.shm_mode()

    @property
    def transport(self) -> str:
        """``"shm"`` while a slab-ring session is live and the mode is not
        ``"off"``, else ``"tcp"``: what the next call rides."""
        if self.shm_mode() == "off":
            return "tcp"
        with self._shm_mtx:
            t = self._shm
        return "shm" if (t is not None and t.alive) else "tcp"

    def _count(self, field: str, n: int = 1) -> None:
        with self._stats_mtx:
            setattr(self, field, getattr(self, field) + n)

    def stats(self) -> dict:
        """Counter snapshot."""
        with self._shm_mtx:
            shm_stats = {
                "shm_calls": self.shm_calls,
                "shm_fallbacks": self.shm_fallbacks,
                "shm_lanes": self.shm_lanes,
                "shm_bytes_avoided": self.shm_bytes_avoided,
            }
        transport = self.transport
        with self._stats_mtx:
            return {
                **shm_stats,
                "transport": transport,
                "calls": self.calls,
                "transport_retries": self.transport_retries,
                "fallback_calls": self.fallback_calls,
                "shed_retries_used": self.shed_retries_used,
                "rejected": dict(self.rejected),
                "stage_totals": dict(self.stage_totals),
                "stage_calls": self.stage_calls,
            }

    def _acquire(self) -> GrpcChannel:
        with self._available:
            while True:
                if self._free:
                    return self._free.pop()
                if len(self._pool) < self._pool_size:
                    ch = GrpcChannel(self._host, self._port, timeout=self.timeout)
                    self._pool.append(ch)
                    return ch
                self._available.wait(timeout=self.timeout)

    def _release(self, ch: GrpcChannel, broken: bool = False) -> None:
        with self._available:
            if broken:
                if ch in self._pool:
                    self._pool.remove(ch)
                try:
                    ch.close()
                except OSError:
                    pass  # already-dead channel; discard is the point
            else:
                self._free.append(ch)
            self._available.notify()

    def close(self) -> None:
        with self._shm_mtx:
            shm, self._shm = self._shm, None
        if shm is not None:
            shm.close()
        with self._available:
            for ch in self._pool:
                try:
                    ch.close()
                except OSError:
                    pass  # best-effort teardown of a possibly-dead channel
            self._pool.clear()
            self._free.clear()
            self._available.notify_all()

    # --- shm negotiation -----------------------------------------------------

    def _maybe_shm(self) -> Optional[shm_transport.ShmClientTransport]:
        mode = self.shm_mode()
        if mode == "off" or not self._shm_local:
            return None
        with self._shm_mtx:
            t = self._shm
            if t is not None:
                if t.alive:
                    return t
                self._shm = None  # dead session (server restart): renegotiate
            now = time.monotonic()
            if now < self._shm_next_retry:
                return None
            self._shm_next_retry = now + 1.0
            ep = shm_transport.read_endpoint(self._port)
            if ep is None:
                # no advert: the server serves TCP only (or is not up);
                # that is negotiation working, not a fallback, unless
                # the caller asked for shm outright
                if mode == "on":
                    self.shm_fallbacks += 1
                return None
            try:
                new = shm_transport.ShmClientTransport(ep["socket"], ep["token"])
            except shm_transport.ShmError:
                self.shm_fallbacks += 1
                return None
            self._shm = new
            return new

    def _call_shm(self, t: shm_transport.ShmClientTransport, req: VerifyRequest,
                  timeout: float) -> Optional[protocol.VerifyResponse]:
        """The request over the slab ring, or None when it must ride TCP
        (a full ring, a lost session, a lane larger than a slab): each
        such fall back is counted in ``shm_fallbacks``."""
        parts = _slab_parts(req, t.slab_bytes)
        if parts is None:
            with self._shm_mtx:
                self.shm_fallbacks += 1
            return None
        try:
            resp = _merge_parts(req, parts, lambda sub: t.call(sub, timeout=timeout))
        except shm_transport.ShmBusy:
            with self._shm_mtx:
                self.shm_fallbacks += 1
            return None
        except shm_transport.ShmError:
            with self._shm_mtx:
                self.shm_fallbacks += 1
                if self._shm is t:
                    self._shm = None
            t.close()
            return None
        with self._shm_mtx:
            self.shm_calls += 1
            self.shm_lanes += len(req)
            self.shm_bytes_avoided += protocol.encoded_request_size(req)
        self._count("calls")
        return resp

    def _call_transport(self, req: VerifyRequest, timeout: float) -> protocol.VerifyResponse:
        """One exchange over the best transport: the slab ring while a
        session is live, else TCP, as one request or, past MAX_LANES,
        requests of at most that many lanes one after another with
        their verdicts merged."""
        t = self._maybe_shm()
        if t is not None:
            resp = self._call_shm(t, req, timeout)
            if resp is not None:
                return resp
        parts = [(s, min(s + protocol.MAX_LANES, len(req)))
                 for s in range(0, len(req), protocol.MAX_LANES)]
        return _merge_parts(req, parts, lambda sub: self.call(sub, timeout=timeout))

    # --- calls --------------------------------------------------------------

    def call(self, req: VerifyRequest, timeout: Optional[float] = None) -> protocol.VerifyResponse:
        """Send one request, retrying with exponential backoff on
        transport failure; raises VerifydUnavailableError when every
        attempt failed. Server-side non-OK statuses return normally."""
        payload = protocol.encode_request(req)
        timeout = self.timeout if timeout is None else timeout
        delay = self.backoff
        last_exc: Optional[Exception] = None
        for attempt in range(self.retries + 1):
            ch = self._acquire()
            try:
                raw = ch.unary(VERIFY_PATH, payload, timeout=timeout)
            except GrpcError as exc:
                # the server answered (wrong path, handler crash): not a
                # transport problem, retrying the same call won't help
                self._release(ch)
                raise VerifydUnavailableError(f"verifyd {self.addr} errored: {exc}") from exc
            except (OSError, H2ProtocolError) as exc:
                self._release(ch, broken=True)
                last_exc = exc
                if attempt < self.retries:
                    self._count("transport_retries")
                    time.sleep(delay)
                    delay *= 2
                    continue
                raise VerifydUnavailableError(f"verifyd {self.addr} unreachable: {exc}") from exc
            else:
                self._release(ch)
                self._count("calls")
                return protocol.decode_response(raw)
        raise VerifydUnavailableError(f"verifyd {self.addr} unreachable: {last_exc}")

    def server_stats(self, timeout: float = 2.0) -> dict:
        """One STATS_PATH round-trip: the server's JSON snapshot."""
        ch = self._acquire()
        try:
            raw = ch.unary(STATS_PATH, b"", timeout=timeout)
        except GrpcError as exc:
            self._release(ch)
            raise VerifydUnavailableError(f"verifyd {self.addr} stats errored: {exc}") from exc
        except (OSError, H2ProtocolError) as exc:
            self._release(ch, broken=True)
            raise VerifydUnavailableError(f"verifyd {self.addr} stats unreachable: {exc}") from exc
        self._release(ch)
        try:
            snap = json.loads(raw.decode("utf-8"))
        except (UnicodeDecodeError, json.JSONDecodeError) as exc:
            raise VerifydUnavailableError(f"verifyd {self.addr} stats malformed: {exc}") from exc
        if not isinstance(snap, dict):
            raise VerifydUnavailableError(f"verifyd {self.addr} stats malformed: not an object")
        return snap

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
        """Remote batch verify. The class defaults to the thread's
        ``classify`` context (else rpc); the deadline defaults to the
        client timeout and propagates on the wire."""
        if not pks:
            return []
        if klass is None:
            klass = current_class()
            if klass is None:
                klass = CLASS_RPC
        if kind is None:
            kind = _CLASS_KIND.get(klass, KIND_RAW)
        if deadline is None:
            deadline = self.timeout
        t0 = time.monotonic()
        with tracing.span("verifyd_call", lanes=len(pks), klass=klass, algo=algo) as sp:
            # this span's context rides the wire (field 7), so the
            # server's spans link under it
            ctx = tracing.current_context()
            trace_bytes = ctx.to_bytes() if ctx is not None else b""
            delay = self.shed_backoff
            sheds = 0
            while True:
                remaining = deadline - (time.monotonic() - t0)
                if remaining <= 0:
                    resp = protocol.VerifyResponse(
                        status=protocol.STATUS_DEADLINE_EXCEEDED,
                        message="deadline spent across shed retries",
                    )
                    break
                req = VerifyRequest(
                    kind=kind,
                    klass=klass,
                    deadline_ms=max(1, int(remaining * 1000)),
                    algo=algo,
                    pks=list(pks),
                    msgs=list(msgs),
                    sigs=list(sigs),
                    tenant=self.tenant,
                    trace=trace_bytes,
                    slo_ms=self.slo_ms,
                    shard_id=self.shard_id,
                    route_epoch=self.route_epoch,
                )
                try:
                    # transport grace past the verify deadline: the
                    # server answers DEADLINE_EXCEEDED at `deadline`
                    resp = self._call_transport(req, timeout=remaining + 0.5)
                except VerifydUnavailableError:
                    if not self.fallback:
                        raise
                    sp.set(outcome="fallback_unavailable", sheds=sheds)
                    self._count("fallback_calls")
                    return _host_verify(algo, pks, msgs, sigs)
                if resp.status == protocol.STATUS_RESOURCE_EXHAUSTED and sheds < self.shed_retries:
                    # shed: back off (jittered exponential, bounded by
                    # the remaining deadline) and try again
                    sheds += 1
                    self._count("shed_retries_used")
                    remaining = deadline - (time.monotonic() - t0)
                    pause = min(delay * (0.5 + random.random() * 0.5), max(0.0, remaining))
                    delay *= 2
                    if pause > 0:
                        time.sleep(pause)
                    continue
                break
            if resp.status != STATUS_OK or len(resp.verdicts) != len(pks):
                with self._stats_mtx:
                    self.rejected[resp.status] = self.rejected.get(resp.status, 0) + 1
                if not self.fallback:
                    raise VerifydRejectedError(resp.status, resp.message)
                sp.set(outcome=STATUS_NAMES.get(resp.status, "bad"), sheds=sheds)
                self._count("fallback_calls")
                return _host_verify(algo, pks, msgs, sigs)
            sp.set(outcome="ok", sheds=sheds)
            self._note_stages(resp, ctx, time.monotonic() - t0)
            return list(resp.verdicts)

    def _note_stages(self, resp: protocol.VerifyResponse, ctx: Optional[tracing.TraceContext],
                     wall_s: float) -> None:
        """Fold the server's stage-time vector into the
        ``e2e_stage_seconds{stage}`` histograms (trace-ID exemplars);
        the client wall's unattributed remainder is the ``transport``
        pseudo-stage."""
        if not resp.stages:
            return
        stages = protocol.unpack_stages(resp.stages)
        exem = {"trace_id": ctx.trace_id} if ctx is not None else None
        attributed = 0.0
        for stage, v in stages.items():
            attributed += v
            self.metrics.e2e_stage_seconds.labels(stage=stage).observe(v, exemplar=exem)
        overhead = max(0.0, wall_s - attributed)
        self.metrics.e2e_stage_seconds.labels(stage="transport").observe(overhead, exemplar=exem)
        with self._stats_mtx:
            for stage, v in stages.items():
                self.stage_totals[stage] = self.stage_totals.get(stage, 0.0) + v
            self.stage_totals["transport"] = self.stage_totals.get("transport", 0.0) + overhead
            self.stage_calls += 1

    @property
    def verify_fn(self) -> Callable[..., List[bool]]:
        """(pks, msgs, sigs) -> List[bool] for any verify_fn seam."""
        return self.verify


def _slab_parts(req: VerifyRequest, slab_bytes: int) -> Optional[List[Tuple[int, int]]]:
    """Cut ``req``'s lanes into runs that each fit one slab and one TCP
    request (at most ``protocol.MAX_LANES`` lanes, which a server's
    default ``max_pending`` admits whole, and ``slab_bytes`` bytes);
    None when one lane alone is larger than a slab."""
    fixed = protocol.PUBKEY_SIZE + protocol.SIG_SIZE + 4
    room = slab_bytes - shm_transport.SLAB_HEADER_BYTES
    cap = min(shm_transport.SHM_MAX_LANES, protocol.MAX_LANES)
    parts: List[Tuple[int, int]] = []
    start, used = 0, 0
    for i, m in enumerate(req.msgs):
        need = fixed + len(m)
        if need > room:
            return None
        if i - start >= cap or used + need > room:
            parts.append((start, i))
            start, used = i, 0
        used += need
    parts.append((start, len(req)))
    return parts


def _merge_parts(req: VerifyRequest, parts: List[Tuple[int, int]],
                 send: Callable[[VerifyRequest], protocol.VerifyResponse]
                 ) -> protocol.VerifyResponse:
    """Send ``req`` as one request per ``(start, end)`` lane run, one
    after another, and merge the verdicts; the first non-OK answer is
    returned as it is."""
    if len(parts) == 1:
        return send(req)
    verdicts: List[bool] = []
    depth = 0
    stage_acc: dict = {}
    for start, end in parts:
        sub = VerifyRequest(
            kind=req.kind,
            klass=req.klass,
            deadline_ms=req.deadline_ms,
            algo=req.algo,
            pks=list(req.pks[start:end]),
            msgs=list(req.msgs[start:end]),
            sigs=list(req.sigs[start:end]),
            tenant=req.tenant,
            trace=req.trace,  # every split rides the same trace
            slo_ms=req.slo_ms,
            shard_id=req.shard_id,
            route_epoch=req.route_epoch,
        )
        resp = send(sub)
        if resp.status != STATUS_OK:
            return resp
        verdicts.extend(resp.verdicts)
        depth = max(depth, resp.queue_depth)
        for stage, v in protocol.unpack_stages(resp.stages).items():
            stage_acc[stage] = stage_acc.get(stage, 0.0) + v
    return protocol.VerifyResponse(
        status=STATUS_OK, verdicts=verdicts, queue_depth=depth,
        stages=protocol.pack_stages(stage_acc) if stage_acc else b"",
    )


# --- process-wide remote backend -------------------------------------------

_remote_mtx = threading.Lock()
_remote_addr: str = ""  # guarded-by: _remote_mtx
_remote_tenant: str = DEFAULT_TENANT  # guarded-by: _remote_mtx
_remote_client: Optional[VerifydClient] = None  # guarded-by: _remote_mtx
_remote_client_key: tuple = ("", DEFAULT_TENANT)  # guarded-by: _remote_mtx


def set_remote_addr(addr: str) -> None:
    """The remote verifier's ``host:port``; empty clears it."""
    global _remote_addr
    with _remote_mtx:
        _remote_addr = addr or ""


def set_remote_tenant(tenant: str) -> None:
    """Tenant/chain namespace this node's remote traffic rides under
    (empty = default)."""
    global _remote_tenant
    with _remote_mtx:
        _remote_tenant = tenant or DEFAULT_TENANT


def reset_remote() -> None:
    """Drop the address, the tenant and the cached client."""
    global _remote_addr, _remote_tenant, _remote_client, _remote_client_key
    with _remote_mtx:
        _remote_addr = ""
        _remote_tenant = DEFAULT_TENANT
        if _remote_client is not None:
            _remote_client.close()
        _remote_client = None
        _remote_client_key = ("", DEFAULT_TENANT)


def remote_client() -> Optional[VerifydClient]:
    """The process-wide client of the configured remote, or None. It is
    cached and rebuilt when the address or tenant changes."""
    global _remote_client, _remote_client_key
    with _remote_mtx:
        if not _remote_addr:
            return None
        key = (_remote_addr, _remote_tenant)
        if _remote_client is None or _remote_client_key != key:
            if _remote_client is not None:
                _remote_client.close()
            _remote_client = VerifydClient(_remote_addr, tenant=_remote_tenant)
            _remote_client_key = key
        return _remote_client


def remote_backend() -> Optional[Callable[..., List[bool]]]:
    """The configured remote's verify_fn, or None."""
    client = remote_client()
    return None if client is None else client.verify


def remote_transport() -> Optional[str]:
    """The process-wide remote client's transport (``"shm"`` or
    ``"tcp"``), or None when no remote is configured. It attaches to
    shm first, so a start-up banner says what the first verify call
    rides."""
    client = remote_client()
    if client is None:
        return None
    client._maybe_shm()
    return client.transport

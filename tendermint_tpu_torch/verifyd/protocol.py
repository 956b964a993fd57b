"""verifyd wire protocol: compact length-delimited request/response.

Counterpart of ``tendermint_tpu/verifyd/protocol.py``, whole: the same
requests and responses encode to the same bytes in both packages.

Rides the repo's own protobuf wire codec (encoding/proto.py) over the
zero-dependency gRPC transport (libs/grpc.py) — one unary method:

    /tendermint.verifyd.Verifier/Verify

Request (proto wire form):
    1  kind      varint   VERIFY_RAW | VERIFY_COMMIT | VERIFY_HEADER
    2  klass     varint   priority class: consensus < blocksync < light < rpc
                          (lower value = higher priority; the wire value
                          is class+1 so consensus=0 survives proto3
                          zero-omission — absent defaults to rpc)
    3  deadline  varint   relative deadline in ms (0 = none); relative —
                          not absolute — so no clock sync is assumed
    4  algo      varint   ed25519 | sr25519
    5  lanes     repeated message { 1 pk, 2 msg, 3 sig }
    6  tenant    string   chain/tenant namespace; OMITTED when it equals
                          the default tenant (proto3 zero-omission: an
                          old client that never sets it emits frames
                          byte-identical to before the field existed,
                          and the decoder maps absence back to
                          DEFAULT_TENANT)
    7  trace     bytes    compact trace context (libs/tracing.
                          TraceContext.to_bytes(): 8B trace_id + 8B
                          span_id + 1B flags); OMITTED when the caller
                          has no active trace, so an untraced client
                          emits frames byte-identical to before the
                          field existed and the decoder maps absence
                          back to the empty (no-trace) default
    8  slo_ms    varint   tenant p99 latency target in ms (the SLO the
                          adaptive server holds this tenant's budget
                          to); 0 = no declared target and is OMITTED
                          (zero-omission: a pre-SLO client emits frames
                          byte-identical to before the field existed,
                          and the decoder maps absence back to 0)
    9  shard     varint   federation shard id the router targeted; the
                          wire value is shard_id+1 so shard 0 survives
                          proto3 zero-omission — absent (an unfederated
                          client) defaults to -1 ("unrouted") and an
                          unfederated client's frames stay byte-
                          identical to before the field existed
    10 epoch     varint   routing epoch of the client's shard map at
                          send time (bumped on every membership change);
                          0 = unfederated and is OMITTED (zero-omission:
                          absence maps back to 0), so the server can
                          count misroutes without trusting clocks

Response:
    1  status       varint   OK | RESOURCE_EXHAUSTED | DEADLINE_EXCEEDED
                             | INVALID | INTERNAL
    2  verdicts     bytes    one byte per lane (1 = valid), only on OK
    3  message      string   human-readable detail on non-OK
    4  queue_depth  varint   server pending depth at respond time
                             (client-side load hint)
    5  stages       bytes    stage-time vector (pack_stages: one f32 of
                             seconds per STAGE_NAMES entry, in order);
                             OMITTED when the server recorded none, so
                             old servers' frames are byte-identical
    6  shard        varint   the responding server's shard id, +1 on the
                             wire (same shift as request field 9); absent
                             (pre-federation server) decodes to -1

``kind`` is advisory: commit semantics (tallying, sign-bytes
construction) stay on the client; the server sees only raw lanes, so
every kind funnels into the same shared scheduler. The kind labels
metrics and picks the default class when the caller sets none.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, List

from tendermint_tpu_torch.encoding.proto import (
    WIRE_BYTES,
    WIRE_VARINT,
    Reader,
    encode_bytes_field,
    encode_varint_field,
    encode_string_field,
)

VERIFY_PATH = "/tendermint.verifyd.Verifier/Verify"
# unary stats/gossip endpoint: empty request payload, JSON response
# (server stats + tenant stats + brownout snapshot + shard identity).
# The federation client polls this to refresh per-shard health.
STATS_PATH = "/tendermint.verifyd.Verifier/Stats"

# request kinds
KIND_RAW = 1
KIND_COMMIT = 2
KIND_HEADER = 3
KIND_NAMES = {KIND_RAW: "raw", KIND_COMMIT: "commit", KIND_HEADER: "header"}

# priority classes (lower value = flushed first when over-subscribed)
CLASS_CONSENSUS = 0
CLASS_BLOCKSYNC = 1
CLASS_LIGHT = 2
CLASS_RPC = 3
CLASS_NAMES = {
    CLASS_CONSENSUS: "consensus",
    CLASS_BLOCKSYNC: "blocksync",
    CLASS_LIGHT: "light",
    CLASS_RPC: "rpc",
}
# classes the admission controller may shed; consensus/blocksync always
# get through (shedding them stalls the chain, not just a reader)
SHEDDABLE_CLASSES = (CLASS_LIGHT, CLASS_RPC)

# signature algorithms
ALGO_ED25519 = 0
ALGO_SR25519 = 1
ALGO_NAMES = {ALGO_ED25519: "ed25519", ALGO_SR25519: "sr25519"}

# response statuses
STATUS_OK = 0
STATUS_RESOURCE_EXHAUSTED = 1
STATUS_DEADLINE_EXCEEDED = 2
STATUS_INVALID = 3
STATUS_INTERNAL = 4
STATUS_NAMES = {
    STATUS_OK: "ok",
    STATUS_RESOURCE_EXHAUSTED: "resource_exhausted",
    STATUS_DEADLINE_EXCEEDED: "deadline_exceeded",
    STATUS_INVALID: "invalid",
    STATUS_INTERNAL: "internal",
}

PUBKEY_SIZE = 32  # ed25519 and sr25519 (ristretto) public keys
SIG_SIZE = 64
MAX_LANES = 4096  # hard per-request cap; larger batches split client-side
MAX_MSG_SIZE = 1 << 20  # 1 MiB per lane message

# tenant namespace: pre-tenant clients never send field 6, so the
# decoder must map absence to this — and the encoder must OMIT it when
# it equals this, or old servers would see an unknown field where old
# clients sent none (the zero-omission symmetry).
DEFAULT_TENANT = "default"
MAX_TENANT_LEN = 64  # wire-level cap; the server additionally hashes/caps

# trace context: pre-trace clients never send field 7, so the decoder
# must map absence to the empty (no-trace) default — and the encoder
# must OMIT it when empty, the same zero-omission symmetry as tenant.
MAX_TRACE_LEN = 64  # wire-level cap; today's context is 17 bytes

# tenant SLO declaration (field 8): 0 = no target, omitted on the wire
# (zero-omission symmetry again). Capped so a hostile client can't
# declare an absurd target that skews the server's budget arithmetic.
MAX_SLO_MS = 600_000  # 10 minutes — far beyond any real latency SLO

# request deadline (field 3): 0 = no deadline (server default applies).
# Capped like slo_ms — the server turns this straight into blocking
# waits (`entry.done.wait(timeout=...)`), so an uncapped 64-bit varint
# would let one request pin a stream worker for centuries.
MAX_DEADLINE_MS = 600_000  # same 10-minute ceiling as MAX_SLO_MS

# federation routing (fields 9/10): shard ids are small ordinals into
# the operator's --shards list; the epoch is a monotone counter bumped
# on membership change. Both capped so a hostile client can't make the
# server's misroute bookkeeping allocate per absurd value.
MAX_SHARD_ID = 4095  # fleet fan-out ceiling, far beyond any real mesh
MAX_ROUTE_EPOCH = 1 << 31

# End-to-end latency attribution stage vector (response field 5), in
# wire order. Each stage is one f32 of seconds summed from the server's
# real spans; together they account for the server-side request wall.
STAGE_NAMES = ("wire_wait", "admission", "batch_residency", "device", "collect")
_STAGES_STRUCT = struct.Struct("<%df" % len(STAGE_NAMES))


def pack_stages(stages: Dict[str, float]) -> bytes:
    """Stage dict -> wire vector (missing stages pack as 0.0)."""
    return _STAGES_STRUCT.pack(
        *(max(0.0, float(stages.get(name, 0.0))) for name in STAGE_NAMES)
    )


def unpack_stages(raw: bytes) -> Dict[str, float]:
    """Wire vector -> stage dict; empty/short input yields {} (an old
    server that never sent field 5)."""
    if len(raw) < _STAGES_STRUCT.size:
        return {}
    vals = _STAGES_STRUCT.unpack_from(raw)
    return dict(zip(STAGE_NAMES, vals))


@dataclass
class VerifyRequest:
    kind: int = KIND_RAW
    klass: int = CLASS_RPC
    deadline_ms: int = 0
    algo: int = ALGO_ED25519
    pks: List[bytes] = field(default_factory=list)
    msgs: List[bytes] = field(default_factory=list)
    sigs: List[bytes] = field(default_factory=list)
    tenant: str = DEFAULT_TENANT
    trace: bytes = b""
    slo_ms: int = 0
    shard_id: int = -1
    route_epoch: int = 0

    def __len__(self) -> int:
        return len(self.pks)


@dataclass
class VerifyResponse:
    status: int = STATUS_OK
    verdicts: List[bool] = field(default_factory=list)
    message: str = ""
    queue_depth: int = 0
    stages: bytes = b""
    shard_id: int = -1


def _encode_lane(pk: bytes, msg: bytes, sig: bytes) -> bytes:
    return (
        encode_bytes_field(1, pk)
        + encode_bytes_field(2, msg)
        + encode_bytes_field(3, sig)
    )


def encode_request(req: VerifyRequest) -> bytes:
    out = bytearray()
    if req.kind:
        out += encode_varint_field(1, req.kind)
    # klass rides the wire +1: CLASS_CONSENSUS is 0, and proto3
    # zero-omission would otherwise make it indistinguishable from
    # "unset" (which defaults to the sheddable rpc class)
    out += encode_varint_field(2, req.klass + 1)
    if req.deadline_ms:
        out += encode_varint_field(3, req.deadline_ms)
    if req.algo:
        out += encode_varint_field(4, req.algo)
    for pk, msg, sig in zip(req.pks, req.msgs, req.sigs):
        out += encode_bytes_field(5, _encode_lane(pk, msg, sig))
    if req.tenant and req.tenant != DEFAULT_TENANT:
        out += encode_string_field(6, req.tenant)
    if req.trace:
        out += encode_bytes_field(7, req.trace)
    if req.slo_ms:
        out += encode_varint_field(8, req.slo_ms)
    # shard id rides the wire +1: shard 0 is a legal target, and proto3
    # zero-omission would otherwise make it indistinguishable from
    # "unrouted" (-1, the pre-federation default) — same shift as klass
    if req.shard_id >= 0:
        out += encode_varint_field(9, req.shard_id + 1)
    if req.route_epoch:
        out += encode_varint_field(10, req.route_epoch)
    return bytes(out)


def _varint_size(value: int) -> int:
    size = 1
    while value > 0x7F:
        value >>= 7
        size += 1
    return size


def encoded_request_size(req: VerifyRequest) -> int:
    """Exact byte length ``encode_request(req)`` would produce, computed
    without materialising the frame.  The reference's shm transport
    (not ported) uses this to report ``codec_bytes_avoided`` honestly — it is the TCP codec cost
    the slab path skipped, per the same zero-omission rules the encoder
    applies (klass rides +1, default tenant omitted)."""
    size = 0
    if req.kind:
        size += 1 + _varint_size(req.kind)
    size += 1 + _varint_size(req.klass + 1)
    if req.deadline_ms:
        size += 1 + _varint_size(req.deadline_ms)
    if req.algo:
        size += 1 + _varint_size(req.algo)
    for pk, msg, sig in zip(req.pks, req.msgs, req.sigs):
        lane = 0
        for part in (pk, msg, sig):
            if part:  # empty bytes fields are omitted entirely
                lane += 1 + _varint_size(len(part)) + len(part)
        size += 1 + _varint_size(lane) + lane
    if req.tenant and req.tenant != DEFAULT_TENANT:
        tenant = req.tenant.encode("utf-8")
        size += 1 + _varint_size(len(tenant)) + len(tenant)
    if req.trace:
        size += 1 + _varint_size(len(req.trace)) + len(req.trace)
    if req.slo_ms:
        size += 1 + _varint_size(req.slo_ms)
    if req.shard_id >= 0:
        size += 1 + _varint_size(req.shard_id + 1)
    if req.route_epoch:
        size += 1 + _varint_size(req.route_epoch)
    return size


def decode_request(data: bytes) -> VerifyRequest:
    """Decode + validate; raises ValueError on any malformed input so the
    server can answer STATUS_INVALID instead of crashing a stream."""
    req = VerifyRequest(kind=KIND_RAW, klass=CLASS_RPC)
    try:
        r = Reader(data)
        for fld, wire in r.fields():
            if fld == 1 and wire == WIRE_VARINT:
                req.kind = r.read_varint()
            elif fld == 2 and wire == WIRE_VARINT:
                req.klass = r.read_varint() - 1
            elif fld == 3 and wire == WIRE_VARINT:
                req.deadline_ms = r.read_varint()
            elif fld == 4 and wire == WIRE_VARINT:
                req.algo = r.read_varint()
            elif fld == 5 and wire == WIRE_BYTES:
                pk = msg = sig = None
                lane = Reader(r.read_bytes())
                for lfld, lwire in lane.fields():
                    if lfld == 1 and lwire == WIRE_BYTES:
                        pk = lane.read_bytes()
                    elif lfld == 2 and lwire == WIRE_BYTES:
                        msg = lane.read_bytes()
                    elif lfld == 3 and lwire == WIRE_BYTES:
                        sig = lane.read_bytes()
                    else:
                        lane.skip(lwire)
                if pk is None or sig is None:
                    raise ValueError("lane missing pk/sig")
                req.pks.append(pk)
                # proto3 zero-omission: an absent msg and an explicitly
                # empty one are the same lane (signing empty messages is
                # legal), so both decode to b"" — otherwise an empty msg
                # round-trips into a frame the decoder rejects
                req.msgs.append(msg or b"")
                req.sigs.append(sig)
            elif fld == 6 and wire == WIRE_BYTES:
                req.tenant = r.read_bytes().decode("utf-8", "replace")
            elif fld == 7 and wire == WIRE_BYTES:
                req.trace = r.read_bytes()
            elif fld == 8 and wire == WIRE_VARINT:
                req.slo_ms = r.read_varint()
            elif fld == 9 and wire == WIRE_VARINT:
                # -1 undoes the wire shift; 0 on the wire never occurs
                # (the encoder omits unrouted requests entirely), so
                # absence and the dataclass default agree on -1
                req.shard_id = r.read_varint() - 1
            elif fld == 10 and wire == WIRE_VARINT:
                req.route_epoch = r.read_varint()
            else:
                r.skip(wire)
    except ValueError:
        raise
    except Exception as exc:  # torn varints etc. from the Reader
        raise ValueError(f"malformed request: {exc}") from exc
    # absence (old client) and the empty string both mean the default
    # tenant — re-establishing the encoder's omitted constant
    req.tenant = req.tenant or DEFAULT_TENANT
    # absence (pre-trace client) means no trace context — re-establish
    # the encoder's omitted empty default the same way
    req.trace = req.trace or b""
    # absence (pre-SLO client) means no declared target
    req.slo_ms = req.slo_ms or 0
    # absence (unfederated client) means no routing epoch
    req.route_epoch = req.route_epoch or 0
    if req.deadline_ms > MAX_DEADLINE_MS:
        raise ValueError(f"deadline_ms too large: {req.deadline_ms}")
    if req.slo_ms > MAX_SLO_MS:
        raise ValueError(f"slo_ms too large: {req.slo_ms}")
    if req.shard_id > MAX_SHARD_ID:
        raise ValueError(f"shard id too large: {req.shard_id}")
    if req.route_epoch > MAX_ROUTE_EPOCH:
        raise ValueError(f"route epoch too large: {req.route_epoch}")
    if len(req.tenant) > MAX_TENANT_LEN:
        raise ValueError(f"tenant name too long: {len(req.tenant)}")
    if len(req.trace) > MAX_TRACE_LEN:
        raise ValueError(f"trace context too long: {len(req.trace)}")
    if req.kind not in KIND_NAMES:
        raise ValueError(f"unknown kind {req.kind}")
    if req.klass not in CLASS_NAMES:
        raise ValueError(f"unknown class {req.klass}")
    if req.algo not in ALGO_NAMES:
        raise ValueError(f"unknown algo {req.algo}")
    if len(req.pks) > MAX_LANES:
        raise ValueError(f"too many lanes: {len(req.pks)} > {MAX_LANES}")
    for pk, msg, sig in zip(req.pks, req.msgs, req.sigs):
        if len(pk) != PUBKEY_SIZE:
            raise ValueError(f"bad pubkey size {len(pk)}")
        if len(sig) != SIG_SIZE:
            raise ValueError(f"bad signature size {len(sig)}")
        if len(msg) > MAX_MSG_SIZE:
            raise ValueError(f"lane message too large: {len(msg)}")
    return req


def encode_response(resp: VerifyResponse) -> bytes:
    out = bytearray()
    if resp.status:
        out += encode_varint_field(1, resp.status)
    if resp.verdicts:
        out += encode_bytes_field(
            2, bytes(1 if ok else 0 for ok in resp.verdicts)
        )
    if resp.message:
        out += encode_string_field(3, resp.message)
    if resp.queue_depth:
        out += encode_varint_field(4, resp.queue_depth)
    if resp.stages:
        out += encode_bytes_field(5, resp.stages)
    # same +1 shift as request field 9: shard 0 must survive
    # zero-omission, and an unfederated server omits the field so its
    # frames stay byte-identical to before it existed
    if resp.shard_id >= 0:
        out += encode_varint_field(6, resp.shard_id + 1)
    return bytes(out)


def decode_response(data: bytes) -> VerifyResponse:
    resp = VerifyResponse()
    try:
        r = Reader(data)
        for fld, wire in r.fields():
            if fld == 1 and wire == WIRE_VARINT:
                resp.status = r.read_varint()
            elif fld == 2 and wire == WIRE_BYTES:
                resp.verdicts = [b == 1 for b in r.read_bytes()]
            elif fld == 3 and wire == WIRE_BYTES:
                resp.message = r.read_bytes().decode("utf-8", "replace")
            elif fld == 4 and wire == WIRE_VARINT:
                resp.queue_depth = r.read_varint()
            elif fld == 5 and wire == WIRE_BYTES:
                resp.stages = r.read_bytes()
            elif fld == 6 and wire == WIRE_VARINT:
                resp.shard_id = r.read_varint() - 1
            else:
                r.skip(wire)
    except Exception as exc:
        raise ValueError(f"malformed response: {exc}") from exc
    # absence (old server) means no stage vector
    resp.stages = resp.stages or b""
    if resp.status not in STATUS_NAMES:
        raise ValueError(f"unknown status {resp.status}")
    if resp.shard_id > MAX_SHARD_ID:
        raise ValueError(f"shard id too large: {resp.shard_id}")
    return resp

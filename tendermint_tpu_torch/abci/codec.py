"""Wire codec for the ABCI socket and gRPC transports.

A copy of ``tendermint_tpu/abci/codec.py``, byte for byte on the wire,
so a port node drives a JAX app process and the reverse. The reference
frames varint-delimited protobuf Request/Response unions
(abci/client/socket_client.go:417, abci/server/socket_server.go:317).
Here frames are 4-byte big-endian length + a JSON document
`{"kind": ..., "type": <method>, "body": {...}}`; message bodies are
encoded by dataclass reflection (bytes as base64, nested dataclasses
recursively, `object`-typed params fields via an override table). Same
transport semantics — ordered request/response streams per connection
with `flush` — with a self-describing encoding in place of generated
protos.
"""

from __future__ import annotations

import base64
import json
import struct
import typing
from dataclasses import fields, is_dataclass
from typing import Any, Optional, Tuple

from tendermint_tpu_torch.abci import types as abci
from tendermint_tpu_torch.encoding.canonical import Timestamp
from tendermint_tpu_torch.types.params import ConsensusParams, ConsensusParamsUpdate

FRAME_HDR = struct.Struct(">I")
MAX_FRAME = 64 << 20

# method name -> (request class, response class); echo/flush are special.
METHODS = {
    "info": (abci.RequestInfo, abci.ResponseInfo),
    "query": (abci.RequestQuery, abci.ResponseQuery),
    "check_tx": (abci.RequestCheckTx, abci.ResponseCheckTx),
    "init_chain": (abci.RequestInitChain, abci.ResponseInitChain),
    "prepare_proposal": (abci.RequestPrepareProposal, abci.ResponsePrepareProposal),
    "process_proposal": (abci.RequestProcessProposal, abci.ResponseProcessProposal),
    "extend_vote": (abci.RequestExtendVote, abci.ResponseExtendVote),
    "verify_vote_extension": (
        abci.RequestVerifyVoteExtension,
        abci.ResponseVerifyVoteExtension,
    ),
    "finalize_block": (abci.RequestFinalizeBlock, abci.ResponseFinalizeBlock),
    "commit": (type(None), abci.ResponseCommit),
    "list_snapshots": (abci.RequestListSnapshots, abci.ResponseListSnapshots),
    "offer_snapshot": (abci.RequestOfferSnapshot, abci.ResponseOfferSnapshot),
    "load_snapshot_chunk": (
        abci.RequestLoadSnapshotChunk,
        abci.ResponseLoadSnapshotChunk,
    ),
    "apply_snapshot_chunk": (
        abci.RequestApplySnapshotChunk,
        abci.ResponseApplySnapshotChunk,
    ),
}

# (class, field) -> concrete type for fields hinted `object` in types.py.
_FIELD_OVERRIDES = {
    (abci.RequestInitChain, "consensus_params"): ConsensusParams,
    (abci.ResponseInitChain, "consensus_params"): ConsensusParams,
    (abci.ResponsePrepareProposal, "consensus_param_updates"): ConsensusParamsUpdate,
    (abci.ResponseFinalizeBlock, "consensus_param_updates"): ConsensusParamsUpdate,
}


def encode_obj(v: Any) -> Any:
    if isinstance(v, bytes):
        return {"__b": base64.b64encode(v).decode()}
    if is_dataclass(v) and not isinstance(v, type):
        return {f.name: encode_obj(getattr(v, f.name)) for f in fields(v)}
    if isinstance(v, (list, tuple)):
        return [encode_obj(x) for x in v]
    return v


def _resolve_hint(cls, name: str, hint: Any) -> Any:
    override = _FIELD_OVERRIDES.get((cls, name))
    if override is not None:
        return override
    return hint


def decode_obj(tp: Any, v: Any) -> Any:
    if v is None:
        return None
    origin = typing.get_origin(tp)
    if origin is typing.Union:  # Optional[X]
        args = [a for a in typing.get_args(tp) if a is not type(None)]
        return decode_obj(args[0], v) if args else v
    if tp is bytes:
        return base64.b64decode(v["__b"]) if isinstance(v, dict) else b""
    if origin in (list, tuple):
        (arg,) = typing.get_args(tp) or (Any,)
        return [decode_obj(arg, x) for x in v]
    if isinstance(tp, type) and is_dataclass(tp):
        hints = typing.get_type_hints(tp)
        kwargs = {}
        for f in fields(tp):
            if f.name not in v:
                continue
            kwargs[f.name] = decode_obj(
                _resolve_hint(tp, f.name, hints.get(f.name, Any)), v[f.name]
            )
        return tp(**kwargs)
    if isinstance(v, dict) and "__b" in v:
        return base64.b64decode(v["__b"])
    return v


def encode_frame(kind: str, type_: str, body: Any) -> bytes:
    doc = json.dumps({"kind": kind, "type": type_, "body": encode_obj(body)})
    raw = doc.encode()
    if len(raw) > MAX_FRAME:
        raise ValueError("abci frame too large")
    return FRAME_HDR.pack(len(raw)) + raw


def decode_frame(raw: bytes) -> Tuple[str, str, Any]:
    doc = json.loads(raw.decode())
    return doc["kind"], doc["type"], doc.get("body")


def read_frame(sock) -> Optional[bytes]:
    hdr = _read_exact(sock, FRAME_HDR.size)
    if hdr is None:
        return None
    (n,) = FRAME_HDR.unpack(hdr)
    if n > MAX_FRAME:
        raise ValueError("abci frame too large")
    return _read_exact(sock, n)


def _read_exact(sock, n: int) -> Optional[bytes]:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf

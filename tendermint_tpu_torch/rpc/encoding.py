"""JSON encoding of core types for RPC responses.

The part of ``tendermint_tpu/rpc/encoding.py`` the light-client serving
tier answers with, and the RFC 3339 parser the light client's
conformance traces are read with. It follows the reference's RPC JSON
conventions (rpc/coretypes/responses.go with proto-JSON encodings):
hashes hex-encoded, signatures base64, timestamps RFC 3339, int64 fields
as strings (Go's proto-JSON renders 64-bit ints as strings; clients
depend on that).
"""

from __future__ import annotations

import base64
import datetime
from typing import Any, Dict

from tendermint_tpu_torch.encoding.canonical import Timestamp
from tendermint_tpu_torch.types.block import BlockID, Commit, CommitSig, Header
from tendermint_tpu_torch.types.validator import Validator


def hex_bytes(b: bytes) -> str:
    return b.hex().upper()


def b64(b: bytes) -> str:
    return base64.b64encode(b).decode()


def rfc3339(ts: Timestamp) -> str:
    dt = datetime.datetime.fromtimestamp(ts.seconds, tz=datetime.timezone.utc)
    frac = f".{ts.nanos:09d}".rstrip("0").rstrip(".")
    return dt.strftime("%Y-%m-%dT%H:%M:%S") + frac + "Z"


def parse_rfc3339(s: str) -> Timestamp:
    if s.endswith("Z"):
        s = s[:-1]
    if "." in s:
        main, frac = s.split(".", 1)
        nanos = int(frac.ljust(9, "0")[:9])
    else:
        main, nanos = s, 0
    dt = datetime.datetime.strptime(main, "%Y-%m-%dT%H:%M:%S").replace(
        tzinfo=datetime.timezone.utc
    )
    return Timestamp(int(dt.timestamp()), nanos)


def block_id_json(bid: BlockID) -> Dict[str, Any]:
    return {
        "hash": hex_bytes(bid.hash),
        "parts": {
            "total": bid.part_set_header.total,
            "hash": hex_bytes(bid.part_set_header.hash),
        },
    }


def header_json(h: Header) -> Dict[str, Any]:
    return {
        "version": {"block": str(h.version.block), "app": str(h.version.app)},
        "chain_id": h.chain_id,
        "height": str(h.height),
        "time": rfc3339(h.time),
        "last_block_id": block_id_json(h.last_block_id),
        "last_commit_hash": hex_bytes(h.last_commit_hash),
        "data_hash": hex_bytes(h.data_hash),
        "validators_hash": hex_bytes(h.validators_hash),
        "next_validators_hash": hex_bytes(h.next_validators_hash),
        "consensus_hash": hex_bytes(h.consensus_hash),
        "app_hash": hex_bytes(h.app_hash),
        "last_results_hash": hex_bytes(h.last_results_hash),
        "evidence_hash": hex_bytes(h.evidence_hash),
        "proposer_address": hex_bytes(h.proposer_address),
    }


def commit_sig_json(cs: CommitSig) -> Dict[str, Any]:
    return {
        "block_id_flag": cs.block_id_flag,
        "validator_address": hex_bytes(cs.validator_address),
        "timestamp": rfc3339(cs.timestamp),
        "signature": b64(cs.signature) if cs.signature else None,
    }


def commit_json(c: Commit) -> Dict[str, Any]:
    return {
        "height": str(c.height),
        "round": c.round,
        "block_id": block_id_json(c.block_id),
        "signatures": [commit_sig_json(s) for s in c.signatures],
    }


def validator_json(v: Validator) -> Dict[str, Any]:
    return {
        "address": hex_bytes(v.address),
        "pub_key": {
            "type": v.pub_key.type,
            "value": b64(v.pub_key.bytes()),
        },
        "voting_power": str(v.voting_power),
        "proposer_priority": str(v.proposer_priority),
    }

"""JSON encoding of core types for RPC responses.

A copy of ``tendermint_tpu/rpc/encoding.py``, whole: the encoders the
node's routes, the light proxy and lightd answer with, and the decoders
``light/provider.py`` ``HTTPProvider`` builds light blocks with. It
follows the reference's RPC JSON conventions (rpc/coretypes/responses.go with proto-JSON encodings):
hashes hex-encoded, signatures base64, timestamps RFC 3339, int64 fields
as strings (Go's proto-JSON renders 64-bit ints as strings; clients
depend on that).

One divergence: the reference's ``rfc3339`` writes the year as the C
library's ``%Y`` does, without padding, so Go's zero time (an absent
commit signature's timestamp) comes out as ``1-01-01T00:00:00Z``, which
its own ``parse_rfc3339`` refuses: the reference's ``HTTPProvider``
cannot read a commit with an absent signature. The port writes four
digits (``0001-01-01T00:00:00Z``, as Go's RFC 3339 does) and reads
either form.
"""

from __future__ import annotations

import base64
import datetime
from typing import Any, Dict

from tendermint_tpu_torch.abci import types as abci
from tendermint_tpu_torch.crypto.keys import pubkey_from_type_and_bytes
from tendermint_tpu_torch.encoding.canonical import Timestamp
from tendermint_tpu_torch.types.block import (
    Block,
    BlockID,
    Commit,
    CommitSig,
    Consensus,
    Header,
    PartSetHeader,
)
from tendermint_tpu_torch.types.validator import Validator


def hex_bytes(b: bytes) -> str:
    return b.hex().upper()


def b64(b: bytes) -> str:
    return base64.b64encode(b).decode()


def unb64(s: str) -> bytes:
    return base64.b64decode(s)


def rfc3339(ts: Timestamp) -> str:
    dt = datetime.datetime.fromtimestamp(ts.seconds, tz=datetime.timezone.utc)
    frac = f".{ts.nanos:09d}".rstrip("0").rstrip(".")
    return f"{dt.year:04d}" + dt.strftime("-%m-%dT%H:%M:%S") + frac + "Z"


def parse_rfc3339(s: str) -> Timestamp:
    if s.endswith("Z"):
        s = s[:-1]
    if "." in s:
        main, frac = s.split(".", 1)
        nanos = int(frac.ljust(9, "0")[:9])
    else:
        main, nanos = s, 0
    year, _, rest = main.partition("-")
    dt = datetime.datetime.strptime(f"{year.zfill(4)}-{rest}", "%Y-%m-%dT%H:%M:%S").replace(
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


def block_json(b: Block) -> Dict[str, Any]:
    return {
        "header": header_json(b.header),
        "data": {"txs": [b64(tx) for tx in b.data.txs]},
        "evidence": {"evidence": []},
        "last_commit": commit_json(b.last_commit) if b.last_commit else None,
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


# --- decoders (client side: the light provider) -----------------------------


def block_id_from_json(d: Dict[str, Any]) -> BlockID:
    return BlockID(
        hash=bytes.fromhex(d.get("hash", "")),
        part_set_header=PartSetHeader(
            total=int(d.get("parts", {}).get("total", 0)),
            hash=bytes.fromhex(d.get("parts", {}).get("hash", "")),
        ),
    )


def header_from_json(d: Dict[str, Any]) -> Header:
    return Header(
        version=Consensus(block=int(d["version"]["block"]), app=int(d["version"]["app"])),
        chain_id=d["chain_id"],
        height=int(d["height"]),
        time=parse_rfc3339(d["time"]),
        last_block_id=block_id_from_json(d["last_block_id"]),
        last_commit_hash=bytes.fromhex(d["last_commit_hash"]),
        data_hash=bytes.fromhex(d["data_hash"]),
        validators_hash=bytes.fromhex(d["validators_hash"]),
        next_validators_hash=bytes.fromhex(d["next_validators_hash"]),
        consensus_hash=bytes.fromhex(d["consensus_hash"]),
        app_hash=bytes.fromhex(d["app_hash"]),
        last_results_hash=bytes.fromhex(d["last_results_hash"]),
        evidence_hash=bytes.fromhex(d["evidence_hash"]),
        proposer_address=bytes.fromhex(d["proposer_address"]),
    )


def commit_from_json(d: Dict[str, Any]) -> Commit:
    return Commit(
        height=int(d["height"]),
        round=int(d["round"]),
        block_id=block_id_from_json(d["block_id"]),
        signatures=[
            CommitSig(
                block_id_flag=int(s["block_id_flag"]),
                validator_address=bytes.fromhex(s["validator_address"]),
                timestamp=parse_rfc3339(s["timestamp"]),
                signature=base64.b64decode(s["signature"]) if s.get("signature") else b"",
            )
            for s in d["signatures"]
        ],
    )


def validator_from_json(d: Dict[str, Any]) -> Validator:
    pub = pubkey_from_type_and_bytes(d["pub_key"]["type"], base64.b64decode(d["pub_key"]["value"]))
    return Validator(
        address=bytes.fromhex(d["address"]),
        pub_key=pub,
        voting_power=int(d["voting_power"]),
        proposer_priority=int(d.get("proposer_priority", 0)),
    )


def event_json(e: abci.Event) -> Dict[str, Any]:
    return {
        "type": e.type,
        "attributes": [{"key": a.key, "value": a.value, "index": a.index} for a in e.attributes],
    }


def exec_tx_result_json(r: abci.ExecTxResult) -> Dict[str, Any]:
    return {
        "code": r.code,
        "data": b64(r.data),
        "log": r.log,
        "info": r.info,
        "gas_wanted": str(r.gas_wanted),
        "gas_used": str(r.gas_used),
        "events": [event_json(e) for e in (r.events or [])],
        "codespace": r.codespace,
    }

"""GenesisDoc (types/genesis.go): the chain's initial conditions.

A copy of ``tendermint_tpu/types/genesis.py``: the document, its checks,
and its JSON form (genesis.json), which carries a chain's start between
processes and between the two packages."""

from __future__ import annotations

import base64
import datetime
import json
import time
from dataclasses import dataclass, field as dc_field
from typing import List, Optional

from tendermint_tpu_torch.crypto.keys import (
    PubKey,
    pubkey_from_type_and_bytes,
)
from tendermint_tpu_torch.encoding.canonical import Timestamp
from tendermint_tpu_torch.types.block import GO_ZERO_TIME, MAX_CHAIN_ID_LEN
from tendermint_tpu_torch.types.params import (
    ABCIParams,
    BlockParams,
    ConsensusParams,
    EvidenceParams,
    SynchronyParams,
    TimeoutParams,
    ValidatorParams,
    VersionParams,
)
from tendermint_tpu_torch.types.validator import Validator
from tendermint_tpu_torch.types.validator_set import ValidatorSet

MAX_GENESIS_SIZE = 100 * 1024 * 1024  # types/genesis.go genesisDocMaxSize


@dataclass
class GenesisValidator:
    """types/genesis.go:33-40."""

    pub_key: PubKey
    power: int
    name: str = ""
    address: bytes = b""

    def __post_init__(self):
        if not self.address and self.pub_key is not None:
            self.address = self.pub_key.address()


@dataclass
class GenesisDoc:
    """types/genesis.go:43-55."""

    chain_id: str
    genesis_time: Timestamp = GO_ZERO_TIME
    initial_height: int = 1
    consensus_params: Optional[ConsensusParams] = None
    validators: List[GenesisValidator] = dc_field(default_factory=list)
    app_hash: bytes = b""
    app_state: bytes = b""

    def validate_and_complete(self) -> None:
        """types/genesis.go:66-109."""
        if not self.chain_id:
            raise ValueError("genesis doc must include non-empty chain_id")
        if len(self.chain_id) > MAX_CHAIN_ID_LEN:
            raise ValueError(f"chain_id in genesis doc is too long (max {MAX_CHAIN_ID_LEN})")
        if self.initial_height < 0:
            raise ValueError("initial_height cannot be negative")
        if self.initial_height == 0:
            self.initial_height = 1
        if self.consensus_params is None:
            self.consensus_params = ConsensusParams()
        else:
            self.consensus_params.validate()
        for i, v in enumerate(self.validators):
            if v.power == 0:
                raise ValueError(f"genesis file cannot contain validators with no voting power: {v}")
            if v.address and v.pub_key.address() != v.address:
                raise ValueError(f"incorrect address for validator {i}")
        if self.genesis_time == GO_ZERO_TIME:
            self.genesis_time = Timestamp.from_unix_ns(time.time_ns())

    def validator_set(self) -> ValidatorSet:
        return ValidatorSet(
            [Validator(v.pub_key, v.power) for v in self.validators]
        )

    # --- JSON persistence (genesis.json format) -----------------------------

    def to_json(self) -> str:
        doc = {
            "genesis_time": _rfc3339(self.genesis_time),
            "chain_id": self.chain_id,
            "initial_height": str(self.initial_height),
            "consensus_params": _params_to_json(self.consensus_params),
            "validators": [
                {
                    "address": v.address.hex().upper(),
                    "pub_key": {
                        "type": f"tendermint/PubKey{v.pub_key.type.capitalize()}"
                        if v.pub_key.type != "ed25519"
                        else "tendermint/PubKeyEd25519",
                        "value": base64.b64encode(v.pub_key.bytes()).decode(),
                    },
                    "power": str(v.power),
                    "name": v.name,
                }
                for v in self.validators
            ],
            "app_hash": self.app_hash.hex().upper(),
            "app_state": json.loads(self.app_state.decode()) if self.app_state else {},
        }
        return json.dumps(doc, indent=2)

    @classmethod
    def from_json(cls, raw: str) -> "GenesisDoc":
        if len(raw) > MAX_GENESIS_SIZE:
            raise ValueError("genesis doc too large")
        doc = json.loads(raw)
        validators = []
        for v in doc.get("validators") or []:
            key_type = _key_type_from_json(v["pub_key"]["type"])
            pub = pubkey_from_type_and_bytes(
                key_type, base64.b64decode(v["pub_key"]["value"])
            )
            validators.append(
                GenesisValidator(
                    pub_key=pub,
                    power=int(v["power"]),
                    name=v.get("name", ""),
                    address=bytes.fromhex(v["address"]) if v.get("address") else b"",
                )
            )
        out = cls(
            chain_id=doc["chain_id"],
            genesis_time=_parse_rfc3339(doc.get("genesis_time")),
            initial_height=int(doc.get("initial_height", 1)),
            consensus_params=_params_from_json(doc.get("consensus_params")),
            validators=validators,
            app_hash=bytes.fromhex(doc.get("app_hash", "")),
            app_state=json.dumps(doc.get("app_state", {})).encode()
            if doc.get("app_state") is not None
            else b"",
        )
        out.validate_and_complete()
        return out

    def save_as(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def from_file(cls, path: str) -> "GenesisDoc":
        with open(path) as f:
            return cls.from_json(f.read())


def _key_type_from_json(type_tag: str) -> str:
    mapping = {
        "tendermint/PubKeyEd25519": "ed25519",
        "tendermint/PubKeySecp256k1": "secp256k1",
        "tendermint/PubKeySr25519": "sr25519",
    }
    if type_tag not in mapping:
        raise ValueError(f"unknown pubkey type tag {type_tag}")
    return mapping[type_tag]


def _rfc3339(ts: Timestamp) -> str:
    dt = datetime.datetime.fromtimestamp(ts.seconds, datetime.timezone.utc)
    frac = f".{ts.nanos:09d}".rstrip("0").rstrip(".")
    return dt.strftime("%Y-%m-%dT%H:%M:%S") + frac + "Z"


def _parse_rfc3339(s: Optional[str]) -> Timestamp:
    if not s:
        return GO_ZERO_TIME
    body = s.rstrip("Z")
    if "." in body:
        main, frac = body.split(".", 1)
        nanos = int(frac.ljust(9, "0")[:9])
    else:
        main, nanos = body, 0
    dt = datetime.datetime.strptime(main, "%Y-%m-%dT%H:%M:%S").replace(
        tzinfo=datetime.timezone.utc
    )
    return Timestamp(int(dt.timestamp()), nanos)


def _params_to_json(p: Optional[ConsensusParams]) -> dict:
    if p is None:
        p = ConsensusParams()
    return {
        "block": {"max_bytes": str(p.block.max_bytes), "max_gas": str(p.block.max_gas)},
        "evidence": {
            "max_age_num_blocks": str(p.evidence.max_age_num_blocks),
            "max_age_duration": str(p.evidence.max_age_duration),
            "max_bytes": str(p.evidence.max_bytes),
        },
        "validator": {"pub_key_types": list(p.validator.pub_key_types)},
        "version": {"app_version": str(p.version.app_version)},
        "synchrony": {
            "precision": str(p.synchrony.precision),
            "message_delay": str(p.synchrony.message_delay),
        },
        "timeout": {
            "propose": str(p.timeout.propose),
            "propose_delta": str(p.timeout.propose_delta),
            "vote": str(p.timeout.vote),
            "vote_delta": str(p.timeout.vote_delta),
            "commit": str(p.timeout.commit),
            "bypass_commit_timeout": p.timeout.bypass_commit_timeout,
        },
        "abci": {
            "vote_extensions_enable_height": str(p.abci.vote_extensions_enable_height),
        },
    }


def _params_from_json(doc: Optional[dict]) -> Optional[ConsensusParams]:
    if doc is None:
        return None
    p = ConsensusParams()
    if "block" in doc:
        p.block = BlockParams(
            max_bytes=int(doc["block"]["max_bytes"]),
            max_gas=int(doc["block"]["max_gas"]),
        )
    if "evidence" in doc:
        p.evidence = EvidenceParams(
            max_age_num_blocks=int(doc["evidence"]["max_age_num_blocks"]),
            max_age_duration=float(doc["evidence"]["max_age_duration"]),
            max_bytes=int(doc["evidence"].get("max_bytes", 0)),
        )
    if "validator" in doc:
        p.validator = ValidatorParams(
            pub_key_types=list(doc["validator"]["pub_key_types"])
        )
    if "version" in doc:
        p.version = VersionParams(app_version=int(doc["version"].get("app_version", 0)))
    if "synchrony" in doc:
        p.synchrony = SynchronyParams(
            precision=float(doc["synchrony"]["precision"]),
            message_delay=float(doc["synchrony"]["message_delay"]),
        )
    if "timeout" in doc:
        t = doc["timeout"]
        p.timeout = TimeoutParams(
            propose=float(t["propose"]),
            propose_delta=float(t["propose_delta"]),
            vote=float(t["vote"]),
            vote_delta=float(t["vote_delta"]),
            commit=float(t["commit"]),
            bypass_commit_timeout=bool(t.get("bypass_commit_timeout", False)),
        )
    if "abci" in doc:
        p.abci = ABCIParams(
            vote_extensions_enable_height=int(
                doc["abci"]["vote_extensions_enable_height"]
            )
        )
    return p

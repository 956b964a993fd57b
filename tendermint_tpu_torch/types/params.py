"""Consensus parameters.

A copy of ``tendermint_tpu/types/params.py``, mirroring types/params.go: Block/Evidence/Validator/Version/Synchrony/
Timeout/ABCI parameter groups, defaults, validation, update-from-ABCI,
and the hash (SHA-256 of the HashedParams proto — params.go:385-399).
Durations are float seconds host-side (the reference uses ns).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field, replace
from typing import List, Optional

from tendermint_tpu_torch.crypto.keys import (
    ED25519_KEY_TYPE,
    SECP256K1_KEY_TYPE,
    SR25519_KEY_TYPE,
)
from tendermint_tpu_torch.encoding.proto import (
    Reader,
    encode_bool_field,
    encode_bytes_field,
    encode_message_field,
    encode_optional_message_field,
    encode_varint_field,
)

MAX_BLOCK_SIZE_BYTES = 104857600  # 100MB, types/params.go:24
BLOCK_PART_SIZE_BYTES = 65536  # types/params.go:21
MAX_BLOCK_PARTS_COUNT = (MAX_BLOCK_SIZE_BYTES // BLOCK_PART_SIZE_BYTES) + 1

ABCI_PUBKEY_TYPE_ED25519 = ED25519_KEY_TYPE
ABCI_PUBKEY_TYPE_SECP256K1 = SECP256K1_KEY_TYPE
ABCI_PUBKEY_TYPE_SR25519 = SR25519_KEY_TYPE


@dataclass
class BlockParams:
    max_bytes: int = 22020096  # 21MB
    max_gas: int = -1


@dataclass
class EvidenceParams:
    max_age_num_blocks: int = 100000
    max_age_duration: float = 48 * 3600.0  # seconds
    max_bytes: int = 1048576


@dataclass
class ValidatorParams:
    pub_key_types: List[str] = field(
        default_factory=lambda: [ABCI_PUBKEY_TYPE_ED25519]
    )


@dataclass
class VersionParams:
    app_version: int = 0


@dataclass
class SynchronyParams:
    """Proposer-based timestamps bounds (types/params.go:81-89)."""

    precision: float = 0.505  # seconds
    message_delay: float = 12.0

    def in_round(self, round_: int) -> "SynchronyParams":
        """Per-round relaxation: message delay grows 10% per round so PBTS
        eventually accepts any proposer timestamp (params.go SynchronyParams)."""
        delay = self.message_delay
        for _ in range(round_):
            delay = delay * 1.1
        return SynchronyParams(self.precision, delay)


@dataclass
class TimeoutParams:
    """On-chain consensus timeouts (types/params.go:91-99)."""

    propose: float = 3.0
    propose_delta: float = 0.5
    vote: float = 1.0
    vote_delta: float = 0.5
    commit: float = 1.0
    bypass_commit_timeout: bool = False

    def propose_timeout(self, round_: int) -> float:
        return self.propose + self.propose_delta * round_

    def vote_timeout(self, round_: int) -> float:
        return self.vote + self.vote_delta * round_


@dataclass
class ABCIParams:
    vote_extensions_enable_height: int = 0

    def vote_extensions_enabled(self, height: int) -> bool:
        if self.vote_extensions_enable_height == 0:
            return False
        return height >= self.vote_extensions_enable_height


@dataclass
class ConsensusParams:
    block: BlockParams = field(default_factory=BlockParams)
    evidence: EvidenceParams = field(default_factory=EvidenceParams)
    validator: ValidatorParams = field(default_factory=ValidatorParams)
    version: VersionParams = field(default_factory=VersionParams)
    synchrony: SynchronyParams = field(default_factory=SynchronyParams)
    timeout: TimeoutParams = field(default_factory=TimeoutParams)
    abci: ABCIParams = field(default_factory=ABCIParams)

    def hash(self) -> bytes:
        """SHA-256 of HashedParams{block_max_bytes=1, block_max_gas=2}
        (types/params.go:385-399)."""
        payload = encode_varint_field(1, self.block.max_bytes) + encode_varint_field(
            2, self.block.max_gas
        )
        return hashlib.sha256(payload).digest()

    def validate(self) -> None:
        """types/params.go ValidateConsensusParams."""
        if self.block.max_bytes <= 0:
            raise ValueError(f"block.max_bytes must be > 0, got {self.block.max_bytes}")
        if self.block.max_bytes > MAX_BLOCK_SIZE_BYTES:
            raise ValueError(
                f"block.max_bytes exceeds {MAX_BLOCK_SIZE_BYTES}"
            )
        if self.block.max_gas < -1:
            raise ValueError(f"block.max_gas must be >= -1, got {self.block.max_gas}")
        if self.evidence.max_age_num_blocks <= 0:
            raise ValueError("evidence.max_age_num_blocks must be > 0")
        if self.evidence.max_age_duration <= 0:
            raise ValueError("evidence.max_age_duration must be > 0")
        if (
            self.evidence.max_bytes > self.block.max_bytes
            or self.evidence.max_bytes < 0
        ):
            raise ValueError("evidence.max_bytes invalid")
        if self.synchrony.precision <= 0 or self.synchrony.message_delay <= 0:
            raise ValueError("synchrony params must be positive")
        for t in (
            self.timeout.propose,
            self.timeout.vote,
            self.timeout.commit,
        ):
            if t <= 0:
                raise ValueError("timeouts must be positive")
        if self.timeout.propose_delta < 0 or self.timeout.vote_delta < 0:
            raise ValueError("timeout deltas must be non-negative")
        if not self.validator.pub_key_types:
            raise ValueError("validator.pub_key_types must not be empty")
        for kt in self.validator.pub_key_types:
            if kt not in (
                ABCI_PUBKEY_TYPE_ED25519,
                ABCI_PUBKEY_TYPE_SECP256K1,
                ABCI_PUBKEY_TYPE_SR25519,
            ):
                raise ValueError(f"unknown pubkey type {kt}")
        if self.abci.vote_extensions_enable_height < 0:
            raise ValueError("abci.vote_extensions_enable_height must be >= 0")

    def update_from(self, updates: Optional["ConsensusParamsUpdate"]) -> "ConsensusParams":
        """Apply a partial ABCI update (params.go UpdateConsensusParams)."""
        if updates is None:
            return self
        out = replace(self)
        if updates.block is not None:
            out.block = updates.block
        if updates.evidence is not None:
            out.evidence = updates.evidence
        if updates.validator is not None:
            out.validator = updates.validator
        if updates.version is not None:
            out.version = updates.version
        if updates.synchrony is not None:
            out.synchrony = updates.synchrony
        if updates.timeout is not None:
            out.timeout = updates.timeout
        if updates.abci is not None:
            out.abci = updates.abci
        return out


@dataclass
class ConsensusParamsUpdate:
    """Partial update as delivered by the ABCI app (all groups optional)."""

    block: Optional[BlockParams] = None
    evidence: Optional[EvidenceParams] = None
    validator: Optional[ValidatorParams] = None
    version: Optional[VersionParams] = None
    synchrony: Optional[SynchronyParams] = None
    timeout: Optional[TimeoutParams] = None
    abci: Optional[ABCIParams] = None


def default_consensus_params() -> ConsensusParams:
    """Fresh defaults (types/params.go DefaultConsensusParams). A function,
    not a shared instance: ConsensusParams is mutable."""
    return ConsensusParams()


# --- proto encoding (tendermint.types.ConsensusParams) ----------------------
#
# Field layout follows proto/tendermint/types/params.proto: block=1,
# evidence=2, validator=3, version=4, synchrony=5, timeout=6, abci=7.
# Durations are google.protobuf.Duration {seconds=1, nanos=2}; host-side
# floats are converted at the boundary.


def _encode_duration(seconds_float: float) -> bytes:
    total_ns = round(seconds_float * 1e9)
    secs, nanos = divmod(total_ns, 1_000_000_000)
    return encode_varint_field(1, secs) + encode_varint_field(2, nanos)


def _decode_duration(data: bytes) -> float:
    r = Reader(data)
    secs = nanos = 0
    for f, w in r.fields():
        if f == 1 and w == 0:
            secs = r.read_svarint()
        elif f == 2 and w == 0:
            nanos = r.read_svarint()
        else:
            r.skip(w)
    return secs + nanos / 1e9


def consensus_params_to_proto_bytes(p: "ConsensusParams") -> bytes:
    evf = encode_varint_field
    block = evf(1, p.block.max_bytes) + evf(2, p.block.max_gas)
    evidence = (
        evf(1, p.evidence.max_age_num_blocks)
        + encode_message_field(2, _encode_duration(p.evidence.max_age_duration))
        + evf(3, p.evidence.max_bytes)
    )
    validator = b"".join(
        encode_bytes_field(1, kt.encode()) for kt in p.validator.pub_key_types
    )
    version = evf(1, p.version.app_version)
    synchrony = encode_optional_message_field(
        1, _encode_duration(p.synchrony.precision)
    ) + encode_optional_message_field(2, _encode_duration(p.synchrony.message_delay))
    timeout = (
        encode_optional_message_field(1, _encode_duration(p.timeout.propose))
        + encode_optional_message_field(2, _encode_duration(p.timeout.propose_delta))
        + encode_optional_message_field(3, _encode_duration(p.timeout.vote))
        + encode_optional_message_field(4, _encode_duration(p.timeout.vote_delta))
        + encode_optional_message_field(5, _encode_duration(p.timeout.commit))
        + encode_bool_field(6, p.timeout.bypass_commit_timeout)
    )
    abci = evf(1, p.abci.vote_extensions_enable_height)
    return (
        encode_message_field(1, block)
        + encode_message_field(2, evidence)
        + encode_message_field(3, validator)
        + encode_message_field(4, version)
        + encode_message_field(5, synchrony)
        + encode_message_field(6, timeout)
        + encode_message_field(7, abci)
    )


def consensus_params_from_proto_bytes(data: bytes) -> "ConsensusParams":
    p = ConsensusParams()
    r = Reader(data)
    for f, w in r.fields():
        if w != 2:
            r.skip(w)
            continue
        payload = r.read_bytes()
        pr = Reader(payload)
        if f == 1:
            max_bytes = max_gas = 0
            for pf, pw in pr.fields():
                if pf == 1 and pw == 0:
                    max_bytes = pr.read_svarint()
                elif pf == 2 and pw == 0:
                    max_gas = pr.read_svarint()
                else:
                    pr.skip(pw)
            p.block = BlockParams(max_bytes, max_gas)
        elif f == 2:
            blocks = 0
            dur = 0.0
            mb = 0
            for pf, pw in pr.fields():
                if pf == 1 and pw == 0:
                    blocks = pr.read_svarint()
                elif pf == 2 and pw == 2:
                    dur = _decode_duration(pr.read_bytes())
                elif pf == 3 and pw == 0:
                    mb = pr.read_svarint()
                else:
                    pr.skip(pw)
            p.evidence = EvidenceParams(blocks, dur, mb)
        elif f == 3:
            kts = []
            for pf, pw in pr.fields():
                if pf == 1 and pw == 2:
                    kts.append(pr.read_bytes().decode())
                else:
                    pr.skip(pw)
            p.validator = ValidatorParams(kts)
        elif f == 4:
            app_version = 0
            for pf, pw in pr.fields():
                if pf == 1 and pw == 0:
                    app_version = pr.read_varint()
                else:
                    pr.skip(pw)
            p.version = VersionParams(app_version)
        elif f == 5:
            precision = message_delay = 0.0
            for pf, pw in pr.fields():
                if pf == 1 and pw == 2:
                    precision = _decode_duration(pr.read_bytes())
                elif pf == 2 and pw == 2:
                    message_delay = _decode_duration(pr.read_bytes())
                else:
                    pr.skip(pw)
            p.synchrony = SynchronyParams(precision, message_delay)
        elif f == 6:
            vals = {}
            bypass = False
            for pf, pw in pr.fields():
                if pf in (1, 2, 3, 4, 5) and pw == 2:
                    vals[pf] = _decode_duration(pr.read_bytes())
                elif pf == 6 and pw == 0:
                    bypass = bool(pr.read_varint())
                else:
                    pr.skip(pw)
            p.timeout = TimeoutParams(
                propose=vals.get(1, 0.0),
                propose_delta=vals.get(2, 0.0),
                vote=vals.get(3, 0.0),
                vote_delta=vals.get(4, 0.0),
                commit=vals.get(5, 0.0),
                bypass_commit_timeout=bypass,
            )
        elif f == 7:
            h = 0
            for pf, pw in pr.fields():
                if pf == 1 and pw == 0:
                    h = pr.read_svarint()
                else:
                    pr.skip(pw)
            p.abci = ABCIParams(h)
    return p

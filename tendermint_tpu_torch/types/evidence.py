"""Light-client attack evidence (types/evidence.go).

The part of ``tendermint_tpu/types/evidence.py`` that the light client's
detector makes and reports: the ``Evidence`` interface and
``LightClientAttackEvidence`` with its encoding
(proto/tendermint/types/evidence.proto), hash, height, time and ABCI
form, so its hash matches the reference's byte for byte.
``DuplicateVoteEvidence``, the proto decoders and ``validate_basic`` are
left out: nothing of the port receives evidence.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field as dc_field
from typing import List, Optional

from tendermint_tpu_torch.encoding.canonical import Timestamp
from tendermint_tpu_torch.encoding.proto import encode_message_field, encode_varint, encode_varint_field
from tendermint_tpu_torch.types.block import GO_ZERO_TIME, HASH_SIZE, _encode_time_field
from tendermint_tpu_torch.types.light import LightBlock
from tendermint_tpu_torch.types.validator import Validator

MISBEHAVIOR_LIGHT_CLIENT_ATTACK = 2  # abci MisbehaviorType


class Evidence:
    """types/evidence.go Evidence interface."""

    def abci(self) -> List[dict]:
        raise NotImplementedError

    def bytes(self) -> bytes:
        raise NotImplementedError

    def hash(self) -> bytes:
        raise NotImplementedError

    def height(self) -> int:
        raise NotImplementedError

    def time(self) -> Timestamp:
        raise NotImplementedError


@dataclass
class LightClientAttackEvidence(Evidence):
    """types/evidence.go:259-267."""

    conflicting_block: Optional[LightBlock] = None
    common_height: int = 0
    byzantine_validators: List[Validator] = dc_field(default_factory=list)
    total_voting_power: int = 0
    timestamp: Timestamp = GO_ZERO_TIME

    def abci(self) -> List[dict]:
        return [
            {
                "type": MISBEHAVIOR_LIGHT_CLIENT_ATTACK,
                "validator": {"address": v.address, "power": v.voting_power},
                "height": self.common_height,
                "time": self.timestamp,
                "total_voting_power": self.total_voting_power,
            }
            for v in self.byzantine_validators
        ]

    def bytes(self) -> bytes:
        """The tendermint.types.LightClientAttackEvidence message."""
        out = b""
        if self.conflicting_block is not None:
            out += encode_message_field(1, self.conflicting_block.to_proto_bytes())
        out += encode_varint_field(2, self.common_height)
        for v in self.byzantine_validators:
            out += encode_message_field(3, v.to_proto_bytes())
        out += encode_varint_field(4, self.total_voting_power)
        out += _encode_time_field(5, self.timestamp)
        return out

    def hash(self) -> bytes:
        """types/evidence.go:374-381: H(conflicting hash[:31] ++ zero
        byte ++ zigzag varint of the common height)."""
        height_buf = encode_varint((self.common_height << 1) ^ (self.common_height >> 63))
        bz = bytearray(HASH_SIZE + len(height_buf))
        bz[: HASH_SIZE - 1] = self.conflicting_block.hash()[: HASH_SIZE - 1]
        bz[HASH_SIZE:] = height_buf
        return hashlib.sha256(bytes(bz)).digest()

    def height(self) -> int:
        return self.common_height

    def time(self) -> Timestamp:
        return self.timestamp

    def conflicting_header_is_invalid(self, trusted_header) -> bool:
        """types/evidence.go ConflictingHeaderIsInvalid: a lunatic attack
        iff a state-derived header field differs from the trusted one."""
        h = self.conflicting_block.header
        return (
            trusted_header.validators_hash != h.validators_hash
            or trusted_header.next_validators_hash != h.next_validators_hash
            or trusted_header.consensus_hash != h.consensus_hash
            or trusted_header.app_hash != h.app_hash
            or trusted_header.last_results_hash != h.last_results_hash
        )

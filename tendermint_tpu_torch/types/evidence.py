"""Evidence of byzantine behavior (types/evidence.go).

A copy of ``tendermint_tpu/types/evidence.py``: ``DuplicateVoteEvidence``
(an equivocation at one height) and ``LightClientAttackEvidence`` (a
conflicting light block at a common height), with the reference's proto
encoding (proto/tendermint/types/evidence.proto), the ``Evidence``
oneof wrapper and its decoder, ``validate_basic`` and
``evidence_list_hash``, so hashes match the reference byte for byte.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field as dc_field
from typing import List, Optional

from tendermint_tpu_torch.crypto import merkle
from tendermint_tpu_torch.encoding.canonical import Timestamp
from tendermint_tpu_torch.encoding.proto import Reader, encode_message_field, encode_varint, encode_varint_field
from tendermint_tpu_torch.types.block import (
    BLOCK_ID_FLAG_COMMIT,
    GO_ZERO_TIME,
    HASH_SIZE,
    Vote,
    _decode_time,
    _encode_time_field,
)
from tendermint_tpu_torch.types.light import LightBlock
from tendermint_tpu_torch.types.validator import Validator
from tendermint_tpu_torch.types.validator_set import ValidatorSet, _by_voting_power

MISBEHAVIOR_DUPLICATE_VOTE = 1  # abci MisbehaviorType
MISBEHAVIOR_LIGHT_CLIENT_ATTACK = 2


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

    def validate_basic(self) -> None:
        raise NotImplementedError

    def to_proto_bytes(self) -> bytes:
        """Encoded as the tendermint.types.Evidence oneof wrapper."""
        raise NotImplementedError


@dataclass
class DuplicateVoteEvidence(Evidence):
    """types/evidence.go:41-49. VoteA/VoteB ordered by BlockID key."""

    vote_a: Optional[Vote] = None
    vote_b: Optional[Vote] = None
    total_voting_power: int = 0
    validator_power: int = 0
    timestamp: Timestamp = GO_ZERO_TIME

    @classmethod
    def new(cls, vote1: Vote, vote2: Vote, block_time: Timestamp, val_set: ValidatorSet) -> "DuplicateVoteEvidence":
        """types/evidence.go:59-88: orders the votes, snapshots the powers."""
        if vote1 is None or vote2 is None:
            raise ValueError("missing vote")
        if val_set is None:
            raise ValueError("missing validator set")
        idx, val = val_set.get_by_address(vote1.validator_address)
        if idx == -1:
            raise ValueError("validator not in validator set")
        if vote1.block_id.key() < vote2.block_id.key():
            vote_a, vote_b = vote1, vote2
        else:
            vote_a, vote_b = vote2, vote1
        return cls(
            vote_a=vote_a,
            vote_b=vote_b,
            total_voting_power=val_set.total_voting_power(),
            validator_power=val.voting_power,
            timestamp=block_time,
        )

    def abci(self) -> List[dict]:
        return [
            {
                "type": MISBEHAVIOR_DUPLICATE_VOTE,
                "validator": {"address": self.vote_a.validator_address, "power": self.validator_power},
                "height": self.vote_a.height,
                "time": self.timestamp,
                "total_voting_power": self.total_voting_power,
            }
        ]

    def bytes(self) -> bytes:
        """The tendermint.types.DuplicateVoteEvidence message."""
        out = b""
        if self.vote_a is not None:
            out += encode_message_field(1, self.vote_a.to_proto_bytes())
        if self.vote_b is not None:
            out += encode_message_field(2, self.vote_b.to_proto_bytes())
        out += encode_varint_field(3, self.total_voting_power)
        out += encode_varint_field(4, self.validator_power)
        out += _encode_time_field(5, self.timestamp)
        return out

    def hash(self) -> bytes:
        return hashlib.sha256(self.bytes()).digest()

    def height(self) -> int:
        return self.vote_a.height

    def time(self) -> Timestamp:
        return self.timestamp

    def validate_basic(self) -> None:
        """types/evidence.go:135-155."""
        if self.vote_a is None or self.vote_b is None:
            raise ValueError("one or both of the votes are empty")
        self.vote_a.validate_basic()
        self.vote_b.validate_basic()
        if self.vote_a.block_id.key() >= self.vote_b.block_id.key():
            raise ValueError("duplicate votes in invalid order")

    def to_proto_bytes(self) -> bytes:
        return encode_message_field(1, self.bytes())

    @classmethod
    def from_inner_proto_bytes(cls, data: bytes) -> "DuplicateVoteEvidence":
        r = Reader(data)
        out = cls()
        for f, w in r.fields():
            if f == 1 and w == 2:
                out.vote_a = Vote.from_proto_bytes(r.read_bytes())
            elif f == 2 and w == 2:
                out.vote_b = Vote.from_proto_bytes(r.read_bytes())
            elif f == 3 and w == 0:
                out.total_voting_power = r.read_svarint()
            elif f == 4 and w == 0:
                out.validator_power = r.read_svarint()
            elif f == 5 and w == 2:
                out.timestamp = _decode_time(r.read_bytes())
            else:
                r.skip(w)
        return out


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

    def get_byzantine_validators(self, common_vals: ValidatorSet, trusted) -> List[Validator]:
        """types/evidence.go:414-460: a lunatic attack blames the common
        set's validators that signed; an equivocation or amnesia attack
        the conflicting set's signers when the rounds match."""
        commit = self.conflicting_block.signed_header.commit
        if self.conflicting_header_is_invalid(trusted.header):
            vset = common_vals
        elif trusted.commit.round == commit.round:
            vset = self.conflicting_block.validator_set
        else:
            return []
        validators = []
        for sig in commit.signatures:
            if sig.block_id_flag != BLOCK_ID_FLAG_COMMIT:
                continue
            _, val = vset.get_by_address(sig.validator_address)
            if val is not None:
                validators.append(val)
        return sorted(validators, key=_by_voting_power)

    def validate_basic(self) -> None:
        """types/evidence.go:408-445."""
        if self.conflicting_block is None:
            raise ValueError("conflicting block is nil")
        if self.conflicting_block.header is None:
            raise ValueError("conflicting block missing header")
        if self.total_voting_power <= 0:
            raise ValueError("negative or zero total voting power")
        if self.common_height <= 0:
            raise ValueError("negative or zero common height")
        if self.common_height > self.conflicting_block.height:
            raise ValueError(
                f"common height is ahead of the conflicting block height "
                f"({self.common_height} > {self.conflicting_block.height})"
            )
        self.conflicting_block.validate_basic(self.conflicting_block.header.chain_id)

    def to_proto_bytes(self) -> bytes:
        return encode_message_field(2, self.bytes())

    @classmethod
    def from_inner_proto_bytes(cls, data: bytes) -> "LightClientAttackEvidence":
        r = Reader(data)
        out = cls()
        for f, w in r.fields():
            if f == 1 and w == 2:
                out.conflicting_block = LightBlock.from_proto_bytes(r.read_bytes())
            elif f == 2 and w == 0:
                out.common_height = r.read_svarint()
            elif f == 3 and w == 2:
                out.byzantine_validators.append(Validator.from_proto_bytes(r.read_bytes()))
            elif f == 4 and w == 0:
                out.total_voting_power = r.read_svarint()
            elif f == 5 and w == 2:
                out.timestamp = _decode_time(r.read_bytes())
            else:
                r.skip(w)
        return out


def evidence_from_proto_bytes(data: bytes) -> Evidence:
    """Decode the tendermint.types.Evidence oneof wrapper."""
    r = Reader(data)
    for f, w in r.fields():
        if f == 1 and w == 2:
            return DuplicateVoteEvidence.from_inner_proto_bytes(r.read_bytes())
        if f == 2 and w == 2:
            return LightClientAttackEvidence.from_inner_proto_bytes(r.read_bytes())
        r.skip(w)
    raise ValueError("evidence is not recognized")


def evidence_list_hash(evidence: List[Evidence]) -> bytes:
    """types/evidence.go:667: the merkle root of the evidence hashes."""
    return merkle.hash_from_byte_slices([ev.hash() for ev in evidence])

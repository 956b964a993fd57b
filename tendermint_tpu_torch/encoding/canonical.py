"""Canonical vote, proposal and vote-extension sign-bytes.

A copy of ``tendermint_tpu/encoding/canonical.py`` (reference
types/canonical.go, types/vote.go:141-170, types/proposal.go): sign-bytes
are the varint-length-prefixed protobuf encoding of the CanonicalVote,
the CanonicalProposal or the CanonicalVoteExtension. The non-nullable
Timestamp and the PartSetHeader inside CanonicalBlockID are always
serialized; other zero values are omitted.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

from tendermint_tpu_torch.encoding.proto import (
    encode_bytes_field,
    encode_message_field,
    encode_sfixed64_field,
    encode_string_field,
    encode_varint_field,
    length_delimited,
)

# SignedMsgType (proto/tendermint/types/types.proto)
SIGNED_MSG_TYPE_PREVOTE = 1
SIGNED_MSG_TYPE_PRECOMMIT = 2
SIGNED_MSG_TYPE_PROPOSAL = 32


class Timestamp(NamedTuple):
    """google.protobuf.Timestamp: seconds + nanos since the Unix epoch."""

    seconds: int = 0
    nanos: int = 0

    def encode(self) -> bytes:
        return encode_varint_field(1, self.seconds) + encode_varint_field(2, self.nanos)

    @classmethod
    def from_unix_ns(cls, ns: int) -> "Timestamp":
        return cls(ns // 1_000_000_000, ns % 1_000_000_000)

    def to_unix_ns(self) -> int:
        return self.seconds * 1_000_000_000 + self.nanos


def encode_canonical_part_set_header(total: int, hash_: bytes) -> bytes:
    return encode_varint_field(1, total) + encode_bytes_field(2, hash_)


def encode_canonical_block_id(
    hash_: bytes, psh_total: int, psh_hash: bytes
) -> Optional[bytes]:
    """None for a nil BlockID, which the canonical vote omits entirely
    (reference: types/canonical.go CanonicalizeBlockID)."""
    if not hash_ and psh_total == 0 and not psh_hash:
        return None
    psh = encode_canonical_part_set_header(psh_total, psh_hash)
    return encode_bytes_field(1, hash_) + encode_message_field(2, psh)


def canonical_vote_bytes(
    chain_id: str,
    msg_type: int,
    height: int,
    round_: int,
    block_id: Optional[bytes],
    timestamp: Timestamp,
) -> bytes:
    """Encoded CanonicalVote (not length-prefixed)."""
    out = encode_varint_field(1, msg_type)
    out += encode_sfixed64_field(2, height)
    out += encode_sfixed64_field(3, round_)
    if block_id is not None:
        out += encode_message_field(4, block_id)
    out += encode_message_field(5, timestamp.encode())
    out += encode_string_field(6, chain_id)
    return out


def vote_sign_bytes(
    chain_id: str,
    msg_type: int,
    height: int,
    round_: int,
    block_id_hash: bytes,
    psh_total: int,
    psh_hash: bytes,
    timestamp: Timestamp,
) -> bytes:
    """types.VoteSignBytes: the delimited canonical vote."""
    bid = encode_canonical_block_id(block_id_hash, psh_total, psh_hash)
    return length_delimited(
        canonical_vote_bytes(chain_id, msg_type, height, round_, bid, timestamp)
    )


def proposal_sign_bytes(
    chain_id: str,
    height: int,
    round_: int,
    pol_round: int,
    block_id_hash: bytes,
    psh_total: int,
    psh_hash: bytes,
    timestamp: Timestamp,
) -> bytes:
    """types.ProposalSignBytes: the delimited CanonicalProposal
    (canonical.proto); ``pol_round`` -1 is a ten-byte varint."""
    bid = encode_canonical_block_id(block_id_hash, psh_total, psh_hash)
    out = encode_varint_field(1, SIGNED_MSG_TYPE_PROPOSAL)
    out += encode_sfixed64_field(2, height)
    out += encode_sfixed64_field(3, round_)
    out += encode_varint_field(4, pol_round)
    if bid is not None:
        out += encode_message_field(5, bid)
    out += encode_message_field(6, timestamp.encode())
    out += encode_string_field(7, chain_id)
    return length_delimited(out)


def vote_extension_sign_bytes(chain_id: str, extension: bytes, height: int, round_: int) -> bytes:
    """types.VoteExtensionSignBytes: the delimited CanonicalVoteExtension."""
    out = encode_bytes_field(1, extension)
    out += encode_sfixed64_field(2, height)
    out += encode_sfixed64_field(3, round_)
    out += encode_string_field(4, chain_id)
    return length_delimited(out)

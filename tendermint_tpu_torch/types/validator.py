"""Validator (types/validator.go): a public key, its voting power, its
proposer priority and its address. The subset of
``tendermint_tpu/types/validator.py`` that commit verification, the
validator-set hash and the light store read."""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional

from tendermint_tpu_torch.crypto.keys import ADDRESS_LEN, PubKey, pubkey_from_proto, pubkey_to_proto
from tendermint_tpu_torch.encoding.proto import (
    Reader,
    encode_bytes_field,
    encode_message_field,
    encode_varint_field,
)


@dataclass
class Validator:
    pub_key: PubKey
    voting_power: int
    address: bytes = field(default=b"")
    proposer_priority: int = 0

    def __post_init__(self):
        if not self.address:
            self.address = self.pub_key.address()

    def copy(self) -> "Validator":
        return replace(self)

    def bytes(self) -> bytes:
        """SimpleValidator proto {pub_key=1, voting_power=2}: the merkle
        leaf of the validator-set hash (types/validator.go:154-170)."""
        return encode_message_field(1, pubkey_to_proto(self.pub_key)) + encode_varint_field(
            2, self.voting_power
        )

    def compare_proposer_priority(self, other: Optional["Validator"]) -> "Validator":
        """Higher priority wins; ties go to the lower address
        (types/validator.go:101-121)."""
        if other is None:
            return self
        if self.proposer_priority != other.proposer_priority:
            return self if self.proposer_priority > other.proposer_priority else other
        if self.address != other.address:
            return self if self.address < other.address else other
        raise ValueError("cannot compare identical validators")

    def validate_basic(self) -> None:
        if self.pub_key is None:
            raise ValueError("validator has nil pubkey")
        if self.voting_power < 0:
            raise ValueError("validator has negative voting power")
        if len(self.address) != ADDRESS_LEN:
            raise ValueError(f"validator address must be 20 bytes: {self.address.hex()}")

    def to_proto_bytes(self) -> bytes:
        """tendermint.types.Validator {address=1, pub_key=2 non-nullable,
        voting_power=3, proposer_priority=4} (types/validator.go ToProto)."""
        return (
            encode_bytes_field(1, self.address)
            + encode_message_field(2, pubkey_to_proto(self.pub_key))
            + encode_varint_field(3, self.voting_power)
            + encode_varint_field(4, self.proposer_priority)
        )

    @classmethod
    def from_proto_bytes(cls, data: bytes) -> "Validator":
        r = Reader(data)
        address = b""
        pub_key = None
        voting_power = proposer_priority = 0
        for f, w in r.fields():
            if f == 1 and w == 2:
                address = r.read_bytes()
            elif f == 2 and w == 2:
                pub_key = pubkey_from_proto(r.read_bytes())
            elif f == 3 and w == 0:
                voting_power = r.read_svarint()
            elif f == 4 and w == 0:
                proposer_priority = r.read_svarint()
            else:
                r.skip(w)
        if pub_key is None:
            raise ValueError("validator proto missing pubkey")
        out = cls(pub_key, voting_power, address or b"\x00", proposer_priority)
        # The wire address is kept as it is, even empty, so the bytes
        # re-encode identically (validator.go:205 keeps vp.GetAddress()).
        out.address = address
        return out

"""Validator (types/validator.go): a public key, its voting power and
its address. The subset of ``tendermint_tpu/types/validator.py`` that
commit verification and the validator-set hash read."""

from __future__ import annotations

from dataclasses import dataclass, field

from tendermint_tpu_torch.crypto.keys import ADDRESS_LEN, PubKey, pubkey_to_proto
from tendermint_tpu_torch.encoding.proto import encode_message_field, encode_varint_field


@dataclass
class Validator:
    pub_key: PubKey
    voting_power: int
    address: bytes = field(default=b"")

    def __post_init__(self):
        if not self.address:
            self.address = self.pub_key.address()

    def bytes(self) -> bytes:
        """SimpleValidator proto {pub_key=1, voting_power=2}: the merkle
        leaf of the validator-set hash (types/validator.go:154-170)."""
        return encode_message_field(1, pubkey_to_proto(self.pub_key)) + encode_varint_field(
            2, self.voting_power
        )

    def validate_basic(self) -> None:
        if self.pub_key is None:
            raise ValueError("validator has nil pubkey")
        if self.voting_power < 0:
            raise ValueError("validator has negative voting power")
        if len(self.address) != ADDRESS_LEN:
            raise ValueError(f"validator address must be 20 bytes: {self.address.hex()}")

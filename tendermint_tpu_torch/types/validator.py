"""Validator (types/validator.go): a public key, its voting power and
its address. The subset of ``tendermint_tpu/types/validator.py`` that
commit verification reads."""

from __future__ import annotations

from dataclasses import dataclass, field

from tendermint_tpu_torch.crypto.keys import PubKey


@dataclass
class Validator:
    pub_key: PubKey
    voting_power: int
    address: bytes = field(default=b"")

    def __post_init__(self):
        if not self.address:
            self.address = self.pub_key.address()

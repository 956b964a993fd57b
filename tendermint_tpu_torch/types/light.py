"""SignedHeader and LightBlock (types/light.go).

The light client's unit of verification: a header plus the commit that
signed it, and the validator set that produced the commit. The part of
``tendermint_tpu/types/light.py`` that verification reads, without the
proto encoders and decoders.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from tendermint_tpu_torch.types.block import Commit, Header
from tendermint_tpu_torch.types.validator_set import ValidatorSet


@dataclass
class SignedHeader:
    """types/light.go SignedHeader {header=1, commit=2}."""

    header: Optional[Header] = None
    commit: Optional[Commit] = None

    @property
    def height(self) -> int:
        return self.header.height if self.header else 0

    @property
    def chain_id(self) -> str:
        return self.header.chain_id if self.header else ""

    def hash(self) -> bytes:
        return self.header.hash() if self.header else b""

    def validate_basic(self, chain_id: str) -> None:
        """types/light.go SignedHeader.ValidateBasic."""
        if self.header is None:
            raise ValueError("missing header")
        if self.commit is None:
            raise ValueError("missing commit")
        self.header.validate_basic()
        self.commit.validate_basic()
        if self.header.chain_id != chain_id:
            raise ValueError(
                f"header belongs to another chain {self.header.chain_id!r}, not {chain_id!r}"
            )
        if self.commit.height != self.header.height:
            raise ValueError(
                f"header and commit height mismatch: {self.header.height} vs "
                f"{self.commit.height}"
            )
        if self.header.hash() != self.commit.block_id.hash:
            raise ValueError("commit signs a different block than the header")


@dataclass
class LightBlock:
    """types/light.go LightBlock {signed_header=1, validator_set=2}."""

    signed_header: Optional[SignedHeader] = None
    validator_set: Optional[ValidatorSet] = None

    def validate_basic(self, chain_id: str) -> None:
        """types/light.go LightBlock.ValidateBasic."""
        if self.signed_header is None:
            raise ValueError("missing signed header")
        if self.validator_set is None:
            raise ValueError("missing validator set")
        self.signed_header.validate_basic(chain_id)
        self.validator_set.validate_basic()
        if self.signed_header.header.validators_hash != self.validator_set.hash():
            raise ValueError("expected validator hash of header to match validator set hash")

"""Commit types: PartSetHeader, BlockID, CommitSig, Commit.

The part of ``tendermint_tpu/types/block.py`` (types/block.go) that
commit verification reads: the block-ID flags, the commit signatures
and ``Commit.vote_sign_bytes``.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import List

from tendermint_tpu_torch.encoding.canonical import (
    SIGNED_MSG_TYPE_PRECOMMIT,
    Timestamp,
    vote_sign_bytes,
)

# Go's time.Time{} (January 1, year 1 UTC) in Unix seconds.
GO_ZERO_TIME = Timestamp(-62135596800, 0)

# BlockIDFlag (types/block.go:583-592)
BLOCK_ID_FLAG_ABSENT = 1
BLOCK_ID_FLAG_COMMIT = 2
BLOCK_ID_FLAG_NIL = 3


@dataclass(frozen=True)
class PartSetHeader:
    """types/part_set.go PartSetHeader {total, hash}."""

    total: int = 0
    hash: bytes = b""


@dataclass(frozen=True)
class BlockID:
    """types/block.go BlockID {hash, part_set_header}."""

    hash: bytes = b""
    part_set_header: PartSetHeader = dc_field(default_factory=PartSetHeader)


NIL_BLOCK_ID = BlockID()


@dataclass
class CommitSig:
    """types/block.go:604-615."""

    block_id_flag: int = BLOCK_ID_FLAG_ABSENT
    validator_address: bytes = b""
    timestamp: Timestamp = GO_ZERO_TIME
    signature: bytes = b""

    @classmethod
    def absent(cls) -> "CommitSig":
        return cls()

    def block_id(self, commit_block_id: BlockID) -> BlockID:
        """The BlockID this signature signed over (types/block.go:641-653)."""
        if self.block_id_flag == BLOCK_ID_FLAG_COMMIT:
            return commit_block_id
        if self.block_id_flag in (BLOCK_ID_FLAG_ABSENT, BLOCK_ID_FLAG_NIL):
            return NIL_BLOCK_ID
        raise ValueError(f"unknown BlockIDFlag: {self.block_id_flag}")


@dataclass
class Commit:
    """types/block.go:815-828; signatures ordered by validator index."""

    height: int = 0
    round: int = 0
    block_id: BlockID = dc_field(default_factory=BlockID)
    signatures: List[CommitSig] = dc_field(default_factory=list)

    def vote_sign_bytes(self, chain_id: str, val_idx: int) -> bytes:
        """types/block.go:851-868: canonical sign-bytes for signature i."""
        cs = self.signatures[val_idx]
        bid = cs.block_id(self.block_id)
        return vote_sign_bytes(
            chain_id,
            SIGNED_MSG_TYPE_PRECOMMIT,
            self.height,
            self.round,
            bid.hash,
            bid.part_set_header.total,
            bid.part_set_header.hash,
            cs.timestamp,
        )

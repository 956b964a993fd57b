"""BlockStore: blocks, parts, commits per height (internal/store/store.go).

A copy of ``tendermint_tpu/storage/blockstore.py``. Key layout mirrors the reference's orderedcode scheme (store.go:651-737)
with one prefix byte + big-endian heights so range scans iterate in
height order: block meta, parts, the canonical commit for height H-1,
the locally-seen commit, a hash->height index, and the extended commit
with vote extensions.
"""

from __future__ import annotations

import threading
from typing import Optional

from tendermint_tpu_torch.storage.kv import KVStore, ordered_key, prefix_end
from tendermint_tpu_torch.types.block import Block, BlockID, Commit, ExtendedCommit
from tendermint_tpu_torch.types.block_meta import BlockMeta
from tendermint_tpu_torch.types.part_set import Part, PartSet

PREFIX_BLOCK_META = 0
PREFIX_BLOCK_PART = 1
PREFIX_BLOCK_COMMIT = 2
PREFIX_SEEN_COMMIT = 3
PREFIX_BLOCK_HASH = 4
PREFIX_EXT_COMMIT = 13


def _meta_key(height: int) -> bytes:
    return ordered_key(PREFIX_BLOCK_META, height)


def _part_key(height: int, index: int) -> bytes:
    return ordered_key(PREFIX_BLOCK_PART, height, index)


def _commit_key(height: int) -> bytes:
    return ordered_key(PREFIX_BLOCK_COMMIT, height)


def _seen_commit_key() -> bytes:
    return bytes([PREFIX_SEEN_COMMIT])


def _ext_commit_key(height: int) -> bytes:
    return ordered_key(PREFIX_EXT_COMMIT, height)


def _hash_key(hash_: bytes) -> bytes:
    return bytes([PREFIX_BLOCK_HASH]) + hash_


class BlockStore:
    """internal/store/store.go:34-: base()..height() contiguous blocks."""

    def __init__(self, db: KVStore):
        self._db = db
        self._mtx = threading.RLock()
        self._base = 0
        self._height = 0
        # Recover base/height from a pre-existing db by scanning metas.
        for k, _ in db.iterator(
            ordered_key(PREFIX_BLOCK_META, 0), prefix_end(bytes([PREFIX_BLOCK_META]))
        ):
            h = int.from_bytes(k[1:9], "big")
            if self._base == 0:
                self._base = h
            self._height = max(self._height, h)

    def base(self) -> int:
        with self._mtx:
            return self._base

    def height(self) -> int:
        with self._mtx:
            return self._height

    def size(self) -> int:
        with self._mtx:
            return 0 if self._height == 0 else self._height - self._base + 1

    # --- save ---------------------------------------------------------------

    def save_block(
        self, block: Block, parts: PartSet, seen_commit: Commit
    ) -> None:
        """store.go SaveBlock: meta + every part + last_commit + seen
        commit, in ONE batch, so a process killed between two writes
        cannot leave a state ahead of a commit that was never stored."""
        if block is None:
            raise ValueError("BlockStore can only save a non-nil block")
        self._save_block_data(
            block, parts,
            extra=[(_seen_commit_key(), seen_commit.to_proto_bytes())],
        )

    def save_block_with_extended_commit(
        self, block: Block, parts: PartSet, seen_extended_commit: ExtendedCommit
    ) -> None:
        """store.go SaveBlockWithExtendedCommit: also persist extensions
        (same single-batch atomicity as save_block)."""
        seen_extended_commit.ensure_extensions()
        self._save_block_data(
            block, parts,
            extra=[
                (
                    _seen_commit_key(),
                    seen_extended_commit.to_commit().to_proto_bytes(),
                ),
                (
                    _ext_commit_key(block.header.height),
                    seen_extended_commit.to_proto_bytes(),
                ),
            ],
        )

    def _save_block_data(self, block: Block, parts: PartSet, extra=()) -> None:
        height = block.header.height
        with self._mtx:
            expected = self._height + 1 if self._height > 0 else height
            if self._height > 0 and height != expected:
                raise ValueError(
                    f"BlockStore can only save contiguous blocks. Wanted "
                    f"{expected}, got {height}"
                )
            if not parts.is_complete():
                raise ValueError("BlockStore can only save complete part sets")
            block_id = BlockID(block.hash(), parts.header())
            meta = BlockMeta.from_block(block, parts.byte_size, block_id)
            batch = self._db.new_batch()
            batch.set(_meta_key(height), meta.to_proto_bytes())
            batch.set(_hash_key(block.hash()), str(height).encode())
            for i in range(parts.total):
                batch.set(_part_key(height, i), parts.get_part(i).to_proto_bytes())
            if block.last_commit is not None:
                batch.set(
                    _commit_key(height - 1), block.last_commit.to_proto_bytes()
                )
            for k, v in extra:
                batch.set(k, v)
            batch.write()
            if self._base == 0:
                self._base = height
            self._height = max(self._height, height)

    # --- load ---------------------------------------------------------------

    def load_block_meta(self, height: int) -> Optional[BlockMeta]:
        raw = self._db.get(_meta_key(height))
        return BlockMeta.from_proto_bytes(raw) if raw is not None else None

    def load_block(self, height: int) -> Optional[Block]:
        meta = self.load_block_meta(height)
        if meta is None:
            return None
        parts = []
        for i in range(meta.block_id.part_set_header.total):
            part = self.load_block_part(height, i)
            if part is None:
                return None
            parts.append(part.bytes)
        return Block.from_proto_bytes(b"".join(parts))

    def load_block_by_hash(self, hash_: bytes) -> Optional[Block]:
        raw = self._db.get(_hash_key(hash_))
        if raw is None:
            return None
        return self.load_block(int(raw.decode()))

    def load_block_part(self, height: int, index: int) -> Optional[Part]:
        raw = self._db.get(_part_key(height, index))
        return Part.from_proto_bytes(raw) if raw is not None else None

    def load_block_commit(self, height: int) -> Optional[Commit]:
        """The canonical commit for `height` (stored with block height+1)."""
        raw = self._db.get(_commit_key(height))
        return Commit.from_proto_bytes(raw) if raw is not None else None

    def save_seen_commit(self, commit: Commit) -> None:
        """Store the commit for the current tip without a block — the
        statesync bootstrap path (store.go SaveSeenCommit), so consensus
        can reconstruct its last commit after the jump."""
        self._db.set(_seen_commit_key(), commit.to_proto_bytes())

    def load_seen_commit(self) -> Optional[Commit]:
        raw = self._db.get(_seen_commit_key())
        return Commit.from_proto_bytes(raw) if raw is not None else None

    def load_block_extended_commit(self, height: int) -> Optional[ExtendedCommit]:
        raw = self._db.get(_ext_commit_key(height))
        return ExtendedCommit.from_proto_bytes(raw) if raw is not None else None

    # --- prune --------------------------------------------------------------

    def prune_blocks(self, retain_height: int) -> int:
        """store.go PruneBlocks: drop [base, retain_height); returns count."""
        with self._mtx:
            if retain_height <= 0:
                raise ValueError("height must be greater than 0")
            if retain_height > self._height:
                raise ValueError(
                    f"cannot prune beyond the latest height {self._height}"
                )
            pruned = 0
            batch = self._db.new_batch()
            for h in range(self._base, retain_height):
                meta = self.load_block_meta(h)
                if meta is None:
                    continue
                batch.delete(_meta_key(h))
                batch.delete(_hash_key(meta.header.hash()))
                batch.delete(_commit_key(h - 1))
                batch.delete(_ext_commit_key(h))
                for i in range(meta.block_id.part_set_header.total):
                    batch.delete(_part_key(h, i))
                pruned += 1
            batch.write()
            self._base = retain_height
            return pruned

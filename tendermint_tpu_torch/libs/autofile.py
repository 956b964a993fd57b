"""Rotating append-only file group (internal/libs/autofile/group.go).

A copy of ``tendermint_tpu/libs/autofile.py``, the consensus WAL's file
(``consensus/wal.py``), less ``head_size``, which nothing of the port
calls.

A Group is a logically-infinite append log physically split into chunks:
writes go to the *head* file; when the head passes ``head_size_limit``
it is sealed into a chunk named ``<head>.<base>`` (base = the chunk's
starting logical offset, zero-padded so lexicographic order is logical
order) and a fresh head opens. When the group's total size passes
``total_size_limit`` the oldest chunks are pruned (group.go's
checkTotalSizeLimit), which is safe for the consensus WAL: replay only
ever starts at the latest #ENDHEIGHT marker.

Readers address bytes by LOGICAL offset — stable across rotation and
pruning — which is what keeps the WAL's replay-offset contract intact.
"""

from __future__ import annotations

import os
import re
from typing import List, Tuple

DEFAULT_HEAD_SIZE_LIMIT = 10 * 1024 * 1024  # group.go defaultHeadSizeLimit
DEFAULT_TOTAL_SIZE_LIMIT = 1024 * 1024 * 1024  # defaultTotalSizeLimit (1GB)

_CHUNK_RE = re.compile(r"\.(\d{16})$")


class Group:
    def __init__(
        self,
        head_path: str,
        head_size_limit: int = DEFAULT_HEAD_SIZE_LIMIT,
        total_size_limit: int = DEFAULT_TOTAL_SIZE_LIMIT,
    ):
        self.head_path = head_path
        self.head_size_limit = head_size_limit
        self.total_size_limit = total_size_limit
        self._head = None
        self._head_base = 0  # logical offset where the head starts
        self._head_size = 0

    # --- chunk bookkeeping ---------------------------------------------------

    def _chunk_paths(self) -> List[Tuple[int, str]]:
        """Sealed chunks as (base_offset, path), oldest first."""
        directory = os.path.dirname(self.head_path) or "."
        prefix = os.path.basename(self.head_path) + "."
        chunks = []
        try:
            names = os.listdir(directory)
        except FileNotFoundError:
            return []
        for name in names:
            if not name.startswith(prefix):
                continue
            m = _CHUNK_RE.search(name)
            if m:
                chunks.append(
                    (int(m.group(1)), os.path.join(directory, name))
                )
        chunks.sort()
        return chunks

    def _derived_head_base(self) -> int:
        """The head's logical base derived from sealed chunks — correct
        whether or not the group is started (reads on an unstarted group
        must see the same offsets a started one would)."""
        chunks = self._chunk_paths()
        if chunks:
            last_base, last_path = chunks[-1]
            return last_base + os.path.getsize(last_path)
        return self._head_base

    def segments(self) -> List[Tuple[int, str]]:
        """All readable segments (base_offset, path), oldest first,
        head last."""
        segs = self._chunk_paths()
        head_base = self._head_base if self._head is not None else (
            self._derived_head_base()
        )
        if os.path.exists(self.head_path):
            segs.append((head_base, self.head_path))
        return segs

    # --- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        chunks = self._chunk_paths()
        if chunks:
            last_base, last_path = chunks[-1]
            self._head_base = last_base + os.path.getsize(last_path)
        else:
            self._head_base = 0
        self._head_size = (
            os.path.getsize(self.head_path)
            if os.path.exists(self.head_path)
            else 0
        )
        os.makedirs(os.path.dirname(self.head_path) or ".", exist_ok=True)
        self._head = open(self.head_path, "ab")

    def stop(self) -> None:
        if self._head is not None:
            self._head.flush()
            os.fsync(self._head.fileno())
            self._head.close()
            self._head = None

    def end_offset(self) -> int:
        return self._head_base + self._head_size

    # --- writing -------------------------------------------------------------

    def write(self, data: bytes) -> None:
        if self._head is None:
            raise RuntimeError("autofile group not started")
        self._head.write(data)
        self._head_size += len(data)

    def flush(self, sync: bool = False) -> None:
        if self._head is None:
            return
        self._head.flush()
        if sync:
            os.fsync(self._head.fileno())

    def maybe_rotate(self) -> bool:
        """Seal the head into a chunk once past the size limit; callers
        invoke this at record boundaries so records never span chunks."""
        if self._head is None or self._head_size < self.head_size_limit:
            return False
        self._head.flush()
        os.fsync(self._head.fileno())
        self._head.close()
        chunk_path = f"{self.head_path}.{self._head_base:016d}"
        os.replace(self.head_path, chunk_path)
        self._head_base += self._head_size
        self._head_size = 0
        self._head = open(self.head_path, "ab")
        self._prune()
        return True

    def _prune(self) -> None:
        chunks = self._chunk_paths()
        total = sum(os.path.getsize(p) for _, p in chunks) + self._head_size
        # never prune the newest sealed chunk: its filename anchors the
        # head's logical base across restarts, keeping offsets stable
        # even when the size limit would otherwise clear every chunk
        for _, path in chunks[:-1]:
            if total <= self.total_size_limit:
                break
            size = os.path.getsize(path)
            os.unlink(path)
            total -= size

    # --- reading -------------------------------------------------------------

    def first_offset(self) -> int:
        segs = self.segments()
        return segs[0][0] if segs else 0

    def iter_segments_from(self, logical_offset: int):
        """Yield (segment_base_of_slice, bytes) per segment from
        logical_offset — peak memory one segment, not the whole log."""
        for base, path in self.segments():
            size = os.path.getsize(path)
            if base + size <= logical_offset:
                continue
            with open(path, "rb") as fh:
                if logical_offset > base:
                    fh.seek(logical_offset - base)
                    yield logical_offset, fh.read()
                else:
                    yield base, fh.read()
            logical_offset = base + size

    def read_from(self, logical_offset: int) -> bytes:
        """All bytes from logical_offset to the end (across segments).
        Prefer iter_segments_from for large logs — this materializes
        everything at once."""
        return b"".join(data for _, data in self.iter_segments_from(logical_offset))

    def truncate_head_tail(self, keep_bytes: int) -> None:
        """Truncate the HEAD file to keep_bytes (crash-torn-tail repair;
        sealed chunks are immutable)."""
        was_open = self._head is not None
        if was_open:
            self._head.close()
            self._head = None
        with open(self.head_path, "r+b") as fh:
            fh.truncate(keep_bytes)
        self._head_size = keep_bytes
        if was_open:
            self._head = open(self.head_path, "ab")

"""The port's autofile group and rotating WAL (``tendermint_tpu_torch/
libs/autofile.py``, ``consensus/wal.py``) on the CPU: the twin of
``tests/test_autofile.py`` (internal/libs/autofile/group.go,
consensus/wal.go rotation behavior), with the JAX package's ``Group``
reading what the port's wrote at the same logical offsets.
"""

import os

import pytest

pytest.importorskip("torch")

from tendermint_tpu.libs.autofile import Group as JGroup
from tendermint_tpu_torch.consensus.wal import (
    WAL,
    EndHeightMessage,
    TimeoutInfo,
)
from tendermint_tpu_torch.libs.autofile import Group


class TestGroup:
    def test_write_read_single_head(self, tmp_path):
        g = Group(str(tmp_path / "log"))
        g.start()
        g.write(b"hello ")
        g.write(b"world")
        g.flush()
        assert g.read_from(0) == b"hello world"
        assert g.read_from(6) == b"world"
        assert g.end_offset() == 11
        g.stop()

    def test_rotation_preserves_logical_offsets(self, tmp_path):
        g = Group(str(tmp_path / "log"), head_size_limit=100)
        g.start()
        blobs = [bytes([i]) * 40 for i in range(10)]  # 400 bytes total
        for blob in blobs:
            g.write(blob)
            g.maybe_rotate()
        g.flush()
        # several sealed chunks plus the head
        assert len(g.segments()) >= 3
        assert g.read_from(0) == b"".join(blobs)
        # mid-stream logical offsets read identically across chunks
        joined = b"".join(blobs)
        for off in (0, 40, 95, 120, 250, 399):
            assert g.read_from(off) == joined[off:]

    def test_restart_resumes_offsets(self, tmp_path):
        path = str(tmp_path / "log")
        g = Group(path, head_size_limit=50)
        g.start()
        g.write(b"a" * 60)
        g.maybe_rotate()
        g.write(b"b" * 10)
        g.flush()
        end = g.end_offset()
        g.stop()

        g2 = Group(path, head_size_limit=50)
        g2.start()
        assert g2.end_offset() == end
        g2.write(b"c" * 5)
        g2.flush()
        assert g2.read_from(0) == b"a" * 60 + b"b" * 10 + b"c" * 5
        g2.stop()

    def test_total_size_limit_prunes_oldest(self, tmp_path):
        g = Group(
            str(tmp_path / "log"), head_size_limit=100, total_size_limit=250
        )
        g.start()
        for i in range(10):
            g.write(bytes([i]) * 100)
            g.maybe_rotate()
        g.flush()
        segs = g.segments()
        total = sum(os.path.getsize(p) for _, p in segs)
        assert total <= 350  # limit + one head's worth of slack
        # the first retained offset moved past zero
        assert g.first_offset() > 0
        # reading from 0 silently starts at the retention horizon
        data = g.read_from(0)
        assert data == g.read_from(g.first_offset())


class TestRotatingWAL:
    def _fill(self, wal, n, start_height=1):
        for h in range(start_height, start_height + n):
            wal.write(TimeoutInfo(0.1, h, 0, 1))
            wal.write_sync(EndHeightMessage(h))

    def test_rotation_replays_all_records(self, tmp_path):
        path = str(tmp_path / "cs.wal")
        wal = WAL(path, head_size_limit=200)
        wal.start()
        self._fill(wal, 50)
        # rotation definitely happened
        assert len(wal._group.segments()) > 2
        msgs = list(wal.iter_messages())
        assert len(msgs) == 100
        heights = [
            m.height for _, m in msgs if isinstance(m, EndHeightMessage)
        ]
        assert heights == list(range(1, 51))
        wal.stop()

    def test_search_end_height_across_chunks(self, tmp_path):
        wal = WAL(str(tmp_path / "cs.wal"), head_size_limit=200)
        wal.start()
        self._fill(wal, 30)
        off = wal.search_for_end_height(17)
        assert off is not None
        # replay from that offset starts at height 18's records
        following = list(wal.iter_messages(off))
        first_ends = [
            m.height
            for _, m in following
            if isinstance(m, EndHeightMessage)
        ]
        assert first_ends[0] == 18
        wal.stop()

    def test_restart_and_torn_tail_on_head(self, tmp_path):
        path = str(tmp_path / "cs.wal")
        wal = WAL(path, head_size_limit=200)
        wal.start()
        self._fill(wal, 20)
        wal.stop()
        # tear the head: append garbage half-record
        with open(path, "ab") as fh:
            fh.write(b"\x00\x01\x02")
        wal2 = WAL(path, head_size_limit=200)
        wal2.start()
        msgs = list(wal2.iter_messages())
        assert len(msgs) == 40  # garbage dropped, all real records intact
        self._fill(wal2, 1, start_height=21)  # still writable
        assert (
            len(list(wal2.iter_messages())) == 42
        )
        wal2.stop()

    def test_unstarted_wal_reads_all_records(self, tmp_path):
        """Reads on a constructed-but-unstarted WAL must see the head at
        its true logical base, not at 0 (replay tooling reads WALs
        without opening them for append)."""
        path = str(tmp_path / "cs.wal")
        wal = WAL(path, head_size_limit=200)
        wal.start()
        self._fill(wal, 20)
        wal.stop()
        cold = WAL(path, head_size_limit=200)  # no start()
        msgs = list(cold.iter_messages())
        assert len(msgs) == 40
        assert cold.search_for_end_height(20) is not None

    def test_pruned_marker_is_fatal_not_silent(self, tmp_path):
        wal = WAL(
            str(tmp_path / "cs.wal"),
            head_size_limit=150,
            total_size_limit=400,
        )
        wal.start()
        self._fill(wal, 200)
        assert wal.search_for_end_height(1) is None
        assert wal.first_offset() > 0  # the caller's fatal-check signal
        wal.stop()

    def test_pruning_keeps_recent_end_heights(self, tmp_path):
        wal = WAL(
            str(tmp_path / "cs.wal"),
            head_size_limit=150,
            total_size_limit=400,
        )
        wal.start()
        self._fill(wal, 200)
        # old heights pruned away, recent ones replayable
        assert wal.search_for_end_height(1) is None
        off = wal.search_for_end_height(200)
        assert off is not None
        wal.stop()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_either_packages_group_reads_the_others_chunks_at_the_same_offsets(tmp_path, writer):
    path = str(tmp_path / "log")
    write_cls, read_cls = (Group, JGroup) if writer == "port" else (JGroup, Group)
    g = write_cls(path, head_size_limit=64)
    g.start()
    blobs = [bytes([i]) * (17 + i) for i in range(12)]
    for blob in blobs:
        g.write(blob)
        g.maybe_rotate()
    g.flush()
    end = g.end_offset()
    g.stop()
    joined = b"".join(blobs)
    other = read_cls(path, head_size_limit=64)
    assert [b for b, _ in other.segments()] == [b for b, _ in write_cls(path).segments()]
    other.start()
    assert other.end_offset() == end == len(joined)
    for off in (0, 17, 63, 64, 150, len(joined) - 1):
        assert other.read_from(off) == joined[off:]
    other.stop()

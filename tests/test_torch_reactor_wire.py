"""The port's consensus reactor wire hygiene: the twin of
``tests/test_reactor_wire.py`` on ``tendermint_tpu_torch``, with its
fourth test, ``test_filedb_auto_compacts``, over both file-store
engines."""

import struct

import pytest

torch = pytest.importorskip("torch")

from tendermint_tpu_torch.consensus.peer_state import PeerState
from tendermint_tpu_torch.consensus.reactor import (
    TAG_VOTE_SET_BITS,
    decode_vote_set_bits,
    encode_vote_set_bits,
)
from tendermint_tpu_torch.libs.bits import BitArray


def test_vote_set_bits_roundtrip():
    ba = BitArray(10)
    ba.set_index(3, True)
    ba.set_index(9, True)
    msg = encode_vote_set_bits(7, 2, 1, ba)
    assert msg[0] == TAG_VOTE_SET_BITS
    h, r, t, got = decode_vote_set_bits(msg[1:])
    assert (h, r, t) == (7, 2, 1)
    assert [got.get_index(i) for i in range(10)] == [ba.get_index(i) for i in range(10)]


def test_vote_set_bits_rejects_hostile_sizes():
    # Oversized nbits claim: would allocate ~256MB
    assert decode_vote_set_bits(struct.pack(">qibi", 1, 0, 1, 2**31 - 1)) is None
    # Truncated body: bits count exceeds backing storage
    assert decode_vote_set_bits(struct.pack(">qibi", 1, 0, 1, 10000) + b"\x01") is None
    # Negative
    assert decode_vote_set_bits(struct.pack(">qibi", 1, 0, 1, -5)) is None


def test_peer_state_catchup_grows_with_late_commit():
    """The first catch-up call often sees no commit yet (n_vals=0); the
    bit arrays grow when the commit appears, keeping the sent marks."""
    ps = PeerState("p")
    ps.ensure_catchup(5, 4, 0)
    assert ps.catchup_commit.size() == 0
    ps.catchup_parts.set_index(1, True)
    ps.ensure_catchup(5, 4, 7)  # commit appeared with 7 signatures
    assert ps.catchup_commit.size() == 7
    assert ps.catchup_parts.get_index(1), "growth must preserve sent marks"
    ps.catchup_commit.set_index(2, True)
    ps.ensure_catchup(5, 4, 7)
    assert ps.catchup_commit.get_index(2)
    ps.ensure_catchup(6, 2, 3)  # height change resets
    assert not ps.catchup_parts.get_index(1)


@pytest.mark.parametrize("kind", ["py", "c"])
def test_filedb_auto_compacts(tmp_path, kind):
    from tendermint_tpu_torch.storage import cfiledb
    from tendermint_tpu_torch.storage.filedb import FileDB

    db = FileDB(str(tmp_path / "kv.fdb")) if kind == "py" else cfiledb.CFileDB(str(tmp_path / "kv.fdb"))
    db.COMPACT_MIN_GARBAGE = 16
    for i in range(200):
        db.set(b"hot", str(i).encode())
    garbage = db._garbage if kind == "py" else db._lib.filedb_garbage(db._h)
    assert garbage < 200, "auto-compaction never ran"
    assert db.get(b"hot") == b"199"
    db.close()

"""The port's consensus WAL beside the JAX package's: every message kind
encodes byte for byte alike, each package reads a WAL the other wrote,
and torn-tail truncation and ``search_for_end_height`` behave alike."""

import os

import pytest

pytest.importorskip("torch")

from tendermint_tpu.consensus import wal as jwal
from tendermint_tpu.types import Proposal as JProposal, Vote as JVote
from tendermint_tpu.types.part_set import PartSet as JPartSet
from tendermint_tpu_torch.consensus import wal
from tendermint_tpu_torch.encoding.canonical import (
    SIGNED_MSG_TYPE_PRECOMMIT,
    SIGNED_MSG_TYPE_PREVOTE,
    Timestamp,
)
from tendermint_tpu_torch.types.block import Proposal, Vote
from tendermint_tpu_torch.types.part_set import PartSet
from tests.helpers import make_block_id as jmake_block_id
from tests.test_torch_privval import make_block_id

ADDR = bytes(range(20))
TS = Timestamp.from_unix_ns(1_700_000_000_123_456_789)


def _messages(pkg):
    """One of each WAL message kind, built in ``pkg`` ("jax" or
    "torch") from the same values."""
    m = jwal if pkg == "jax" else wal
    VoteT, ProposalT, PartSetT = (JVote, JProposal, JPartSet) if pkg == "jax" else (Vote, Proposal, PartSet)
    bid = (jmake_block_id if pkg == "jax" else make_block_id)(b"wal")
    ts = TS if pkg == "torch" else type(JVote().timestamp)(*TS)
    parts = PartSetT.from_data(bytes(range(256)) * 700, 65536)
    prevote = VoteT(type=SIGNED_MSG_TYPE_PREVOTE, height=7, round=2, block_id=bid, timestamp=ts,
                    validator_address=ADDR, validator_index=3, signature=b"\x11" * 64)
    precommit = VoteT(type=SIGNED_MSG_TYPE_PRECOMMIT, height=7, round=2, block_id=bid, timestamp=ts,
                      validator_address=ADDR, validator_index=3, signature=b"\x12" * 64,
                      extension=b"ext", extension_signature=b"\x13" * 64)
    nil_vote = VoteT(type=SIGNED_MSG_TYPE_PREVOTE, height=7, round=0, timestamp=ts, validator_address=ADDR,
                     validator_index=0, signature=b"\x14" * 64)
    proposal = ProposalT(height=7, round=2, pol_round=-1, block_id=bid, timestamp=ts, signature=b"\x15" * 64)
    pol = ProposalT(height=7, round=3, pol_round=1, block_id=bid, timestamp=ts, signature=b"\x16" * 64)
    return [
        m.MsgInfo(prevote, "peer-a"),
        m.MsgInfo(precommit, ""),
        m.MsgInfo(nil_vote, "p"),
        m.MsgInfo(proposal, "peer-b"),
        m.MsgInfo(pol, ""),
        m.MsgInfo(m.BlockPartInfo(7, 2, parts.get_part(0)), "peer-c"),
        m.MsgInfo(m.BlockPartInfo(7, 2, parts.get_part(parts.total - 1)), ""),
        m.TimeoutInfo(3.0, 7, 2, 3),
        m.TimeoutInfo(0.25, 7, 0, 1),
        m.EndHeightMessage(6),
        m.RoundStateEvent(7, 2, "RoundStepPrevote"),
    ]


KINDS = ["prevote", "precommit_ext", "nil_vote", "proposal", "proposal_pol", "part_first", "part_last",
         "timeout", "timeout_float", "end_height", "round_state"]


@pytest.mark.parametrize("i", range(len(KINDS)), ids=KINDS)
def test_every_message_kind_encodes_byte_for_byte_alike(i):
    jmsg, tmsg = _messages("jax")[i], _messages("torch")[i]
    payload = wal._encode_payload(tmsg)
    assert payload == jwal._encode_payload(jmsg)
    # and decodes back to itself in both packages
    assert wal._encode_payload(wal._decode_payload(payload)) == payload
    assert jwal._encode_payload(jwal._decode_payload(payload)) == payload


def _write(m, path, msgs):
    w = m.WAL(path)
    w.start()
    for k, msg in enumerate(msgs):
        (w.write_sync if k % 2 else w.write)(msg)
    w.stop()


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_each_package_reads_a_wal_the_other_wrote(tmp_path, writer):
    jpath, tpath = str(tmp_path / "j.wal"), str(tmp_path / "t.wal")
    _write(jwal, jpath, _messages("jax"))
    _write(wal, tpath, _messages("torch"))
    with open(jpath, "rb") as a, open(tpath, "rb") as b:
        assert a.read() == b.read()
    path = jpath if writer == "jax" else tpath
    reader, other = (wal, jwal) if writer == "jax" else (jwal, wal)
    got = list(reader.WAL(path).iter_messages())
    want = list(other.WAL(path).iter_messages())
    assert [off for off, _ in got] == [off for off, _ in want]
    assert [reader._encode_payload(msg) for _, msg in got] == [other._encode_payload(msg) for _, msg in want]


@pytest.mark.parametrize("cut", [1, 5, 9, 30])
def test_a_torn_tail_is_truncated_alike_and_end_heights_are_found_alike(tmp_path, cut):
    """A record cut ``cut`` bytes short: both packages drop it on start,
    keep the same bytes, and find the same end-height offsets."""
    paths = {}
    for name, m in (("jax", jwal), ("torch", wal)):
        path = str(tmp_path / f"{name}.wal")
        msgs = _messages(name)
        w = m.WAL(path)
        w.start()
        for h in (1, 2, 3):
            for msg in msgs[:4]:
                w.write(msg)
            w.write_sync(m.EndHeightMessage(h))
        w.write(msgs[7])
        w.stop()
        with open(path, "r+b") as f:
            f.truncate(os.path.getsize(path) - cut)
        w = m.WAL(path)
        w.start()
        w.stop()
        paths[name] = path
    with open(paths["jax"], "rb") as a, open(paths["torch"], "rb") as b:
        assert a.read() == b.read()
    for h in (0, 1, 2, 3, 4):
        assert wal.WAL(paths["torch"]).search_for_end_height(h) == jwal.WAL(paths["jax"]).search_for_end_height(h)
    assert wal.WAL(paths["torch"]).search_for_end_height(3) is not None


def test_a_corrupt_interior_record_raises_in_both(tmp_path):
    for m, name in ((jwal, "jax"), (wal, "torch")):
        path = str(tmp_path / f"{name}.wal")
        _write(m, path, _messages(name))
        with open(path, "r+b") as f:
            f.seek(12)
            b = f.read(1)
            f.seek(12)
            f.write(bytes([b[0] ^ 0xFF]))
        with pytest.raises(m.WALCorruptionError):
            list(m.WAL(path).iter_messages())


def test_rotation_keeps_logical_offsets_alike(tmp_path):
    """A small head limit rotates the WAL into chunks; both packages
    name, prune and read them alike."""
    names = {}
    for m, name in ((jwal, "jax"), (wal, "torch")):
        d = tmp_path / name
        d.mkdir()
        w = m.WAL(str(d / "cs.wal"), head_size_limit=1024, total_size_limit=3000)
        w.start()
        for h in range(1, 80):
            w.write(_messages(name)[7])
            w.write_sync(m.EndHeightMessage(h))
        w.stop()
        names[name] = sorted(os.listdir(d))
        offsets = [m.WAL(str(d / "cs.wal")).search_for_end_height(h) for h in (1, 40, 79)]
        names[name + "_offsets"] = offsets
        names[name + "_first"] = m.WAL(str(d / "cs.wal")).first_offset()
    assert names["jax"] == names["torch"] and len(names["jax"]) > 1
    assert names["jax_offsets"] == names["torch_offsets"]
    assert names["jax_first"] == names["torch_first"] > 0

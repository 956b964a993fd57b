"""The port's FilePV beside the JAX package's: the twin of
``tests/test_privval.py``, key and state files carried between the two
packages, byte-identical signatures (Ed25519 is deterministic) and the
same refusals over a seeded walk of heights, rounds and steps. Equality
is exact."""

import json

import numpy as np
import pytest

pytest.importorskip("torch")

from tendermint_tpu.encoding.canonical import (
    SIGNED_MSG_TYPE_PRECOMMIT as J_PRECOMMIT,
    SIGNED_MSG_TYPE_PREVOTE as J_PREVOTE,
    Timestamp as JTimestamp,
)
from tendermint_tpu.privval import FilePV as JFilePV
from tendermint_tpu.privval.file_pv import DoubleSignError as JDoubleSignError
from tendermint_tpu.types import BlockID as JBlockID, PartSetHeader as JPartSetHeader
from tendermint_tpu.types import Proposal as JProposal, Vote as JVote
from tendermint_tpu.crypto.keys import Ed25519PrivKey as JEd25519PrivKey
from tendermint_tpu_torch.encoding.canonical import (
    SIGNED_MSG_TYPE_PRECOMMIT,
    SIGNED_MSG_TYPE_PREVOTE,
    Timestamp,
)
from tendermint_tpu_torch.privval import DoubleSignError, FilePV
from tendermint_tpu_torch.privval.file_pv import LastSignState
from tendermint_tpu_torch.types.block import BlockID, PartSetHeader, Proposal, Vote
from tests.helpers import CHAIN_ID, make_block_id as jmake_block_id

TS = Timestamp.from_unix_ns(1_700_000_000_000_000_000)
TS2 = Timestamp.from_unix_ns(1_700_000_001_000_000_000)


def make_block_id(seed: bytes = b"block") -> BlockID:
    """``tests/helpers.py`` ``make_block_id`` in the port."""
    j = jmake_block_id(seed)
    return BlockID(j.hash, PartSetHeader(j.part_set_header.total, j.part_set_header.hash))


@pytest.fixture()
def pv(tmp_path):
    return FilePV.generate(str(tmp_path / "key.json"), str(tmp_path / "state.json"))


def _vote(pv, type_=SIGNED_MSG_TYPE_PREVOTE, height=1, round_=0, bid=None, ts=TS, extension=b""):
    return Vote(
        type=type_,
        height=height,
        round=round_,
        block_id=bid if bid is not None else make_block_id(),
        timestamp=ts,
        validator_address=pv.get_pub_key().address(),
        validator_index=0,
        extension=extension,
    )


class TestFilePV:
    """``tests/test_privval.py`` ``TestFilePV``, on the port."""

    def test_sign_and_verify(self, pv):
        v = _vote(pv)
        pv.sign_vote(CHAIN_ID, v)
        v.verify(CHAIN_ID, pv.get_pub_key())

    def test_persistence_roundtrip(self, pv, tmp_path):
        v = _vote(pv)
        pv.sign_vote(CHAIN_ID, v)
        reloaded = FilePV.load(str(tmp_path / "key.json"), str(tmp_path / "state.json"))
        assert reloaded.get_pub_key() == pv.get_pub_key()
        assert reloaded.last_sign_state.height == 1
        assert reloaded.last_sign_state.step == 2
        assert reloaded.last_sign_state.signature == v.signature

    def test_height_regression_rejected(self, pv):
        pv.sign_vote(CHAIN_ID, _vote(pv, height=5))
        with pytest.raises(DoubleSignError, match="height regression"):
            pv.sign_vote(CHAIN_ID, _vote(pv, height=4))

    def test_round_regression_rejected(self, pv):
        pv.sign_vote(CHAIN_ID, _vote(pv, height=5, round_=3))
        with pytest.raises(DoubleSignError, match="round regression"):
            pv.sign_vote(CHAIN_ID, _vote(pv, height=5, round_=2))

    def test_step_regression_rejected(self, pv):
        pv.sign_vote(CHAIN_ID, _vote(pv, type_=SIGNED_MSG_TYPE_PRECOMMIT))
        with pytest.raises(DoubleSignError, match="step regression"):
            pv.sign_vote(CHAIN_ID, _vote(pv, type_=SIGNED_MSG_TYPE_PREVOTE))

    def test_same_vote_reuses_signature(self, pv):
        v1 = _vote(pv)
        pv.sign_vote(CHAIN_ID, v1)
        v2 = _vote(pv)
        pv.sign_vote(CHAIN_ID, v2)
        assert v2.signature == v1.signature

    def test_timestamp_only_diff_reuses_signature(self, pv):
        v1 = _vote(pv, ts=TS)
        pv.sign_vote(CHAIN_ID, v1)
        v2 = _vote(pv, ts=TS2)
        pv.sign_vote(CHAIN_ID, v2)
        assert v2.signature == v1.signature
        assert v2.timestamp == TS  # back to the signed timestamp
        v2.verify(CHAIN_ID, pv.get_pub_key())

    def test_conflicting_block_rejected(self, pv):
        pv.sign_vote(CHAIN_ID, _vote(pv, bid=make_block_id(b"a")))
        with pytest.raises(DoubleSignError, match="conflicting data"):
            pv.sign_vote(CHAIN_ID, _vote(pv, bid=make_block_id(b"b")))

    def test_precommit_extension_signed(self, pv):
        v = _vote(pv, type_=SIGNED_MSG_TYPE_PRECOMMIT, extension=b"price:9")
        pv.sign_vote(CHAIN_ID, v)
        assert v.extension_signature
        v.verify_vote_and_extension(CHAIN_ID, pv.get_pub_key())

    def test_extension_on_prevote_rejected(self, pv):
        v = _vote(pv, type_=SIGNED_MSG_TYPE_PREVOTE, extension=b"x")
        with pytest.raises(ValueError, match="extension"):
            pv.sign_vote(CHAIN_ID, v)

    def test_nil_precommit_no_extension_signature(self, pv):
        v = _vote(pv, type_=SIGNED_MSG_TYPE_PRECOMMIT, bid=BlockID())
        pv.sign_vote(CHAIN_ID, v)
        assert v.extension_signature == b""

    def test_sign_proposal_and_hrs(self, pv):
        p = Proposal(height=3, round=0, pol_round=-1, block_id=make_block_id(), timestamp=TS)
        pv.sign_proposal(CHAIN_ID, p)
        assert p.signature
        # the proposal step (1) comes before the votes at one HRS
        pv.sign_vote(CHAIN_ID, _vote(pv, height=3))
        with pytest.raises(DoubleSignError):
            pv.sign_proposal(
                CHAIN_ID,
                Proposal(height=3, round=0, pol_round=-1, block_id=make_block_id(b"other"), timestamp=TS),
            )

    def test_load_or_generate(self, tmp_path):
        key, state = str(tmp_path / "k.json"), str(tmp_path / "s.json")
        pv1 = FilePV.load_or_generate(key, state)
        pv2 = FilePV.load_or_generate(key, state)
        assert pv1.get_pub_key() == pv2.get_pub_key()


# --- the two packages ---------------------------------------------------------


def _jbid(bid: BlockID) -> JBlockID:
    return JBlockID(bid.hash, JPartSetHeader(bid.part_set_header.total, bid.part_set_header.hash))


def _pair(tmp_path, seed=7):
    """A JAX FilePV of a seeded key, and the port's FilePV loaded from
    the files the JAX one wrote."""
    jpv = JFilePV(
        JEd25519PrivKey.from_seed(bytes([seed]) * 32), str(tmp_path / "jkey.json"), str(tmp_path / "jstate.json")
    )
    jpv.save()
    return jpv, FilePV.load(str(tmp_path / "jkey.json"), str(tmp_path / "jstate.json"))


def test_the_jax_key_and_state_files_load_in_the_port_and_back(tmp_path):
    jpv, tpv = _pair(tmp_path)
    assert tpv.get_pub_key().bytes() == jpv.get_pub_key().bytes()
    assert tpv.priv_key.bytes() == jpv.priv_key.bytes()
    jv = JVote(type=J_PREVOTE, height=4, round=1, block_id=jmake_block_id(), timestamp=JTimestamp(*TS),
               validator_address=jpv.get_pub_key().address(), validator_index=0)
    jpv.sign_vote(CHAIN_ID, jv)
    tpv = FilePV.load(str(tmp_path / "jkey.json"), str(tmp_path / "jstate.json"))
    assert tpv.last_sign_state == LastSignState(4, 1, 2, jv.signature, jv.sign_bytes(CHAIN_ID))
    # the port writes the same documents back
    tpv.key_file_path, tpv.state_file_path = str(tmp_path / "tkey.json"), str(tmp_path / "tstate.json")
    tpv.save()
    for j, t in (("jkey.json", "tkey.json"), ("jstate.json", "tstate.json")):
        assert json.loads((tmp_path / j).read_text()) == json.loads((tmp_path / t).read_text())
    jpv2 = JFilePV.load(str(tmp_path / "tkey.json"), str(tmp_path / "tstate.json"))
    assert jpv2.last_sign_state.signature == jv.signature


def test_votes_and_proposals_are_signed_byte_for_byte_alike(tmp_path):
    jpv, tpv = _pair(tmp_path)
    addr = tpv.get_pub_key().address()
    step = 0
    for height in (1, 2):
        for round_ in (0, 1):
            bid = make_block_id(b"b%d%d" % (height, round_))
            ts = Timestamp.from_unix_ns(TS.to_unix_ns() + step)
            step += 1
            jp = JProposal(height=height, round=round_, pol_round=round_ - 1, block_id=_jbid(bid),
                           timestamp=JTimestamp(*ts))
            tp = Proposal(height=height, round=round_, pol_round=round_ - 1, block_id=bid, timestamp=ts)
            jpv.sign_proposal(CHAIN_ID, jp)
            tpv.sign_proposal(CHAIN_ID, tp)
            assert tp.sign_bytes(CHAIN_ID) == jp.sign_bytes(CHAIN_ID)
            assert tp.to_proto_bytes() == jp.to_proto_bytes()
            for jtype, ttype in ((J_PREVOTE, SIGNED_MSG_TYPE_PREVOTE), (J_PRECOMMIT, SIGNED_MSG_TYPE_PRECOMMIT)):
                ext = b"ext-%d" % height if ttype == SIGNED_MSG_TYPE_PRECOMMIT else b""
                jv = JVote(type=jtype, height=height, round=round_, block_id=_jbid(bid), timestamp=JTimestamp(*ts),
                           validator_address=addr, validator_index=3, extension=ext)
                tv = Vote(type=ttype, height=height, round=round_, block_id=bid, timestamp=ts,
                          validator_address=addr, validator_index=3, extension=ext)
                jpv.sign_vote(CHAIN_ID, jv)
                tpv.sign_vote(CHAIN_ID, tv)
                assert (tv.signature, tv.extension_signature) == (jv.signature, jv.extension_signature)
                assert tv.to_proto_bytes() == jv.to_proto_bytes()
                assert JVote.from_proto_bytes(tv.to_proto_bytes()) == jv
                assert Vote.from_proto_bytes(jv.to_proto_bytes()) == tv


def test_the_same_refusals_over_a_seeded_walk(tmp_path):
    """Both signers see the same seeded stream of (height, round, step,
    block, timestamp) requests: the same signature or the same error."""
    jpv, tpv = _pair(tmp_path, seed=11)
    tpv.state_file_path = str(tmp_path / "tstate.json")
    addr = tpv.get_pub_key().address()
    rng = np.random.default_rng(2026)
    outcomes = {"signed": 0, "refused": 0}
    path = []  # the (height, round, kind) requests so far: a walk forward ...
    for _ in range(60):
        if path and rng.random() < 0.3:  # ... with a step back or a repeat now and then
            height, round_, kind = path[int(rng.integers(0, len(path)))]
        else:
            height, round_, kind = path[-1] if path else (1, 0, 0)
            kind += 1
            if kind == 3:
                height, round_, kind = (height + 1, 0, 0) if rng.random() < 0.5 else (height, round_ + 1, 0)
        path.append((height, round_, kind))
        bid = make_block_id(b"blk%d" % int(rng.integers(0, 2)))
        ts = Timestamp.from_unix_ns(TS.to_unix_ns() + int(rng.integers(0, 3)) * 1_000_000)
        if kind == 0:
            j = JProposal(height=height, round=round_, pol_round=-1, block_id=_jbid(bid), timestamp=JTimestamp(*ts))
            t = Proposal(height=height, round=round_, pol_round=-1, block_id=bid, timestamp=ts)
            jsign, tsign = jpv.sign_proposal, tpv.sign_proposal
        else:
            jt, tt = (J_PREVOTE, SIGNED_MSG_TYPE_PREVOTE) if kind == 1 else (J_PRECOMMIT, SIGNED_MSG_TYPE_PRECOMMIT)
            j = JVote(type=jt, height=height, round=round_, block_id=_jbid(bid), timestamp=JTimestamp(*ts),
                      validator_address=addr, validator_index=0)
            t = Vote(type=tt, height=height, round=round_, block_id=bid, timestamp=ts,
                     validator_address=addr, validator_index=0)
            jsign, tsign = jpv.sign_vote, tpv.sign_vote
        jerr = terr = None
        try:
            jsign(CHAIN_ID, j)
        except JDoubleSignError as e:
            jerr = str(e)
        try:
            tsign(CHAIN_ID, t)
        except DoubleSignError as e:
            terr = str(e)
        assert jerr == terr
        if jerr is None:
            assert (t.signature, tuple(t.timestamp)) == (j.signature, tuple(j.timestamp))
        outcomes["refused" if jerr else "signed"] += 1
    assert outcomes["signed"] > 5 and outcomes["refused"] > 5
    assert (tpv.last_sign_state.height, tpv.last_sign_state.round, tpv.last_sign_state.step) == (
        jpv.last_sign_state.height, jpv.last_sign_state.round, jpv.last_sign_state.step)

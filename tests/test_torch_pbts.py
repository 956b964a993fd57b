"""Proposer-based timestamps on the port's state machine: the twin of
``tests/test_pbts.py`` (the timeliness predicate and the prevote
decision), and the predicate held to the JAX package's over a seeded
grid of timestamps, receive times and rounds."""

import time

import numpy as np
import pytest

pytest.importorskip("torch")

import tendermint_tpu_torch
from tendermint_tpu.encoding.canonical import Timestamp as JTimestamp
from tendermint_tpu_torch.consensus.cstypes import RoundStep
from tendermint_tpu_torch.encoding.canonical import SIGNED_MSG_TYPE_PREVOTE, Timestamp
from tendermint_tpu_torch.types.block import BLOCK_PART_SIZE_BYTES, BlockID, ExtendedCommit, Proposal
from tendermint_tpu_torch.types.part_set import PartSet
from tests import test_consensus as jcons
from tests import test_pbts as jpbts
from tests.test_torch_consensus import build_validator

NS = 1_000_000_000


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(tendermint_tpu_torch, "DEFAULT_DEVICE", "cpu")


def _stage_proposal(cs, ts_ns: int, recv_ns: int, round_: int = 0):
    """A complete proposal and block in the round state, with the given
    proposal timestamp and receive time (as gossip would leave them)."""
    rs = cs.rs
    last = cs.rs.last_commit.make_extended_commit() if rs.last_commit is not None else ExtendedCommit()
    block = cs.block_exec.create_proposal_block(rs.height, cs.state, last, cs.state.validators.get_proposer().address)
    block.header.time = Timestamp.from_unix_ns(ts_ns)
    block._hash = None
    parts = PartSet.from_data(block.to_proto_bytes(), BLOCK_PART_SIZE_BYTES)
    proposal = Proposal(height=rs.height, round=round_, pol_round=-1, block_id=BlockID(block.hash(), parts.header()),
                        timestamp=Timestamp.from_unix_ns(ts_ns))
    rs.round = round_
    rs.step = RoundStep.PROPOSE
    rs.proposal = proposal
    rs.proposal_receive_time = Timestamp.from_unix_ns(recv_ns)
    rs.proposal_block = block
    rs.proposal_block_parts = parts
    return block


def _prevote_cast(cs):
    """Run the prevote decision; the block hash prevoted (b'' for nil)."""
    votes = []
    orig = cs._sign_add_vote
    cs._sign_add_vote = lambda type_, block_hash, psh: votes.append((type_, block_hash))
    try:
        cs._do_prevote(cs.rs.height, cs.rs.round)
    finally:
        cs._sign_add_vote = orig
    assert votes and votes[0][0] == SIGNED_MSG_TYPE_PREVOTE
    return votes[0][1]


@pytest.fixture()
def validator(tmp_path):
    cs, privs, app = build_validator(tmp_path)
    sp = cs.state.consensus_params.synchrony
    assert sp.precision > 0 and sp.message_delay > 0
    yield cs
    cs.stop()


class TestTimelinessPredicate:
    def test_exact_receipt_is_timely(self, validator):
        now = time.time_ns()
        _stage_proposal(validator, ts_ns=now, recv_ns=now)
        assert validator._proposal_is_timely()

    def test_future_timestamp_untimely(self, validator):
        sp = validator.state.consensus_params.synchrony
        now = time.time_ns()
        ahead = int(sp.precision * NS) + 200_000_000
        _stage_proposal(validator, ts_ns=now + ahead, recv_ns=now)
        assert not validator._proposal_is_timely()

    def test_stale_timestamp_untimely(self, validator):
        sp = validator.state.consensus_params.synchrony
        now = time.time_ns()
        behind = int((sp.precision + sp.message_delay) * NS) + 200_000_000
        _stage_proposal(validator, ts_ns=now - behind, recv_ns=now)
        assert not validator._proposal_is_timely()

    def test_round_relaxation_eventually_accepts(self, validator):
        sp = validator.state.consensus_params.synchrony
        now = time.time_ns()
        behind = int((sp.precision + sp.message_delay) * NS) + 500_000_000
        for round_ in range(0, 60):
            _stage_proposal(validator, ts_ns=now - behind, recv_ns=now, round_=round_)
            if validator._proposal_is_timely():
                assert round_ > 0, "round 0 must reject this stale proposal"
                return
        pytest.fail("relaxation never accepted the proposal")


class TestPrevoteDecision:
    def test_timely_proposal_prevoted(self, validator):
        now = time.time_ns()
        block = _stage_proposal(validator, ts_ns=now, recv_ns=now)
        assert _prevote_cast(validator) == block.hash()

    def test_untimely_proposal_gets_nil_prevote(self, validator):
        sp = validator.state.consensus_params.synchrony
        now = time.time_ns()
        _stage_proposal(validator, ts_ns=now + int(sp.precision * NS) + 500_000_000, recv_ns=now)
        assert _prevote_cast(validator) == b""

    def test_header_time_mismatch_gets_nil_prevote(self, validator):
        now = time.time_ns()
        _stage_proposal(validator, ts_ns=now, recv_ns=now)
        validator.rs.proposal_block.header.time = Timestamp.from_unix_ns(now + NS)
        validator.rs.proposal_block._hash = None
        assert _prevote_cast(validator) == b""

    def test_locked_validator_ignores_timeliness(self, validator):
        sp = validator.state.consensus_params.synchrony
        now = time.time_ns()
        behind = int((sp.precision + sp.message_delay) * NS) + 500_000_000
        block = _stage_proposal(validator, ts_ns=now - behind, recv_ns=now)
        validator.rs.locked_round = 0
        validator.rs.locked_block = block
        validator.rs.locked_block_parts = validator.rs.proposal_block_parts
        validator.rs.round = 1
        validator.rs.proposal.round = 1
        assert _prevote_cast(validator) == block.hash()


def test_the_timeliness_predicate_matches_the_jax_package(tmp_path):
    """Both packages' ``_proposal_is_timely`` over a seeded grid of
    offsets around the window's edges and rounds 0-9."""
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    jcs, _, _ = jcons.build_validator(tmp_path / "j")
    tcs, _, _ = build_validator(tmp_path / "t")
    sp = tcs.state.consensus_params.synchrony
    edges = [-int(sp.precision * NS), int((sp.precision + sp.message_delay) * NS)]
    rng = np.random.default_rng(12)
    now = time.time_ns()
    answers = set()
    try:
        for _ in range(80):
            round_ = int(rng.integers(0, 10))
            offset = int(edges[int(rng.integers(0, 2))] * (1.1 ** round_)) + int(rng.integers(-3, 4)) * 100_000_000
            _stage_proposal(tcs, ts_ns=now, recv_ns=now + offset, round_=round_)
            jpbts._stage_proposal(jcs, ts_ns=now, recv_ns=now + offset, round_=round_)
            assert isinstance(jcs.rs.proposal_receive_time, JTimestamp)
            got = tcs._proposal_is_timely()
            assert got == jcs._proposal_is_timely(), (round_, offset)
            answers.add(got)
    finally:
        jcs.stop()
        tcs.stop()
    assert answers == {True, False}

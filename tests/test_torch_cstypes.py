"""The port's HeightVoteSet and RoundState beside the JAX package's: the
twin of ``tests/test_cstypes.py``, then seeded vote streams fed into
both packages' ``HeightVoteSet``, which must give the same accepts, the
same errors (a conflicting vote among them), the same
``two_thirds_majority``, ``pol_info`` and peer catch-up rounds. Four
validators and host verification only: nothing reaches a batch."""

import numpy as np
import pytest

pytest.importorskip("torch")

from tendermint_tpu.consensus import cstypes as jcstypes
from tendermint_tpu.encoding.canonical import Timestamp as JTimestamp
from tendermint_tpu.types import BlockID as JBlockID, PartSetHeader as JPartSetHeader, Vote as JVote
from tendermint_tpu_torch.consensus.cstypes import (
    GotVoteFromUnwantedRoundError,
    HeightVoteSet,
    RoundState,
    RoundStep,
)
from tendermint_tpu_torch.encoding.canonical import (
    SIGNED_MSG_TYPE_PRECOMMIT,
    SIGNED_MSG_TYPE_PREVOTE,
    Timestamp,
)
from tendermint_tpu_torch.types.block import BlockID, Vote
from tests import helpers as jhelpers
from tests.test_torch_execution import make_validators
from tests.test_torch_privval import make_block_id

CHAIN_ID = jhelpers.CHAIN_ID


def signed_vote(priv, vset, idx, height=1, round_=0, type_=SIGNED_MSG_TYPE_PREVOTE, block_id=None, extension=b""):
    """``tests/test_vote_set.py`` ``signed_vote`` in the port."""
    vote = Vote(
        type=type_,
        height=height,
        round=round_,
        block_id=block_id if block_id is not None else BlockID(),
        timestamp=Timestamp.from_unix_ns(1_700_000_000_000_000_000 + idx),
        validator_address=vset.validators[idx].address,
        validator_index=idx,
        extension=extension,
    )
    vote.signature = priv.sign(vote.sign_bytes(CHAIN_ID))
    if extension:
        vote.extension_signature = priv.sign(vote.extension_sign_bytes(CHAIN_ID))
    return vote


def test_round_progression_and_pol():
    privs, vset = make_validators(4, power=1)
    hvs = HeightVoteSet(CHAIN_ID, 1, vset)
    bid = make_block_id()
    hvs.set_round(1)
    for i in range(4):
        assert hvs.add_vote(signed_vote(privs[i], vset, i, height=1, round_=1, block_id=bid))
    pol_round, pol_bid = hvs.pol_info()
    assert pol_round == 1 and pol_bid == bid
    assert hvs.prevotes(1).has_two_thirds_majority()
    assert hvs.prevotes(0) is not None
    assert hvs.prevotes(5) is None


def test_peer_catchup_round_limit():
    privs, vset = make_validators(4)
    hvs = HeightVoteSet(CHAIN_ID, 1, vset)
    # a peer may bring in at most 2 rounds the set did not expect
    v1 = signed_vote(privs[0], vset, 0, height=1, round_=5, block_id=make_block_id())
    assert hvs.add_vote(v1, peer_id="peerA")
    v2 = signed_vote(privs[1], vset, 1, height=1, round_=6, block_id=make_block_id())
    assert hvs.add_vote(v2, peer_id="peerA")
    v3 = signed_vote(privs[2], vset, 2, height=1, round_=7, block_id=make_block_id())
    with pytest.raises(GotVoteFromUnwantedRoundError):
        hvs.add_vote(v3, peer_id="peerA")
    # another peer still has its allowance
    assert hvs.add_vote(v3, peer_id="peerB")


def test_duplicate_vote_returns_false():
    privs, vset = make_validators(4)
    hvs = HeightVoteSet(CHAIN_ID, 1, vset)
    v = signed_vote(privs[0], vset, 0, height=1, round_=0, block_id=make_block_id())
    assert hvs.add_vote(v)
    assert not hvs.add_vote(v)


def test_precommits_tracked_separately():
    privs, vset = make_validators(4)
    hvs = HeightVoteSet(CHAIN_ID, 1, vset)
    bid = make_block_id()
    hvs.add_vote(signed_vote(privs[0], vset, 0, height=1, block_id=bid))
    hvs.add_vote(signed_vote(privs[0], vset, 0, height=1, type_=SIGNED_MSG_TYPE_PRECOMMIT, block_id=bid))
    assert hvs.prevotes(0).get_by_index(0) is not None
    assert hvs.precommits(0).get_by_index(0) is not None


def test_round_state_defaults():
    rs = RoundState()
    assert rs.step == RoundStep.NEW_HEIGHT
    assert rs.locked_round == -1 and rs.valid_round == -1
    assert rs.height_round_step() == "0/0/1"


def test_round_steps_and_errors_match_the_jax_package():
    assert [(s.name, int(s)) for s in RoundStep] == [(s.name, int(s)) for s in jcstypes.RoundStep]
    assert RoundState().height_round_step() == jcstypes.RoundState().height_round_step()


# --- seeded streams through both packages --------------------------------------


def _outcome(fn):
    """("ok", result) or the error's kind and text; the text of a
    non-deterministic signature holds both votes' reprs, which differ
    between the packages by module, so only its kind is kept."""
    try:
        return ("ok", fn())
    except Exception as e:
        kind = type(e).__name__
        return (kind, "" if kind == "NonDeterministicSignatureError" else str(e))


def _jbid(bid):
    return JBlockID(bid.hash, JPartSetHeader(bid.part_set_header.total, bid.part_set_header.hash))


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("extended", [False, True], ids=["plain", "extended"])
def test_seeded_vote_streams_give_the_same_decisions(seed, extended):
    """Votes of 4 validators, for 2 blocks or nil, over rounds 0-4, from
    3 peers, with replays, conflicts, bad signatures and peer-claimed
    majorities, go into both packages' ``HeightVoteSet``: every answer
    and every query after it must agree."""
    privs, vset = make_validators(4, power=1)
    jprivs, jvset = jhelpers.make_validators(4, power=1)
    assert [v.address for v in vset.validators] == [v.address for v in jvset.validators]
    rng = np.random.default_rng(seed)
    make = HeightVoteSet.extended if extended else HeightVoteSet
    jmake = jcstypes.HeightVoteSet.extended if extended else jcstypes.HeightVoteSet
    hvs, jhvs = make(CHAIN_ID, 3, vset), jmake(CHAIN_ID, 3, jvset)
    blocks = [make_block_id(b"a"), make_block_id(b"b"), BlockID()]
    kinds = {"accepted": 0, "errors": set()}
    for step in range(120):
        action = rng.random()
        if action < 0.08:
            r = int(hvs.round) + int(rng.integers(0, 2))
            got = (_outcome(lambda: hvs.set_round(r)), _outcome(lambda: jhvs.set_round(r)))
        elif action < 0.14:
            r, t, b = int(rng.integers(0, 5)), int(rng.integers(1, 3)), blocks[int(rng.integers(0, 2))]
            peer = f"p{int(rng.integers(0, 3))}"
            got = (_outcome(lambda: hvs.set_peer_maj23(r, t, peer, b)),
                   _outcome(lambda: jhvs.set_peer_maj23(r, t, peer, _jbid(b))))
        else:
            i = int(rng.integers(0, 4))
            t = int(rng.integers(1, 3))
            r = int(rng.integers(0, 5))
            b = blocks[int(rng.integers(0, 3))]
            ext = b"x%d" % i if (extended and t == SIGNED_MSG_TYPE_PRECOMMIT and not b.is_nil()) else b""
            v = signed_vote(privs[i], vset, i, height=3, round_=r, type_=t, block_id=b, extension=ext)
            if rng.random() < 0.1:
                v.signature = bytes(64)
            jv = JVote(type=t, height=3, round=r, block_id=_jbid(b), timestamp=JTimestamp(*v.timestamp),
                       validator_address=v.validator_address, validator_index=i, signature=v.signature,
                       extension=v.extension, extension_signature=v.extension_signature)
            peer = f"p{int(rng.integers(0, 3))}"
            got = (_outcome(lambda: hvs.add_vote(v, peer)), _outcome(lambda: jhvs.add_vote(jv, peer)))
            if got[0][0] == "ok" and got[0][1]:
                kinds["accepted"] += 1
        assert got[0] == got[1], f"step {step}: {got}"
        if got[0][0] != "ok":
            kinds["errors"].add(got[0][0])
        assert hvs.round == jhvs.round
        pol, jpol = hvs.pol_info(), jhvs.pol_info()
        assert pol[0] == jpol[0] and pol[1].hash == jpol[1].hash
        assert hvs.peer_catchup_rounds == jhvs.peer_catchup_rounds
        assert sorted(hvs.round_vote_sets) == sorted(jhvs.round_vote_sets)
        for r in hvs.round_vote_sets:
            for ours, theirs in ((hvs.prevotes(r), jhvs.prevotes(r)), (hvs.precommits(r), jhvs.precommits(r))):
                (bid, ok), (jbid, jok) = ours.two_thirds_majority(), theirs.two_thirds_majority()
                assert (ok, bid.hash) == (jok, jbid.hash)
                assert ours.has_two_thirds_any() == theirs.has_two_thirds_any()
                assert ours.bit_array().get_true_indices() == theirs.bit_array().get_true_indices()
    assert kinds["accepted"] > 10
    assert "ConflictingVotesError" in kinds["errors"] and "VoteError" in kinds["errors"]

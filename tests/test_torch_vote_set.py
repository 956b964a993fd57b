"""The port's ``VoteSet`` and ``Vote`` against the JAX package's.

Both vote sets are fed the same votes (signed with the JAX package's
keys, carried to the port with ``types/carry.py``); every add must give
the same return value, or the same exception type and message, and the
tallies, bit arrays, lookups and ``make_commit().to_proto_bytes()`` must
be equal. A pre-verification tag spares the host verify only for the key
and sign-bytes it was issued for: a stale tag, or one for another key,
sends the vote back to a full check in both packages.
"""

import copy
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from tendermint_tpu.crypto import keys as jkeys
from tendermint_tpu.encoding.canonical import (
    SIGNED_MSG_TYPE_PRECOMMIT,
    SIGNED_MSG_TYPE_PREVOTE,
    Timestamp as JTimestamp,
)
from tendermint_tpu.types import BlockID as JBlockID
from tendermint_tpu.types import Vote as JVote
from tendermint_tpu.types import vote_set as jvs
from tendermint_tpu_torch.crypto import keys as tkeys
from tendermint_tpu_torch.encoding import canonical as tcanonical
from tendermint_tpu_torch.types import carry
from tendermint_tpu_torch.types import vote_set as tvs
from tests.helpers import CHAIN_ID, make_block_id, make_validators

BID_A = make_block_id(b"a")
BID_B = make_block_id(b"b")


def test_signed_message_types_match():
    assert (tcanonical.SIGNED_MSG_TYPE_PREVOTE, tcanonical.SIGNED_MSG_TYPE_PRECOMMIT) == (
        SIGNED_MSG_TYPE_PREVOTE, SIGNED_MSG_TYPE_PRECOMMIT)


def _vote(privs, vset, idx, height=1, round_=0, type_=SIGNED_MSG_TYPE_PREVOTE, block_id=BID_A,
          extension=b"", signer=None):
    vote = JVote(
        type=type_,
        height=height,
        round=round_,
        block_id=block_id,
        timestamp=JTimestamp.from_unix_ns(1_700_000_000_000_000_000 + idx),
        validator_address=vset.validators[idx].address,
        validator_index=idx,
        extension=extension,
    )
    priv = privs[idx if signer is None else signer]
    vote.signature = priv.sign(vote.sign_bytes(CHAIN_ID))
    if extension:
        vote.extension_signature = priv.sign(vote.extension_sign_bytes(CHAIN_ID))
    return vote


class Twin:
    """A JAX vote set and the port's, fed alike."""

    def __init__(self, vset, height, round_, type_, extended=False):
        make_j = jvs.VoteSet.extended if extended else jvs.VoteSet
        make_t = tvs.VoteSet.extended if extended else tvs.VoteSet
        self.j = make_j(CHAIN_ID, height, round_, type_, vset)
        self.t = make_t(CHAIN_ID, height, round_, type_, carry.validator_set(vset))

    @staticmethod
    def _call(fn):
        try:
            return "ok", fn()
        except Exception as exc:  # the outcome under comparison
            return type(exc).__name__, str(exc)

    def add(self, jvote):
        got_j = self._call(lambda: self.j.add_vote(jvote))
        got_t = self._call(lambda: self.t.add_vote(carry.vote(jvote)))
        assert got_j == got_t
        return got_t

    def peer_maj23(self, peer, bid):
        got_j = self._call(lambda: self.j.set_peer_maj23(peer, bid))
        got_t = self._call(lambda: self.t.set_peer_maj23(peer, carry.block_id(bid)))
        assert got_j == got_t
        return got_t

    def assert_same_state(self, vset, block_ids):
        j, t = self.j, self.t
        bits = lambda ba: None if ba is None else (ba.size(), bytes(ba._elems), str(ba))
        assert bits(j.bit_array()) == bits(t.bit_array())
        for bid in block_ids:
            assert bits(j.bit_array_by_block_id(bid)) == bits(t.bit_array_by_block_id(carry.block_id(bid)))
        jmaj, jok = j.two_thirds_majority()
        tmaj, tok = t.two_thirds_majority()
        assert (jok, jmaj.to_proto_bytes()) == (tok, tmaj.to_proto_bytes())
        for q in ("has_two_thirds_majority", "has_two_thirds_any", "has_all", "size"):
            assert getattr(j, q)() == getattr(t, q)(), q
        assert j.sum == t.sum
        shape = lambda v: None if v is None else (v.validator_index, v.block_id.key(), bytes(v.signature))
        for i in range(-1, len(vset) + 1):
            assert shape(j.get_by_index(i)) == shape(t.get_by_index(i))
        for val in vset.validators:
            assert shape(j.get_by_address(val.address)) == shape(t.get_by_address(val.address))
        assert [shape(v) for v in j.vote_list()] == [shape(v) for v in t.vote_list()]


def test_add_vote_outcomes_errors_and_tallies_match():
    privs, vset = make_validators(10, power=1)
    tw = Twin(vset, 1, 0, SIGNED_MSG_TYPE_PREVOTE)
    for i in range(6):
        assert tw.add(_vote(privs, vset, i)) == ("ok", True)
    assert tw.add(_vote(privs, vset, 0)) == ("ok", False)  # duplicate
    other_sig = _vote(privs, vset, 1)
    other_sig.signature = bytes(64)
    kind, msg = tw.add(other_sig)
    assert kind == "NonDeterministicSignatureError" and msg.startswith("existing vote: Vote(")
    assert tw.add(_vote(privs, vset, 6, height=2))[0] == "VoteSetError"  # wrong step
    assert tw.add(_vote(privs, vset, 6, round_=1))[1].endswith("unexpected step")
    assert tw.add(_vote(privs, vset, 6, type_=SIGNED_MSG_TYPE_PRECOMMIT))[0] == "VoteSetError"
    bad_index = dataclasses.replace(_vote(privs, vset, 6), validator_index=10)
    assert tw.add(bad_index) == (
        "VoteSetError", "cannot find validator 10 in valSet of size 10: invalid validator index")
    assert tw.add(dataclasses.replace(_vote(privs, vset, 6), validator_index=-1))[1] == (
        "index < 0: invalid validator index")
    assert tw.add(dataclasses.replace(_vote(privs, vset, 6), validator_address=b""))[1] == (
        "empty address: invalid validator address")
    wrong_addr = dataclasses.replace(_vote(privs, vset, 6), validator_address=vset.validators[7].address)
    assert tw.add(wrong_addr)[1].endswith("invalid validator address")
    forged = _vote(privs, vset, 6, signer=7)  # validator 7's key signed 6's vote
    assert tw.add(forged) == ("VoteError", "invalid signature")
    kind, msg = tw.add(_vote(privs, vset, 0, block_id=BID_B))
    assert kind == "ConflictingVotesError"
    assert msg == f"conflicting votes from validator {vset.validators[0].address.hex()}"
    assert tw.add(_vote(privs, vset, 7, block_id=JBlockID())) == ("ok", True)  # nil
    tw.assert_same_state(vset, (BID_A, BID_B, JBlockID()))
    assert tw.add(_vote(privs, vset, 6)) == ("ok", True)  # the 7th: +2/3 for A
    assert tw.t.two_thirds_majority() == (carry.block_id(BID_A), True)
    # A peer claims +2/3 for B: the conflicting vote is tracked there.
    assert tw.peer_maj23("peer1", BID_B) == ("ok", None)
    assert tw.peer_maj23("peer1", BID_B) == ("ok", None)
    assert tw.add(_vote(privs, vset, 1, block_id=BID_B))[0] == "ConflictingVotesError"
    assert tw.peer_maj23("peer1", BID_A) == (
        "VoteSetError", "setPeerMaj23: conflicting blockID from peer peer1")
    for i in (8, 9):
        assert tw.add(_vote(privs, vset, i)) == ("ok", True)
    tw.assert_same_state(vset, (BID_A, BID_B, JBlockID()))
    assert tw.t.has_all() and tw.t.bit_array().get_true_indices() == list(range(10))


def test_make_commit_is_byte_equal():
    privs, vset = make_validators(7)
    tw = Twin(vset, 3, 1, SIGNED_MSG_TYPE_PRECOMMIT)
    pre = lambda i, bid=BID_A: _vote(privs, vset, i, height=3, round_=1,
                                      type_=SIGNED_MSG_TYPE_PRECOMMIT, block_id=bid)
    assert tw.add(pre(0))[0] == "ok"
    # before +2/3 neither package makes a commit
    assert Twin._call(tw.j.make_commit) == Twin._call(tw.t.make_commit) == (
        "VoteSetError", "cannot MakeExtendedCommit unless a blockhash has +2/3")
    for i in (1, 2, 3, 5):
        assert tw.add(pre(i)) == ("ok", True)
    assert tw.add(pre(4, JBlockID())) == ("ok", True)  # a nil precommit
    assert tw.add(pre(6, BID_B)) == ("ok", True)  # a precommit for another block
    jc, tc = tw.j.make_commit(), tw.t.make_commit()
    assert jc.to_proto_bytes() == tc.to_proto_bytes()
    assert [cs.block_id_flag for cs in tc.signatures] == [2, 2, 2, 2, 3, 2, 1]
    prevotes = Twin(vset, 3, 1, SIGNED_MSG_TYPE_PREVOTE)
    assert Twin._call(prevotes.j.make_commit) == Twin._call(prevotes.t.make_commit) == (
        "VoteSetError", "cannot MakeExtendedCommit unless VoteSet.Type is Precommit")


def test_extension_checks_match():
    privs, vset = make_validators(4)
    ext = Twin(vset, 3, 0, SIGNED_MSG_TYPE_PRECOMMIT, extended=True)
    pre = lambda i, **kw: _vote(privs, vset, i, height=3, type_=SIGNED_MSG_TYPE_PRECOMMIT, **kw)
    assert ext.add(pre(0, extension=b"oracle-price:42")) == ("ok", True)
    bad_ext = pre(1, extension=b"oracle-price:42")
    bad_ext.extension_signature = bytes(64)
    assert ext.add(bad_ext) == ("VoteError", "invalid extension signature")
    plain = Twin(vset, 3, 0, SIGNED_MSG_TYPE_PRECOMMIT)
    assert plain.add(pre(2, extension=b"x")) == (
        "VoteSetError", "unexpected vote extension data present in vote")


@pytest.fixture()
def host_verifies(monkeypatch):
    """Counts of host signature checks in each package."""
    counts = {"jax": 0, "port": 0}
    for name, cls in (("jax", jkeys.Ed25519PubKey), ("port", tkeys.Ed25519PubKey)):
        orig = cls.verify_signature

        def counted(self, msg, sig, _orig=orig, _name=name):
            counts[_name] += 1
            return _orig(self, msg, sig)

        monkeypatch.setattr(cls, "verify_signature", counted)
    return counts


def test_a_tag_skips_the_host_verify_only_for_its_key_and_bytes(host_verifies):
    privs, vset = make_validators(2)
    mine, other = vset.validators[0].pub_key, vset.validators[1].pub_key
    pairs = {"jax": (mine, other), "port": (carry.pub_key(mine), carry.pub_key(other))}
    for name in ("jax", "port"):
        pk, opk = pairs[name]
        convert = (lambda v: v) if name == "jax" else carry.vote
        good = convert(_vote(privs, vset, 0))
        good.mark_pre_verified(CHAIN_ID, pk.bytes())
        good.verify(CHAIN_ID, pk)
        assert host_verifies[name] == 0  # the tag was honoured
        # a tag for another key: verified on the host (and genuine)
        other_tag = convert(_vote(privs, vset, 0))
        other_tag.mark_pre_verified(CHAIN_ID, opk.bytes())
        other_tag.verify(CHAIN_ID, pk)
        assert host_verifies[name] == 1
        # a stale tag: the vote changed after it was tagged
        stale = convert(_vote(privs, vset, 0))
        stale.mark_pre_verified(CHAIN_ID, pk.bytes())
        stale.timestamp = type(stale.timestamp)(stale.timestamp.seconds + 1, 0)
        with pytest.raises(ValueError, match="invalid signature") as info:
            stale.verify(CHAIN_ID, pk)
        assert type(info.value).__name__ == "VoteError"
        assert host_verifies[name] == 2
        # a forged signature tagged for another chain is still rejected
        forged = convert(_vote(privs, vset, 0))
        forged.signature = bytes(64)
        forged.mark_pre_verified("other-chain", pk.bytes())
        with pytest.raises(ValueError, match="invalid signature"):
            forged.verify(CHAIN_ID, pk)
        assert host_verifies[name] == 3


def test_a_stale_extension_tag_is_reverified_in_the_vote_set(host_verifies):
    privs, vset = make_validators(4)
    jv = _vote(privs, vset, 0, height=3, type_=SIGNED_MSG_TYPE_PRECOMMIT, extension=b"e1")
    for name, make, convert, val_set in (
        ("jax", jvs.VoteSet.extended, lambda v: copy.deepcopy(v), vset),
        ("port", tvs.VoteSet.extended, carry.vote, carry.validator_set(vset)),
    ):
        vote = convert(jv)
        pk = val_set.validators[0].pub_key
        vote.mark_pre_verified(CHAIN_ID, pk.bytes(), extension_too=True)
        vote.extension = b"e2"  # the extension changed after the tag
        vs = make(CHAIN_ID, 3, 0, SIGNED_MSG_TYPE_PRECOMMIT, val_set)
        with pytest.raises(ValueError, match="invalid extension signature"):
            vs.add_vote(vote)
        assert host_verifies[name] == 1  # the vote's tag held, the extension's did not


def test_validate_basic_and_commit_sig_match():
    privs, vset = make_validators(2)
    good = _vote(privs, vset, 0, type_=SIGNED_MSG_TYPE_PRECOMMIT)
    cases = {
        "good": good,
        "bad_type": dataclasses.replace(good, type=7),
        "negative_height": dataclasses.replace(good, height=-1),
        "short_address": dataclasses.replace(good, validator_address=b"x"),
        "no_signature": dataclasses.replace(good, signature=b""),
        "extension_on_prevote": dataclasses.replace(good, type=SIGNED_MSG_TYPE_PREVOTE, extension=b"e"),
        "extension_unsigned": dataclasses.replace(good, extension=b"e"),
        "incomplete_block_id": dataclasses.replace(good, block_id=JBlockID(b"\x01" * 32)),
    }
    for name, jv in cases.items():
        tv = carry.vote(jv)
        assert Twin._call(jv.validate_basic) == Twin._call(tv.validate_basic), name
        j_sig, t_sig = Twin._call(jv.commit_sig), Twin._call(tv.commit_sig)
        if j_sig[0] == "ok":
            assert j_sig[1].to_proto_bytes() == t_sig[1].to_proto_bytes(), name
        else:
            assert j_sig == t_sig, name

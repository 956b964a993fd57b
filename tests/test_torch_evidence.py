"""The port's evidence types, verification and pool beside the JAX
package's, on the CPU.

- Twins of the 11 tests of ``tests/test_evidence.py`` on the port.
- Parity: the evidence proto bytes, hashes and ``evidence_list_hash``;
  a block carrying both kinds, byte for byte and by hash; the evidence
  the consensus buffer builds from the same pair and state; both pools'
  verdicts on the same valid and tampered evidence.
- The held divergence: under an injected device fault, the JAX pool
  answers on the host and the port's raises (unless host fallback is
  on, and then the answers are counted).
- The slice whole: one ``ConsensusState`` with a scripted broadcaster
  whose validator equivocates; the node reports the pair, its pool
  verifies the evidence once the height commits, and the node proposes
  and commits it.

The port's pool runs on ``device="cpu"`` with a fresh shared scheduler;
commits stay under 16 lanes and evidence pairs are two lanes, so both
packages verify on the host tier.
"""

from dataclasses import replace
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

import tendermint_tpu_torch
from tendermint_tpu.crypto import batch as jbatch
from tendermint_tpu.encoding.canonical import Timestamp as JTimestamp
from tendermint_tpu.evidence import EvidencePool as JEvidencePool
from tendermint_tpu.evidence.verify import InvalidEvidenceError as JInvalidEvidenceError
from tendermint_tpu.state.state import State as JState
from tendermint_tpu.types import make_block as jmake_block
from tendermint_tpu.types.evidence import (
    DuplicateVoteEvidence as JDuplicateVoteEvidence,
    LightClientAttackEvidence as JLightClientAttackEvidence,
    evidence_from_proto_bytes as jevidence_from_proto_bytes,
    evidence_list_hash as jevidence_list_hash,
)
from tendermint_tpu_torch.crypto import batch as crypto_batch
from tendermint_tpu_torch.crypto.keys import Ed25519PrivKey
from tendermint_tpu_torch.encoding.canonical import SIGNED_MSG_TYPE_PRECOMMIT, SIGNED_MSG_TYPE_PREVOTE, Timestamp
from tendermint_tpu_torch.evidence import EvidencePool, verify_duplicate_vote
from tendermint_tpu_torch.evidence.verify import InvalidEvidenceError, verify_light_client_attack
from tendermint_tpu_torch.ops import device_policy
from tendermint_tpu_torch.ops.fault_injection import DeviceFault
from tendermint_tpu_torch.state.state import State
from tendermint_tpu_torch.storage.kv import MemDB
from tendermint_tpu_torch.types import carry
from tendermint_tpu_torch.types.block import Block, Vote
from tendermint_tpu_torch.types.evidence import (
    DuplicateVoteEvidence,
    LightClientAttackEvidence,
    evidence_from_proto_bytes,
    evidence_list_hash,
)
from tendermint_tpu_torch.types.validator import Validator
from tendermint_tpu_torch.types.validator_set import ValidatorSet
from tests import helpers as jhelpers
from tests import test_evidence as jev_tests
from tests.test_light import build_light_chain
from tests.test_torch_block_store import make_block_id
from tests.test_torch_execution import CHAIN_ID, make_validators

BASE_NS = jev_tests.BASE_NS


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(tendermint_tpu_torch, "DEFAULT_DEVICE", "cpu")
    monkeypatch.setattr(crypto_batch, "_shared_scheduler", None)
    monkeypatch.setattr(device_policy, "shared", device_policy.DeviceHealth())
    yield
    crypto_batch.shutdown_shared_scheduler()


def signed_vote(priv, vset, idx, height=1, round_=0, type_=SIGNED_MSG_TYPE_PREVOTE, block_id=None):
    """``tests/test_vote_set.py`` ``signed_vote`` in the port."""
    vote = Vote(
        type=type_,
        height=height,
        round=round_,
        block_id=block_id if block_id is not None else make_block_id(b"nil"),
        timestamp=Timestamp.from_unix_ns(1_700_000_000_000_000_000 + idx),
        validator_address=vset.validators[idx].address,
        validator_index=idx,
    )
    vote.signature = priv.sign(vote.sign_bytes(CHAIN_ID))
    return vote


def make_duplicate_evidence(privs, vset, idx=0, height=5):
    """``tests/test_evidence.py`` ``make_duplicate_evidence`` in the port."""
    v1 = signed_vote(privs[idx], vset, idx, height=height, block_id=make_block_id(b"a"))
    v2 = signed_vote(privs[idx], vset, idx, height=height, block_id=make_block_id(b"b"))
    return DuplicateVoteEvidence.new(v1, v2, Timestamp.from_unix_ns(BASE_NS), vset)


def carried_light_chain(n, **kw):
    blocks, _, vset = build_light_chain(n, **kw)
    return [carry.light_block(b) for b in blocks], carry.validator_set(vset)


# --- tests/test_evidence.py ------------------------------------------------------


class TestVerifyDuplicateVote:
    def test_valid(self):
        privs, vset = make_validators(4)
        verify_duplicate_vote(make_duplicate_evidence(privs, vset), CHAIN_ID, vset)

    def test_same_block_id_rejected(self):
        privs, vset = make_validators(4)
        ev = make_duplicate_evidence(privs, vset)
        ev.vote_b = ev.vote_a
        with pytest.raises(InvalidEvidenceError, match="same"):
            verify_duplicate_vote(ev, CHAIN_ID, vset)

    def test_bad_signature_rejected(self):
        privs, vset = make_validators(4)
        ev = make_duplicate_evidence(privs, vset)
        ev.vote_b.signature = bytes(64)
        with pytest.raises(InvalidEvidenceError, match="signature"):
            verify_duplicate_vote(ev, CHAIN_ID, vset)

    def test_unknown_validator_rejected(self):
        privs, vset = make_validators(4)
        ev = make_duplicate_evidence(privs, vset)
        stranger = ValidatorSet([Validator(Ed25519PrivKey.from_seed(b"\x99" * 32).pub_key(), 5)])
        with pytest.raises(InvalidEvidenceError, match="not a validator"):
            verify_duplicate_vote(ev, CHAIN_ID, stranger)


class FakeStateStore:
    def __init__(self, vset):
        self.vset = vset

    def load_validators(self, height):
        return self.vset


def pool_with_state(vset, height=10, pkg="port"):
    """``TestEvidencePool._pool_with_state`` in either package."""
    if pkg == "port":
        pool, state_cls, ts = EvidencePool(state_store=FakeStateStore(vset)), State, Timestamp
    else:
        pool, state_cls, ts = JEvidencePool(state_store=FakeStateStore(vset)), JState, JTimestamp
    pool.set_state(state_cls(chain_id=CHAIN_ID, last_block_height=height,
                             last_block_time=ts.from_unix_ns(BASE_NS + 1_000_000_000),
                             validators=vset, next_validators=vset, last_validators=vset))
    return pool


class TestEvidencePool:
    def test_add_and_reap(self):
        privs, vset = make_validators(4)
        pool = pool_with_state(vset)
        ev = make_duplicate_evidence(privs, vset)
        pool.add_evidence(ev)
        pending, size = pool.pending_evidence(-1)
        assert len(pending) == 1 and size > 0 and pending[0].hash() == ev.hash()
        pool.add_evidence(ev)  # idempotent
        assert len(pool.pending_evidence(-1)[0]) == 1

    def test_committed_not_repending(self):
        privs, vset = make_validators(4)
        pool = pool_with_state(vset)
        ev = make_duplicate_evidence(privs, vset)
        pool.add_evidence(ev)
        pool.update(pool.state, [ev])
        assert pool.pending_evidence(-1)[0] == [] and pool.is_committed(ev)
        with pytest.raises(InvalidEvidenceError, match="committed"):
            pool.check_evidence([ev])

    def test_report_conflicting_votes(self):
        privs, vset = make_validators(4)
        pool = pool_with_state(vset)
        v1 = signed_vote(privs[1], vset, 1, height=5, block_id=make_block_id(b"a"))
        v2 = signed_vote(privs[1], vset, 1, height=5, block_id=make_block_id(b"b"))
        pool.report_conflicting_votes(v1, v2)
        assert len(pool.pending_evidence(-1)[0]) == 0  # buffered until the next update
        pool.update(pool.state, [])
        assert len(pool.pending_evidence(-1)[0]) == 1

    def test_expired_evidence_rejected_and_pruned(self):
        privs, vset = make_validators(4)
        pool = pool_with_state(vset, height=10)
        pool.add_evidence(make_duplicate_evidence(privs, vset, height=5))
        future = replace(pool.state, last_block_height=5 + 200_000,
                         last_block_time=Timestamp.from_unix_ns(BASE_NS + int(100 * 3600 * 1e9)))
        pool.update(future, [])
        assert pool.pending_evidence(-1)[0] == []
        with pytest.raises(InvalidEvidenceError, match="too old"):
            pool.add_evidence(make_duplicate_evidence(privs, vset, height=5))

    def test_power_mismatch_rejected(self):
        privs, vset = make_validators(4)
        pool = pool_with_state(vset)
        ev = make_duplicate_evidence(privs, vset)
        ev.total_voting_power = 999
        with pytest.raises(InvalidEvidenceError, match="total voting power"):
            pool.add_evidence(ev)


class TestVerifyLightClientAttack:
    def test_equivocation_attack_verifies(self):
        blocks, vset = carried_light_chain(8)
        forked, _ = carried_light_chain(8, fork_at=5)
        common, trusted = blocks[3].signed_header, blocks[7].signed_header
        ev = LightClientAttackEvidence(conflicting_block=forked[7], common_height=4,
                                       total_voting_power=vset.total_voting_power(), timestamp=common.header.time)
        verify_light_client_attack(ev, common, trusted, vset, device="cpu")

    def test_fabricated_commit_rejected(self):
        blocks, vset = carried_light_chain(8)
        forked, _ = carried_light_chain(8, fork_at=5)
        forked[7].signed_header.commit.signatures[0].signature = bytes(64)
        ev = LightClientAttackEvidence(conflicting_block=forked[7], common_height=4,
                                       total_voting_power=vset.total_voting_power(),
                                       timestamp=blocks[3].signed_header.header.time)
        with pytest.raises(InvalidEvidenceError, match="signature|commit"):
            verify_light_client_attack(ev, blocks[3].signed_header, blocks[7].signed_header, vset, device="cpu")


# --- parity with the JAX package ------------------------------------------------------


def both_attacks():
    """The same light client attack in both packages: conflicting 8 of a
    fork at 5, common height 4, blamed validators from the JAX method."""
    jblocks, _, jvset = build_light_chain(8)
    jforked, _, _ = build_light_chain(8, fork_at=5)
    jev = JLightClientAttackEvidence(conflicting_block=jforked[7], common_height=4,
                                     total_voting_power=jvset.total_voting_power(),
                                     timestamp=jblocks[3].signed_header.header.time)
    jev.byzantine_validators = jev.get_byzantine_validators(jvset, jblocks[7].signed_header)
    ev = LightClientAttackEvidence(conflicting_block=carry.light_block(jforked[7]), common_height=4,
                                   total_voting_power=jev.total_voting_power,
                                   timestamp=carry.timestamp(jev.timestamp))
    ev.byzantine_validators = ev.get_byzantine_validators(carry.validator_set(jvset),
                                                          carry.signed_header(jblocks[7].signed_header))
    return jev, ev


def test_evidence_bytes_hashes_and_list_hash_match_the_jax_package():
    jprivs, jvset = jhelpers.make_validators(4)
    privs, vset = make_validators(4)
    jdup, dup = jev_tests.make_duplicate_evidence(jprivs, jvset, idx=2), make_duplicate_evidence(privs, vset, idx=2)
    jlca, lca = both_attacks()
    assert len(lca.byzantine_validators) == 4
    for j, t in ((jdup, dup), (jlca, lca)):
        assert t.to_proto_bytes() == j.to_proto_bytes() and t.bytes() == j.bytes()
        assert t.hash() == j.hash() and t.height() == j.height()
        back = evidence_from_proto_bytes(j.to_proto_bytes())
        assert type(back) is type(t) and back.to_proto_bytes() == j.to_proto_bytes()
        assert jevidence_from_proto_bytes(t.to_proto_bytes()).hash() == j.hash()
        assert [(m["type"], m["validator"]["address"], m["validator"]["power"], m["height"], m["total_voting_power"])
                for m in t.abci()] == [
            (m["type"], m["validator"]["address"], m["validator"]["power"], m["height"], m["total_voting_power"])
            for m in j.abci()]
        t.validate_basic()
    assert evidence_list_hash([dup, lca]) == jevidence_list_hash([jdup, jlca])
    assert evidence_list_hash([]) == jevidence_list_hash([])
    with pytest.raises(ValueError, match="not recognized"):
        evidence_from_proto_bytes(b"")


def test_a_block_with_both_kinds_of_evidence_matches_the_jax_package_s():
    jprivs, jvset = jhelpers.make_validators(4)
    jdup = jev_tests.make_duplicate_evidence(jprivs, jvset)
    jlca, _ = both_attacks()
    jblock = jmake_block(6, [b"k=v"], None, evidence=[jdup, jlca])
    jblock.header.chain_id = CHAIN_ID
    raw = jblock.to_proto_bytes()
    block = Block.from_proto_bytes(raw)
    assert block.to_proto_bytes() == raw and block.hash() == jblock.hash()
    assert block.evidence_hash() == jblock.evidence_hash() == block.header.evidence_hash
    assert [type(ev) for ev in block.evidence] == [DuplicateVoteEvidence, LightClientAttackEvidence]


def test_the_consensus_buffer_makes_the_jax_package_s_evidence():
    """The same conflicting pair and state: the evidence each pool builds
    on ``update`` (stamped with the state's last block time, which its
    hash covers) is byte for byte the same."""
    jprivs, jvset = jhelpers.make_validators(4)
    privs, vset = make_validators(4)
    jpool, pool = pool_with_state(jvset, pkg="jax"), pool_with_state(vset)
    from tests.test_vote_set import signed_vote as jsigned_vote

    for seeds in ((b"a", b"b"), (b"d", b"c")):
        jpool.report_conflicting_votes(*[jsigned_vote(jprivs[1], jvset, 1, height=5, block_id=jhelpers.make_block_id(s))
                                         for s in seeds])
        pool.report_conflicting_votes(*[signed_vote(privs[1], vset, 1, height=5, block_id=make_block_id(s))
                                        for s in seeds])
    jpool.update(jpool.state, [])
    pool.update(pool.state, [])
    jpending, pending = jpool.pending_evidence(-1)[0], pool.pending_evidence(-1)[0]
    assert len(pending) == len(jpending) == 2
    assert [ev.to_proto_bytes() for ev in pending] == [ev.to_proto_bytes() for ev in jpending]
    assert pending[0].timestamp == pool.state.last_block_time


class FakeBlockStore:
    """Block metas and commits of a light chain, the pool's reads."""

    def __init__(self, blocks):
        self.blocks = {b.height: b for b in blocks}

    def load_block_meta(self, h):
        b = self.blocks.get(h)
        return None if b is None else SimpleNamespace(header=b.signed_header.header)

    def load_block_commit(self, h):
        b = self.blocks.get(h)
        return None if b is None else b.signed_header.commit


def _tampered(ev, kind):
    """A copy of ``ev`` (either package) with one fault."""
    ev = evidence_from_proto_bytes(ev.to_proto_bytes()) if isinstance(ev, (DuplicateVoteEvidence,
                                                                          LightClientAttackEvidence)) \
        else jevidence_from_proto_bytes(ev.to_proto_bytes())
    if kind == "signature":
        if hasattr(ev, "vote_b"):
            ev.vote_b.signature = bytes(64)
        else:
            ev.conflicting_block.signed_header.commit.signatures[1].signature = bytes(64)
    elif kind == "total_voting_power":
        ev.total_voting_power += 1
    elif kind == "validator_power":
        ev.validator_power += 1
    elif kind == "timestamp":
        ev.timestamp = type(ev.timestamp).from_unix_ns(ev.timestamp.to_unix_ns() + 1)
    return ev


@pytest.mark.parametrize("kind", ["duplicate", "attack"])
def test_both_pools_give_the_same_verdicts(kind):
    """The same valid and tampered evidence into fresh pools of both
    packages: accepted by both, or refused by both with the same error."""
    if kind == "duplicate":
        jprivs, jvset = jhelpers.make_validators(4)
        privs, vset = make_validators(4)
        jgood, good = jev_tests.make_duplicate_evidence(jprivs, jvset), make_duplicate_evidence(privs, vset)
        faults = ["signature", "total_voting_power", "validator_power"]

        def pools():
            return pool_with_state(jvset, pkg="jax"), pool_with_state(vset)
    else:
        jblocks, _, jvset = build_light_chain(8)
        blocks, vset = [carry.light_block(b) for b in jblocks], carry.validator_set(jvset)
        jgood, good = both_attacks()
        faults = ["signature", "total_voting_power", "timestamp"]

        def pools():
            jp, p = (JEvidencePool(state_store=FakeStateStore(jvset), block_store=FakeBlockStore(jblocks)),
                     EvidencePool(state_store=FakeStateStore(vset), block_store=FakeBlockStore(blocks)))
            jp.set_state(JState(chain_id=CHAIN_ID, last_block_height=8, last_block_time=jblocks[7].header.time,
                                validators=jvset, next_validators=jvset, last_validators=jvset))
            p.set_state(State(chain_id=CHAIN_ID, last_block_height=8, last_block_time=blocks[7].header.time,
                              validators=vset, next_validators=vset, last_validators=vset))
            return jp, p
    jpool, pool = pools()
    jpool.add_evidence(jgood)
    pool.add_evidence(good)
    assert [e.hash() for e in pool.pending_evidence(-1)[0]] == [e.hash() for e in jpool.pending_evidence(-1)[0]]
    for fault in faults:
        jpool, pool = pools()
        with pytest.raises(JInvalidEvidenceError) as jerr:
            jpool.add_evidence(_tampered(jgood, fault))
        with pytest.raises(InvalidEvidenceError) as terr:
            pool.add_evidence(_tampered(good, fault))
        assert str(terr.value).split(":")[0] == str(jerr.value).split(":")[0], fault
        assert pool.pending_evidence(-1)[0] == []


# --- the held divergence ---------------------------------------------------------------


def test_a_device_fault_raises_in_the_port_where_the_jax_pool_answers_on_the_host(monkeypatch):
    """An injected device fault in the shared scheduler's flush: the JAX
    pool's ``_verify_pair`` answers on the host (the valid pair is taken,
    the bad one refused), the port's raises the fault out of
    ``add_evidence``; with host fallback on, the port answers on the host
    too and counts the two lanes."""
    jprivs, jvset = jhelpers.make_validators(4)
    privs, vset = make_validators(4)

    def j_fault(pks, msgs, sigs):
        raise RuntimeError("injected device fault")

    def fault(pks, msgs, sigs):
        raise DeviceFault("injected device fault")

    monkeypatch.setattr(jbatch, "tiered_verify_ed25519", j_fault)
    monkeypatch.setattr(crypto_batch, "tiered_verify_ed25519", fault)
    jpool = pool_with_state(jvset, pkg="jax")
    jpool.add_evidence(jev_tests.make_duplicate_evidence(jprivs, jvset))
    assert len(jpool.pending_evidence(-1)[0]) == 1
    jbad = jev_tests.make_duplicate_evidence(jprivs, jvset, idx=1)
    jbad.vote_b.signature = bytes(64)
    with pytest.raises(JInvalidEvidenceError, match="signature"):
        jpool.add_evidence(jbad)

    pool = pool_with_state(vset)
    with pytest.raises(DeviceFault, match="injected"):
        pool.add_evidence(make_duplicate_evidence(privs, vset))
    assert pool.pending_evidence(-1)[0] == []
    with pytest.raises(DeviceFault):  # a block's evidence: check_evidence raises too
        pool.check_evidence([make_duplicate_evidence(privs, vset)])
    pool.report_conflicting_votes(*[signed_vote(privs[1], vset, 1, height=5, block_id=make_block_id(s))
                                    for s in (b"a", b"b")])
    with pytest.raises(DeviceFault):  # and update, where the consensus buffer is verified
        pool.update(pool.state, [])

    device_policy.shared.host_fallback = True
    pool.add_evidence(make_duplicate_evidence(privs, vset))
    bad = make_duplicate_evidence(privs, vset, idx=1)
    bad.vote_b.signature = bytes(64)
    with pytest.raises(InvalidEvidenceError, match="signature"):
        pool.add_evidence(bad)
    assert len(pool.pending_evidence(-1)[0]) == 1
    assert device_policy.shared.fallback_lanes["ed25519"] == 4


def test_a_stopped_scheduler_raises_unless_host_fallback_is_on():
    """``submit`` raising (the scheduler stopped): the reference answers
    inline on the host; the port raises, or with host fallback on
    answers inline and counts the pair."""
    privs, vset = make_validators(4)
    pool = pool_with_state(vset)
    sched = crypto_batch.get_shared_scheduler()
    sched.stop()
    with pytest.raises(RuntimeError, match="not running"):
        pool.add_evidence(make_duplicate_evidence(privs, vset))
    device_policy.shared.host_fallback = True
    pool.add_evidence(make_duplicate_evidence(privs, vset))
    assert len(pool.pending_evidence(-1)[0]) == 1
    assert device_policy.shared.fallback_lanes["ed25519"] == 2


# --- the slice whole: a validator's pool in consensus ---------------------------------------


def test_an_equivocation_is_reported_verified_proposed_and_committed(tmp_path):
    """One ``ConsensusState`` of four validators, its peers scripted: the
    validator that proposes height 1 sends a second prevote for another
    block there. The node reports the pair, its ``EvidencePool`` builds
    and verifies the evidence through the shared scheduler once height 1
    commits, the node proposes it in its block at height 2 and commits
    it; FinalizeBlock receives the misbehavior. The evidence is the one
    the JAX package builds from the same pair and block time."""
    from tendermint_tpu_torch.consensus.state import Broadcaster
    from tendermint_tpu_torch.privval import FilePV
    from tendermint_tpu_torch.types.block import BLOCK_PART_SIZE_BYTES, BlockID, Proposal
    from tendermint_tpu_torch.types.part_set import PartSet
    from tests.test_torch_consensus import CHAIN_ID as CS_CHAIN_ID, build_validator, wait_for_height

    pvs = [FilePV.generate(str(tmp_path / f"k{i}.json"), str(tmp_path / f"s{i}.json")) for i in range(4)]
    probe, _, _ = build_validator(tmp_path, n_vals=4, index=0, privs=pvs)
    vals = probe.state.validators.copy()
    first = vals.get_proposer().address
    vals.increment_proposer_priority(1)
    second = vals.get_proposer().address
    by_addr = {pv.get_pub_key().address(): i for i, pv in enumerate(pvs)}
    node, _, _ = build_validator(tmp_path, n_vals=4, index=by_addr[second], privs=pvs)
    shadow, _, _ = build_validator(tmp_path, n_vals=4, index=by_addr[first], privs=pvs)
    vset = node.state.validators
    pool = EvidencePool(MemDB(), node.block_exec.state_store, node.block_store, device="cpu")
    pool.set_state(node.state)
    node.block_exec.evidence_pool = pool
    misbehavior = {}
    client = node.block_exec.app
    real_finalize = client.finalize_block

    def finalize(req):
        misbehavior[req.height] = list(req.misbehavior)
        return real_finalize(req)

    client.finalize_block = finalize
    equivocator = vset.get_by_address(first)[0]
    sent = []

    class Peers(Broadcaster):
        """The other three validators: each answers the node's vote with
        its own; the equivocator adds a prevote for another block at
        height 1."""

        def broadcast_vote(self, vote):
            for pv in pvs:
                addr = pv.get_pub_key().address()
                if addr == second:
                    continue
                i = vset.get_by_address(addr)[0]
                blocks = [vote.block_id]
                if i == equivocator and vote.type == SIGNED_MSG_TYPE_PREVOTE and vote.height == 1:
                    blocks.append(make_block_id(b"the other block"))
                for bid in blocks:
                    v = Vote(type=vote.type, height=vote.height, round=vote.round, block_id=bid,
                             timestamp=vote.timestamp, validator_address=addr, validator_index=i)
                    v.signature = pv.priv_key.sign(v.sign_bytes(CS_CHAIN_ID))
                    sent.append(v)
                    node.add_vote_from_peer(v, f"peer{i}")

    node.broadcaster = Peers()
    block = shadow._create_proposal_block()
    parts = PartSet.from_data(block.to_proto_bytes(), BLOCK_PART_SIZE_BYTES)
    proposal = Proposal(height=1, round=0, pol_round=-1, block_id=BlockID(block.hash(), parts.header()),
                        timestamp=block.header.time)
    proposal.signature = pvs[by_addr[first]].priv_key.sign(proposal.sign_bytes(CS_CHAIN_ID))
    scheduled = crypto_batch.get_shared_scheduler().stats()["entries_verified"]
    node.start()
    try:
        node.add_proposal_from_peer(proposal, "peerP")
        for i in range(parts.total):
            node.add_block_part_from_peer(1, 0, parts.get_part(i), "peerP")
        assert wait_for_height([node], 2, timeout=30), f"height {node.block_store.height()}, error {node.error!r}"
    finally:
        node.stop()
    block2 = node.block_store.load_block(2)
    assert len(block2.evidence) == 1 and block2.header.proposer_address == second
    ev = block2.evidence[0]
    assert isinstance(ev, DuplicateVoteEvidence) and ev.vote_a.validator_address == first
    assert ev.timestamp == node.block_store.load_block(1).header.time
    assert pool.is_committed(ev) and not pool.is_pending(ev) and pool.pending_evidence(-1)[0] == []
    assert [(m.type, m.validator_address, m.height) for m in misbehavior[2]] == [(1, first, 1)]
    assert misbehavior[1] == []
    assert crypto_batch.get_shared_scheduler().stats()["entries_verified"] - scheduled >= 2

    pair = [v for v in sent if v.validator_address == first and v.type == SIGNED_MSG_TYPE_PREVOTE and v.height == 1]
    from tendermint_tpu.types.block import Vote as JVote
    from tendermint_tpu.types.validator_set import ValidatorSet as JValidatorSet

    jvset = JValidatorSet.from_proto_bytes(node.block_exec.state_store.load_validators(1).to_proto_bytes())
    jev = JDuplicateVoteEvidence.new(*[JVote.from_proto_bytes(v.to_proto_bytes()) for v in pair],
                                     JTimestamp.from_unix_ns(ev.timestamp.to_unix_ns()), jvset)
    assert jev.to_proto_bytes() == ev.to_proto_bytes()
    assert not [v for v in sent if v.type == SIGNED_MSG_TYPE_PRECOMMIT and v.block_id != block2.last_commit.block_id
                and v.height == 1]

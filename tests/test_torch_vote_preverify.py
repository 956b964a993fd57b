"""The port's vote pre-verifier (``consensus/reactor.py``) against the JAX
package's, with the ``_FakeCS`` harness of ``tests/test_vote_preverify.py``.

The JAX pre-verifier runs on a scheduler backed by the host oracle (its
first device trace would take longer than these tests); the port's runs
on its own shared scheduler and engine on the CPU. Both must forward the
same votes in the same order, tagged alike, with the same counts. The
warm-up is where the two differ on purpose: the port's reaches
``verify_batch`` with 16 distinct lanes, the reference's reaches its
``verify_fn`` with one coalesced lane, and the port keeps a failed
warm-up's exception.
"""

import threading
import time

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import tendermint_tpu_torch
from tendermint_tpu.consensus.reactor import VotePreverifier as JPreverifier
from tendermint_tpu.crypto import batch as jbatch
from tendermint_tpu.crypto.ed25519_ref import verify_zip215
from tendermint_tpu.crypto.scheduler import VerifyScheduler as JScheduler
from tendermint_tpu.encoding.canonical import (
    SIGNED_MSG_TYPE_PRECOMMIT,
    SIGNED_MSG_TYPE_PREVOTE,
    Timestamp,
)
from tendermint_tpu.types.block import Vote
from tendermint_tpu_torch import ops as tops
from tendermint_tpu_torch.consensus import reactor as treactor
from tendermint_tpu_torch.crypto import batch as tbatch
from tendermint_tpu_torch.ops import device_policy
from tendermint_tpu_torch.ops import precompute as tpc
from tendermint_tpu_torch.types import carry
from tests.helpers import CHAIN_ID, make_block_id, make_validators

WAIT = 10.0


class _FakeState:
    def __init__(self, validators):
        self.chain_id = CHAIN_ID
        self.validators = validators


class _FakeRS:
    def __init__(self, height, validators):
        self.height = height
        self.validators = validators


class _FakeCS:
    """The slice of ConsensusState the pre-verifier touches."""

    def __init__(self, height, validators):
        self.rs = _FakeRS(height, validators)
        self.state = _FakeState(validators)
        self.received = []

    def add_vote_from_peer(self, vote, peer_id):
        self.received.append((vote, peer_id))

    def wait_received(self, k, timeout=WAIT):
        deadline = time.monotonic() + timeout
        while len(self.received) < k and time.monotonic() < deadline:
            time.sleep(0.005)
        return len(self.received) >= k


def _signed_vote(privs, vset, idx, height=5, round_=0, type_=SIGNED_MSG_TYPE_PREVOTE, extension=b""):
    val = vset.validators[idx]
    vote = Vote(
        type=type_,
        height=height,
        round=round_,
        block_id=make_block_id(),
        timestamp=Timestamp.from_unix_ns(1_700_000_000_000_000_000),
        validator_address=val.address,
        validator_index=idx,
        extension=extension,
    )
    vote.signature = privs[idx].sign(vote.sign_bytes(CHAIN_ID))
    if extension:
        vote.extension_signature = privs[idx].sign(vote.extension_sign_bytes(CHAIN_ID))
    return vote


@pytest.fixture()
def port_env(monkeypatch):
    """The port on the CPU with a fresh shared scheduler and health
    machine."""
    monkeypatch.setattr(tendermint_tpu_torch, "DEFAULT_DEVICE", "cpu")
    monkeypatch.setattr(tbatch, "_shared_scheduler", None)
    monkeypatch.setattr(device_policy, "shared", device_policy.DeviceHealth())
    tpc.reset()
    yield
    if tbatch._shared_scheduler is not None:
        tbatch._shared_scheduler.stop()
    tpc.reset()


@pytest.fixture()
def nets(port_env, monkeypatch):
    """A warm JAX pre-verifier and a warm port one over the same 4
    validators at height 5."""
    jsched = JScheduler(
        lambda pks, msgs, sigs: [verify_zip215(p, m, s) for p, m, s in zip(pks, msgs, sigs)],
        max_delay=0.01,
    )
    jsched.start()
    monkeypatch.setattr(jbatch, "_shared_scheduler", jsched)
    privs, vset = make_validators(4)
    jcs = _FakeCS(5, vset)
    tcs = _FakeCS(5, carry.validator_set(vset))
    jpv, tpv = JPreverifier(jcs), treactor.VotePreverifier(tcs)
    jpv.start()
    tpv.start()
    assert jpv._warm.wait(timeout=WAIT)
    assert tpv.wait_warmup(timeout=WAIT) and tpv.warmup_error is None
    yield privs, vset, {"jax": (jpv, jcs), "port": (tpv, tcs)}
    jpv.stop()
    tpv.stop()
    jsched.stop()


def _feed(nets, votes):
    """Submit the same votes (carried for the port) to both and return,
    per package, the forwarded votes' (index, round, peer, tagged,
    extension tagged) and the counters."""
    out = {}
    for name, (pv, cs) in nets.items():
        before = (pv.batched, pv.passthrough)
        for i, (vote, peer) in enumerate(votes):
            pv.submit(vote if name == "jax" else carry.vote(vote), peer)
        assert cs.wait_received(len(votes))
        out[name] = (
            [(v.validator_index, v.round, peer, v._pre_verified is not None,
              v._pre_verified_ext is not None) for v, peer in cs.received],
            (pv.batched - before[0], pv.passthrough - before[1]),
        )
        cs.received.clear()
    assert out["jax"] == out["port"]
    return out["port"]


def test_valid_votes_tagged_invalid_forwarded_unmarked_in_order(nets):
    privs, vset, pair = nets
    votes = []
    for i in range(8):
        v = _signed_vote(privs, vset, i % 4, round_=i)
        if i % 3 == 0:
            v.signature = bytes(64)
        votes.append((v, f"p{i}"))
    forwarded, counts = _feed(pair, votes)
    assert [(r, peer) for _, r, peer, _, _ in forwarded] == [(i, f"p{i}") for i in range(8)]
    assert [tagged for _, _, _, tagged, _ in forwarded] == [i % 3 != 0 for i in range(8)]
    assert counts == (5, 3)
    # the tag carries the key and the chain it was verified for
    tpv, tcs = pair["port"]
    vote = carry.vote(votes[1][0])
    tpv.submit(vote, "p")
    assert tcs.wait_received(1)
    assert vote._pre_verified[:2] == (CHAIN_ID, vset.validators[1].pub_key.bytes())


def test_unresolvable_votes_pass_through_alike(nets):
    privs, vset, pair = nets
    wrong_height = _signed_vote(privs, vset, 0, height=99)
    wrong_address = _signed_vote(privs, vset, 1)
    wrong_address.validator_address = vset.validators[2].address
    forwarded, counts = _feed(pair, [(wrong_height, "a"), (wrong_address, "b")])
    assert [tagged for _, _, _, tagged, _ in forwarded] == [False, False]
    assert counts == (0, 2)


def test_extension_tagged_for_a_non_nil_precommit(nets):
    privs, vset, pair = nets
    ext = _signed_vote(privs, vset, 3, type_=SIGNED_MSG_TYPE_PRECOMMIT, extension=b"oracle-price:42")
    bad_ext = _signed_vote(privs, vset, 2, type_=SIGNED_MSG_TYPE_PRECOMMIT, extension=b"x")
    bad_ext.extension_signature = bytes(64)
    forwarded, counts = _feed(pair, [(ext, "x"), (bad_ext, "y")])
    # the vote's own signature is good in both: tagged; only the good
    # extension is tagged
    assert [(t, e) for _, _, _, t, e in forwarded] == [(True, True), (True, False)]
    assert counts == (2, 0)


def test_port_warmup_reaches_verify_batch_with_distinct_lanes(port_env, monkeypatch):
    calls = []
    real = tops.verify_batch

    def recording(pks, msgs, sigs, device=None):
        calls.append(list(zip(pks, msgs, sigs)))
        return real(pks, msgs, sigs, device=device)

    monkeypatch.setattr(tops, "verify_batch", recording)
    privs, vset = make_validators(4)
    pv = treactor.VotePreverifier(_FakeCS(5, carry.validator_set(vset)))
    pv.start()
    try:
        assert pv.wait_warmup(timeout=WAIT)
        assert pv.warmup_error is None and pv.warmups == 1
    finally:
        pv.stop()
    assert len(calls) == 1
    lanes = calls[0]
    assert len(lanes) == len(set(lanes)) >= tbatch.DEVICE_THRESHOLD
    assert len({len(m) for _, m, _ in lanes}) == 1  # one length: the device hash takes them
    # a second probe signs other messages, so the verdict cache cannot answer it
    assert not set(treactor.warmup_lanes(1)) & set(treactor.warmup_lanes(2))


def test_reference_warmup_reaches_its_verify_fn_with_one_lane(monkeypatch):
    """The documented divergence: the reference's 16 pad submissions
    coalesce into one lane, a host-tier flush."""
    calls = []

    def counting(pks, msgs, sigs):
        calls.append(len(pks))
        return [verify_zip215(p, m, s) for p, m, s in zip(pks, msgs, sigs)]

    sched = JScheduler(counting, max_delay=0.01)
    sched.start()
    monkeypatch.setattr(jbatch, "_shared_scheduler", sched)
    privs, vset = make_validators(4)
    pv = JPreverifier(_FakeCS(5, vset))
    pv.start()
    try:
        assert pv._warm.wait(timeout=WAIT)
    finally:
        pv.stop()
        sched.stop()
    assert calls == [1] and sched.stats()["entries_coalesced"] == jbatch.DEVICE_THRESHOLD - 1
    assert calls[0] < jbatch.DEVICE_THRESHOLD  # tiered_verify_ed25519 keeps it on the host


@pytest.mark.parametrize("fault", ["verify", "scheduler"])
def test_a_failed_warmup_is_kept_and_votes_pass_through(port_env, monkeypatch, fault):
    if fault == "verify":
        def broken(pks, msgs, sigs, device=None):
            raise RuntimeError("device fault in the warm-up")

        monkeypatch.setattr(tops, "verify_batch", broken)
    else:
        def no_scheduler():
            raise RuntimeError("scheduler unavailable")

        monkeypatch.setattr(tbatch, "get_shared_scheduler", no_scheduler)
    privs, vset = make_validators(4)
    cs = _FakeCS(5, carry.validator_set(vset))
    pv = treactor.VotePreverifier(cs)
    pv.start()
    try:
        assert not pv.wait_warmup(timeout=WAIT)
        err = pv.warmup_error
        assert isinstance(err, RuntimeError)
        if fault == "verify":
            # the flush failed closed: the probe's lanes read False
            assert "16 of 16 valid probe lanes not verified" in str(err)
            assert tbatch.get_shared_scheduler().stats()["flush_errors"] == 1
        else:
            assert str(err) == "scheduler unavailable"
        vote = carry.vote(_signed_vote(privs, vset, 0))
        pv.submit(vote, "p")
        assert cs.received == [(vote, "p")] and vote._pre_verified is None
        assert (pv.batched, pv.passthrough) == (0, 1)
    finally:
        pv.stop()


def test_concurrent_peers_forward_every_vote_once_each(port_env):
    """Several peer threads deliver the same votes: every delivery is
    forwarded, tagged, and the duplicates cost no extra verifier lane
    within a flush."""
    privs, vset = make_validators(8)
    cs = _FakeCS(5, carry.validator_set(vset))
    votes = [carry.vote(_signed_vote(privs, vset, i)) for i in range(8)]
    lock = threading.Lock()
    received = []
    cs.add_vote_from_peer = lambda v, p: (lock.acquire(), received.append((v, p)), lock.release())
    pv = treactor.VotePreverifier(cs)
    pv.start()
    try:
        assert pv.wait_warmup(timeout=WAIT)
        sched = tbatch.get_shared_scheduler()
        before = sched.stats()
        peers = [threading.Thread(target=lambda k=k: [pv.submit(carry.vote(v), f"peer{k}") for v in votes])
                 for k in range(4)]
        for t in peers:
            t.start()
        for t in peers:
            t.join(timeout=WAIT)
        deadline = time.monotonic() + WAIT
        while len(received) < 32 and time.monotonic() < deadline:
            time.sleep(0.005)
        after = sched.stats()
    finally:
        pv.stop()
    assert len(received) == 32 and all(v._pre_verified is not None for v, _ in received)
    assert (pv.batched, pv.passthrough) == (32, 0)
    assert after["entries_verified"] - before["entries_verified"] == 32
    assert after["flush_errors"] == after["fallback_flushes"] == 0

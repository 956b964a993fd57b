"""The port's block sync beside the JAX package's: the twin of
``tests/test_blocksync.py`` (pool scheduling, the pipelined catch-up, a
corrupt peer banned), a block that passes the window and fails
``validate_block`` (validated before it is saved, unlike the reference),
a port follower syncing a chain the JAX package built (carried as proto
bytes), one window wide enough for the port's
plain kernels on the CPU, and the held divergences (a secp256k1 lane,
``mesh=``)."""

import hashlib

import pytest

pytest.importorskip("torch")

import tendermint_tpu_torch
from tendermint_tpu.blocksync.syncer import (
    BlockSyncer as JBlockSyncer,
    PeerTransport as JPeerTransport,
)
from tendermint_tpu.parallel.pipeline import (
    CommitTask as JCommitTask,
    verify_commits_pipelined as jverify_commits_pipelined,
)
from tendermint_tpu.crypto import keys as jkeys
from tendermint_tpu.state.execution import InvalidBlockError as JInvalidBlockError
from tendermint_tpu.types import block as jblock
from tendermint_tpu.types.validator import Validator as JValidator
from tendermint_tpu.types.validator_set import ValidatorSet as JValidatorSet
from tendermint_tpu_torch.blocksync.pool import BlockPool
from tendermint_tpu_torch.blocksync.syncer import BlockSyncer, PeerTransport
from tendermint_tpu_torch.crypto.keys import Ed25519PrivKey, Secp256k1PrivKey
from tendermint_tpu_torch.ops import cuda_verify, precompute
from tendermint_tpu_torch.parallel.pipeline import CommitTask, verify_commits_pipelined
from tendermint_tpu_torch.types.block import Block, BlockID, ExtendedCommit, PartSetHeader
from tests import test_blocksync as jsync
from tests import test_execution as jexec
from tests.test_torch_execution import (
    CHAIN_ID,
    advance_one_height,
    make_chain_env,
    make_commit,
    make_validators,
)


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(tendermint_tpu_torch, "DEFAULT_DEVICE", "cpu")


def make_block_id(seed=b"block"):
    return BlockID(hashlib.sha256(seed).digest(), PartSetHeader(1, hashlib.sha256(seed + b"-parts").digest()))


def build_source_chain(n_heights, n_vals=4, fork_app_at=None):
    """A fully applied port chain whose stores serve blocks. With
    ``fork_app_at``, a key is written into the source's app outside any
    block just before that height is applied: from the next block on,
    the chain carries app hashes an honest follower does not compute."""
    executor, state, privs, vset, app = make_chain_env(n_vals)
    ec = ExtendedCommit()
    for h in range(1, n_heights + 1):
        if h == fork_app_at:
            app._db.set(b"fork", b"1")
        state, ec = advance_one_height(executor, state, privs, vset, [b"h%d=v%d" % (h, h)], ec)
    return executor, state


class FakePeer(PeerTransport):
    """Serves blocks out of a source block store (of either package: a
    block crosses as its proto bytes) into the pool."""

    def __init__(self, pool, source_store, drop_heights=(), corrupt_heights=()):
        self.pool = pool
        self.store = source_store
        self.drop = set(drop_heights)
        self.corrupt = set(corrupt_heights)
        self.requests = []

    def request_block(self, peer_id, height):
        self.requests.append((peer_id, height))
        if height in self.drop:
            return
        src = self.store.load_block(height)
        if src is None:
            return
        block = Block.from_proto_bytes(src.to_proto_bytes())
        if height in self.corrupt and block.last_commit.signatures:
            block.last_commit.signatures[0].signature = bytes(64)
            block.last_commit._hash = None
        self.pool.add_block(peer_id, block)


def _follower(n_vals=4, **kw):
    executor, state, _, _, _ = make_chain_env(n_vals)
    kw.setdefault("device", "cpu")
    syncer = BlockSyncer(state, executor, executor.block_store, transport=None, **kw)
    return executor, syncer


def _sync(syncer, until, steps=100):
    for _ in range(steps):
        syncer.step()
        if syncer.state.last_block_height >= until:
            break
    return syncer.state.last_block_height


class TestBlockPool:
    def test_scheduling_and_delivery(self):
        pool = BlockPool(1)
        pool.set_peer_range("p1", 1, 5)
        assert [h for h, _ in pool.make_requests()] == [1, 2, 3, 4, 5]
        assert pool.num_pending() == 5

    def test_per_peer_limit(self):
        pool = BlockPool(1)
        pool.set_peer_range("p1", 1, 100)
        assert len(pool.make_requests()) == 20  # MAX_PENDING_REQUESTS_PER_PEER

    def test_add_block_only_from_assigned_peer(self):
        executor, _ = build_source_chain(2)
        block = executor.block_store.load_block(1)
        pool = BlockPool(1)
        pool.set_peer_range("p1", 1, 3)
        pool.make_requests()
        assert not pool.add_block("p2", block)  # wrong peer
        assert pool.add_block("p1", block)
        assert not pool.add_block("p1", block)  # duplicate

    def test_timeout_bans_peer(self):
        t = {"now": 0.0}
        pool = BlockPool(1, now=lambda: t["now"])
        pool.set_peer_range("p1", 1, 3)
        pool.make_requests()
        t["now"] = 100.0
        assert pool.check_timeouts() == ["p1"]
        assert pool.max_peer_height() == 0


class TestPipelinedVerification:
    def test_batch_of_commits(self):
        privs, vset = make_validators(4)
        tasks = []
        for h in range(1, 6):
            bid = make_block_id(b"blk%d" % h)
            tasks.append(CommitTask(CHAIN_ID, vset, bid, h, make_commit(bid, h, 0, vset, privs)))
        assert all(v.ok for v in verify_commits_pipelined(tasks, use_device=False))

    def test_bad_commit_attributed_within_batch(self):
        privs, vset = make_validators(4)
        tasks = []
        for h in range(1, 6):
            bid = make_block_id(b"blk%d" % h)
            commit = make_commit(bid, h, 0, vset, privs)
            if h == 3:
                commit.signatures[1].signature = bytes(64)
            tasks.append(CommitTask(CHAIN_ID, vset, bid, h, commit))
        verdicts = verify_commits_pipelined(tasks, use_device=False)
        assert [v.ok for v in verdicts] == [True, True, False, True, True]
        assert "#1" in str(verdicts[2].error)

    def test_insufficient_power_detected(self):
        privs, vset = make_validators(4)
        bid = make_block_id()
        commit = make_commit(bid, 1, 0, vset, privs, absent={0, 1})
        verdicts = verify_commits_pipelined([CommitTask(CHAIN_ID, vset, bid, 1, commit)], use_device=False)
        assert not verdicts[0].ok


def _secp_factory(i):
    if i % 2:
        return Secp256k1PrivKey((i + 1).to_bytes(32, "big"))
    return Ed25519PrivKey.from_seed(i.to_bytes(32, "big"))


def test_a_secp256k1_lane_is_answered_by_its_host_check_where_the_reference_fails_the_window():
    privs, vset = make_validators(6, key_factory=_secp_factory)
    bid = make_block_id(b"secp")
    commit = make_commit(bid, 1, 0, vset, privs)
    secp_idx = next(i for i, v in enumerate(vset.validators) if v.pub_key.type == "secp256k1")
    for use_device in (None, False):
        assert [v.ok for v in verify_commits_pipelined([CommitTask(CHAIN_ID, vset, bid, 1, commit)],
                                                       use_device=use_device)] == [True]
    bad = make_commit(bid, 1, 0, vset, privs)
    sig = bad.signatures[secp_idx].signature
    bad.signatures[secp_idx].signature = sig[:5] + bytes([sig[5] ^ 1]) + sig[6:]
    verdict = verify_commits_pipelined([CommitTask(CHAIN_ID, vset, bid, 1, bad)])[0]
    assert not verdict.ok and f"(#{secp_idx})" in str(verdict.error)

    # The same valid commit in the JAX package: its pipeline hands the
    # secp256k1 key to the ed25519 verifier, and the window fails.
    jset = JValidatorSet([JValidator(jkeys.pubkey_from_type_and_bytes(v.pub_key.type, v.pub_key.bytes()),
                                     v.voting_power) for v in vset.validators])
    assert jset.hash() == vset.hash()
    jcommit = jblock.Commit.from_proto_bytes(commit.to_proto_bytes())
    jbid = jblock.BlockID.from_proto_bytes(bid.to_proto_bytes())
    jverdict = jverify_commits_pipelined([JCommitTask(CHAIN_ID, jset, jbid, 1, jcommit)], use_device=False)[0]
    assert not jverdict.ok and f"(#{secp_idx})" in str(jverdict.error)


class TestBlockSyncer:
    def test_catch_up_pipelined(self):
        source_exec, _ = build_source_chain(12)
        follower_exec, syncer = _follower(verify_window=8)
        syncer.transport = FakePeer(syncer.pool, source_exec.block_store)
        syncer.pool.set_peer_range("p1", 1, source_exec.block_store.height())
        assert _sync(syncer, 11, steps=50) >= 11
        assert follower_exec.state_store.load().last_block_height >= 11
        assert (source_exec.state_store.load_validators(11).hash()
                == follower_exec.state_store.load_validators(11).hash())
        for h in range(1, 12):
            assert (follower_exec.block_store.load_block_meta(h).block_id
                    == source_exec.block_store.load_block_meta(h).block_id)

    def test_corrupt_block_bans_peer_and_recovers(self):
        source_exec, _ = build_source_chain(8)
        follower_exec, syncer = _follower(verify_window=4)
        bad_peer = FakePeer(syncer.pool, source_exec.block_store, corrupt_heights={4})
        good_peer = FakePeer(syncer.pool, source_exec.block_store)

        class Router(PeerTransport):
            def request_block(self, peer_id, height):
                (bad_peer if peer_id == "bad" else good_peer).request_block(peer_id, height)

        syncer.transport = Router()
        syncer.pool.set_peer_range("bad", 1, 8)
        for _ in range(100):
            syncer.step()
            if syncer.state.last_block_height >= 2:
                break
            if "bad" in syncer.pool._banned and "good" not in syncer.pool._peers:
                syncer.pool.set_peer_range("good", 1, 8)
        syncer.pool.set_peer_range("good", 1, 8)
        assert _sync(syncer, 7) >= 7
        assert "bad" in syncer.pool._banned
        # the good peer served the re-requested heights 3 and 4
        assert ("good", 3) in good_peer.requests and ("good", 4) in good_peer.requests

    def test_a_block_that_fails_validation_is_not_saved_and_its_peer_is_banned(self):
        """A peer serves a chain whose app forked at height 4: every
        commit is valid, so the window passes, but block 5's AppHash is
        not the one the follower's app computed and ``validate_block``
        rejects it. The port validates before it saves, as reactor.go
        does: block 5 is never stored, heights 5 and 6 are asked again of
        a good peer, the bad one is banned, and the follower converges.
        The reference's syncer saves block 5 first, and the error escapes
        ``step()``."""
        source_exec, _ = build_source_chain(8)
        fork_exec, _ = build_source_chain(8, fork_app_at=4)
        good_store, fork_store = source_exec.block_store, fork_exec.block_store
        assert fork_store.load_block_meta(4).block_id == good_store.load_block_meta(4).block_id
        assert fork_store.load_block(5).header.app_hash != good_store.load_block(5).header.app_hash
        follower_exec, syncer = _follower(verify_window=4)
        bad_peer = FakePeer(syncer.pool, fork_store)
        good_peer = FakePeer(syncer.pool, good_store)
        saved = []
        save_block = follower_exec.block_store.save_block

        def recording_save(block, parts, seen_commit):
            saved.append(block.hash())
            return save_block(block, parts, seen_commit)

        follower_exec.block_store.save_block = recording_save

        class Router(PeerTransport):
            def request_block(self, peer_id, height):
                (bad_peer if peer_id == "bad" else good_peer).request_block(peer_id, height)

        syncer.transport = Router()
        syncer.pool.set_peer_range("bad", 1, 8)
        for _ in range(50):
            syncer.step()
            if "bad" in syncer.pool._banned:
                break
        assert "bad" in syncer.pool._banned
        assert syncer.state.last_block_height == 4 and follower_exec.block_store.height() == 4
        syncer.pool.set_peer_range("good", 1, 8)
        assert _sync(syncer, 7) == 7
        assert ("good", 5) in good_peer.requests and ("good", 6) in good_peer.requests
        assert fork_store.load_block(5).hash() not in saved
        for h in range(1, 8):
            assert (follower_exec.block_store.load_block_meta(h).block_id
                    == good_store.load_block_meta(h).block_id)

        # The reference, on the same blocks carried as proto bytes.
        jexecutor, jstate, _, _, _ = jexec.make_chain_env(4)
        jsyncer = JBlockSyncer(jstate, jexecutor, jexecutor.block_store, transport=None,
                               verify_window=4, use_device=False)

        class JBadPeer(JPeerTransport):
            def request_block(self, peer_id, height):
                block = fork_store.load_block(height)
                jsyncer.pool.add_block(peer_id, jblock.Block.from_proto_bytes(block.to_proto_bytes()))

        jsyncer.transport = JBadPeer()
        jsyncer.pool.set_peer_range("bad", 1, 8)
        with pytest.raises(JInvalidBlockError, match="AppHash"):
            for _ in range(50):
                jsyncer.step()
        assert jsyncer.state.last_block_height == 4 and jexecutor.block_store.height() == 5
        assert "bad" not in jsyncer.pool._banned

    def test_mesh_raises_as_the_pipeline_does(self):
        executor, state, _, _, _ = make_chain_env()
        with pytest.raises(NotImplementedError, match="item 10"):
            BlockSyncer(state, executor, executor.block_store, transport=None, mesh=object(), device="cpu")

    def test_a_port_follower_syncs_a_chain_the_jax_package_built(self):
        jsource_exec, _ = jsync.build_source_chain(8)
        jstore = jsource_exec.block_store
        follower_exec, syncer = _follower(verify_window=4)
        syncer.transport = FakePeer(syncer.pool, jstore)
        syncer.pool.set_peer_range("p1", 1, jstore.height())
        assert _sync(syncer, 7) == 7
        for h in range(1, 8):
            tmeta = follower_exec.block_store.load_block_meta(h)
            jmeta = jstore.load_block_meta(h)
            assert tmeta.block_id.hash == jmeta.block_id.hash
            assert tmeta.block_id.part_set_header.hash == jmeta.block_id.part_set_header.hash
            assert tmeta.to_proto_bytes() == jmeta.to_proto_bytes()
        # the app hash after height 7 is the one block 8 carries
        assert syncer.state.app_hash == jstore.load_block(8).header.app_hash
        assert (follower_exec.state_store.load_validators(8).hash()
                == jsource_exec.state_store.load_validators(8).hash())

    def test_a_window_at_24_validators_runs_the_plain_kernels(self, monkeypatch):
        """A window of 17-lane commits and 24-lane LastCommits: both reach
        the engine (16 lanes and up), which runs its plain versions on the
        CPU (the wrappers launch no kernel there). ``validate_block``'s
        second verification of a LastCommit finds the window's 17 lanes
        in the verdict cache."""
        monkeypatch.setattr(cuda_verify, "LAUNCHES", dict.fromkeys(cuda_verify.LAUNCHES, 0))
        precompute.reset()
        source_exec, _ = build_source_chain(3, n_vals=24)
        follower_exec, syncer = _follower(n_vals=24, verify_window=4)
        syncer.transport = FakePeer(syncer.pool, source_exec.block_store)
        syncer.pool.set_peer_range("p1", 1, 3)
        precompute.results.clear()  # the source's own verdicts
        before = precompute.results.stats()
        assert _sync(syncer, 2) == 2
        after = precompute.results.stats()
        # window: 2 x 17 lanes, all new; height 2's LastCommit: 17 cached, 7 new
        assert after["misses"] - before["misses"] == 2 * 17 + 7
        assert after["hits"] - before["hits"] == 17
        for h in (1, 2):
            assert (follower_exec.block_store.load_block_meta(h).block_id
                    == source_exec.block_store.load_block_meta(h).block_id)
        assert not any(cuda_verify.LAUNCHES.values())
        precompute.reset()

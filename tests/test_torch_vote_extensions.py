"""ABCI++ vote extensions on the port's state machine: the twin of
``tests/test_vote_extensions.py``. With ``abci.vote_extensions_enable_height``
set, every precommit for a block carries the app's extension (ExtendVote),
peers verify it (VerifyVoteExtension), extended commits are stored, the
next proposer's PrepareProposal receives them, a tampered extension is
refused at ingestion, and a restart (the WAL and the ``Handshaker``) keeps
extending. The reference runs these over its node and p2p layers (ROADMAP
§A item 8d); here the validators are wired by the loopback broadcaster.
The stored extended commits are also read by the JAX package."""

import copy
import threading

import pytest

torch = pytest.importorskip("torch")

import tendermint_tpu_torch
from tendermint_tpu.types import ExtendedCommit as JExtendedCommit
from tendermint_tpu.crypto.keys import Ed25519PubKey as JEd25519PubKey
from tendermint_tpu_torch.abci import types as abci
from tendermint_tpu_torch.abci.client import LocalClient
from tendermint_tpu_torch.abci.kvstore import KVStoreApplication
from tendermint_tpu_torch.consensus.replay import Handshaker
from tendermint_tpu_torch.consensus.state import ConsensusState
from tendermint_tpu_torch.consensus.wal import WAL, NilWAL
from tendermint_tpu_torch.encoding.canonical import SIGNED_MSG_TYPE_PRECOMMIT, Timestamp
from tendermint_tpu_torch.privval import FilePV
from tendermint_tpu_torch.state import StateStore, state_from_genesis
from tendermint_tpu_torch.state.execution import BlockExecutor
from tendermint_tpu_torch.storage.blockstore import BlockStore
from tendermint_tpu_torch.storage.kv import MemDB
from tendermint_tpu_torch.types.block import BlockID, PartSetHeader, Vote
from tendermint_tpu_torch.types.genesis import GenesisDoc, GenesisValidator
from tendermint_tpu_torch.types.params import ConsensusParams, TimeoutParams
from tests.test_torch_consensus import LoopbackNet, _wait, wait_for_height

CHAIN = "ext-chain"
BASE_NS = 1_700_000_000_000_000_000


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(tendermint_tpu_torch, "DEFAULT_DEVICE", "cpu")


class ExtensionApp(KVStoreApplication):
    """kvstore, deterministic vote extensions and a log of what came in."""

    def __init__(self):
        super().__init__()
        self.lock = threading.Lock()
        self.extended_heights = []
        self.verified = []
        self.received_in_prepare = []

    def extend_vote(self, req):
        with self.lock:
            self.extended_heights.append(req.height)
        return abci.ResponseExtendVote(vote_extension=b"ext-h%d" % req.height)

    def verify_vote_extension(self, req):
        with self.lock:
            self.verified.append((req.height, bytes(req.vote_extension)))
        ok = req.vote_extension == b"ext-h%d" % req.height
        return abci.ResponseVerifyVoteExtension(
            status=abci.VERIFY_VOTE_EXTENSION_ACCEPT if ok else abci.VERIFY_VOTE_EXTENSION_REJECT
        )

    def prepare_proposal(self, req):
        if req.local_last_commit is not None:
            exts = [bytes(v.vote_extension) for v in (req.local_last_commit.votes or []) if v.vote_extension]
            if exts:
                with self.lock:
                    self.received_in_prepare.append((req.height, sorted(exts)))
        return super().prepare_proposal(req)


def _genesis(pvs, enable_height=1):
    params = ConsensusParams()
    params.timeout = TimeoutParams(propose=0.6, propose_delta=0.2, vote=0.3, vote_delta=0.1, commit=0.1)
    params.abci.vote_extensions_enable_height = enable_height
    return GenesisDoc(chain_id=CHAIN, genesis_time=Timestamp.from_unix_ns(BASE_NS), consensus_params=params,
                      validators=[GenesisValidator(pub_key=pv.get_pub_key(), power=10) for pv in pvs])


def _node(genesis, pv, app, wal, stores=None):
    """A validator over ``app``: InitChain on fresh stores, or the
    ``Handshaker`` over ``stores``."""
    client = LocalClient(app)
    client.start()
    if stores is None:
        state = state_from_genesis(genesis)
        state.app_hash = client.init_chain(abci.RequestInitChain(chain_id=CHAIN, initial_height=1)).app_hash
        stores = (StateStore(MemDB()), BlockStore(MemDB()))
        stores[0].save(state)
    executor = BlockExecutor(stores[0], client, stores[1], device="cpu")
    state = Handshaker(stores[0], stores[1], executor, genesis).handshake(client, stores[0].load())
    return ConsensusState(state, executor, stores[1], priv_validator=pv, wal=wal)


class TestVoteExtensions:
    def test_extension_lifecycle_across_network(self, tmp_path):
        pvs = [FilePV.generate(str(tmp_path / f"pk{i}.json"), str(tmp_path / f"ps{i}.json")) for i in range(3)]
        genesis = _genesis(pvs)
        apps = [ExtensionApp() for _ in range(3)]
        net = LoopbackNet()
        nodes = [_node(genesis, pvs[i], apps[i], NilWAL()) for i in range(3)]
        for n in nodes:
            net.attach(n)
        for n in nodes:
            n.start()
        try:
            assert wait_for_height(nodes, 3, timeout=90), f"heights: {[n.block_store.height() for n in nodes]}"
            assert _wait(lambda: any(app.received_in_prepare for app in apps), timeout=30), (
                "extensions never flowed back into PrepareProposal"
            )
        finally:
            for n in nodes:
                n.stop()
        for app in apps:
            assert app.extended_heights, "ExtendVote never called"
        assert any(app.verified for app in apps)
        for app in apps:
            for height, ext in app.verified:
                assert ext == b"ext-h%d" % height
        node = nodes[0]
        h = min(n.block_store.height() for n in nodes) - 1
        ec = node.block_store.load_block_extended_commit(h)
        assert ec is not None, f"no extended commit stored at {h}"
        exts = [bytes(s.extension) for s in ec.extended_signatures if s.extension]
        assert exts and all(e == b"ext-h%d" % h for e in exts), exts
        got_h, got_exts = next(app.received_in_prepare[0] for app in apps if app.received_in_prepare)
        assert all(e == b"ext-h%d" % (got_h - 1) for e in got_exts)
        # the JAX package reads the stored extended commit, and each
        # extension signature verifies there
        jec = JExtendedCommit.from_proto_bytes(ec.to_proto_bytes())
        assert jec.to_proto_bytes() == ec.to_proto_bytes()
        vset = node.block_exec.state_store.load_validators(h)
        for i, e in enumerate(jec.extended_signatures):
            if e.extension:
                jec.get_extended_vote(i).verify_vote_and_extension(
                    CHAIN, JEd25519PubKey(vset.validators[i].pub_key.bytes()))

    def test_tampered_extension_rejected_at_ingestion(self, tmp_path):
        """A precommit whose extension was changed after signing, or
        stripped, is refused at ingestion (state.go:2387-2416)."""
        privs = [FilePV.generate(str(tmp_path / f"k{i}.json"), str(tmp_path / f"s{i}.json")) for i in range(2)]
        cs = _node(_genesis(privs, enable_height=1), privs[0], ExtensionApp(), NilWAL())
        try:
            other = privs[1]
            addr = other.get_pub_key().address()
            val_idx, _ = cs.state.validators.get_by_address(addr)
            good = Vote(type=SIGNED_MSG_TYPE_PRECOMMIT, height=1, round=0,
                        block_id=BlockID(b"\x07" * 32, PartSetHeader(1, b"\x08" * 32)),
                        timestamp=Timestamp.from_unix_ns(BASE_NS), validator_address=addr,
                        validator_index=val_idx, extension=b"ext-h1")
            other.sign_vote(cs.state.chain_id, good)
            assert cs._add_vote(copy.deepcopy(good), "peer1")
            bad = copy.deepcopy(good)
            bad.extension = b"tampered"
            with pytest.raises(Exception):
                cs._add_vote(bad, "peer2")
            stripped = copy.deepcopy(good)
            stripped.extension = b""
            stripped.extension_signature = b""
            with pytest.raises(Exception):
                cs._add_vote(stripped, "peer3")
        finally:
            cs.stop()


class TestExtensionRestart:
    def test_extended_commits_survive_restart_and_replay(self, tmp_path):
        """A chain whose commits carry extensions restarts cleanly: the
        WAL's replay and the handshake walk them, and the node goes on
        extending."""
        pv = FilePV.generate(str(tmp_path / "epk.json"), str(tmp_path / "eps.json"))
        genesis = _genesis([pv])
        wal_path = str(tmp_path / "cs.wal")
        node = _node(genesis, pv, ExtensionApp(), WAL(wal_path))
        node.start()
        try:
            assert wait_for_height([node], 3, timeout=60)
        finally:
            node.stop()
        h_before = node.block_store.height()
        ec = node.block_store.load_block_extended_commit(h_before)
        assert ec is not None and any(v.extension for v in ec.extended_signatures)
        app2 = ExtensionApp()
        stores = (node.block_exec.state_store, node.block_store)
        node2 = _node(genesis, FilePV.load(str(tmp_path / "epk.json"), str(tmp_path / "eps.json")), app2,
                      WAL(wal_path), stores)
        assert app2.info(abci.RequestInfo()).last_block_height == h_before  # the handshake replayed them
        node2.start()
        try:
            assert wait_for_height([node2], h_before + 2, timeout=60), (
                f"stuck at {node2.block_store.height()} after restart (was {h_before})"
            )
        finally:
            node2.stop()
        assert app2.extended_heights, "no ExtendVote after restart"
        ec2 = node2.block_store.load_block_extended_commit(node2.block_store.height())
        assert ec2 is not None and any(v.extension for v in ec2.extended_signatures)


def test_extended_votes_and_stripping_match_the_jax_package(tmp_path):
    """``ExtendedCommit.get_extended_vote``, ``strip_extensions`` and
    ``Vote.strip_extension`` on a stored extended commit, beside the JAX
    package's on the same bytes."""
    pv = FilePV.generate(str(tmp_path / "k.json"), str(tmp_path / "s.json"))
    node = _node(_genesis([pv]), pv, ExtensionApp(), NilWAL())
    node.start()
    try:
        assert wait_for_height([node], 2, timeout=60)
    finally:
        node.stop()
    ec = node.block_store.load_block_extended_commit(2)
    jec = JExtendedCommit.from_proto_bytes(ec.to_proto_bytes())
    vote, jvote = ec.get_extended_vote(0), jec.get_extended_vote(0)
    assert vote.to_proto_bytes() == jvote.to_proto_bytes() and vote.extension == b"ext-h2"
    vote.verify_vote_and_extension(CHAIN, pv.get_pub_key())
    assert (vote.strip_extension(), jvote.strip_extension()) == (True, True)
    assert vote.to_proto_bytes() == jvote.to_proto_bytes() and not vote.strip_extension()
    assert (ec.strip_extensions(), jec.strip_extensions()) == (True, True)
    assert ec.to_proto_bytes() == jec.to_proto_bytes() and not ec.strip_extensions()

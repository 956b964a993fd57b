"""The port's consensus state machine beside the JAX package's.

- The twin of ``tests/test_consensus.py`` on the port: a single
  validator, the WAL restart, a 4-validator loopback network and its
  silent node, malformed peer input, locking, the double-sign guard and
  round skipping.
- Transcript parity: a JAX and a port ``ConsensusState`` with the same
  key, driven through the same scripted inputs (proposals with fixed
  timestamps, votes of three seeded peers, the locking scenarios), must
  broadcast the same votes and proposals (type, height, round, block).
- Chain parity: a 4-validator port network's chain replays in the JAX
  executor to the same app hash and its commits pass the JAX
  ``verify_commit``; a JAX single validator's chain does the same in the
  port.
- The slice whole: ``chip_smoke.py`` phase 15's harness at 20 validators
  on the CPU, its spread 0, so a step's votes meet in flushes of 16
  lanes or more and reach the plain versions; its blocks' txs give the
  JAX kvstore app the same app hashes and its commits pass the JAX
  ``Vote.verify`` one signature at a time.
- The held divergence: a device error inside the state machine stops
  the port's node and reaches the caller, where the reference's node
  stalls without a word.

The port runs on ``device="cpu"``. JAX batches stay under 16 lanes, so
the JAX package traces nothing. Timeouts are short, as in the
reference's ``fast_params()``; equality is exact.
"""

import copy
import time

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import tendermint_tpu_torch
from tendermint_tpu.abci import types as jabci
from tendermint_tpu.abci.kvstore import KVStoreApplication as JKVStoreApplication
from tendermint_tpu.state import StateStore as JStateStore, state_from_genesis as jstate_from_genesis
from tendermint_tpu.state.execution import BlockExecutor as JBlockExecutor
from tendermint_tpu.storage import MemDB as JMemDB
from tendermint_tpu.storage.blockstore import BlockStore as JBlockStore
from tendermint_tpu.types import Block as JBlock, Commit as JCommit
from tendermint_tpu.types.genesis import GenesisDoc as JGenesisDoc
from tendermint_tpu_torch.abci import types as abci
from tendermint_tpu_torch.abci.client import LocalClient
from tendermint_tpu_torch.abci.kvstore import KVStoreApplication
from tendermint_tpu_torch.consensus.reactor import ConsensusView
from tendermint_tpu_torch.consensus.state import (
    DEVICE_ERRORS,
    Broadcaster,
    ConsensusState,
    DoubleSigningRiskError,
)
from tendermint_tpu_torch.consensus.wal import WAL
from tendermint_tpu_torch.crypto import merkle
from tendermint_tpu_torch.encoding.canonical import (
    SIGNED_MSG_TYPE_PRECOMMIT,
    SIGNED_MSG_TYPE_PREVOTE,
    Timestamp,
)
from tendermint_tpu_torch.ops import device_policy, fault_injection
from tendermint_tpu_torch.ops.fault_injection import DeviceFault
from tendermint_tpu_torch.privval import FilePV
from tendermint_tpu_torch.state import StateStore, state_from_genesis
from tendermint_tpu_torch.state.execution import BlockExecutor
from tendermint_tpu_torch.storage.blockstore import BlockStore
from tendermint_tpu_torch.storage.kv import MemDB
from tendermint_tpu_torch.types.block import Block, BlockID, Commit, Proposal, Vote
from tendermint_tpu_torch.types.genesis import GenesisDoc, GenesisValidator
from tendermint_tpu_torch.types.params import ConsensusParams, TimeoutParams
from tendermint_tpu_torch.types.part_set import Part
from tendermint_tpu_torch.types.validation import verify_commit
from tests import test_consensus as jcons
from tests.test_torch_privval import make_block_id

CHAIN_ID = "cons-chain"
BASE_NS = 1_700_000_000_000_000_000


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(tendermint_tpu_torch, "DEFAULT_DEVICE", "cpu")


def fast_params() -> ConsensusParams:
    p = ConsensusParams()
    p.timeout = TimeoutParams(propose=0.5, propose_delta=0.1, vote=0.2, vote_delta=0.1, commit=0.05)
    return p


def build_validator(tmp_path, n_vals=1, index=0, privs=None, now=None):
    """``tests/test_consensus.py`` ``build_validator`` in the port: one
    validator's app, stores, executor and consensus state."""
    if privs is None:
        privs = [FilePV.generate(str(tmp_path / f"key{i}.json"), str(tmp_path / f"state{i}.json"))
                 for i in range(n_vals)]
    gen = GenesisDoc(
        chain_id=CHAIN_ID,
        genesis_time=Timestamp.from_unix_ns(BASE_NS),
        consensus_params=fast_params(),
        validators=[GenesisValidator(pub_key=pv.get_pub_key(), power=10) for pv in privs],
    )
    sm_state = state_from_genesis(gen)
    app = KVStoreApplication()
    client = LocalClient(app)
    client.start()
    init = client.init_chain(abci.RequestInitChain(chain_id=CHAIN_ID, initial_height=1))
    sm_state.app_hash = init.app_hash
    state_store = StateStore(MemDB())
    state_store.save(sm_state)
    block_store = BlockStore(MemDB())
    block_exec = BlockExecutor(state_store, client, block_store, now=now, device="cpu")
    cs = ConsensusState(sm_state, block_exec, block_store, priv_validator=privs[index],
                        wal=WAL(str(tmp_path / f"wal{index}.log")), now=now)
    return cs, privs, app


def wait_for_height(cs_list, height, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if all(cs.block_store.height() >= height for cs in cs_list):
            return True
        time.sleep(0.02)
    return False


def _wait(fn, timeout=15.0, interval=0.01):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        v = fn()
        if v:
            return v
        time.sleep(interval)
    return None


class TestSingleValidator:
    def test_self_commits_blocks(self, tmp_path):
        cs, privs, app = build_validator(tmp_path)
        cs.start()
        try:
            assert wait_for_height([cs], 3), f"only reached height {cs.block_store.height()}"
        finally:
            cs.stop()
        # the chain verifies: every stored commit
        for h in range(1, 3):
            commit = cs.block_store.load_block_commit(h)
            meta = cs.block_store.load_block_meta(h)
            vals = cs.block_exec.state_store.load_validators(h)
            verify_commit(CHAIN_ID, vals, meta.block_id, h, commit)

    def test_wal_replay_restart(self, tmp_path):
        cs, privs, app = build_validator(tmp_path)
        cs.start()
        assert wait_for_height([cs], 2)
        cs.stop()
        height_before = cs.block_store.height()
        # restart from the same stores and WAL: resume, no double-sign
        sm_state = cs.block_exec.state_store.load()
        cs2 = ConsensusState(sm_state, cs.block_exec, cs.block_store, priv_validator=privs[0],
                             wal=WAL(str(tmp_path / "wal0.log")))
        cs2.start()
        try:
            assert wait_for_height([cs2], height_before + 2)
        finally:
            cs2.stop()


class LoopbackNet(Broadcaster):
    """An in-process network: every broadcast goes to every other
    validator's peer queue."""

    def __init__(self):
        self.nodes = []

    def attach(self, cs):
        net = self

        class NodeB(Broadcaster):
            def broadcast_proposal(self, proposal):
                net.deliver(cs, "proposal", proposal)

            def broadcast_block_part(self, height, round_, part):
                net.deliver(cs, "part", (height, round_, part))

            def broadcast_vote(self, vote):
                net.deliver(cs, "vote", vote)

        cs.broadcaster = NodeB()
        self.nodes.append(cs)

    def deliver(self, sender, kind, payload):
        for node in self.nodes:
            if node is sender:
                continue
            if kind == "proposal":
                node.add_proposal_from_peer(payload, "peer")
            elif kind == "part":
                h, r, p = payload
                node.add_block_part_from_peer(h, r, p, "peer")
            else:
                node.add_vote_from_peer(copy.copy(payload), "peer")


def loopback_network(tmp_path, n=4):
    privs = [FilePV.generate(str(tmp_path / f"key{i}.json"), str(tmp_path / f"state{i}.json")) for i in range(n)]
    net = LoopbackNet()
    nodes = []
    for i in range(n):
        cs, _, _ = build_validator(tmp_path, n_vals=n, index=i, privs=privs)
        net.attach(cs)
        nodes.append(cs)
    return nodes


class TestFourValidatorNetwork:
    def test_network_commits(self, tmp_path):
        nodes = loopback_network(tmp_path)
        for cs in nodes:
            cs.start()
        try:
            assert wait_for_height(nodes, 3, timeout=60), f"heights: {[cs.block_store.height() for cs in nodes]}"
            h1 = [cs.block_store.load_block_meta(1).block_id for cs in nodes]
            assert all(b == h1[0] for b in h1)
        finally:
            for cs in nodes:
                cs.stop()

    def test_network_survives_one_silent_node(self, tmp_path):
        nodes = loopback_network(tmp_path)
        # node 3 never starts: 30 of 40 power is over 2/3
        for cs in nodes[:3]:
            cs.start()
        try:
            assert wait_for_height(nodes[:3], 2, timeout=90), (
                f"heights: {[cs.block_store.height() for cs in nodes[:3]]}"
            )
        finally:
            for cs in nodes[:3]:
                cs.stop()


class TestPeerRobustness:
    def test_malformed_peer_input_does_not_kill_loop(self, tmp_path):
        """A bad proposal signature or a bogus block part from a peer is
        dropped; the receive routine goes on."""
        cs, privs, app = build_validator(tmp_path)
        cs.start()
        try:
            bad = Proposal(height=cs.rs.height, round=0, pol_round=-1, block_id=make_block_id(),
                           timestamp=Timestamp.from_unix_ns(BASE_NS), signature=b"\x01" * 64)
            cs.add_proposal_from_peer(bad, "evil")
            cs.add_block_part_from_peer(
                cs.rs.height, 0,
                Part(index=0, bytes=b"junk", proof=merkle.Proof(total=1, index=0, leaf_hash=b"\x02" * 32)),
                "evil",
            )
            assert wait_for_height([cs], 2, timeout=30)
            assert cs.error is None
        finally:
            cs.stop()


# --- locking (the reference's state_test.go locking sections) ----------------


class CaptureB(Broadcaster):
    """Records what the node under test broadcasts."""

    def __init__(self):
        self.proposals = []
        self.parts = []
        self.votes = []
        self.transcript = []

    def broadcast_proposal(self, proposal):
        self.proposals.append(proposal)
        self.transcript.append(("proposal", proposal.height, proposal.round, proposal.block_id.hash))

    def broadcast_block_part(self, height, round_, part):
        self.parts.append((height, round_, part))

    def broadcast_vote(self, vote):
        self.votes.append(vote)
        self.transcript.append((vote.type, vote.height, vote.round, vote.block_id.hash))


def _vote_of(cap, type_, round_, height=1):
    for v in cap.votes:
        if v.type == type_ and v.round == round_ and v.height == height:
            return v
    return None


class LockHarness:
    """ONE real ConsensusState (the height-1 round-0 proposer, or not)
    and three scripted validators whose votes are made and injected
    (the reference's common_test.go harness)."""

    def __init__(self, tmp_path, subject_is_proposer=True):
        privs = [FilePV.generate(str(tmp_path / f"lk{i}.json"), str(tmp_path / f"ls{i}.json")) for i in range(4)]
        probe, _, _ = build_validator(tmp_path, n_vals=4, index=0, privs=privs)
        proposer_addr = probe.rs.validators.get_proposer().address
        by_addr = {p.get_pub_key().address(): i for i, p in enumerate(privs)}
        prop_idx = by_addr[proposer_addr]
        idx = prop_idx if subject_is_proposer else next(i for i in range(4) if i != prop_idx)
        if idx == 0:
            self.cs = probe
        else:
            self.cs, _, _ = build_validator(tmp_path, n_vals=4, index=idx, privs=privs)
        self.tmp_path = tmp_path
        self.privs = privs
        self.cap = CaptureB()
        self.cs.broadcaster = self.cap
        self.vset = self.cs.state.validators
        self.index_of = {v.address: i for i, v in enumerate(self.vset.validators)}
        self.priv_of_index = {self.index_of[p.get_pub_key().address()]: p for p in privs}
        self.subject_index = self.index_of[privs[idx].get_pub_key().address()]

    def others(self):
        return [i for i in range(4) if i != self.subject_index]

    def make_vote(self, val_index, type_, round_, block_id, height=1):
        pv = self.priv_of_index[val_index]
        v = Vote(type=type_, height=height, round=round_, block_id=block_id,
                 timestamp=Timestamp.from_unix_ns(BASE_NS + 1000 + val_index),
                 validator_address=pv.get_pub_key().address(), validator_index=val_index)
        v.signature = pv.priv_key.sign(v.sign_bytes(CHAIN_ID))
        return v

    def inject_votes(self, type_, round_, block_id, n=None, height=1):
        idxs = self.others() if n is None else self.others()[:n]
        for i in idxs:
            self.cs.add_vote_from_peer(self.make_vote(i, type_, round_, block_id, height), f"peer{i}")

    def proposal_block_id(self):
        prop = _wait(lambda: self.cap.proposals[0] if self.cap.proposals else None)
        assert prop is not None, "subject never proposed"
        return prop.block_id

    def alternative_block(self, proposer_index_in_vset):
        """A valid competing block from the given validator's own
        proposal machinery, and its part set."""
        from tendermint_tpu_torch.types.block import BLOCK_PART_SIZE_BYTES
        from tendermint_tpu_torch.types.part_set import PartSet

        priv = self.priv_of_index[proposer_index_in_vset]
        priv_pos = next(i for i, p in enumerate(self.privs) if p is priv)
        shadow, _, _ = build_validator(self.tmp_path, n_vals=4, index=priv_pos, privs=self.privs)
        block = shadow._create_proposal_block()
        assert block is not None
        return block, PartSet.from_data(block.to_proto_bytes(), BLOCK_PART_SIZE_BYTES)

    def inject_proposal(self, proposer_index, block, parts, round_, pol_round=-1):
        priv = self.priv_of_index[proposer_index]
        prop = Proposal(height=1, round=round_, pol_round=pol_round, block_id=BlockID(block.hash(), parts.header()),
                        timestamp=block.header.time)
        prop.signature = priv.priv_key.sign(prop.sign_bytes(CHAIN_ID))
        self.cs.add_proposal_from_peer(prop, "peerP")
        for i in range(parts.total):
            self.cs.add_block_part_from_peer(1, round_, parts.get_part(i), "peerP")


PV, PC = SIGNED_MSG_TYPE_PREVOTE, SIGNED_MSG_TYPE_PRECOMMIT


class TestLocking:
    def test_nil_prevote_on_propose_timeout(self, tmp_path):
        h = LockHarness(tmp_path, subject_is_proposer=False)
        h.cs.start()
        try:
            pv = _wait(lambda: _vote_of(h.cap, PV, 0))
            assert pv is not None, "no prevote broadcast"
            assert pv.block_id.is_nil(), "must prevote nil without a proposal"
        finally:
            h.cs.stop()

    def test_lock_then_nil_prevote_on_new_block_without_pol(self, tmp_path):
        h = LockHarness(tmp_path, subject_is_proposer=True)
        h.cs.start()
        try:
            a_id = h.proposal_block_id()
            h.inject_votes(PV, 0, a_id, n=2)
            pc0 = _wait(lambda: _vote_of(h.cap, PC, 0))
            assert pc0 is not None and pc0.block_id.hash == a_id.hash
            assert h.cs.rs.locked_round == 0
            h.inject_votes(PC, 0, BlockID())
            assert _wait(lambda: h.cs.rs.round == 1, timeout=20), f"stuck in round {h.cs.rs.round}"
            r1_proposer = h.index_of[h.cs.rs.validators.get_proposer().address]
            assert r1_proposer != h.subject_index, "rotation must move on"
            block_b, parts_b = h.alternative_block(r1_proposer)
            assert block_b.hash() != a_id.hash
            h.inject_proposal(r1_proposer, block_b, parts_b, round_=1)
            pv1 = _wait(lambda: _vote_of(h.cap, PV, 1), timeout=20)
            assert pv1 is not None, "no round-1 prevote"
            assert pv1.block_id.is_nil(), "locked validator prevoted a different block without a POL"
            assert h.cs.rs.proposal_block is not None
            assert h.cs.rs.proposal_block.hash() == block_b.hash()
            assert h.cs.rs.locked_block.hash() == a_id.hash
            b_id = BlockID(block_b.hash(), parts_b.header())
            h.inject_votes(PV, 1, b_id)
            pc1 = _wait(lambda: _vote_of(h.cap, PC, 1), timeout=20)
            assert pc1 is not None, "no round-1 precommit"
            assert pc1.block_id.hash == block_b.hash(), "must relock on new POL"
            assert h.cs.rs.locked_round == 1
            assert h.cs.rs.locked_block.hash() == block_b.hash()
        finally:
            h.cs.stop()

    def test_prevote_locked_block_when_reproposed_with_pol(self, tmp_path):
        h = LockHarness(tmp_path, subject_is_proposer=True)
        h.cs.start()
        try:
            a_id = h.proposal_block_id()
            a_parts = _wait(lambda: h.cap.parts if h.cap.parts else None)
            h.inject_votes(PV, 0, a_id, n=2)
            assert _wait(lambda: h.cs.rs.locked_round == 0, timeout=20)
            locked_block = h.cs.rs.locked_block
            h.inject_votes(PC, 0, BlockID())
            assert _wait(lambda: h.cs.rs.round == 1, timeout=20)
            r1_proposer = h.index_of[h.cs.rs.validators.get_proposer().address]
            priv = h.priv_of_index[r1_proposer]
            prop = Proposal(height=1, round=1, pol_round=0, block_id=a_id, timestamp=locked_block.header.time)
            prop.signature = priv.priv_key.sign(prop.sign_bytes(CHAIN_ID))
            h.cs.add_proposal_from_peer(prop, "peerP")
            for _, _, part in a_parts:
                h.cs.add_block_part_from_peer(1, 1, part, "peerP")
            pv1 = _wait(lambda: _vote_of(h.cap, PV, 1), timeout=20)
            assert pv1 is not None, "no round-1 prevote"
            assert pv1.block_id.hash == a_id.hash, (
                "validator must prevote its locked block when re-proposed with a valid POL round"
            )
        finally:
            h.cs.stop()

    def test_invalid_injected_votes_do_not_corrupt_lock_state(self, tmp_path):
        h = LockHarness(tmp_path, subject_is_proposer=True)
        h.cs.start()
        try:
            a_id = h.proposal_block_id()
            good = h.make_vote(h.others()[0], PV, 0, a_id)
            bad_sig = h.make_vote(h.others()[1], PV, 0, a_id)
            bad_sig.signature = b"\x01" * 64
            bad_idx = Vote(type=PV, height=1, round=0, block_id=a_id, timestamp=Timestamp.from_unix_ns(BASE_NS),
                           validator_address=b"\x05" * 20, validator_index=55, signature=b"\x02" * 64)
            h.cs.add_vote_from_peer(bad_sig, "evil")
            h.cs.add_vote_from_peer(bad_idx, "evil")
            h.cs.add_vote_from_peer(good, "peer")
            time.sleep(0.3)
            assert h.cs.rs.locked_round == -1
            h.cs.add_vote_from_peer(h.make_vote(h.others()[1], PV, 0, a_id), "peer")
            pc0 = _wait(lambda: _vote_of(h.cap, PC, 0), timeout=20)
            assert pc0 is not None and pc0.block_id.hash == a_id.hash
            assert h.cs.rs.locked_round == 0
        finally:
            h.cs.stop()


class TestDoubleSignRiskGuard:
    def test_restart_with_recent_own_signature_refuses(self, tmp_path):
        cs, privs, app = build_validator(tmp_path)
        cs.start()
        assert wait_for_height([cs], 3)
        cs.stop()
        sm_state = cs.block_exec.state_store.load()
        cs2 = ConsensusState(sm_state, cs.block_exec, cs.block_store, priv_validator=privs[0],
                             wal=WAL(str(tmp_path / "wal0.log")), double_sign_check_height=10)
        with pytest.raises(DoubleSigningRiskError):
            cs2.start()
        cs2.stop()

    def test_restart_disabled_guard_proceeds(self, tmp_path):
        cs, privs, app = build_validator(tmp_path)
        cs.start()
        assert wait_for_height([cs], 2)
        cs.stop()
        sm_state = cs.block_exec.state_store.load()
        cs2 = ConsensusState(sm_state, cs.block_exec, cs.block_store, priv_validator=privs[0],
                             wal=WAL(str(tmp_path / "wal0.log")))
        cs2.start()
        try:
            assert wait_for_height([cs2], cs.block_store.height() + 1)
        finally:
            cs2.stop()

    def test_unsigned_lookback_window_proceeds(self, tmp_path):
        cs, privs, app = build_validator(tmp_path)
        cs.start()
        assert wait_for_height([cs], 2)
        cs.stop()
        sm_state = cs.block_exec.state_store.load()
        other = FilePV.generate(str(tmp_path / "okey.json"), str(tmp_path / "ostate.json"))
        cs2 = ConsensusState(sm_state, cs.block_exec, cs.block_store, priv_validator=other,
                             wal=WAL(str(tmp_path / "wal-obs.log")), double_sign_check_height=10)
        cs2.start()  # no signature of its own in the window: no refusal
        cs2.stop()


class TestRoundSkipping:
    def test_two_thirds_any_at_future_round_skips_forward(self, tmp_path):
        h = LockHarness(tmp_path, subject_is_proposer=False)
        h.cs.start()
        try:
            h.inject_votes(PV, 5, BlockID())
            assert _wait(lambda: h.cs.rs.round == 5, timeout=20), f"stuck at round {h.cs.rs.round}"
            assert _wait(lambda: _vote_of(h.cap, PV, 5), timeout=20) is not None
        finally:
            h.cs.stop()

    def test_future_round_precommits_skip_too(self, tmp_path):
        h = LockHarness(tmp_path, subject_is_proposer=False)
        h.cs.start()
        try:
            h.inject_votes(PC, 3, BlockID())
            assert _wait(lambda: h.cs.rs.round >= 3, timeout=20), f"stuck at round {h.cs.rs.round}"
        finally:
            h.cs.stop()


def test_consensus_state_satisfies_the_pre_verifiers_view(tmp_path):
    """``VotePreverifier`` reads the slice of the state that
    ``ConsensusView`` names; the real state has it."""
    cs, _, _ = build_validator(tmp_path, n_vals=2)
    for name, kind in (("rs", None), ("state", None), ("add_vote_from_peer", callable)):
        assert name in ConsensusView.__annotations__ or hasattr(ConsensusView, name)
        assert hasattr(cs, name) and (kind is None or kind(getattr(cs, name)))
    assert cs.rs.height == 1 and cs.rs.validators is cs.state.validators
    assert cs.state.chain_id == CHAIN_ID
    assert not hasattr(cs, "device") and cs.block_exec.device == torch.device("cpu")


# --- transcript parity ---------------------------------------------------------


def _pkg(root):
    """The modules a scripted node needs, of one package."""
    import importlib
    from types import SimpleNamespace

    names = {"abci": "abci.types", "client": "abci.client", "kvstore": "abci.kvstore", "cons": "consensus.state",
             "wal": "consensus.wal", "canonical": "encoding.canonical", "privval": "privval", "sm": "state",
             "execution": "state.execution", "kv": "storage.kv", "blockstore": "storage.blockstore",
             "genesis": "types.genesis", "block": "types.block", "part_set": "types.part_set"}
    return SimpleNamespace(root=root, **{k: importlib.import_module(f"{root}.{v}") for k, v in names.items()})


JAX, PORT = _pkg("tendermint_tpu"), _pkg("tendermint_tpu_torch")
FIXED_NS = BASE_NS + 10**9  # the clock of the scripted nodes: every block and vote at this instant


def scripted_keys(tmp_path, n=4):
    """``n`` seeded keys as JAX FilePV key files; each package loads
    them with a state file of its own."""
    from tendermint_tpu.crypto.keys import Ed25519PrivKey as JEd25519PrivKey

    paths = []
    for i in range(n):
        key = str(tmp_path / f"sk{i}.json")
        JAX.privval.FilePV(JEd25519PrivKey.from_seed(bytes([i + 1]) * 32), key, str(tmp_path / f"sj{i}.json")).save()
        paths.append(key)
    return paths


def scripted_genesis(key_paths, params_json_from=None):
    """The genesis JSON of the scripted chain (fast timeouts), written by
    the JAX package."""
    from tendermint_tpu.types.params import ConsensusParams as JParams, TimeoutParams as JTimeouts

    p = JParams()
    p.timeout = JTimeouts(propose=0.5, propose_delta=0.1, vote=0.2, vote_delta=0.1, commit=0.05)
    pvs = [JAX.privval.FilePV.load(k, k + ".none") for k in key_paths]
    return JAX.genesis.GenesisDoc(
        chain_id=CHAIN_ID, genesis_time=JAX.canonical.Timestamp.from_unix_ns(BASE_NS), consensus_params=p,
        validators=[JAX.genesis.GenesisValidator(pub_key=pv.get_pub_key(), power=10) for pv in pvs],
    ).to_json()


class ScriptedNode:
    """One package's node for a script: the validator of key
    ``key_paths[index]`` on the genesis JSON, its clock fixed at
    FIXED_NS, a NilWAL, a capturing broadcaster."""

    def __init__(self, P, tmp_path, genesis_json, key_paths, index, tag, clock_ns=None):
        self.P = P
        now = lambda: P.canonical.Timestamp.from_unix_ns(clock_ns() if clock_ns else FIXED_NS)
        gen = P.genesis.GenesisDoc.from_json(genesis_json)
        st = P.sm.state_from_genesis(gen)
        client = P.client.LocalClient(P.kvstore.KVStoreApplication())
        client.start()
        st.app_hash = client.init_chain(P.abci.RequestInitChain(chain_id=CHAIN_ID, initial_height=1)).app_hash
        ss, bs = P.sm.StateStore(P.kv.MemDB()), P.blockstore.BlockStore(P.kv.MemDB())
        ss.save(st)
        kw = {"device": "cpu"} if P is PORT else {}
        self.executor = P.execution.BlockExecutor(ss, client, bs, now=now, **kw)
        self.pvs = [P.privval.FilePV.load(k, str(tmp_path / f"{tag}-{P.root}-{i}.json"))
                    for i, k in enumerate(key_paths)]
        self.cap = CaptureB()
        self.cs = P.cons.ConsensusState(st, self.executor, bs, priv_validator=self.pvs[index],
                                        wal=P.wal.NilWAL(), broadcaster=self.cap, now=now)
        self.vset = st.validators
        self.index_of = {v.address: i for i, v in enumerate(self.vset.validators)}
        self.subject = self.index_of[self.pvs[index].get_pub_key().address()]
        self.priv_at = {self.index_of[pv.get_pub_key().address()]: pv for pv in self.pvs}

    def others(self):
        return [i for i in range(len(self.vset)) if i != self.subject]

    def block_id(self, hash_, total, psh_hash):
        return self.P.block.BlockID(hash_, self.P.block.PartSetHeader(total, psh_hash))

    def vote(self, i, type_, round_, bid, height=1):
        v = self.P.block.Vote(type=type_, height=height, round=round_, block_id=bid,
                              timestamp=self.P.canonical.Timestamp.from_unix_ns(FIXED_NS),
                              validator_address=self.vset.validators[i].address, validator_index=i)
        v.signature = self.priv_at[i].priv_key.sign(v.sign_bytes(CHAIN_ID))
        return v

    def inject(self, type_, round_, bid, idxs=None, height=1):
        votes = [self.vote(i, type_, round_, bid, height) for i in (self.others() if idxs is None else idxs)]
        for v in votes:
            self.cs.add_vote_from_peer(copy.copy(v), f"peer{v.validator_index}")
        return votes

    def propose(self, i, block, parts, round_, pol_round=-1):
        bid = self.P.block.BlockID(block.hash(), parts.header())
        prop = self.P.block.Proposal(height=block.header.height, round=round_, pol_round=pol_round, block_id=bid,
                                     timestamp=block.header.time)
        prop.signature = self.priv_at[i].priv_key.sign(prop.sign_bytes(CHAIN_ID))
        self.cs.add_proposal_from_peer(prop, "peerP")
        for k in range(parts.total):
            self.cs.add_block_part_from_peer(block.header.height, round_, parts.get_part(k), "peerP")

    def proposer_block(self, i, tmp_path, genesis_json, key_paths):
        """Validator ``i``'s own proposal for height 1 (a shadow node of
        its key), and its part set."""
        pos = next(k for k, pv in enumerate(self.pvs) if pv is self.priv_at[i])
        shadow = ScriptedNode(self.P, tmp_path, genesis_json, key_paths, pos, f"shadow{i}")
        block = shadow.cs._create_proposal_block()
        return block, self.P.part_set.PartSet.from_data(block.to_proto_bytes(), self.P.block.BLOCK_PART_SIZE_BYTES)

    def wait_vote(self, type_, round_, height=1):
        v = _wait(lambda: _vote_of(self.cap, type_, round_, height), timeout=20)
        assert v is not None, f"{self.P.root}: no {type_} at {height}/{round_}"
        return v


def run_script(P, tmp_path, scenario):
    """Drive one package's node through ``scenario``; return what it
    broadcast (kind, height, round, block hash) and the block it
    committed, if any."""
    key_paths = scripted_keys(tmp_path)
    genesis_json = scripted_genesis(key_paths)
    probe = ScriptedNode(P, tmp_path, genesis_json, key_paths, 0, "probe")
    proposer = probe.index_of[probe.vset.get_proposer().address]
    pos = {probe.index_of[pv.get_pub_key().address()]: k for k, pv in enumerate(probe.pvs)}
    subject = proposer if scenario != "timeout_and_skip" else (proposer + 1) % 4
    n = ScriptedNode(P, tmp_path, genesis_json, key_paths, pos[subject], scenario)
    n.cs.start()
    try:
        if scenario == "timeout_and_skip":
            assert n.wait_vote(PV, 0).block_id.is_nil()  # no proposal: nil after the timeout
            n.inject(PV, 3, n.block_id(b"", 0, b""))  # +2/3 at a future round pulls it there
            n.wait_vote(PV, 3)
            n.inject(PC, 3, n.block_id(b"", 0, b""))
            n.wait_vote(PC, 3)
        else:
            prop = _wait(lambda: n.cap.proposals[0] if n.cap.proposals else None)
            assert prop is not None
            a_id = prop.block_id
            if scenario == "invalid_votes":
                bad = n.vote(n.others()[1], PV, 0, a_id)
                bad.signature = b"\x01" * 64
                n.cs.add_vote_from_peer(bad, "evil")
            n.inject(PV, 0, a_id, n.others()[:2])
            n.wait_vote(PC, 0)
            n.inject(PC, 0, n.block_id(b"", 0, b""))
            assert _wait(lambda: n.cs.rs.round == 1, timeout=20)
            r1 = n.index_of[n.cs.rs.validators.get_proposer().address]
            if scenario == "relock":
                block_b, parts_b = n.proposer_block(r1, tmp_path, genesis_json, key_paths)
                n.propose(r1, block_b, parts_b, 1)
                assert n.wait_vote(PV, 1).block_id.is_nil()
                b_id = n.P.block.BlockID(block_b.hash(), parts_b.header())
            else:  # re-proposed with its POL round
                parts = n.cs.rs.locked_block_parts
                n.propose(r1, n.cs.rs.locked_block, parts, 1, pol_round=0)
                n.wait_vote(PV, 1)
                b_id = a_id
            n.inject(PV, 1, b_id)
            n.wait_vote(PC, 1)
            n.inject(PC, 1, b_id)
            assert _wait(lambda: n.cs.block_store.height() >= 1, timeout=20)
    finally:
        n.cs.stop()
    committed = n.cs.block_store.load_block_meta(1)
    return n.cap.transcript, committed.block_id.hash if committed else None


@pytest.mark.parametrize("scenario", ["relock", "repropose_with_pol", "invalid_votes", "timeout_and_skip"])
def test_the_broadcast_transcripts_match_the_jax_package(tmp_path, scenario):
    """The same key, genesis, clock and scripted inputs through both
    packages' state machines: the same votes and proposals, in order."""
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    jt, jblock = run_script(JAX, tmp_path / "jax", scenario)
    tt, tblock = run_script(PORT, tmp_path / "port", scenario)
    assert tt == jt
    assert tblock == jblock
    if scenario == "timeout_and_skip":
        assert [(k, r) for k, _, r, _ in tt] == [(PV, 0), (PV, 3), (PC, 3)]
    else:
        assert len(tt) >= 5 and tblock is not None


# --- chain parity --------------------------------------------------------------


def _genesis_json(pvs, params):
    return GenesisDoc(chain_id=CHAIN_ID, genesis_time=Timestamp.from_unix_ns(BASE_NS), consensus_params=params,
                      validators=[GenesisValidator(pub_key=pv.get_pub_key(), power=10) for pv in pvs]).to_json()


def test_a_port_network_chain_replays_in_the_jax_executor(tmp_path):
    """A 4-validator port network commits 3 heights; its blocks, carried
    as proto bytes, replay in the JAX executor to the same app hashes,
    and each commit passes the JAX ``verify_commit`` (host tier)."""
    from tendermint_tpu.abci.client import LocalClient as JLocalClient
    from tendermint_tpu.types import BlockID as JBlockID, ValidatorSet as JValidatorSet

    nodes = loopback_network(tmp_path)
    for cs in nodes:
        cs.start()
    try:
        assert wait_for_height(nodes, 3, timeout=60)
    finally:
        for cs in nodes:
            cs.stop()
    node = nodes[0]
    pvs = [cs.priv_validator for cs in nodes]
    jgen = JGenesisDoc.from_json(_genesis_json(pvs, fast_params()))
    jst = jstate_from_genesis(jgen)
    jclient = JLocalClient(JKVStoreApplication())
    jclient.start()
    jst.app_hash = jclient.init_chain(jabci.RequestInitChain(chain_id=CHAIN_ID, initial_height=1)).app_hash
    jss = JStateStore(JMemDB())
    jss.save(jst)
    jexec = JBlockExecutor(jss, jclient, JBlockStore(JMemDB()))
    top = node.block_store.height()
    final = node.block_exec.state_store.load()
    for h in range(1, top + 1):
        meta = node.block_store.load_block_meta(h)
        jbid = JBlockID.from_proto_bytes(meta.block_id.to_proto_bytes())
        jst = jexec.apply_block(jst, jbid, JBlock.from_proto_bytes(node.block_store.load_block(h).to_proto_bytes()))
        want = final.app_hash if h == top else node.block_store.load_block(h + 1).header.app_hash
        assert jst.app_hash == want
        jvals = JValidatorSet.from_proto_bytes(node.block_exec.state_store.load_validators(h).to_proto_bytes())
        commit = node.block_store.load_block_commit(h) if h < top else node.block_store.load_seen_commit()
        jvals.verify_commit(CHAIN_ID, jbid, h, JCommit.from_proto_bytes(commit.to_proto_bytes()))


def test_a_jax_single_validator_chain_replays_in_the_port(tmp_path):
    """The other way round: a JAX single validator's chain replays in the
    port's executor to the same app hashes, and its commits pass the
    port's ``verify_commit``."""
    from tendermint_tpu.types.genesis import GenesisDoc as JG, GenesisValidator as JGV

    jcs, jprivs, _ = jcons.build_validator(tmp_path)
    jcs.start()
    try:
        assert jcons.wait_for_height([jcs], 3)
    finally:
        jcs.stop()
    gen_json = JG(chain_id=jcons.CHAIN_ID, genesis_time=jcs.state.last_block_time.__class__.from_unix_ns(jcons.BASE_NS),
                  consensus_params=jcons.fast_params(),
                  validators=[JGV(pub_key=pv.get_pub_key(), power=10) for pv in jprivs]).to_json()
    st = state_from_genesis(GenesisDoc.from_json(gen_json))
    client = LocalClient(KVStoreApplication())
    client.start()
    st.app_hash = client.init_chain(abci.RequestInitChain(chain_id=jcons.CHAIN_ID, initial_height=1)).app_hash
    ss = StateStore(MemDB())
    ss.save(st)
    executor = BlockExecutor(ss, client, BlockStore(MemDB()), device="cpu")
    top = jcs.block_store.height()
    for h in range(1, top + 1):
        bid = BlockID.from_proto_bytes(jcs.block_store.load_block_meta(h).block_id.to_proto_bytes())
        st = executor.apply_block(st, bid, Block.from_proto_bytes(jcs.block_store.load_block(h).to_proto_bytes()))
        want = jcs.block_exec.state_store.load().app_hash if h == top else jcs.block_store.load_block(h + 1).header.app_hash
        assert st.app_hash == want
        jcommit = jcs.block_store.load_block_commit(h) if h < top else jcs.block_store.load_seen_commit()
        verify_commit(jcons.CHAIN_ID, ss.load_validators(h), bid, h, Commit.from_proto_bytes(jcommit.to_proto_bytes()))


# --- the held divergence: a device error stops the node ------------------------


def late_proposal(P, tmp_path, arm):
    """A node of 16 validators commits height 1; at height 2 +2/3 of the
    others prevote and precommit block 2 before its proposal arrives, so
    the node enters the commit step without the block, and the block's
    first ``validate_block`` (``verify_commit`` of height 1's 16
    signatures) runs at finalize. ``arm(node)`` is called just before the
    proposal is delivered. Returns the node."""
    key_paths = scripted_keys(tmp_path, 16)
    genesis_json = scripted_genesis(key_paths)
    probe = ScriptedNode(P, tmp_path, genesis_json, key_paths, 0, "probe")
    pos = {probe.index_of[pv.get_pub_key().address()]: k for k, pv in enumerate(probe.pvs)}
    p1 = probe.index_of[probe.vset.get_proposer().address]
    p2 = probe.index_of[probe.cs.state.next_validators.get_proposer().address]
    subject = next(i for i in range(16) if i not in (p1, p2))
    wall = time.time_ns
    n = ScriptedNode(P, tmp_path, genesis_json, key_paths, pos[subject], "node", clock_ns=wall)
    shadow = ScriptedNode(P, tmp_path, genesis_json, key_paths, pos[p1], "shadow", clock_ns=wall)
    step = lambda h, s: _wait(lambda: n.cs.rs.height == h and int(n.cs.rs.step) == s, timeout=20)
    n.cs.start()
    assert step(1, 3)  # PROPOSE
    block1 = shadow.cs._create_proposal_block()
    parts1 = P.part_set.PartSet.from_data(block1.to_proto_bytes(), P.block.BLOCK_PART_SIZE_BYTES)
    bid1 = P.block.BlockID(block1.hash(), parts1.header())
    n.propose(p1, block1, parts1, 0)
    assert n.wait_vote(PV, 0).block_id == bid1
    n.inject(PV, 0, bid1)
    own = n.wait_vote(PC, 0)
    precommits = {v.validator_index: v for v in n.inject(PC, 0, bid1)}
    precommits[own.validator_index] = own
    assert wait_for_height([n.cs], 1)
    st2 = shadow.executor.apply_block(shadow.cs.state, bid1, block1)
    ext = P.block.ExtendedCommit(
        height=1, round=0, block_id=bid1,
        extended_signatures=[precommits[i].extended_commit_sig() for i in range(16)])
    block2 = shadow.executor.create_proposal_block(2, st2, ext, n.vset.validators[p2].address)
    parts2 = P.part_set.PartSet.from_data(block2.to_proto_bytes(), P.block.BLOCK_PART_SIZE_BYTES)
    bid2 = P.block.BlockID(block2.hash(), parts2.header())
    assert len(block2.last_commit.signatures) == 16
    assert step(2, 3)
    n.inject(PV, 0, bid2, height=2)
    n.inject(PC, 0, bid2, height=2)
    assert step(2, 8)  # COMMIT, without the block
    arm(n)
    n.propose(p2, block2, parts2, 0)
    return n


def test_a_device_error_at_finalize_stops_the_port_node_and_the_reference_stalls(tmp_path, monkeypatch):
    """Held divergence (ROADMAP §C): a DeviceFault injected into the
    chunk ``validate_block`` verifies at finalize stops the port's node
    with the fault, and ``stop()`` raises it; the reference's node, its
    ``validate_block`` patched to raise the same RuntimeError, stays at
    its height with no error."""
    from tendermint_tpu_torch.ops import ed25519_batch

    monkeypatch.setattr(device_policy, "shared", device_policy.DeviceHealth())
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()

    def arm_port(n):
        fault_injection.install(fault_injection.FaultPlan(site="ed25519.chunk", fail_calls={1}))

    try:
        n = late_proposal(PORT, tmp_path / "port", arm_port)
        assert _wait(lambda: n.cs.error is not None, timeout=30)
        plan = fault_injection.active()
    finally:
        fault_injection.uninstall()
    assert isinstance(n.cs.error, DeviceFault) and isinstance(n.cs.error, DEVICE_ERRORS)
    assert plan.faults_raised == 1 and ed25519_batch.CHUNK >= 16
    with pytest.raises(DeviceFault):
        n.cs.stop()
    assert n.cs.block_store.height() == 1
    assert device_policy.shared.snapshot()["failures"]["transient"] == 1

    def arm_jax(n):
        real = n.executor.validate_block

        def validate_block(state, block):
            if block.header.height == 2:
                raise RuntimeError("injected transient fault at ed25519.chunk call #1")
            return real(state, block)

        n.executor.validate_block = validate_block

    j = late_proposal(JAX, tmp_path / "jax", arm_jax)
    time.sleep(1.0)
    assert j.cs.block_store.height() == 1 and int(j.cs.rs.step) == 8
    assert j.cs._thread.is_alive()
    j.cs.stop()  # nothing to report: the reference dropped the error


def test_bad_blocks_still_draw_a_nil_prevote(tmp_path):
    """``InvalidBlockError`` and ``InvalidCommitError`` stay
    ``ValueError``\\ s: a block that fails ``validate_block`` draws a nil
    prevote and the node goes on, as in the reference."""
    from tendermint_tpu_torch.state.execution import InvalidBlockError
    from tendermint_tpu_torch.types.validation import InvalidCommitError

    assert issubclass(InvalidBlockError, ValueError) and issubclass(InvalidCommitError, ValueError)
    assert not issubclass(InvalidBlockError, DEVICE_ERRORS) and not issubclass(InvalidCommitError, DEVICE_ERRORS)
    h = LockHarness(tmp_path, subject_is_proposer=False)
    r0 = h.index_of[h.vset.get_proposer().address]
    block, parts = h.alternative_block(r0)
    block.header.app_hash = b"\x07" * 32  # a forged AppHash
    block._hash = None
    from tendermint_tpu_torch.types.block import BLOCK_PART_SIZE_BYTES
    from tendermint_tpu_torch.types.part_set import PartSet

    parts = PartSet.from_data(block.to_proto_bytes(), BLOCK_PART_SIZE_BYTES)
    h.cs.start()
    try:
        assert _wait(lambda: h.cs.rs.step >= 3, timeout=10)
        h.inject_proposal(r0, block, parts, round_=0)
        pv = _wait(lambda: _vote_of(h.cap, PV, 0))
        assert pv is not None and pv.block_id.is_nil()
        assert h.cs.rs.proposal_block is not None and h.cs.error is None
    finally:
        h.cs.stop()


# --- the slice whole -----------------------------------------------------------


def test_phase_15_at_20_validators_on_the_cpu(tmp_path, monkeypatch):
    """``chip_smoke.py`` phase 15 on the CPU: 20 validators (2 silent),
    7 heights (the third in round 1; the equivocation at 4, its evidence
    in 5, the unseen evidence in 6, the repeat at 7 in round 1), a
    restart and one more height, the spread 0; the store and the device
    hash forced on and the kernel wrappers counted, so the device tier's
    flushes reach the plain versions. Then the JAX package checks its
    chain: the blocks' txs give its kvstore app the same app hashes,
    each commit's 18 signatures pass the JAX ``Vote.verify`` one at a
    time, and the blocks' evidence decodes in the JAX package to the
    same hashes."""
    import chip_smoke as cs_mod
    from tendermint_tpu.crypto.keys import Ed25519PubKey as JEd25519PubKey
    from tendermint_tpu_torch.crypto import batch as crypto_batch, ed25519_ref
    from tendermint_tpu_torch.ops import cuda_hash, cuda_verify, hash512, precompute, resident

    for mod, names in ((cuda_verify, ("verify", "verify_tables", "verify_resident")), (cuda_hash, ("challenge",))):
        for name in names:
            real = getattr(mod, name)

            def counted(*a, _real=real, _mod=mod, _name=name, **k):
                _mod.LAUNCHES[_name] += 1
                return _real(*a, **k)

            monkeypatch.setattr(mod, name, counted)
    monkeypatch.setattr(hash512, "device_hash_enabled", lambda d: d is not None)
    monkeypatch.setattr(device_policy, "shared", device_policy.DeviceHealth())
    monkeypatch.setattr(crypto_batch, "_shared_scheduler", None)
    for name, value in (("CONSENSUS_VALIDATORS", 20), ("CONSENSUS_SILENT", 2), ("CONSENSUS_HEIGHTS", 7),
                        ("CONSENSUS_RESTART_HEIGHTS", 1), ("CONSENSUS_NIL_HEIGHT", 3), ("CONSENSUS_TXS", 20),
                        ("CONSENSUS_EQUIVOCATION_HEIGHT", 4), ("CONSENSUS_UNSEEN_HEIGHT", 6),
                        ("CONSENSUS_REPEAT_FROM", 7),
                        ("CONSENSUS_SPREAD_S", 0.0), ("CONSENSUS_SIGNERS", 2),
                        ("CONSENSUS_TIMEOUTS", TimeoutParams(propose=1.0, propose_delta=0.2, vote=0.3,
                                                             vote_delta=0.1, commit=0.1))):
        monkeypatch.setattr(cs_mod, name, value)
    keys = [ed25519_ref.keypair_from_seed(bytes([i + 40]) * 32) for i in range(20)]
    resident.configure("on")
    tiers = dict(crypto_batch.tier_lanes)
    try:
        counts, (genesis, state_store, block_store, harness) = cs_mod.phase_consensus(keys, torch.device("cpu"))
    finally:
        resident.configure(None)
        crypto_batch.shutdown_shared_scheduler()
        precompute.reset()
    assert crypto_batch.tier_lanes["device"] > tiers["device"]
    assert counts["verify_resident"] > 0 and counts["challenge"] > 0
    assert cs_mod.check_healthy("phase 15 on the CPU")
    top = block_store.height()
    assert top == 8 and [harness.committed[h]["round"] for h in range(1, 9)] == [0, 0, 1, 0, 0, 0, 1, 0]

    japp = JKVStoreApplication()
    japp.init_chain(jabci.RequestInitChain(chain_id=genesis.chain_id, initial_height=1))
    for h in range(1, top + 1):
        block = block_store.load_block(h)
        japp.finalize_block(jabci.RequestFinalizeBlock(hash=block.hash(), height=h, time=block.header.time,
                                                       txs=list(block.data.txs)))
        app_hash = japp.commit() and japp.info(jabci.RequestInfo()).last_block_app_hash
        want = state_store.load().app_hash if h == top else block_store.load_block(h + 1).header.app_hash
        assert app_hash == want
        assert [JBlock.from_proto_bytes(block.to_proto_bytes()).evidence_hash()] == [block.header.evidence_hash]
        assert len(block.evidence) == (1 if h in (5, 6) else 0)
        if h < top:
            jcommit = JCommit.from_proto_bytes(block_store.load_block_commit(h).to_proto_bytes())
            vset = state_store.load_validators(h)
            signed = [i for i, s in enumerate(jcommit.signatures) if not s.is_absent()]
            assert len(signed) == 18
            for i in signed:
                jcommit.get_vote(i).verify(genesis.chain_id, JEd25519PubKey(vset.validators[i].pub_key.bytes()))


def test_the_consensus_metrics_expose_as_the_jax_package_does():
    """``ConsensusMetrics``: the same families, help texts and labels."""
    from tendermint_tpu.libs.metrics import ConsensusMetrics as JConsensusMetrics, Registry as JRegistry
    from tendermint_tpu_torch.libs.metrics import ConsensusMetrics, Registry

    reg, jreg = Registry(), JRegistry()
    for m in (ConsensusMetrics(reg), JConsensusMetrics(jreg)):
        m.height.set(7)
        m.rounds.set(1)
        m.validators.set(150)
        m.missing_validators.set(15)
        m.block_interval_seconds.observe(1.75)
        m.num_txs.set(200)
        m.block_size_bytes.set(9800)
        m.total_txs.inc(200)
        m.wal_writes.inc(3)
        m.step_duration_seconds.labels(step="prevote").observe(0.02)
    assert reg.expose() == jreg.expose()

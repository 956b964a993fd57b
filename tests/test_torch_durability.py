"""Crash durability of the port's node: file stores, the ABCI handshake's
replay and rollback.

- The twin of ``tests/test_durability.py`` on ``tendermint_tpu_torch``:
  a single-validator node on ``db_backend="filedb"`` commits blocks, is
  stopped without its key (the crash), and a fresh ``Node`` on the same
  home replays the app and keeps committing; ``rollback_state`` rewinds
  one height and the restarted node commits it again; a torn or garbage
  WAL tail is cut on restart.
- Held to the JAX package: one genesis and one tx stream, built into
  each package's file stores, rolled back in each and reopened by each
  package's ``Node``, give the same block hashes and app hashes at every
  height, before the rollback and after the restart.
- The held divergence: a device error in the tip the restart re-applies
  (``apply_block`` verifies its LastCommit) fails the port's node, which
  raises it from its constructor with its stores closed.

Nodes run on ``device="cpu"``; the chains of the parity tests come from
``tests/test_torch_execution.py``'s seeded executors.
"""

import os

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from tendermint_tpu.abci.client import LocalClient as JLocalClient
from tendermint_tpu.abci.kvstore import KVStoreApplication as JKVStoreApplication
from tendermint_tpu.node.node import Node as JNode, NodeConfig as JNodeConfig
from tendermint_tpu.p2p.transport import MemoryNetwork as JMemoryNetwork
from tendermint_tpu.state.execution import BlockExecutor as JBlockExecutor
from tendermint_tpu.state.rollback import rollback_state as jrollback_state
from tendermint_tpu.state.store import StateStore as JStateStore
from tendermint_tpu.storage import open_db as jopen_db
from tendermint_tpu.storage.blockstore import BlockStore as JBlockStore
from tendermint_tpu.types import BlockID as JBlockID, ExtendedCommit as JExtendedCommit
from tendermint_tpu.types.genesis import GenesisDoc as JGenesisDoc, GenesisValidator as JGenesisValidator
from tendermint_tpu.types.part_set import PartSet as JPartSet
from tendermint_tpu.encoding.canonical import Timestamp as JTimestamp
from tendermint_tpu_torch.abci.client import LocalClient
from tendermint_tpu_torch.abci.kvstore import KVStoreApplication
from tendermint_tpu_torch.consensus.state import DEVICE_ERRORS
from tendermint_tpu_torch.crypto.keys import Ed25519PrivKey
from tendermint_tpu_torch.encoding.canonical import Timestamp
from tendermint_tpu_torch.node import Node, NodeConfig
from tendermint_tpu_torch.ops import device_policy, fault_injection, precompute
from tendermint_tpu_torch.ops.fault_injection import DeviceFault
from tendermint_tpu_torch.p2p.transport import MemoryNetwork
from tendermint_tpu_torch.privval import FilePV
from tendermint_tpu_torch.state.execution import BlockExecutor
from tendermint_tpu_torch.state.rollback import rollback_state
from tendermint_tpu_torch.state.store import StateStore
from tendermint_tpu_torch.storage import open_db
from tendermint_tpu_torch.storage.blockstore import BlockStore
from tendermint_tpu_torch.types.block import BlockID, ExtendedCommit
from tendermint_tpu_torch.types.genesis import GenesisDoc, GenesisValidator
from tendermint_tpu_torch.types.part_set import PartSet
from tests import helpers as jhelpers
from tests import test_execution as jexec
from tests.test_torch_execution import BASE_NS, CHAIN_ID, NEW_SEED, _step, make_chain_env, make_commit
from tests.test_torch_node import fast_genesis, port_node_env, wait_for  # noqa: F401 (fixture)

from tendermint_tpu.crypto.keys import Ed25519PrivKey as JEd25519PrivKey


def make_node(home):
    os.makedirs(home, exist_ok=True)
    pv = FilePV.load_or_generate(home + "/pk.json", home + "/ps.json")
    cfg = NodeConfig(chain_id="node-chain", home=home, blocksync=False, wal_enabled=True, db_backend="filedb",
                     moniker="dur0")
    app = KVStoreApplication()
    node = Node(cfg, fast_genesis([pv]), LocalClient(app), priv_validator=pv, device="cpu")
    return node, app


def _run_to_height(node, h, timeout=60):
    assert wait_for(lambda: node.height >= h, timeout=timeout), f"stuck at height {node.height}"


def _hard_stop(node):
    """Stop the threads with what already hit the disk (writes are
    fsynced a batch): the nearest an in-process test comes to kill -9."""
    node.consensus.priv_validator = None  # sign nothing further
    node.stop()


@pytest.fixture()
def home(tmp_path):
    return str(tmp_path / "node0")


class TestCrashRestart:
    def test_restart_replays_app_and_continues(self, port_node_env, home):
        node, app = make_node(home)
        node.start()
        try:
            node.submit_tx(b"k1=v1")
            _run_to_height(node, 3)
            h_before = node.height
        finally:
            _hard_stop(node)
        node2, app2 = make_node(home)
        try:
            assert node2.height >= h_before, "block store lost blocks"
            assert node2.sm_state.last_block_height >= h_before
            info = app2.info(None)
            assert info.last_block_height == node2.sm_state.last_block_height
            assert info.last_block_app_hash == node2.sm_state.app_hash
            assert node2.handshaker.n_blocks_replayed == node2.sm_state.last_block_height
            node2.start()
            _run_to_height(node2, h_before + 2)
        finally:
            _hard_stop(node2)

    def test_restart_twice_keeps_chain_contiguous(self, port_node_env, home):
        heights = []
        for _ in range(3):
            node, _ = make_node(home)
            node.start()
            try:
                _run_to_height(node, node.height + 2)
                heights.append(node.height)
            finally:
                _hard_stop(node)
        assert heights[0] < heights[1] < heights[2]
        node, _ = make_node(home)
        try:
            for h in range(1, heights[-1] + 1):
                assert node.block_store.load_block(h) is not None, h
        finally:
            _hard_stop(node)


class TestRollback:
    def test_rollback_state_one_height(self, port_node_env, home):
        node, _ = make_node(home)
        node.start()
        try:
            _run_to_height(node, 4)
        finally:
            _hard_stop(node)
        db_dir = home + "/data"
        state_store = StateStore(open_db("filedb", db_dir, "state"))
        block_store = BlockStore(open_db("filedb", db_dir, "blockstore"))
        s0 = state_store.load()
        h0 = s0.last_block_height
        tip_meta = block_store.load_block_meta(h0)
        new_h, new_hash = rollback_state(state_store, block_store, hard=True)
        assert new_h == h0 - 1
        assert new_hash == tip_meta.header.app_hash
        assert state_store.load().last_block_height == h0 - 1
        assert block_store.height() == h0 - 1
        state_store._db.close()
        block_store._db.close()
        node2, _ = make_node(home)
        node2.start()
        try:
            _run_to_height(node2, h0 + 1)
            assert node2.block_store.load_block(h0) is not None
        finally:
            _hard_stop(node2)

    def test_rollback_requires_progress(self):
        with pytest.raises(ValueError):
            rollback_state(StateStore(open_db("memdb")), BlockStore(open_db("memdb")))


class TestWALCorruption:
    def _wal_head(self, home):
        head = os.path.join(home, "cs.wal")
        assert os.path.exists(head), f"no WAL head at {head}"
        return head

    @pytest.mark.parametrize("tail", ["torn", "garbage"])
    def test_tail_truncated_on_restart(self, port_node_env, home, tail):
        node, _ = make_node(home)
        node.start()
        try:
            _run_to_height(node, 3)
            h_before = node.height
        finally:
            _hard_stop(node)
        with open(self._wal_head(home), "ab") as f:
            if tail == "torn":
                f.write(b"\x00\x00\x00\x09\x00\x00\x00\xff" + b"torn")  # a partial record
            else:
                f.write(os.urandom(512))  # bad CRC framing
        node2, _ = make_node(home)
        node2.start()
        try:
            _run_to_height(node2, h_before + 2)
        finally:
            _hard_stop(node2)


# --- held to the JAX package --------------------------------------------------------


def _clock():
    clock = {"ns": BASE_NS}

    def now():
        clock["ns"] += 1_000_000_000
        return clock["ns"]

    return clock, now


def _write_home(executor, home, opener):
    """Copy an executor's state and block stores into file stores under
    ``home/data``, as a node keeps them."""
    for name, src in (("state", executor.state_store._db), ("blockstore", executor.block_store._db)):
        db = opener("filedb", os.path.join(home, "data"), name)
        db.apply_batch([("set", k, v) for k, v in src.iterator()])
        db.close()


def build_chain_homes(tmp_path, n_heights, n_vals=4, which=("port", "jax")):
    """One seeded chain (``tests/test_torch_execution.py``'s tx stream, a
    validator joining at height 3) built by each package's executor and
    written into that package's file stores. Returns, by package, the
    home, the genesis, the states by height, the block hashes by height
    and the private keys by address."""
    out = {}
    for pkg in which:
        if pkg == "port":
            executor, state, privs, vset, _ = make_chain_env(n_vals)
            secret = {p.pub_key().address(): p for p in privs + [Ed25519PrivKey.from_seed(NEW_SEED)]}
            ec, sign, ps, bid = ExtendedCommit(), make_commit, PartSet, BlockID
            genesis = GenesisDoc(chain_id=CHAIN_ID, genesis_time=Timestamp.from_unix_ns(BASE_NS),
                                 validators=[GenesisValidator(v.pub_key, v.voting_power) for v in vset.validators])
            opener, wrap = open_db, ExtendedCommit.wrap_commit
        else:
            executor, state, privs, vset, _ = jexec.make_chain_env(n_vals)
            secret = {p.pub_key().address(): p for p in privs + [JEd25519PrivKey.from_seed(NEW_SEED)]}
            ec, sign, ps, bid = JExtendedCommit(), jhelpers.make_commit, JPartSet, JBlockID
            genesis = JGenesisDoc(chain_id=CHAIN_ID, genesis_time=JTimestamp.from_unix_ns(BASE_NS),
                                  validators=[JGenesisValidator(v.pub_key, v.voting_power) for v in vset.validators])
            opener, wrap = jopen_db, JExtendedCommit.wrap_commit
        states, hashes = {0: state}, {}
        for _ in range(n_heights):
            state, commit, block, _ = _step(executor, state, secret, ec, sign, ps, bid)
            ec = wrap(commit)
            states[state.last_block_height] = state
            hashes[state.last_block_height] = block.hash()
        home = str(tmp_path / pkg)
        _write_home(executor, home, opener)
        out[pkg] = {"home": home, "genesis": genesis, "states": states, "hashes": hashes, "secret": secret}
    return out


def _open_node(pkg, env, **cfg):
    """Each package's ``Node`` on its home: filedb stores, a fresh kvstore
    app (the handshake replays the stored blocks into it)."""
    if pkg == "port":
        return Node(NodeConfig(chain_id=CHAIN_ID, home=env["home"], db_backend="filedb", wal_enabled=False,
                               listen_addr="n", **cfg),
                    env["genesis"], LocalClient(KVStoreApplication()), memory_network=MemoryNetwork(), device="cpu")
    return JNode(JNodeConfig(chain_id=CHAIN_ID, home=env["home"], db_backend="filedb", wal_enabled=False,
                             listen_addr="n", **cfg),
                 env["genesis"], JLocalClient(JKVStoreApplication()), memory_network=JMemoryNetwork())


def _close(node):
    for db in list(node._dbs):
        db.close()
    node._dbs = []


def test_a_rolled_back_port_node_and_jax_node_give_the_same_hashes_at_every_height(port_node_env, tmp_path):
    envs = build_chain_homes(tmp_path, 6)
    port, jax = envs["port"], envs["jax"]
    for h in range(1, 7):
        assert port["hashes"][h] == jax["hashes"][h], h
        assert port["states"][h].app_hash == jax["states"][h].app_hash, h
    for pkg, roll, ss, bs, opener in (("port", rollback_state, StateStore, BlockStore, open_db),
                                      ("jax", jrollback_state, JStateStore, JBlockStore, jopen_db)):
        data = os.path.join(envs[pkg]["home"], "data")
        state_store, block_store = ss(opener("filedb", data, "state")), bs(opener("filedb", data, "blockstore"))
        assert roll(state_store, block_store) == (5, envs[pkg]["states"][5].app_hash)
        state_store._db.close()
        block_store._db.close()
    # each package's node reopens its home: InitChain, replay 1-4, and the
    # tip (6) the state trails re-applied through apply_block
    nodes = {pkg: _open_node(pkg, envs[pkg]) for pkg in envs}
    try:
        for pkg, node in nodes.items():
            assert node.sm_state.last_block_height == 6, pkg
            assert node.handshaker.n_blocks_replayed == 6 if pkg == "port" else True
        assert nodes["port"].sm_state.app_hash == nodes["jax"].sm_state.app_hash == port["states"][6].app_hash
        # two more heights on each package's reopened stores
        app_hashes = {}
        for pkg, node in nodes.items():
            env = envs[pkg]
            clock, now = _clock()
            clock["ns"] = BASE_NS + 6 * 1_000_000_000
            if pkg == "port":
                executor = BlockExecutor(node.state_store, node.app, node.block_store,
                                         now=lambda: Timestamp.from_unix_ns(now()), device="cpu")
                ec, sign, ps, bid = ExtendedCommit.wrap_commit(node.block_store.load_seen_commit()), make_commit, \
                    PartSet, BlockID
                wrap = ExtendedCommit.wrap_commit
            else:
                executor = JBlockExecutor(node.state_store, node.app, node.block_store,
                                          now=lambda: JTimestamp.from_unix_ns(now()))
                ec, sign, ps, bid = JExtendedCommit.wrap_commit(node.block_store.load_seen_commit()), \
                    jhelpers.make_commit, JPartSet, JBlockID
                wrap = JExtendedCommit.wrap_commit
            state = node.sm_state
            app_hashes[pkg] = [state.app_hash]
            for _ in range(2):
                state, commit, _, _ = _step(executor, state, env["secret"], ec, sign, ps, bid)
                ec = wrap(commit)
                app_hashes[pkg].append(state.app_hash)
        assert app_hashes["port"] == app_hashes["jax"]
        for h in range(1, 9):
            p = nodes["port"].block_store.load_block_meta(h)
            j = nodes["jax"].block_store.load_block_meta(h)
            assert p.block_id.hash == j.block_id.hash, h
            assert p.header.app_hash == j.header.app_hash, h
    finally:
        for node in nodes.values():
            _close(node)


def test_a_device_error_in_the_restarts_reapplied_tip_fails_the_port_node(port_node_env, tmp_path, monkeypatch):
    """The tip a rolled-back state trails goes through ``apply_block``,
    whose ``validate_block`` verifies the tip's LastCommit (16 lanes: the
    device tier). A DeviceFault there fails the port's node: the
    constructor raises it and closes the stores, so the home opens
    again."""
    monkeypatch.setattr(device_policy, "shared", device_policy.DeviceHealth())
    env = build_chain_homes(tmp_path, 3, n_vals=16, which=("port",))["port"]
    data = os.path.join(env["home"], "data")
    state_store, block_store = StateStore(open_db("filedb", data, "state")), BlockStore(open_db("filedb", data,
                                                                                              "blockstore"))
    rollback_state(state_store, block_store)
    state_store._db.close()
    block_store._db.close()
    precompute.results.clear()  # the build verified these lanes in this process
    fault_injection.install(fault_injection.FaultPlan(site="ed25519.chunk", fail_calls={1}))
    try:
        with pytest.raises(DeviceFault) as err:
            _open_node("port", env)
        plan = fault_injection.active()
    finally:
        fault_injection.uninstall()
    assert isinstance(err.value, DEVICE_ERRORS) and plan.faults_raised == 1
    node = _open_node("port", env)  # the stores were released; no fault now
    try:
        assert node.sm_state.last_block_height == 3
        assert node.sm_state.app_hash == env["states"][3].app_hash
    finally:
        _close(node)


def test_a_failed_handshake_frees_the_stores_for_a_retry_on_the_same_home(port_node_env, tmp_path):
    """A handshake that fails for a reason other than the device (an app
    ahead of the block store) also raises from the constructor with the
    stores' files and locks released: a second ``Node`` on the same home
    in the same process opens them and replays the chain."""
    from tendermint_tpu_torch.consensus.replay import HandshakeError

    env = build_chain_homes(tmp_path, 3, which=("port",))["port"]
    ahead = KVStoreApplication()
    ahead._height = 9  # ahead of the 3 stored blocks
    with pytest.raises(HandshakeError, match="ahead of block store"):
        Node(NodeConfig(chain_id=CHAIN_ID, home=env["home"], db_backend="filedb", wal_enabled=False, listen_addr="n"),
             env["genesis"], LocalClient(ahead), memory_network=MemoryNetwork(), device="cpu")
    node = _open_node("port", env)
    try:
        assert node.handshaker.n_blocks_replayed == 3
        assert node.sm_state.app_hash == env["states"][3].app_hash
    finally:
        _close(node)

"""State sync in the port: snapshots, the syncer's light walk and a
fresh node joining from a snapshot.

- The kvstore app's snapshots equal the JAX kvstore's (list, chunks and
  hash) over one seeded tx stream; a restore takes them; a corrupt chunk
  restarts the snapshot (the twin of ``tests/test_statesync.py``'s
  cases).
- The syncer's ``State``, built from three verified light blocks, equals
  the JAX syncer's on the same chain.
- A fresh port node joins from a port peer over the memory network and
  from a JAX peer over encrypted TCP: it restores the newest snapshot,
  never fetches a block below it, backfills verified headers, then
  block-syncs on.
- The held divergence: a device error in the light walk fails the port's
  node, where the reference's falls back to block sync from genesis.

The chains come from ``tests/test_torch_durability.py``'s
``build_chain_homes`` (``tests/test_torch_execution.py``'s seeded
executors, written into file stores); serving nodes reopen them, and
their handshake replays the blocks into an app that takes a snapshot
every ``SNAPSHOT_INTERVAL`` heights. Nodes run on ``device="cpu"``.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from tendermint_tpu.abci import types as jabci
from tendermint_tpu.abci.client import LocalClient as JLocalClient
from tendermint_tpu.abci.kvstore import KVStoreApplication as JKVStoreApplication
from tendermint_tpu.node.node import Node as JNode, NodeConfig as JNodeConfig
from tendermint_tpu.ops.fault_injection import DeviceFault as JDeviceFault
from tendermint_tpu.p2p.transport import MemoryNetwork as JMemoryNetwork
from tendermint_tpu.state.store import StateStore as JStateStore
from tendermint_tpu.statesync import StateSyncConfig as JStateSyncConfig
from tendermint_tpu.statesync import syncer as jsyncer_mod
from tendermint_tpu.storage import open_db as jopen_db
from tendermint_tpu.storage.blockstore import BlockStore as JBlockStore
from tendermint_tpu_torch.abci import types as abci
from tendermint_tpu_torch.abci.client import LocalClient
from tendermint_tpu_torch.abci.kvstore import KVStoreApplication
from tendermint_tpu_torch.node import Node, NodeConfig
from tendermint_tpu_torch.ops.fault_injection import DeviceFault
from tendermint_tpu_torch.p2p.transport import MemoryNetwork
from tendermint_tpu_torch.state.store import StateStore
from tendermint_tpu_torch.statesync import StateSyncConfig
from tendermint_tpu_torch.statesync import syncer as syncer_mod
from tendermint_tpu_torch.storage import open_db
from tendermint_tpu_torch.storage.blockstore import BlockStore
from tests.test_torch_durability import build_chain_homes
from tests.test_torch_execution import CHAIN_ID
from tests.test_torch_node import port_node_env, wait_for  # noqa: F401 (fixture)

SNAPSHOT_INTERVAL = 4
HEIGHTS = 14  # snapshots at 4, 8, 12; the light walk to 12 needs 13 and 14
TRUST_PERIOD_S = 10 * 365 * 86400.0  # the chains' genesis time is in 2023


# --- snapshots ------------------------------------------------------------------


def _drive(app, module, heights, seed=5):
    """One seeded tx stream, a few heights of it, committed."""
    rng = np.random.default_rng(seed)
    for h in range(1, heights + 1):
        txs = [b"acct-%03d=%s" % (int(a), rng.bytes(24).hex().encode()) for a in rng.integers(0, 300, 40)]
        app.finalize_block(module.RequestFinalizeBlock(height=h, txs=txs))
        app.commit()


def test_snapshots_equal_the_jax_kvstores():
    app, japp = KVStoreApplication(snapshot_interval=2), JKVStoreApplication(snapshot_interval=2)
    _drive(app, abci, 7)
    _drive(japp, jabci, 7)
    snaps = app.list_snapshots(abci.RequestListSnapshots()).snapshots
    jsnaps = japp.list_snapshots(jabci.RequestListSnapshots()).snapshots
    assert [s.height for s in snaps] == [2, 4, 6]  # three kept
    assert [(s.height, s.format, s.chunks, s.hash, s.metadata) for s in snaps] == \
        [(s.height, s.format, s.chunks, s.hash, s.metadata) for s in jsnaps]
    assert snaps[-1].chunks >= 2
    for s in snaps:
        for i in range(s.chunks + 1):  # one past the end too
            got = app.load_snapshot_chunk(abci.RequestLoadSnapshotChunk(height=s.height, format=1, chunk=i)).chunk
            want = japp.load_snapshot_chunk(jabci.RequestLoadSnapshotChunk(height=s.height, format=1, chunk=i)).chunk
            assert got == want and bool(got) == (i < s.chunks)
    # a port app restores from the JAX app's chunks
    at6 = KVStoreApplication()
    _drive(at6, abci, 6)
    fresh = KVStoreApplication()
    s = jsnaps[-1]
    assert fresh.offer_snapshot(abci.RequestOfferSnapshot(
        snapshot=abci.Snapshot(s.height, s.format, s.chunks, s.hash), app_hash=at6._app_hash,
    )).result == abci.OFFER_SNAPSHOT_ACCEPT
    for i in range(s.chunks):
        chunk = japp.load_snapshot_chunk(jabci.RequestLoadSnapshotChunk(height=s.height, format=1, chunk=i)).chunk
        r = fresh.apply_snapshot_chunk(abci.RequestApplySnapshotChunk(index=i, chunk=chunk))
        assert r.result == abci.APPLY_CHUNK_ACCEPT
    assert fresh._height == 6 and fresh._app_hash == at6._app_hash != japp._app_hash  # japp went on to 7


def test_snapshot_take_list_load_restore():
    app = KVStoreApplication(snapshot_interval=2)
    app.finalize_block(abci.RequestFinalizeBlock(height=1, txs=[b"k1=v1"]))
    app.commit()
    app.finalize_block(abci.RequestFinalizeBlock(height=2, txs=[b"k2=" + b"v2" * 3000]))
    app.commit()  # forces multiple chunks
    snaps = app.list_snapshots(None).snapshots
    assert [s.height for s in snaps] == [2]
    snap = snaps[0]
    assert snap.chunks >= 2
    chunks = [app.load_snapshot_chunk(abci.RequestLoadSnapshotChunk(height=2, format=1, chunk=i)).chunk
              for i in range(snap.chunks)]
    assert all(chunks)
    fresh = KVStoreApplication()
    res = fresh.offer_snapshot(abci.RequestOfferSnapshot(snapshot=snap, app_hash=app._app_hash))
    assert res.result == abci.OFFER_SNAPSHOT_ACCEPT
    for i, c in enumerate(chunks):
        r = fresh.apply_snapshot_chunk(abci.RequestApplySnapshotChunk(index=i, chunk=c))
        assert r.result == abci.APPLY_CHUNK_ACCEPT
    assert fresh._height == 2
    assert fresh._app_hash == app._app_hash
    assert fresh._db.get(b"k2") == b"v2" * 3000


def test_corrupt_chunk_restarts_snapshot():
    app = KVStoreApplication(snapshot_interval=1)
    app.finalize_block(abci.RequestFinalizeBlock(height=1, txs=[b"k=" + b"v" * 9000]))
    app.commit()
    snap = app.list_snapshots(None).snapshots[0]
    chunks = [app.load_snapshot_chunk(abci.RequestLoadSnapshotChunk(height=1, format=1, chunk=i)).chunk
              for i in range(snap.chunks)]
    fresh = KVStoreApplication()
    fresh.offer_snapshot(abci.RequestOfferSnapshot(snapshot=snap, app_hash=app._app_hash))
    bad = b"\x00" * len(chunks[0])
    fresh.apply_snapshot_chunk(abci.RequestApplySnapshotChunk(index=0, chunk=bad))
    for i, c in enumerate(chunks[1:], start=1):
        r = fresh.apply_snapshot_chunk(abci.RequestApplySnapshotChunk(index=i, chunk=c))
    assert r.result == abci.APPLY_CHUNK_RETRY_SNAPSHOT
    for i, c in enumerate(chunks):
        r = fresh.apply_snapshot_chunk(abci.RequestApplySnapshotChunk(index=i, chunk=c))
    assert r.result == abci.APPLY_CHUNK_ACCEPT
    assert fresh._height == 1


# --- the state provider -----------------------------------------------------------


class _StoreServed:
    """The syncer's fetchers answered from a chain's stores, as a peer's
    reactor would serve them."""

    def __init__(self, syncer, reactor_cls, state_store, block_store):
        server = reactor_cls.__new__(reactor_cls)
        server.block_store, server.state_store = block_store, state_store
        syncer._fetch_light_block = server._serve_light_block
        syncer._fetch_params = state_store.load_consensus_params


def test_the_syncers_state_equals_the_jax_syncers(port_node_env, tmp_path):
    from tendermint_tpu.statesync.reactor import StateSyncReactor as JReactor
    from tendermint_tpu_torch.statesync.reactor import StateSyncReactor

    envs = build_chain_homes(tmp_path, HEIGHTS)
    built = {}
    stores = []
    for pkg, opener, ss, bs, mod, cfg_cls, reactor_cls in (
        ("port", open_db, StateStore, BlockStore, syncer_mod, StateSyncConfig, StateSyncReactor),
        ("jax", jopen_db, JStateStore, JBlockStore, jsyncer_mod, JStateSyncConfig, JReactor),
    ):
        data = os.path.join(envs[pkg]["home"], "data")
        state_store, block_store = ss(opener("filedb", data, "state")), bs(opener("filedb", data, "blockstore"))
        stores += [state_store, block_store]
        cfg = cfg_cls(enabled=True, trust_height=1, trust_hash=block_store.load_block_meta(1).header.hash(),
                      trust_period=TRUST_PERIOD_S)
        kwargs = {"device": "cpu"} if pkg == "port" else {}
        syncer = mod.StateSyncer(None, None, state_store, block_store, envs[pkg]["genesis"], cfg, **kwargs)
        _StoreServed(syncer, reactor_cls, state_store, block_store)
        snap = (abci if pkg == "port" else jabci).Snapshot(height=12, format=1, chunks=1, hash=b"x")
        state, base = syncer._build_state(snap)
        built[pkg] = (state, base)
    try:
        (s, b), (js, jb) = built["port"], built["jax"]
        assert b.signed_header.header.hash() == jb.signed_header.header.hash()
        assert s.last_block_height == js.last_block_height == 12
        assert s.last_block_id.hash == js.last_block_id.hash
        assert s.last_block_time.to_unix_ns() == js.last_block_time.to_unix_ns()
        assert s.app_hash == js.app_hash == envs["port"]["states"][12].app_hash
        assert s.last_results_hash == js.last_results_hash
        for name in ("last_validators", "validators", "next_validators"):
            assert getattr(s, name).hash() == getattr(js, name).hash(), name
        assert s.last_height_validators_changed == js.last_height_validators_changed == 13
        assert s.consensus_params.hash() == js.consensus_params.hash()
        assert (s.version.block, s.version.app) == (js.version.block, js.version.app)
    finally:
        for st in stores:
            st._db.close()


# --- a fresh node joins ------------------------------------------------------------------


def _serving_port_node(env, net):
    return Node(NodeConfig(chain_id=CHAIN_ID, home=env["home"], db_backend="filedb", wal_enabled=False,
                           blocksync=False, listen_addr="server" if net is not None else "127.0.0.1:0",
                           moniker="server"),
                env["genesis"], LocalClient(KVStoreApplication(snapshot_interval=SNAPSHOT_INTERVAL)),
                memory_network=net, device="cpu")


def _sync_config(cls, trust_hash, **kw):
    return cls(enabled=True, trust_height=1, trust_hash=trust_hash, trust_period=TRUST_PERIOD_S,
               discovery_time=0.5, backfill_blocks=2, light_block_timeout=5.0, chunk_timeout=5.0, **kw)


def _port_joiner(tmp_path, env, peer, net, trust_hash):
    app = KVStoreApplication()
    node = Node(NodeConfig(chain_id=CHAIN_ID, home=str(tmp_path / "joiner"), db_backend="filedb-c", wal_enabled=False,
                           listen_addr="joiner" if net is not None else "127.0.0.1:0", persistent_peers=[peer],
                           moniker="joiner", statesync=_sync_config(StateSyncConfig, trust_hash)),
                env["genesis"], LocalClient(app), memory_network=net, device="cpu")
    return node, app


def _check_joined(node, app, want_app_hash, tip=HEIGHTS):
    assert wait_for(lambda: node.failed is not None or node.sm_state.last_block_height >= 12, timeout=60), \
        f"state sync never completed: {node.statesync_error!r}"
    assert node.failed is None and node.statesync_error is None
    snap_height = node.sm_state.last_block_height
    assert snap_height == 12  # the newest snapshot
    assert node.block_store.load_block(1) is None and node.block_store.load_block(snap_height) is None
    assert sorted(node.statesyncer.backfilled) == [snap_height - 2, snap_height - 1]
    assert wait_for(lambda: node.height >= tip - 1, timeout=60), f"stuck at {node.height}"
    assert node.block_store.load_block(snap_height + 1) is not None
    assert app.info(None).last_block_height >= snap_height + 1
    assert app._height == tip - 1 and app._app_hash == want_app_hash
    assert node.failed is None


def test_a_fresh_port_node_joins_from_port_peers(port_node_env, tmp_path):
    env = build_chain_homes(tmp_path, HEIGHTS, which=("port",))["port"]
    net = MemoryNetwork()
    server = _serving_port_node(env, net)
    assert server.handshaker.n_blocks_replayed == HEIGHTS
    server.start()
    joiner = None
    try:
        trust_hash = server.block_store.load_block_meta(1).header.hash()
        joiner, app = _port_joiner(tmp_path, env, f"{server.node_key.node_id}@server", net, trust_hash)
        assert joiner.statesyncer is not None and joiner.statesyncer.device == torch.device("cpu")
        joiner.start()
        _check_joined(joiner, app, env["states"][HEIGHTS - 1].app_hash)
    finally:
        server.stop()
        if joiner is not None:
            joiner.stop()


def test_a_jax_node_serves_a_port_joiner(port_node_env, tmp_path):
    """A JAX node on its own file stores serves snapshots, chunks, light
    blocks, params and blocks over encrypted TCP; the port's node joins
    from it."""
    env = build_chain_homes(tmp_path, HEIGHTS)
    jenv = env["jax"]
    server = JNode(JNodeConfig(chain_id=CHAIN_ID, home=jenv["home"], db_backend="filedb", wal_enabled=False,
                               blocksync=False, listen_addr="127.0.0.1:0", moniker="jserver"),
                   jenv["genesis"], JLocalClient(JKVStoreApplication(snapshot_interval=SNAPSHOT_INTERVAL)))
    server.start()
    joiner = None
    try:
        peer = f"{server.node_key.node_id}@{server.transport.listen_addr}"
        trust_hash = server.block_store.load_block_meta(1).header.hash()
        joiner, app = _port_joiner(tmp_path, env["port"], peer, None, trust_hash)
        joiner.start()
        _check_joined(joiner, app, env["port"]["states"][HEIGHTS - 1].app_hash)
    finally:
        server.stop()
        if joiner is not None:
            joiner.stop()


def test_a_device_error_in_the_light_walk_fails_the_port_node_where_the_reference_block_syncs_from_genesis(
        port_node_env, tmp_path, monkeypatch):
    envs = build_chain_homes(tmp_path, HEIGHTS)

    # the reference: the fault escapes sync(), and its node block-syncs
    # from genesis instead
    jfault = JDeviceFault("injected light-walk fault")

    def jfaulty_verify(*args, **kwargs):
        raise jfault

    monkeypatch.setattr(jsyncer_mod.light_verifier, "verify", jfaulty_verify)
    jnet = JMemoryNetwork()
    jenv = envs["jax"]
    jserver = JNode(JNodeConfig(chain_id=CHAIN_ID, home=jenv["home"], db_backend="filedb", wal_enabled=False,
                                blocksync=False, listen_addr="server", moniker="server"),
                    jenv["genesis"], JLocalClient(JKVStoreApplication(snapshot_interval=SNAPSHOT_INTERVAL)),
                    memory_network=jnet)
    jserver.start()
    jjoiner = None
    try:
        trust_hash = jserver.block_store.load_block_meta(1).header.hash()
        jjoiner = JNode(JNodeConfig(chain_id=CHAIN_ID, wal_enabled=False, listen_addr="joiner",
                                    persistent_peers=[f"{jserver.node_key.node_id}@server"],
                                    statesync=_sync_config(JStateSyncConfig, trust_hash)),
                        jenv["genesis"], JLocalClient(JKVStoreApplication()), memory_network=jnet)
        jjoiner.start()
        assert wait_for(lambda: jjoiner.height >= HEIGHTS - 1, timeout=60), jjoiner.height
        assert jjoiner.statesync_error is jfault and jjoiner.failed is None
        assert jjoiner.block_store.load_block(1) is not None  # from genesis
    finally:
        jserver.stop()
        if jjoiner is not None:
            jjoiner.stop()

    # the port: the node fails with the fault, and stop() raises it
    fault = DeviceFault("injected light-walk fault")

    def faulty_verify(*args, **kwargs):
        raise fault

    monkeypatch.setattr(syncer_mod.light_verifier, "verify", faulty_verify)
    env = envs["port"]
    net = MemoryNetwork()
    server = _serving_port_node(env, net)
    server.start()
    try:
        joiner, _ = _port_joiner(tmp_path, env, f"{server.node_key.node_id}@server", net,
                                 server.block_store.load_block_meta(1).header.hash())
        joiner.start()
        assert wait_for(lambda: joiner.failed is not None, timeout=30)
        assert joiner.failed is fault and joiner.statesync_error is fault
        assert joiner.height == 0 and not joiner.caught_up  # no block sync from genesis
        with pytest.raises(DeviceFault, match="light-walk"):
            joiner.stop()
    finally:
        server.stop()


def test_a_device_error_in_a_statesync_handler_fails_the_port_node_where_the_reference_drops_it(
        port_node_env, tmp_path):
    """The reference's statesync reactor drops every exception of a
    handler (``statesync/reactor.py:147-153``); the port's drops
    malformed peer input as before, but a device error stops the reactor
    and fails the node."""
    from tendermint_tpu.node.node import Node as JN
    from tendermint_tpu.p2p.router import Envelope as JEnvelope
    from tendermint_tpu.statesync import reactor as jreactor
    from tendermint_tpu_torch.p2p.router import Envelope
    from tendermint_tpu_torch.privval import FilePV
    from tendermint_tpu_torch.statesync import reactor as treactor
    from tests.test_torch_node import make_node

    calls = []

    def jfaulty(peer, snapshot):
        calls.append(snapshot)
        raise JDeviceFault("injected")

    jnode = JN(JNodeConfig(chain_id=CHAIN_ID, listen_addr="j", wal_enabled=False, blocksync=False),
               build_chain_homes(tmp_path, 1, which=("jax",))["jax"]["genesis"],
               JLocalClient(JKVStoreApplication()), memory_network=JMemoryNetwork())
    jr = jnode.statesync_reactor
    jr.on_snapshot = jfaulty
    jr.start()
    try:
        msg = jreactor.encode_snapshots_response(jabci.Snapshot(1, 1, 1, b"h"))
        for _ in range(2):
            jr.snapshot_ch.in_queue.put(JEnvelope(jreactor.SNAPSHOT_CHANNEL, msg, from_peer="p"))
        assert wait_for(lambda: len(calls) == 2, timeout=5)
        assert all(t.is_alive() for t in jr._threads) and not hasattr(jr, "error")
    finally:
        jr.stop()

    pv = FilePV.generate(str(tmp_path / "k.json"), str(tmp_path / "s.json"))
    node, _ = make_node("ss", [pv], index=0, net=MemoryNetwork(), blocksync=False)
    fault = DeviceFault("injected statesync fault")
    dropped = []

    def faulty(peer, snapshot):
        if snapshot.height == 1:
            dropped.append(snapshot)
            raise ValueError("a malformed offer")  # dropped, as the reference drops it
        raise fault

    node.statesync_reactor.on_snapshot = faulty
    node.start()
    ch = node.statesync_reactor.snapshot_ch
    for height in (1, 2):
        msg = treactor.encode_snapshots_response(abci.Snapshot(height, 1, 1, b"h"))
        ch.in_queue.put(Envelope(treactor.SNAPSHOT_CHANNEL, msg, from_peer="p"))
    assert wait_for(lambda: node.failed is not None, timeout=5)
    assert len(dropped) == 1 and node.failed is fault and node.statesync_reactor.error is fault
    with pytest.raises(DeviceFault, match="injected statesync fault"):
        node.stop()

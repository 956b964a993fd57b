"""The port's node: full stacks forming a network.

- The twin of ``tests/test_node.py`` on ``tendermint_tpu_torch.node``:
  four validators on the memory network commit blocks and gossip a tx,
  PEX spreads the addresses; a late non-validator block-syncs in; two
  validators commit over encrypted TCP.
- ``NodeConfig``'s fields are the reference's less exactly the fields of
  the features the port has not yet (ROADMAP §A item 10); a
  memory-network node with ``rpc_laddr`` answers ``status``, ``commit``
  and ``tx_search`` from its index.
- The held divergences: a device error that the reference's evidence
  reactor, block-sync thread or ``Node.stop`` hides ends, in the port,
  in ``Node.failed`` and is raised by ``Node.stop()``.

The port's nodes run on ``device="cpu"`` with a fresh shared scheduler;
the process-wide sinks a node installs (the tracer's metrics observer
and profile sink, the ops metrics) are put back after each test.
"""

import dataclasses
import threading
import time
import types

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import tendermint_tpu_torch
from tendermint_tpu.blocksync import syncer as jsyncer_mod
from tendermint_tpu.evidence import reactor as jev_reactor
from tendermint_tpu.node.node import Node as JNode, NodeConfig as JNodeConfig
from tendermint_tpu.ops.fault_injection import DeviceFault as JDeviceFault
from tendermint_tpu.p2p.key import NodeKey as JNodeKey
from tendermint_tpu.p2p.peermanager import PeerManager as JPeerManager
from tendermint_tpu.p2p.router import Envelope as JEnvelope, Router as JRouter
from tendermint_tpu.p2p.transport import MemoryNetwork as JMemoryNetwork, NodeInfo as JNodeInfo
from tendermint_tpu_torch import ops as tops
from tendermint_tpu_torch.abci import types as abci
from tendermint_tpu_torch.abci.client import LocalClient
from tendermint_tpu_torch.abci.kvstore import KVStoreApplication
from tendermint_tpu_torch.crypto import batch as crypto_batch
from tendermint_tpu_torch.encoding.canonical import Timestamp
from tendermint_tpu_torch.evidence import reactor as ev_reactor
from tendermint_tpu_torch.libs import tracing
from tendermint_tpu_torch.node import Node, NodeConfig
from tendermint_tpu_torch.ops import introspect
from tendermint_tpu_torch.ops.fault_injection import DeviceFault
from tendermint_tpu_torch.p2p.router import Envelope
from tendermint_tpu_torch.p2p.transport import MemoryNetwork
from tendermint_tpu_torch.privval import FilePV
from tendermint_tpu_torch.types.genesis import GenesisDoc, GenesisValidator
from tendermint_tpu_torch.types.params import ConsensusParams, TimeoutParams

CHAIN = "node-chain"
BASE_NS = 1_700_000_000_000_000_000

# The reference's fields the port leaves out, by the item that brings
# each (NodeConfig's docstring).
CUT_FIELDS = {
    "mesh_devices": "10",
}


@pytest.fixture
def port_node_env(monkeypatch):
    """CPU nodes on a fresh shared scheduler; the sinks a node installs
    are put back after."""
    monkeypatch.setattr(tendermint_tpu_torch, "DEFAULT_DEVICE", "cpu")
    monkeypatch.setattr(crypto_batch, "_shared_scheduler", None)
    saved = (tracing.tracer._observer, tracing.tracer._profile, introspect.profiler._enabled)
    yield
    crypto_batch.shutdown_shared_scheduler()
    observer, profile, enabled = saved
    introspect.profiler._enabled = enabled
    tracing.tracer.set_metrics_observer(observer)
    tracing.tracer.set_profile_sink(profile)
    tops.bind_metrics(None)


def fast_genesis(privs, chain=CHAIN):
    params = ConsensusParams()
    params.timeout = TimeoutParams(propose=0.6, propose_delta=0.2, vote=0.3, vote_delta=0.1, commit=0.1)
    return GenesisDoc(
        chain_id=chain,
        genesis_time=Timestamp.from_unix_ns(BASE_NS),
        consensus_params=params,
        validators=[GenesisValidator(pub_key=pv.get_pub_key(), power=10) for pv in privs],
    )


def make_node(name, privs, index=None, net=None, blocksync=True, persistent_peers=()):
    app = KVStoreApplication()
    cfg = NodeConfig(
        chain_id=CHAIN,
        listen_addr=name if net is not None else "127.0.0.1:0",
        blocksync=blocksync,
        wal_enabled=False,
        persistent_peers=list(persistent_peers),
        moniker=name,
    )
    node = Node(
        cfg,
        fast_genesis(privs),
        LocalClient(app),
        priv_validator=privs[index] if index is not None else None,
        memory_network=net,
        device="cpu",
    )
    return node, app


def wait_for(fn, timeout=60.0, interval=0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if fn():
            return True
        time.sleep(interval)
    return False


@pytest.fixture()
def four_privs(tmp_path):
    return [FilePV.generate(str(tmp_path / f"pk{i}.json"), str(tmp_path / f"ps{i}.json")) for i in range(4)]


class TestMemoryNetworkCluster:
    def test_four_validators_commit_and_gossip_tx(self, port_node_env, four_privs):
        net = MemoryNetwork()
        nodes, apps = [], []
        for i in range(4):
            node, app = make_node(f"node{i}", four_privs, index=i, net=net)
            nodes.append(node)
            apps.append(app)
        for node in nodes[1:]:
            node.config.persistent_peers = [f"{nodes[0].node_key.node_id}@node0"]
        for node in nodes:
            node.start()
        try:
            assert wait_for(lambda: all(len(n.router.connected_peers()) >= 1 for n in nodes), timeout=10)
            assert wait_for(lambda: all(n.height >= 2 for n in nodes), timeout=90), [n.height for n in nodes]
            # A tx submitted at node 3 gossips to the proposer and commits.
            nodes[3].submit_tx(b"color=indigo")
            assert wait_for(
                lambda: all(a.query(abci.RequestQuery(data=b"color")).value == b"indigo" for a in apps),
                timeout=90,
            ), "tx failed to commit on all nodes"
            # PEX spread the addresses: a later node knows more than the seed.
            assert wait_for(lambda: len(nodes[3].peer_manager.connected_peers()) >= 2, timeout=30)
            assert all(n.failed is None for n in nodes)
        finally:
            for node in nodes:
                node.stop()

    def test_late_joiner_blocksyncs(self, port_node_env, four_privs):
        net = MemoryNetwork()
        nodes = []
        for i in range(3):
            node, _ = make_node(f"v{i}", four_privs, index=i, net=net)
            if i > 0:
                node.config.persistent_peers = [f"{nodes[0].node_key.node_id}@v0"]
            nodes.append(node)
        for node in nodes:
            node.start()
        try:
            assert wait_for(lambda: all(n.height >= 3 for n in nodes), timeout=90)
            # A non-validator observer joins late and block-syncs.
            observer, _ = make_node(
                "observer", four_privs, net=net, persistent_peers=[f"{nodes[0].node_key.node_id}@v0"]
            )
            observer.start()
            target = max(n.height for n in nodes)
            assert wait_for(lambda: observer.height >= target, timeout=90), (observer.height, target)
            # The height can reach the target through block sync before the
            # switch: the syncer switches once it is level with its tallest
            # peer, and the validators keep committing meanwhile. So wait
            # for the switch itself, within the same bound.
            assert wait_for(lambda: observer.caught_up or observer.failed is not None, timeout=90), (
                observer.height, max(n.height for n in nodes))
            assert observer.caught_up and observer.failed is None
            for h in range(1, target + 1):
                want = nodes[0].block_store.load_block_meta(h).block_id
                assert observer.block_store.load_block_meta(h).block_id == want
            observer.stop()
        finally:
            for node in nodes:
                node.stop()


    def test_a_node_answers_status_commit_and_tx_search_over_rpc(self, port_node_env, four_privs):
        """A memory-network validator with ``rpc_laddr`` and the default
        ``tx_index`` serves its chain and its index over HTTP."""
        from tendermint_tpu_torch.libs.pubsub import Query
        from tendermint_tpu_torch.rpc.client import HTTPClient

        assert NodeConfig().tx_index and NodeConfig().tx_index_sinks == ["kv"] and not NodeConfig().rpc_laddr
        cfg = NodeConfig(chain_id=CHAIN, listen_addr="rpc0", wal_enabled=False, blocksync=False,
                         rpc_laddr="127.0.0.1:0")
        node = Node(cfg, fast_genesis(four_privs[:1]), LocalClient(KVStoreApplication()),
                    priv_validator=four_privs[0], memory_network=MemoryNetwork(), device="cpu")
        node.start()
        try:
            client = HTTPClient(node.rpc_server.url)
            node.submit_tx(b"rpc=node")
            assert wait_for(lambda: node.indexer.search_tx_keys(Query.parse("app.key = 'rpc'")), timeout=60)
            st = client.status()
            assert st["node_info"]["id"] == node.node_key.node_id and int(st["sync_info"]["latest_block_height"]) >= 1
            found = client.tx_search("app.key = 'rpc'")
            height = int(found["txs"][0]["height"])
            assert found["total_count"] == "1" and found["txs"][0]["tx"] == "cnBjPW5vZGU="
            commit = client.commit(height)["signed_header"]
            assert commit["header"]["height"] == str(height)
            assert commit["commit"]["block_id"]["hash"] == node.block_store.load_block_meta(height).block_id.hash.hex().upper()
            assert node.failed is None
        finally:
            node.stop()
        assert node.rpc_server._thread is None


class TestTCPCluster:
    def test_two_validators_over_tcp(self, port_node_env, tmp_path):
        privs = [FilePV.generate(str(tmp_path / f"k{i}.json"), str(tmp_path / f"s{i}.json")) for i in range(2)]
        node0, app0 = make_node("tcp0", privs, index=0)
        node0.start()
        node1, app1 = make_node(
            "tcp1", privs, index=1, persistent_peers=[f"{node0.node_key.node_id}@{node0.node_info.listen_addr}"]
        )
        node1.start()
        try:
            assert wait_for(lambda: node0.height >= 2 and node1.height >= 2, timeout=90), (node0.height, node1.height)
            node1.submit_tx(b"transport=tcp")
            assert wait_for(
                lambda: app0.query(abci.RequestQuery(data=b"transport")).value == b"tcp", timeout=90
            )
        finally:
            node1.stop()
            node0.stop()


def test_node_config_is_the_references_less_the_cut_features():
    ref = {f.name for f in dataclasses.fields(JNodeConfig)}
    port = {f.name for f in dataclasses.fields(NodeConfig)}
    assert port == ref - set(CUT_FIELDS)
    assert set(CUT_FIELDS) <= ref
    doc = " ".join(NodeConfig.__doc__.split())
    for name, item in CUT_FIELDS.items():
        assert f"``{name}``" in doc and f"item {item}" in doc, (name, item)
    # what it cannot serve, it refuses: a file store without a home, a
    # backend it does not know
    for backend, match in (("filedb", "requires a db_dir"), ("rocksdb", "unknown db backend")):
        with pytest.raises(ValueError, match=match):
            Node(NodeConfig(db_backend=backend), fast_genesis([]), LocalClient(KVStoreApplication()), device="cpu")


# --- the held divergences ------------------------------------------------------


def _single_node(tmp_path, name, blocksync):
    pv = FilePV.generate(str(tmp_path / f"{name}k.json"), str(tmp_path / f"{name}s.json"))
    node, _ = make_node(name, [pv], index=0, net=MemoryNetwork(), blocksync=blocksync)
    return node


def test_a_device_error_in_the_evidence_reactor_fails_the_node(port_node_env, monkeypatch, tmp_path):
    """The reference's evidence reactor drops a device error of the
    pool's verification and goes on; the port's keeps it in
    ``Node.failed``, stops, and ``Node.stop()`` raises it."""
    # The reference: its loop survives the fault and records nothing.
    class FaultyPool:
        calls = 0

        def is_pending(self, ev):
            return False

        def is_committed(self, ev):
            return False

        def add_evidence(self, ev):
            FaultyPool.calls += 1
            raise JDeviceFault("injected")

    monkeypatch.setattr(jev_reactor, "evidence_from_proto_bytes", lambda raw: object())
    nk = JNodeKey.generate()
    jrouter = JRouter(JNodeInfo(nk.node_id, CHAIN), JPeerManager(nk.node_id), JMemoryNetwork().transport("j"))
    jr = jev_reactor.EvidenceReactor(FaultyPool(), jrouter)
    jr.start()
    try:
        for _ in range(2):
            jr.channel.in_queue.put(JEnvelope(jev_reactor.EVIDENCE_CHANNEL, b"ev", from_peer="p"))
        assert wait_for(lambda: FaultyPool.calls == 2, timeout=5)
        assert jr._thread.is_alive() and not hasattr(jr, "error")
    finally:
        jr.stop()

    # The port: the node fails with the fault, and stop() raises it.
    node = _single_node(tmp_path, "ev", blocksync=False)
    fault = DeviceFault("injected evidence fault")

    def faulty_add(ev):
        raise fault

    monkeypatch.setattr(ev_reactor, "evidence_from_proto_bytes", lambda raw: object())
    monkeypatch.setattr(node.evidence_pool, "is_pending", lambda ev: False)
    monkeypatch.setattr(node.evidence_pool, "is_committed", lambda ev: False)
    monkeypatch.setattr(node.evidence_pool, "add_evidence", faulty_add)
    node.start()
    node.evidence_reactor.channel.in_queue.put(Envelope(ev_reactor.EVIDENCE_CHANNEL, b"ev", from_peer="p"))
    assert wait_for(lambda: node.failed is not None, timeout=5)
    assert node.failed is fault and node.evidence_reactor.error is fault
    assert wait_for(lambda: not node.evidence_reactor._thread.is_alive(), timeout=5)
    with pytest.raises(DeviceFault, match="injected evidence fault"):
        node.stop()
    assert node.router.connected_peers() == [] and not node.consensus_reactor._threads


def test_a_device_error_in_the_block_sync_thread_fails_the_node(port_node_env, tmp_path):
    """The reference's syncer thread ends when ``step()`` raises, the
    error left to the thread's excepthook (the node then never leaves
    block sync); the port's syncer keeps the error, and the node fails
    with it."""
    unhandled = []
    hook, threading.excepthook = threading.excepthook, lambda args: unhandled.append(args.exc_value)
    caught_up = []
    jsyncer = jsyncer_mod.BlockSyncer.__new__(jsyncer_mod.BlockSyncer)
    jsyncer._stop_flag = threading.Event()
    jsyncer.on_caught_up = caught_up.append

    def jfaulty_step():
        raise JDeviceFault("injected")

    jsyncer.step = jfaulty_step
    t = threading.Thread(target=jsyncer._run)
    try:
        t.start()
        t.join(timeout=5)
    finally:
        threading.excepthook = hook
    assert not t.is_alive() and not caught_up and not hasattr(jsyncer, "error")
    assert len(unhandled) == 1 and isinstance(unhandled[0], JDeviceFault)

    node = _single_node(tmp_path, "bs", blocksync=True)
    fault = DeviceFault("injected sync fault")

    def faulty_step():
        raise fault

    node.syncer.step = faulty_step
    node.start()
    assert wait_for(lambda: node.failed is not None, timeout=5)
    assert node.failed is fault and node.syncer.error is fault
    with pytest.raises(DeviceFault, match="injected sync fault"):
        node.stop()


def test_node_stop_raises_what_consensus_stop_raised(port_node_env, tmp_path):
    """The reference's ``Node.stop`` swallows the error of
    ``consensus.stop()`` (the one that stopped its receive routine); the
    port's releases everything, then raises it."""
    stopped = []

    def jfaulty_stop():
        raise JDeviceFault("injected")

    stub = types.SimpleNamespace(stop=lambda: stopped.append(1))
    jnode = types.SimpleNamespace(
        rpc_server=None, consensus=types.SimpleNamespace(stop=jfaulty_stop),
        blocksync_reactor=stub, statesync_reactor=stub, consensus_reactor=stub, mempool_reactor=stub,
        evidence_reactor=stub, pex_reactor=stub, router=stub, _signer_endpoint=None, _owned_signer=None,
        event_sink=None, _dbs=[], _started=True,
    )
    JNode.stop(jnode)  # returns: the fault is hidden
    assert len(stopped) == 7 and not jnode._started

    node = _single_node(tmp_path, "st", blocksync=False)
    node.start()
    assert wait_for(lambda: node.height >= 1, timeout=30)
    fault = DeviceFault("injected consensus fault")
    real_stop = node.consensus.stop

    def faulty_stop():
        real_stop()
        raise fault

    node.consensus.stop = faulty_stop
    with pytest.raises(DeviceFault, match="injected consensus fault"):
        node.stop()
    assert node.failed is fault
    assert not node._started and node.router._stop_flag.is_set()


def test_a_peer_gossips_more_than_one_tx_where_the_reference_admits_one():
    """The reference's mempool reactor gives the peer's ID as the tx's
    sender, and the mempool holds one tx a sender: the second tx a peer
    gossips is refused and stays in the seen-cache. The port's reactor
    gives the app's sender alone (Go's rule), so both are admitted."""
    from tendermint_tpu.abci.client import LocalClient as JLocalClient
    from tendermint_tpu.abci.kvstore import KVStoreApplication as JKVStoreApplication
    from tendermint_tpu.mempool import reactor as jmr
    from tendermint_tpu.mempool.mempool import MempoolConfig as JMempoolConfig, TxMempool as JTxMempool
    from tendermint_tpu_torch.mempool import reactor as mr
    from tendermint_tpu_torch.mempool.mempool import MempoolConfig, TxMempool
    from tendermint_tpu_torch.p2p.key import NodeKey
    from tendermint_tpu_torch.p2p.peermanager import PeerManager
    from tendermint_tpu_torch.p2p.router import Router
    from tendermint_tpu_torch.p2p.transport import NodeInfo

    txs = [b"gossip-a=1", b"gossip-b=2", b"gossip-c=3"]
    sizes = []
    for pkg in ("jax", "port"):
        if pkg == "jax":
            client = JLocalClient(JKVStoreApplication())
            mp = JTxMempool(JMempoolConfig(), client)
            nk = JNodeKey.generate()
            router = JRouter(JNodeInfo(nk.node_id, CHAIN), JPeerManager(nk.node_id), JMemoryNetwork().transport("m"))
            reactor, env = jmr.MempoolReactor(mp, router), JEnvelope
        else:
            client = LocalClient(KVStoreApplication())
            mp = TxMempool(MempoolConfig(), client)
            nk = NodeKey.generate()
            router = Router(NodeInfo(nk.node_id, CHAIN), PeerManager(nk.node_id), MemoryNetwork().transport("m"))
            reactor, env = mr.MempoolReactor(mp, router), Envelope
        client.start()
        reactor.start()
        try:
            for tx in txs:
                reactor.channel.in_queue.put(env(0x30, tx, from_peer="p" * 40))
            wait_for(lambda: reactor.channel.in_queue.empty(), timeout=5)
            time.sleep(0.3)
            sizes.append(mp.size())
        finally:
            reactor.stop()
    assert sizes == [1, 3]


def test_catch_up_parts_wait_for_the_peers_commit_step():
    """A peer a height behind, not yet in its commit step, has no part
    set for that height and drops a part. The reference's catch-up sends
    the stored block's part at once and marks it sent (so it never sends
    it again); the port sends the commit's votes first, and the part once
    the peer announces the commit step."""
    from tendermint_tpu.consensus import reactor as jcr
    from tendermint_tpu.types.block import BLOCK_PART_SIZE_BYTES as JPART_SIZE
    from tendermint_tpu.types.part_set import PartSet as JPartSet
    from tendermint_tpu_torch.consensus import reactor as cr
    from tendermint_tpu_torch.consensus.cstypes import RoundStep
    from tendermint_tpu_torch.types.block import Commit
    from tendermint_tpu_torch.types.part_set import Part
    from tests import helpers as jhelpers

    privs, vset = jhelpers.make_validators(4)
    jparts = JPartSet.from_data(b"block bytes" * 100, JPART_SIZE)
    jbid = jhelpers.make_block_id(b"catch-up")
    jcommit = jhelpers.make_commit(jbid, 5, 0, vset, privs)

    def gossip(mod, part, commit, step):
        sent = []

        class Channel:
            def __init__(self, cid):
                self.cid = cid

            def send(self, env):
                sent.append((self.cid, env.message[0]))

            broadcast = send

        meta = types.SimpleNamespace(block_id=types.SimpleNamespace(part_set_header=types.SimpleNamespace(total=1)))
        store = types.SimpleNamespace(
            base=lambda: 1, load_block_meta=lambda h: meta, load_block_extended_commit=lambda h: None,
            load_block_commit=lambda h: commit, load_seen_commit=lambda: None, load_block_part=lambda h, i: part,
        )
        cs = types.SimpleNamespace(block_store=store, rs=types.SimpleNamespace(height=6))
        router = types.SimpleNamespace(open_channel=Channel)
        reactor = mod.ConsensusReactor(cs, router)
        ps = mod.PeerState("p")
        ps.apply_new_round_step(5, 0, step, -1)
        reactor._gossip_once(ps)
        return sent

    propose, commit_step = int(RoundStep.PROPOSE), int(RoundStep.COMMIT)
    jsent = gossip(jcr, jparts.get_part(0), jcommit, propose)
    part = Part.from_proto_bytes(jparts.get_part(0).to_proto_bytes())
    commit = Commit.from_proto_bytes(jcommit.to_proto_bytes())
    sent = gossip(cr, part, commit, propose)
    data, vote = (cr.DATA_CHANNEL, cr.TAG_BLOCK_PART), (cr.VOTE_CHANNEL, cr.TAG_VOTE)
    assert jsent == [data] + [vote] * 4  # the part goes before the peer can take it
    assert sent == [vote] * 4
    assert gossip(cr, part, commit, commit_step) == [data] + [vote] * 4

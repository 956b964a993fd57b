"""The port's node RPC beside the JAX package's: the twin of
``tests/test_rpc.py``.

- Route parity: one seeded six-height chain (``tests/test_torch_execution``
  ``_step``: txs, a validator joining and one changing power at height
  3) is built in both packages, each executor's ``event_publisher``
  indexing the block and publishing it on an event bus, as a node's
  ``_fire_events`` does. Every route of ``Environment.routes()`` that
  reads that chain is asked through each package's ``RPCServer``, and
  the results must be the same bytes after ``json.dumps(...,
  sort_keys=True)``; error answers must carry the same code and message.
- A live port node (one validator, fast timeouts, ``device="cpu"``,
  ``rpc_laddr="127.0.0.1:0"``) answers the reference's tests of
  ``tests/test_rpc.py``: status, blocks, broadcast_tx_commit, tx_search,
  the event log, URI requests, ``HTTPProvider``.
- The wire crosses the packages: a JAX ``HTTPProvider`` and
  ``LightClient`` verify a chain served by a port node's RPC, and the
  port's ``HTTPProvider`` and ``LightClient`` one served by a JAX node.
"""

import contextlib
import json
import types
import urllib.request

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from tendermint_tpu import eventbus as jeb
from tendermint_tpu.indexer.kv import KVIndexer as JKVIndexer
from tendermint_tpu.mempool.mempool import MempoolConfig as JMempoolConfig, TxMempool as JTxMempool
from tendermint_tpu.node.node import Node as JNode
from tendermint_tpu.rpc import core as jcore
from tendermint_tpu.rpc.server import RPCServer as JRPCServer
from tendermint_tpu.storage import MemDB as JMemDB
from tendermint_tpu.types.genesis import GenesisDoc as JGenesisDoc, GenesisValidator as JGenesisValidator
from tendermint_tpu_torch import eventbus as eb
from tendermint_tpu_torch.abci import types as abci
from tendermint_tpu_torch.abci.client import LocalClient
from tendermint_tpu_torch.abci.kvstore import KVStoreApplication
from tendermint_tpu_torch.encoding.canonical import Timestamp
from tendermint_tpu_torch.indexer.kv import KVIndexer
from tendermint_tpu_torch.light.client import LightClient, TrustOptions
from tendermint_tpu_torch.light.provider import HTTPProvider, HeightTooHighError, ProviderError
from tendermint_tpu_torch.mempool.mempool import MempoolConfig, TxMempool
from tendermint_tpu_torch.node import Node, NodeConfig
from tendermint_tpu_torch.privval import FilePV
from tendermint_tpu_torch.rpc import core
from tendermint_tpu_torch.rpc.client import HTTPClient, RPCClientError
from tendermint_tpu_torch.rpc.server import RPCError, RPCServer
from tendermint_tpu_torch.storage.kv import MemDB
from tendermint_tpu_torch.types.block import tx_hash
from tendermint_tpu_torch.types.genesis import GenesisDoc, GenesisValidator
from tendermint_tpu_torch.types.validation import verify_commit_light
from tests import helpers as jhelpers
from tests import test_execution as jexec
from tests import test_torch_execution as texec
from tests.test_torch_node import CHAIN, fast_genesis, wait_for

N_HEIGHTS = 6
NODE_INFO = dict(node_id="ab" * 20, listen_addr="127.0.0.1:26656", network=texec.CHAIN_ID, version="0.1.0",
                 moniker="parity")


# --- route parity over one seeded chain ---------------------------------------


def _chain_env(pkg):
    """A six-height chain in package ``pkg`` ("port" or "jax") behind an
    ``Environment`` and an ``RPCServer`` (never started: requests go
    through its dispatch)."""
    if pkg == "port":
        executor, state, privs, _, _ = texec.make_chain_env()
        _, vset = texec.make_validators(4)
        gen = GenesisDoc(chain_id=texec.CHAIN_ID, genesis_time=Timestamp.from_unix_ns(texec.BASE_NS),
                         validators=[GenesisValidator(pub_key=v.pub_key, power=v.voting_power)
                                     for v in vset.validators])
        extra = texec.Ed25519PrivKey.from_seed(texec.NEW_SEED)
        sign, part_set, block_id, ec_cls = texec.make_commit, texec.PartSet, texec.BlockID, texec.ExtendedCommit
        bus_mod, indexer, mempool = eb, KVIndexer(MemDB()), TxMempool(MempoolConfig(), executor.app)
        core_mod, server_cls, node_cls = core, RPCServer, Node
    else:
        executor, state, privs, _, _ = jexec.make_chain_env()
        _, vset = jhelpers.make_validators(4)
        gen = JGenesisDoc(chain_id=texec.CHAIN_ID, genesis_time=jexec.Timestamp.from_unix_ns(texec.BASE_NS),
                          validators=[JGenesisValidator(pub_key=v.pub_key, power=v.voting_power)
                                      for v in vset.validators])
        extra = texec.JEd25519PrivKey.from_seed(texec.NEW_SEED)
        sign, part_set, block_id, ec_cls = jhelpers.make_commit, texec.JPartSet, texec.JBlockID, texec.JExtendedCommit
        bus_mod, indexer, mempool = jeb, JKVIndexer(JMemDB()), JTxMempool(JMempoolConfig(), executor.app)
        core_mod, server_cls, node_cls = jcore, (lambda routes: JRPCServer(routes, evloop=False)), JNode
    bus = bus_mod.EventBus()
    fire = types.SimpleNamespace(event_bus=bus, event_sink=types.SimpleNamespace(
        index_finalized_block=indexer.index_finalized_block))
    executor.event_publisher = lambda *args: node_cls._fire_events(fire, *args)
    secret_of = {p.pub_key().address(): p for p in privs + [extra]}
    ec = ec_cls()
    for _ in range(N_HEIGHTS):
        state, commit, _, _ = texec._step(executor, state, secret_of, ec, sign, part_set, block_id)
        ec = ec_cls.wrap_commit(commit)
    env = core_mod.Environment(
        node_info=types.SimpleNamespace(**NODE_INFO), genesis=gen, block_store=executor.block_store,
        state_store=executor.state_store, mempool=mempool, app_client=executor.app, event_bus=bus,
        indexer=indexer, get_state=lambda: state, is_syncing=lambda: False,
    )
    return env, server_cls(env.routes()), executor


@pytest.fixture(scope="module")
def chain_envs():
    import tendermint_tpu_torch

    saved, tendermint_tpu_torch.DEFAULT_DEVICE = tendermint_tpu_torch.DEFAULT_DEVICE, "cpu"
    try:
        port, jax = _chain_env("port"), _chain_env("jax")
    finally:
        tendermint_tpu_torch.DEFAULT_DEVICE = saved
    for env, _, _ in (port, jax):  # two txs left in each mempool
        for tx in (b"pending-a=1", b"pending-b=2"):
            env.mempool.check_tx(tx)
    return port, jax


def _block_txs(executor):
    return [tx for h in range(1, N_HEIGHTS + 1) for tx in executor.block_store.load_block(h).data.txs]


def _requests(executor):
    """(method, params) for every route that reads the chain."""
    reqs = [("health", {}), ("status", {}), ("net_info", {}), ("blockchain", {}),
            ("blockchain", {"minHeight": 2, "maxHeight": 4}), ("genesis", {}), ("genesis_chunked", {"chunk": 0}),
            ("genesis_chunked", {"chunk": 3}), ("consensus_state", {}), ("dump_consensus_state", {}),
            ("unconfirmed_txs", {}), ("unconfirmed_txs", {"page": 2, "per_page": 1}), ("num_unconfirmed_txs", {}),
            ("abci_info", {}), ("abci_query", {"data": "0x" + b"k3".hex()}),
            ("abci_query", {"data": "0x" + b"missing".hex(), "path": "/store"}),
            ("check_tx", {"tx": "0x" + b"fresh=1".hex()}), ("broadcast_tx_sync", {"tx": "0x" + b"fresh=2".hex()}),
            ("broadcast_tx_async", {"tx": "0x" + b"fresh=3".hex()}), ("block", {"height": 99}), ("block", {}),
            ("block_by_hash", {"hash": "0x" + "00" * 32}), ("header_by_hash", {"hash": "0x" + "00" * 32}),
            ("validators", {"height": 4, "page": 2, "per_page": 2}), ("nonsense_route", {}),
            ("tx", {"hash": "0x" + "11" * 32}), ("remove_tx", {"tx_key": "0xdead"}),
            ("events", {"maxItems": 5}), ("events", {"after": 3, "maxItems": 500, "waitTime": 0}),
            ("events", {"filter": {"query": "tm.event = 'Tx' AND tx.height >= 3"}, "waitTime": 0}),
            ("subscribe", {"query": "tm.event = 'NewBlock'", "waitTime": 0}),
            ("events", {"filter": {"query": "tm.event = = 'x'"}}),
            ("tx_search", {"query": "tm.event = 'Tx'", "per_page": 100}),
            ("tx_search", {"query": "tx.height >= 2 AND tx.height <= 4", "page": 2, "per_page": 2,
                           "order_by": "desc"}),
            ("tx_search", {"query": "app.key = 'acct1'"}), ("tx_search", {"query": "bad query ="}),
            ("block_search", {"query": "tm.event = 'NewBlock'"}),
            ("block_search", {"query": "block.height > 4", "order_by": "desc"})]
    for h in range(1, N_HEIGHTS + 1):
        block_hash = "0x" + executor.block_store.load_block_meta(h).block_id.hash.hex()
        reqs += [("block", {"height": h}), ("commit", {"height": h}), ("header", {"height": h}),
                 ("block_results", {"height": h}), ("validators", {"height": h}),
                 ("consensus_params", {"height": h}), ("block_by_hash", {"hash": block_hash}),
                 ("header_by_hash", {"hash": block_hash})]
    for tx in _block_txs(executor)[::3]:
        reqs += [("tx", {"hash": "0x" + tx_hash(tx).hex(), "prove": True}), ("tx", {"hash": "0x" + tx_hash(tx).hex()})]
    return reqs


def _answer(server, method, params):
    """A route's answer through the server's dispatch: the result as
    sorted JSON, or the error's code and message."""
    resp = server._dispatch({"jsonrpc": "2.0", "id": 1, "method": method, "params": params})
    if "error" in resp:
        return ("error", resp["error"]["code"], resp["error"]["message"])
    return json.dumps(resp["result"], sort_keys=True)


def test_the_routes_read_the_chain_alike(chain_envs):
    (env, server, executor), (jenv, jserver, jexecutor) = chain_envs
    assert [b.hash() for b in map(executor.block_store.load_block, range(1, 7))] == \
           [b.hash() for b in map(jexecutor.block_store.load_block, range(1, 7))]
    assert set(env.routes()) == set(jenv.routes())
    reqs = _requests(executor)
    asked = {m for m, _ in reqs}
    assert asked >= set(env.routes()) - {"broadcast_tx_commit", "broadcast_evidence"}
    errors = 0
    for method, params in reqs:
        got, want = _answer(server, method, params), _answer(jserver, method, params)
        assert got == want, (method, params)
        errors += isinstance(got, tuple)
    assert errors == 7


def test_a_proof_checks_against_the_data_hash(chain_envs):
    from tendermint_tpu_torch.crypto.merkle import Proof

    (env, _, executor), _ = chain_envs
    txs = executor.block_store.load_block(3).data.txs
    out = env.tx(hash="0x" + tx_hash(txs[-1]).hex(), prove=True)
    p = out["proof"]["proof"]
    proof = Proof(total=int(p["total"]), index=int(p["index"]), leaf_hash=core.enc.unb64(p["leaf_hash"]),
                  aunts=[core.enc.unb64(a) for a in p["aunts"]])
    root = bytes.fromhex(out["proof"]["root_hash"])
    assert root == executor.block_store.load_block(3).header.data_hash and proof.verify(root, tx_hash(txs[-1]))


def test_uri_requests_decode_alike(chain_envs):
    (_, server, _), (_, jserver, _) = chain_envs
    for target in ("/block?height=2", '/abci_query?data="0x6b33"', "/validators?height=3&per_page=2",
                   "/tx_search?query=%22tx.height%3D4%22", "/commit?height=true", "/"):
        got, want = server._get_response(target), jserver._get_response(target)
        assert got[:2] == want[:2]
        if target == "/":
            assert got[2] == want[2]
        else:
            assert json.loads(got[2]) == json.loads(want[2]), target


def test_batch_and_malformed_envelopes(chain_envs):
    (_, server, _), (_, jserver, _) = chain_envs
    for body in (b"[]", b"not json", b'"x"', b'[{"id": 1, "method": "health"}, {"id": 2, "method": "nope"}]',
                 b'{"id": 3, "method": "block", "params": [2]}', b'{"id": 4, "method": "block", "params": 5}'):
        assert json.loads(server._post_body(body)) == json.loads(jserver._post_body(body)), body


# --- a live port node ---------------------------------------------------------


@contextlib.contextmanager
def serving_port_node(tmp, height=1):
    """A live port node (one validator, fast timeouts, ``device="cpu"``,
    its RPC on 127.0.0.1) at ``height`` or above, on a fresh shared
    scheduler; the package's device and the sinks a node installs are
    put back after."""
    import tendermint_tpu_torch
    from tendermint_tpu_torch import ops as tops
    from tendermint_tpu_torch.crypto import batch as crypto_batch
    from tendermint_tpu_torch.libs import tracing
    from tendermint_tpu_torch.ops import introspect

    saved_dev, tendermint_tpu_torch.DEFAULT_DEVICE = tendermint_tpu_torch.DEFAULT_DEVICE, "cpu"
    saved = (tracing.tracer._observer, tracing.tracer._profile, introspect.profiler._enabled)
    crypto_batch._shared_scheduler = None
    pv = FilePV.generate(str(tmp / "pk.json"), str(tmp / "ps.json"))
    node = Node(NodeConfig(chain_id=CHAIN, blocksync=False, wal_enabled=False, rpc_laddr="127.0.0.1:0"),
                fast_genesis([pv]), LocalClient(KVStoreApplication()), priv_validator=pv, device="cpu")
    node.start()
    try:
        assert wait_for(lambda: node.height >= height, timeout=60)
        yield node, pv
    finally:
        node.stop()
        crypto_batch.shutdown_shared_scheduler()
        observer, profile, enabled = saved
        introspect.profiler._enabled = enabled
        tracing.tracer.set_metrics_observer(observer)
        tracing.tracer.set_profile_sink(profile)
        tops.bind_metrics(None)
        tendermint_tpu_torch.DEFAULT_DEVICE = saved_dev


@pytest.fixture(scope="module")
def rpc_node(tmp_path_factory):
    with serving_port_node(tmp_path_factory.mktemp("rpcnode")) as (node, _):
        yield node, HTTPClient(node.rpc_server.url)


class TestRPCServer:
    def test_health_and_status(self, rpc_node):
        node, client = rpc_node
        assert client.health() == {}
        st = client.status()
        assert st["node_info"]["network"] == CHAIN and st["node_info"]["id"] == node.node_key.node_id
        assert int(st["sync_info"]["latest_block_height"]) >= 1
        assert st["sync_info"]["catching_up"] is False
        assert st["validator_info"]["voting_power"] == "10"

    def test_block_commit_validators(self, rpc_node):
        node, client = rpc_node
        blk = client.block(1)
        assert blk["block"]["header"]["height"] == "1" and blk["block"]["header"]["chain_id"] == CHAIN
        commit = client.commit(1)
        assert commit["signed_header"]["commit"]["height"] == "1"
        assert commit["signed_header"]["commit"]["block_id"]["hash"] == blk["block_id"]["hash"]
        vals = client.validators(1)
        assert vals["total"] == "1" and vals["validators"][0]["voting_power"] == "10"
        bc = client.call("blockchain", {"minHeight": 1, "maxHeight": 2})
        assert int(bc["last_height"]) >= 1 and bc["block_metas"]
        assert client.call("header", {"height": 1})["header"]["height"] == "1"

    def test_genesis_and_consensus(self, rpc_node):
        node, client = rpc_node
        assert client.call("genesis")["genesis"]["chain_id"] == CHAIN
        assert int(client.call("consensus_params")["consensus_params"]["block"]["max_bytes"]) > 0
        assert int(client.call("consensus_state")["round_state"]["height"]) >= 1
        dump = client.call("dump_consensus_state")
        rs = dump["round_state"]
        assert rs["validators"]["count"] == 1 and dump["peers"] == []
        assert all(set(r["prevotes_bit_array"]) <= {"x", "_"} for r in rs["height_vote_set"])

    def test_broadcast_tx_commit_index_and_search(self, rpc_node):
        node, client = rpc_node
        res = client.broadcast_tx_commit(b"fruit=apple", timeout=30)
        assert res["check_tx"]["code"] == 0 and res["tx_result"] is not None, res
        height = int(res["height"])
        assert node.block_store.load_block(height).data.txs == [b"fruit=apple"]
        assert client.abci_query("", b"fruit")["response"]["value"] == core.enc.b64(b"apple")
        tx_hash_ = bytes.fromhex(res["hash"])
        assert client.tx(tx_hash_)["height"] == str(height)
        for q in (f"tx.height = {height}", f"tm.event = 'Tx' AND tx.height = {height}", f"tx.hash = '{res['hash']}'"):
            assert client.tx_search(q)["total_count"] == "1", q
        blocks = client.block_search(f"tm.event = 'NewBlock' AND block.height = {height}")
        assert blocks["total_count"] == "1"

    def test_events_observe_the_round_lifecycle(self, rpc_node):
        """The state machine's round events reach the bus: NewRound,
        NewRoundStep, CompleteProposal and Vote, then NewBlock."""
        node, client = rpc_node
        h0 = node.height
        assert wait_for(lambda: node.height >= h0 + 2, timeout=30)
        seen, after = set(), 0
        want = {"NewRound", "NewRoundStep", "CompleteProposal", "Vote", "NewBlock", "NewBlockHeader"}
        for _ in range(20):
            ev = client.events(after=after, wait_time=1.0, max_items=200)
            seen.update(item["event"] for item in ev["items"])
            after = int(ev["newest"])
            if want <= seen:
                break
        assert want <= seen, want - seen
        ev = client.events(query="tm.event = 'NewBlock'", wait_time=5.0)
        cursor = int(ev["newest"])
        ev2 = client.events(query="tm.event = 'NewBlock'", after=cursor, wait_time=5.0)
        assert ev["items"] and all(int(i["cursor"]) > cursor for i in ev2["items"])

    def test_abci_info_mempool_and_errors(self, rpc_node):
        node, client = rpc_node
        assert int(client.abci_info()["response"]["last_block_height"]) >= 1
        assert "n_txs" in client.call("num_unconfirmed_txs")
        with pytest.raises(RPCClientError) as info:
            client.call("nonsense_route")
        assert info.value.code == -32601
        with pytest.raises(RPCClientError, match="no block at height"):
            client.block(10_000_000)

    def test_uri_get_requests(self, rpc_node):
        node, client = rpc_node
        with urllib.request.urlopen(node.rpc_server.url + "/status", timeout=5) as r:
            assert json.loads(r.read())["result"]["node_info"]["network"] == CHAIN
        with urllib.request.urlopen(node.rpc_server.url + "/block?height=1", timeout=5) as r:
            assert json.loads(r.read())["result"]["block"]["header"]["height"] == "1"
        with urllib.request.urlopen(node.rpc_server.url + "/metrics", timeout=5) as r:
            assert b"tendermint_consensus_height" in r.read()

    def test_http_provider_builds_a_verifiable_light_block(self, rpc_node):
        node, client = rpc_node
        lb = HTTPProvider(CHAIN, node.rpc_server.url).light_block(1)
        assert lb.height == 1 and lb.hash() == node.block_store.load_block_meta(1).block_id.hash
        assert lb.signed_header.header.validators_hash == lb.validator_set.hash()
        verify_commit_light(CHAIN, lb.validator_set, lb.signed_header.commit.block_id, 1, lb.signed_header.commit,
                            device="cpu")
        with pytest.raises(HeightTooHighError):
            HTTPProvider(CHAIN, node.rpc_server.url).light_block(10_000_000)
        with pytest.raises(ProviderError):
            HTTPProvider(CHAIN, "http://127.0.0.1:9", timeout=1).light_block(1)


class TestProfilingRoutes:
    """The pprof-analog surface: thread dumps and the CPU profiler,
    behind the unsafe opt-in."""

    def test_dump_routines_lists_threads(self):
        out = core.Environment().dump_routines()
        names = [r["thread"] for r in out["routines"]]
        assert out["count"] >= 1 and any("MainThread" in n for n in names)

    def test_profiler_roundtrip_and_double_start(self):
        env = core.Environment()
        env.unsafe_start_profiler()
        try:
            with pytest.raises(RPCError):
                env.unsafe_start_profiler()
            sum(i * i for i in range(50_000))
        finally:
            out = env.unsafe_stop_profiler(top=5)
        assert "function calls" in out["stats"]
        with pytest.raises(RPCError, match="not running"):
            env.unsafe_stop_profiler()

    def test_unsafe_routes_gated(self):
        unsafe = {"dump_routines", "unsafe_disconnect_peers", "unsafe_start_profiler", "unsafe_stop_profiler"}
        assert not unsafe & set(core.Environment().routes())
        assert unsafe <= set(core.Environment(unsafe=True).routes())
        assert set(core.Environment(unsafe=True).routes()) == set(jcore.Environment(unsafe=True).routes())


# --- the wire across the packages ---------------------------------------------


def test_a_jax_light_client_verifies_a_port_nodes_chain(rpc_node):
    from tendermint_tpu.light.client import LightClient as JLightClient, TrustOptions as JTrustOptions
    from tendermint_tpu.light.provider import HTTPProvider as JHTTPProvider

    node, _ = rpc_node
    assert wait_for(lambda: node.height >= 4, timeout=30)
    url = node.rpc_server.url
    anchor = node.block_store.load_block_meta(1).block_id.hash
    lc = JLightClient(CHAIN, JTrustOptions(period=10 * 365 * 86400.0, height=1, hash=anchor),
                      JHTTPProvider(CHAIN, url), [JHTTPProvider(CHAIN, url)], bisect_batching=False)
    lb = lc.verify_light_block_at_height(3)
    assert lb.hash() == node.block_store.load_block_meta(3).block_id.hash


def test_the_port_light_client_verifies_a_jax_nodes_chain(tmp_path):
    from tendermint_tpu.abci.client import LocalClient as JLocalClient
    from tendermint_tpu.abci.kvstore import KVStoreApplication as JKVStoreApplication
    from tendermint_tpu.node.node import NodeConfig as JNodeConfig
    from tendermint_tpu.privval import FilePV as JFilePV
    from tests import test_node as jtest_node

    pv = JFilePV.generate(str(tmp_path / "k.json"), str(tmp_path / "s.json"))
    jnode = JNode(JNodeConfig(chain_id=jtest_node.CHAIN, blocksync=False, wal_enabled=False,
                              rpc_laddr="127.0.0.1:0"),
                  jtest_node.fast_genesis([pv]), JLocalClient(JKVStoreApplication()), priv_validator=pv)
    jnode.start()
    try:
        assert wait_for(lambda: jnode.height >= 4, timeout=60)
        url = jnode.rpc_server.url
        anchor = jnode.block_store.load_block_meta(1).block_id.hash
        lc = LightClient(jtest_node.CHAIN, TrustOptions(period=10 * 365 * 86400.0, height=1, hash=anchor),
                         HTTPProvider(jtest_node.CHAIN, url), [HTTPProvider(jtest_node.CHAIN, url)],
                         bisect_batching=False, device="cpu")
        lb = lc.verify_light_block_at_height(3)
        assert lb.hash() == jnode.block_store.load_block_meta(3).block_id.hash
        # the port's client answers the JAX node's JSON as the JAX client does
        lb2 = HTTPProvider(jtest_node.CHAIN, url).light_block(2)
        assert lb2.signed_header.commit.to_proto_bytes() == \
            jnode.block_store.load_block_commit(2).to_proto_bytes()
    finally:
        jnode.stop()


# --- repaired reference faults ----------------------------------------------


def test_an_admitted_tx_is_gossiped_where_the_reference_only_admits_it(chain_envs):
    """Go's mempool reactor gossips every tx its mempool holds; the
    reference's broadcast routes only admit the tx, so on a network it
    waits until its node proposes. The port's routes hand an admitted tx
    to the node's mempool reactor, and a refused one to nobody."""
    (env, _, _), (jenv, _, _) = chain_envs
    sent = []
    reactor = types.SimpleNamespace(broadcast_tx=sent.append)
    gossiping = core.Environment(mempool=env.mempool, mempool_reactor=reactor)
    assert "mempool_reactor" not in jcore.Environment.__init__.__code__.co_varnames
    for route in ("broadcast_tx_sync", "broadcast_tx_async"):
        tx = f"gossip-{route}=1".encode()
        assert gossiping.routes()[route](tx="0x" + tx.hex())["code"] == 0
        assert sent[-1] == tx
    before = len(sent)
    assert gossiping.broadcast_tx_sync(tx="0x" + b"val:not-a-key!1".hex())["code"] != 0  # the app refuses it
    assert len(sent) == before
    # the reference: admitted, never handed to a reactor
    jenv.broadcast_tx_sync(tx="0x" + b"gossip-ref=1".hex())
    assert b"gossip-ref=1" in jenv.mempool.tx_list()


def test_go_zero_time_round_trips_where_the_reference_refuses_it():
    """An absent commit signature carries Go's zero time. The reference
    writes it with an unpadded year, which its own parser refuses; the
    port writes four digits, as Go does, and reads both forms."""
    from tendermint_tpu.rpc import encoding as jenc
    from tendermint_tpu_torch.consensus.cstypes import GO_ZERO_TIME
    from tendermint_tpu_torch.types.block import CommitSig

    assert core.enc.rfc3339(GO_ZERO_TIME) == "0001-01-01T00:00:00Z"
    assert core.enc.parse_rfc3339("0001-01-01T00:00:00Z") == GO_ZERO_TIME
    written = jenc.rfc3339(jenc.parse_rfc3339("2023-11-14T22:13:20Z"))
    assert written == core.enc.rfc3339(core.enc.parse_rfc3339(written)) == "2023-11-14T22:13:20Z"
    ref = jenc.rfc3339(jenc.Timestamp(GO_ZERO_TIME.seconds, GO_ZERO_TIME.nanos))
    assert ref == "1-01-01T00:00:00Z"
    with pytest.raises(ValueError):
        jenc.parse_rfc3339(ref)
    assert core.enc.parse_rfc3339(ref) == GO_ZERO_TIME
    absent = CommitSig.absent()
    assert core.enc.commit_from_json(core.enc.commit_json(
        types.SimpleNamespace(height=1, round=0, block_id=texec.BlockID(), signatures=[absent]))
    ).signatures[0].timestamp == absent.timestamp

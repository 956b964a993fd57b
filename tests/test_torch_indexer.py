"""The port's tx and block index and its event sinks beside the JAX
package's: the twin of ``tests/test_indexer.py`` and
``tests/test_sinks.py``.

The same seeded blocks (txs, ABCI events with indexed and unindexed
attributes) go into both packages' ``KVIndexer`` over ``MemDB`` and
both ``SQLEventSink``s over ``sqlite3``: the stores must hold the same
keys and values, the same rows, and answer every query with the same
results."""

import hashlib
import sqlite3

import numpy as np
import pytest

pytest.importorskip("torch")

from tendermint_tpu.abci import types as jabci
from tendermint_tpu.indexer import sink as jsink
from tendermint_tpu.indexer.kv import KVIndexer as JKVIndexer
from tendermint_tpu.libs.pubsub import Query as JQuery
from tendermint_tpu.storage import MemDB as JMemDB
from tendermint_tpu_torch.abci import types as abci
from tendermint_tpu_torch.indexer import sink
from tendermint_tpu_torch.indexer.kv import KVIndexer, TxResult
from tendermint_tpu_torch.libs.pubsub import Query
from tendermint_tpu_torch.storage.kv import MemDB
from tests.test_torch_node import port_node_env  # noqa: F401  (a fixture)

SEED = 20261018
QUERIES = (
    "app.kind = 'transfer'",
    "app.kind = 'stake'",
    "tx.height >= 3 AND tx.height <= 5",
    "tx.height < 2",
    "tm.event = 'Tx'",
    "tm.event = 'Tx' AND tx.height = 4",
    "tm.event = 'NewBlock'",
    "transfer.amount > 50",
    "transfer.amount >= 50 AND app.kind = 'transfer'",
    "transfer.to CONTAINS 'addr1'",
    "transfer.memo EXISTS",
    "transfer.amount EXISTS",
    "app.kind = 'nope'",
)
BLOCK_QUERIES = (
    "tm.event = 'NewBlock'",
    "block.height > 2",
    "block.height = 4 AND block_meta.round = 0",
    "block_meta.proposer CONTAINS 'val'",
    "block_meta.round EXISTS",
    "block_meta.round >= 1",
    "tm.event = 'Tx'",
)


def _blocks(pkg, n_heights=6, seed=SEED):
    """``n_heights`` blocks of seeded txs and events in package ``pkg``
    (its ``abci`` module): (height, txs, ResponseFinalizeBlock)."""
    rng = np.random.default_rng(seed)
    out = []
    for h in range(1, n_heights + 1):
        txs, results = [], []
        for i in range(int(rng.integers(0, 5))):
            amount = int(rng.integers(0, 100))
            txs.append(b"tx-%d-%d=%d" % (h, i, amount))
            kind = ("transfer", "stake")[int(rng.integers(2))]
            attrs = [pkg.EventAttribute(key="amount", value=str(amount), index=True),
                     pkg.EventAttribute(key="to", value=f"addr{int(rng.integers(20))}", index=True),
                     pkg.EventAttribute(key="memo", value="m", index=bool(rng.integers(2)))]
            results.append(pkg.ExecTxResult(code=int(rng.integers(2)), data=rng.bytes(3), log="ok",
                                            gas_wanted=int(rng.integers(100)), gas_used=int(rng.integers(100)),
                                            events=[pkg.Event(type="app", attributes=[
                                                pkg.EventAttribute(key="kind", value=kind, index=True)]),
                                                pkg.Event(type="transfer", attributes=attrs),
                                                pkg.Event(type="", attributes=attrs)]))
        fres = pkg.ResponseFinalizeBlock(events=[pkg.Event(type="block_meta", attributes=[
            pkg.EventAttribute(key="round", value=str(h % 2), index=True),
            pkg.EventAttribute(key="proposer", value=f"val{h % 3}", index=True)])], tx_results=results)
        out.append((h, txs, fres))
    return out


@pytest.fixture(scope="module")
def indexers():
    idx, jidx = KVIndexer(MemDB()), JKVIndexer(JMemDB())
    for (h, txs, fres), (_, jtxs, jfres) in zip(_blocks(abci), _blocks(jabci)):
        idx.index_finalized_block(h, txs, fres)
        jidx.index_finalized_block(h, jtxs, jfres)
    return idx, jidx


def test_the_stores_hold_the_same_keys_and_values(indexers):
    idx, jidx = indexers
    got = [(bytes(k), bytes(v)) for k, v in idx.db.iterator(None, None)]
    want = [(bytes(k), bytes(v)) for k, v in jidx.db.iterator(None, None)]
    assert got == want and len(got) > 30


@pytest.mark.parametrize("text", QUERIES)
def test_tx_search_gives_the_same_results(indexers, text):
    idx, jidx = indexers
    keys, jkeys = idx.search_tx_keys(Query.parse(text)), jidx.search_tx_keys(JQuery.parse(text))
    assert keys == jkeys and keys == sorted(keys)
    got = [t.to_json() for t in idx.search_txs(Query.parse(text), limit=5)]
    assert got == [t.to_json() for t in jidx.search_txs(JQuery.parse(text), limit=5)]


@pytest.mark.parametrize("text", BLOCK_QUERIES)
def test_block_search_gives_the_same_heights(indexers, text):
    idx, jidx = indexers
    assert idx.search_block_heights(Query.parse(text)) == jidx.search_block_heights(JQuery.parse(text))


def test_get_tx_and_hash_condition(indexers):
    idx, jidx = indexers
    h, txs, _ = next(b for b in _blocks(abci) if b[1])
    th = hashlib.sha256(txs[0]).digest()
    tr = idx.get_tx(th)
    assert tr.height == h and tr.index == 0 and tr.to_json() == jidx.get_tx(th).to_json()
    assert TxResult.from_json(tr.to_json()).to_json() == tr.to_json()
    assert idx.search_tx_keys(Query.parse(f"tx.hash = '{th.hex()}'")) == [(h, 0, th)]
    assert idx.search_tx_keys(Query.parse("tx.hash = 'zz'")) == []
    assert idx.get_tx(b"\x00" * 32) is None


def test_a_page_decodes_only_its_records():
    idx = KVIndexer(MemDB())
    ev = [abci.Event(type="app", attributes=[abci.EventAttribute(key="kind", value="transfer", index=True)])]
    idx.index_txs(TxResult(height=h, index=i, tx=b"tx-%d-%d" % (h, i), result=abci.ExecTxResult(events=ev))
                  for h in range(1, 21) for i in range(5))
    decoded, orig = [], idx.get_tx

    def counting_get(h):
        decoded.append(h)
        return orig(h)

    idx.get_tx = counting_get
    out = idx.search_txs(Query.parse("app.kind = 'transfer'"), limit=7)
    assert len(decoded) == 7
    assert [(t.height, t.index) for t in out] == [(1, 0), (1, 1), (1, 2), (1, 3), (1, 4), (2, 0), (2, 1)]


# --- sinks ---------------------------------------------------------------------


def _sql_rows(conn):
    cur = conn.cursor()
    out = {}
    for table, cols in (("blocks", "height, chain_id"),
                        ("tx_results", 'block_id, "index", tx_hash, tx_result'),
                        ("events", "block_id, tx_id, type"),
                        ("attributes", "event_id, key, composite_key, value")):
        cur.execute(f"SELECT {cols} FROM {table} ORDER BY rowid")
        out[table] = cur.fetchall()
    for view in ("block_events", "tx_events"):
        cur.execute(f"SELECT * FROM {view}")
        out[view] = sorted(tuple(x for x in row if not (isinstance(x, str) and x.endswith("Z"))) for row in cur)
    return out


def test_the_sql_sinks_write_the_same_rows():
    conn, jconn = sqlite3.connect(":memory:"), sqlite3.connect(":memory:")
    s, js = sink.SQLEventSink(conn, "sql-chain"), jsink.SQLEventSink(jconn, "sql-chain")
    for (h, txs, fres), (_, jtxs, jfres) in zip(_blocks(abci), _blocks(jabci)):
        s.index_finalized_block(h, txs, fres)
        js.index_finalized_block(h, jtxs, jfres)
    rows = _sql_rows(conn)
    assert rows == _sql_rows(jconn)
    assert [r[0] for r in rows["blocks"]] == list(range(1, 7))
    cur = conn.cursor()
    cur.execute("SELECT COUNT(*) FROM events WHERE tx_id IS NULL")
    assert cur.fetchone()[0] == 6  # one block event a height
    s.close()
    js.close()


def test_a_failed_block_rolls_back():
    conn = sqlite3.connect(":memory:")
    s = sink.SQLEventSink(conn, "c")
    s.index_finalized_block(1, [], abci.ResponseFinalizeBlock())
    with pytest.raises(sqlite3.IntegrityError):
        s.index_finalized_block(1, [], abci.ResponseFinalizeBlock())  # (height, chain_id) is unique
    s.index_finalized_block(2, [], abci.ResponseFinalizeBlock())
    cur = conn.cursor()
    cur.execute("SELECT height FROM blocks ORDER BY height")
    assert cur.fetchall() == [(1,), (2,)]


def test_null_and_multi_sinks():
    calls = []

    class Probe(sink.NullEventSink):
        def __init__(self, name):
            self.name = name

        def index_finalized_block(self, height, txs, fres):
            calls.append((self.name, height))

    class Broken(sink.NullEventSink):
        def index_finalized_block(self, height, txs, fres):
            raise OSError("disk full")

    sink.NullEventSink().index_finalized_block(1, [b"tx"], abci.ResponseFinalizeBlock())
    ms = sink.MultiSink([Probe("a"), Broken(), Probe("b")])
    with pytest.warns(UserWarning, match="Broken failed at height 9"):
        ms.index_finalized_block(9, [], abci.ResponseFinalizeBlock())
    assert calls == [("a", 9), ("b", 9)]
    kv = KVIndexer(MemDB())
    sink.KVEventSink(kv).index_finalized_block(*_blocks(abci)[0])
    assert kv.search_block_heights(Query.parse("block.height = 1")) == [1]


def _sink_node(tmp_path, sinks):
    from tendermint_tpu_torch.abci.client import LocalClient
    from tendermint_tpu_torch.abci.kvstore import KVStoreApplication
    from tendermint_tpu_torch.node import Node, NodeConfig
    from tendermint_tpu_torch.privval import FilePV
    from tests.test_torch_node import fast_genesis

    pv = FilePV.generate(str(tmp_path / "k.json"), str(tmp_path / "s.json"))
    cfg = NodeConfig(chain_id="node-chain", wal_enabled=False, blocksync=False, moniker="sink-node",
                     tx_index_sinks=sinks)
    return Node(cfg, fast_genesis([pv]), LocalClient(KVStoreApplication()), priv_validator=pv, device="cpu")


def test_node_config_selects_sinks(port_node_env, tmp_path):
    """A node with sinks ["null", "psql"] keeps no kv index and records
    its blocks in the SQL schema; an unknown sink is refused."""
    from tests.test_torch_node import wait_for

    node = _sink_node(tmp_path, ["null", "psql", "sql"])
    assert node.indexer is None
    assert [type(s).__name__ for s in node.event_sink.sinks] == ["NullEventSink", "SQLEventSink"]
    conn = node.event_sink.sinks[1]._conn
    node.start()
    try:
        # node.height is the block store's, which is saved before the
        # block is applied and indexed; block 3 is saved only once block
        # 2 has been indexed (finalize: save, apply, then the next height)
        assert wait_for(lambda: node.height >= 3, timeout=60)
        cur = conn.cursor()
        cur.execute("SELECT COUNT(*) FROM blocks")
        assert cur.fetchone()[0] >= 2
    finally:
        node.stop()
    with pytest.raises(ValueError, match="unknown indexer sink"):
        _sink_node(tmp_path, ["elastic"])

"""The port's mempool beside the JAX package's, on the CPU: twins of the
11 tests of ``tests/test_mempool.py``, then a seeded mix of kvstore txs
(priorities, senders, refused and repeated txs) through both pools,
whose admissions, reap orders, evictions, recheck survivors and metrics
must agree exactly."""

import numpy as np
import pytest

pytest.importorskip("torch")

from tendermint_tpu.abci import types as jabci
from tendermint_tpu.abci.client import LocalClient as JLocalClient
from tendermint_tpu.libs.metrics import MempoolMetrics as JMempoolMetrics, Registry as JRegistry
from tendermint_tpu.mempool import MempoolConfig as JMempoolConfig, TxMempool as JTxMempool
from tendermint_tpu_torch.abci import types as abci
from tendermint_tpu_torch.abci.client import LocalClient
from tendermint_tpu_torch.abci.kvstore import KVStoreApplication
from tendermint_tpu_torch.libs.metrics import MempoolMetrics, Registry
from tendermint_tpu_torch.mempool import LRUTxCache, MempoolConfig, TxMempool
from tests import test_mempool as jmp


class PriorityApp(KVStoreApplication):
    """CheckTx priority = the int after the last ':' when present."""

    def check_tx(self, req):
        res = super().check_tx(req)
        if res.is_ok() and b":" in req.tx:
            try:
                res.priority = int(req.tx.rsplit(b":", 1)[1])
            except ValueError:
                pass
        return res


def make_mempool(config=None, metrics=None):
    client = LocalClient(PriorityApp())
    client.start()
    return TxMempool(config or MempoolConfig(), client, metrics=metrics)


# --- tests/test_mempool.py -------------------------------------------------------


class TestLRUTxCache:
    def test_push_dedupe_and_evict(self):
        c = LRUTxCache(2)
        assert c.push(b"a") and c.push(b"b")
        assert not c.push(b"a")
        assert c.push(b"c")  # evicts b (a was refreshed)
        assert not c.has(b"b") and c.has(b"a") and c.has(b"c")


class TestTxMempool:
    def test_check_tx_admits_and_dedupes(self):
        mp = make_mempool()
        res = mp.check_tx(b"k=v")
        assert res.is_ok() and len(mp) == 1
        with pytest.raises(KeyError, match="cache"):
            mp.check_tx(b"k=v")

    def test_invalid_tx_rejected(self):
        mp = make_mempool()
        res = mp.check_tx(bytes([0xFF, 0xFE]))  # not utf-8: invalid format
        assert not res.is_ok() and len(mp) == 0

    def test_priority_ordering_in_reap(self):
        mp = make_mempool()
        for tx in [b"a=1:5", b"b=2:50", b"c=3:10"]:
            mp.check_tx(tx)
        assert mp.reap_max_bytes_max_gas(-1, -1) == [b"b=2:50", b"c=3:10", b"a=1:5"]
        assert mp.reap_max_txs(2) == [b"b=2:50", b"c=3:10"]

    def test_reap_respects_max_bytes(self):
        mp = make_mempool()
        mp.check_tx(b"a=" + b"x" * 100 + b":9")
        mp.check_tx(b"b=1:5")
        # reaping stops at the FIRST over-budget tx
        assert mp.reap_max_bytes_max_gas(20, -1) == []
        assert mp.reap_max_bytes_max_gas(200, -1) == [b"a=" + b"x" * 100 + b":9", b"b=1:5"]

    def test_update_removes_committed_and_rechecks(self):
        mp = make_mempool()
        mp.check_tx(b"a=1:5")
        mp.check_tx(b"b=2:9")
        mp.lock()
        try:
            mp.update(1, [b"a=1:5"], [abci.ExecTxResult(code=0)])
        finally:
            mp.unlock()
        assert mp.tx_list() == [b"b=2:9"]
        with pytest.raises(KeyError):  # a committed tx stays cached
            mp.check_tx(b"a=1:5")

    def test_eviction_by_priority_when_full(self):
        mp = make_mempool(MempoolConfig(size=2))
        mp.check_tx(b"a=1:1")
        mp.check_tx(b"b=2:2")
        mp.check_tx(b"c=3:50")  # evicts the lowest priority (a)
        txs = mp.tx_list()
        assert b"a=1:1" not in txs and b"c=3:50" in txs
        with pytest.raises(OverflowError):
            mp.check_tx(b"d=4:0")  # lower than everything: no room

    def test_ttl_num_blocks(self):
        mp = make_mempool(MempoolConfig(ttl_num_blocks=1, recheck=False))
        mp.check_tx(b"a=1:5")
        mp.lock()
        try:
            mp.update(3, [], [])
        finally:
            mp.unlock()
        assert len(mp) == 0

    def test_sender_dedupe(self):
        mp = make_mempool()
        mp.check_tx(b"a=1:5", sender="alice")
        with pytest.raises(KeyError, match="sender"):
            mp.check_tx(b"b=2:5", sender="alice")

    def test_txs_available_signal(self):
        mp = make_mempool()
        mp.enable_txs_available()
        assert not mp.txs_available().is_set()
        mp.check_tx(b"a=1:5")
        assert mp.txs_available().is_set()

    def test_oversize_tx_rejected(self):
        mp = make_mempool(MempoolConfig(max_tx_bytes=10))
        with pytest.raises(ValueError, match="size"):
            mp.check_tx(b"x" * 11)


# --- parity with the JAX package ----------------------------------------------------


def test_the_config_defaults_are_the_reference_s():
    assert vars(MempoolConfig()) == vars(JMempoolConfig())
    assert (MempoolConfig().size, MempoolConfig().max_txs_bytes, MempoolConfig().cache_size,
            MempoolConfig().max_tx_bytes, MempoolConfig().recheck) == (5000, 1 << 30, 10000, 1 << 20, True)


def _seeded_mix(rng, n):
    """kvstore txs (key=value:priority), with a sender on some, a few
    refused (not utf-8) and a few repeated."""
    out = []
    for i in range(n):
        kind = rng.integers(0, 20)
        if kind == 0:
            out.append((bytes([0xFF, 0xFE, i % 256, i // 256]), ""))
        elif kind == 1 and out:
            out.append(out[int(rng.integers(0, len(out)))])
        else:
            tx = b"acct-%05d=%s:%d" % (rng.integers(0, 4096), rng.bytes(6).hex().encode(), rng.integers(0, 100))
            out.append((tx, "s%d" % rng.integers(0, 40) if kind == 2 else ""))
    return out


def _drive(pkg, mix, rng_seed):
    """Run the mix through one package's pool (size 64, so it evicts),
    reap, commit a seeded third, recheck; returns what each step saw."""
    if pkg == "port":
        client = LocalClient(PriorityApp())
        reg = Registry()
        mp = TxMempool(MempoolConfig(size=64), client, metrics=MempoolMetrics(reg))
        ok_res = abci.ExecTxResult
    else:
        client = JLocalClient(jmp.PriorityApp())
        reg = JRegistry()
        mp = JTxMempool(JMempoolConfig(size=64), client, metrics=JMempoolMetrics(reg))
        ok_res = jabci.ExecTxResult
    client.start()
    outcomes = []
    for tx, sender in mix:
        try:
            outcomes.append(("code", mp.check_tx(tx, sender=sender).code))
        except (KeyError, OverflowError) as e:
            outcomes.append((type(e).__name__, str(e)))
    reaped = mp.reap_max_bytes_max_gas(1500, 40)
    rng = np.random.default_rng(rng_seed)
    committed = [tx for tx in mp.tx_list() if rng.integers(0, 3) == 0]
    mp.lock()
    try:
        mp.update(1, committed, [ok_res(code=0) for _ in committed])
    finally:
        mp.unlock()
    return outcomes, reaped, mp.reap_max_txs(-1), mp.tx_list(), mp.size_bytes(), reg.expose()


def test_a_seeded_mix_admits_reaps_evicts_and_rechecks_as_the_jax_pool_does():
    mix = _seeded_mix(np.random.default_rng(20261017), 400)
    port, jax = _drive("port", mix, 7), _drive("jax", mix, 7)
    outcomes, reaped, after, gossip, size, exposition = port
    assert outcomes == jax[0]
    assert reaped == jax[1] and after == jax[2] and gossip == jax[3] and size == jax[4]
    assert exposition == jax[5]
    assert {o[0] for o in outcomes} >= {"code", "KeyError", "OverflowError"}
    assert 0 < len(reaped) < 64 and len(after) < 64

"""The port's seed node and per-IP connection tracker: the twin of
``tests/test_seed.py`` on ``tendermint_tpu_torch`` (node/seed.go,
internal/p2p/conn_tracker.go)."""

import pytest

torch = pytest.importorskip("torch")

from tendermint_tpu_torch.abci.client import LocalClient
from tendermint_tpu_torch.abci.kvstore import KVStoreApplication
from tendermint_tpu_torch.node.node import Node, NodeConfig
from tendermint_tpu_torch.node.seed import SeedNode
from tendermint_tpu_torch.p2p.conn_tracker import ConnTracker
from tendermint_tpu_torch.privval import FilePV
from tests.test_torch_node import CHAIN, fast_genesis, port_node_env, wait_for  # noqa: F401


class TestConnTracker:
    def test_limits_per_ip(self):
        t = ConnTracker(max_per_ip=2)
        assert t.add("1.2.3.4")
        assert t.add("1.2.3.4")
        assert not t.add("1.2.3.4")  # third concurrent rejected
        assert t.add("5.6.7.8")  # other IPs unaffected
        t.remove("1.2.3.4")
        assert t.add("1.2.3.4")  # freed slot reusable
        assert t.count("1.2.3.4") == 2
        assert t.total() == 3

    def test_remove_below_zero_safe(self):
        t = ConnTracker(max_per_ip=1)
        t.remove("9.9.9.9")  # never added: no-op
        assert t.count("9.9.9.9") == 0
        assert t.add("9.9.9.9")


class TestSeedNode:
    def test_seed_distributes_addresses(self, port_node_env, tmp_path):
        """Two full nodes that only know the seed discover each other
        through PEX and connect directly."""
        seed = SeedNode(home=str(tmp_path / "seed"), chain_id=CHAIN, listen_addr="127.0.0.1:0")
        seed.start()
        try:
            seed_peer = f"{seed.node_key.node_id}@{seed.listen_addr}"
            pvs = [FilePV.generate(str(tmp_path / f"pk{i}.json"), str(tmp_path / f"ps{i}.json")) for i in range(2)]
            genesis = fast_genesis(pvs)
            nodes = [
                Node(
                    NodeConfig(
                        chain_id=CHAIN,
                        listen_addr="127.0.0.1:0",
                        wal_enabled=False,
                        persistent_peers=[seed_peer],
                        moniker=f"n{i}",
                    ),
                    genesis,
                    LocalClient(KVStoreApplication()),
                    priv_validator=pvs[i],
                    device="cpu",
                )
                for i in range(2)
            ]
            for node in nodes:
                node.start()
            try:
                # both connect to the seed, learn each other over PEX,
                # dial directly, and (being the 2 validators) commit
                assert wait_for(
                    lambda: all(any(p != seed.node_key.node_id for p in n.router.connected_peers()) for n in nodes),
                    timeout=30,
                ), "nodes never discovered each other via the seed"
                assert wait_for(lambda: all(n.height >= 1 for n in nodes), timeout=60), [n.height for n in nodes]
                # the seed never participates in consensus
                assert not hasattr(seed, "consensus")
                assert len(seed.connected_peers()) >= 2
            finally:
                for node in nodes:
                    node.stop()
        finally:
            seed.stop()

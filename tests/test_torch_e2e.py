"""The port's e2e harness (``tendermint_tpu_torch/e2e/``) on the CPU: the
twin of ``tests/test_e2e.py`` (test/e2e analog).

Manifest parsing is covered cheaply, and each manifest parses to what
the JAX package's parser makes of it. The runner's testnets, at the
reference's sizes, are port node processes (``python -m
tendermint_tpu_torch start --device cpu``: the runner's ``device``, the
held divergence from the JAX runner's CPU pin) with the port's app and
signer processes: 3 validators through setup, start, tx load, a kill -9
and a disconnect with recovery, wait, and the RPC-only invariant suite;
the gRPC and socket apps; the remote and gRPC signers; a late joiner
that state-syncs in. Every wait in the runner is on something it can
observe (a bound port, a height over the RPC) under a deadline.
"""

import dataclasses
import os

import pytest

pytest.importorskip("torch")

from tendermint_tpu.e2e.manifest import Manifest as JManifest
from tendermint_tpu_torch.e2e import runner as runner_mod
from tendermint_tpu_torch.e2e.manifest import Manifest
from tendermint_tpu_torch.e2e.runner import Runner

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def one_intra_op_thread(monkeypatch):
    """The runner's children inherit this environment: one torch
    intra-op thread a node process, as the plain kernels' small tensors
    gain nothing from more and the nodes share the test machine."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def _same_as_the_references(text):
    port, jax = Manifest.parse(text), JManifest.parse(text)
    assert dataclasses.asdict(port) == dataclasses.asdict(jax)
    return port


class TestManifest:
    def test_parse_full(self):
        m = _same_as_the_references(
            """
[testnet]
chain_id = "x"
load_tx_per_sec = 1.5
wait_heights = 3

[node.validator0]

[node.v1]
perturb = ["kill", "pause", "restart"]
db_backend = "memdb"
proxy_app = "persistent_kvstore"

[node.full0]
mode = "full"
start_at = 7
"""
        )
        assert m.chain_id == "x"
        assert m.load_tx_per_sec == 1.5
        assert set(m.nodes) == {"validator0", "v1", "full0"}
        assert m.nodes["v1"].perturb == ["kill", "pause", "restart"]
        assert m.nodes["full0"].mode == "full"
        assert m.nodes["full0"].start_at == 7

    def test_rejects_bad_perturbation(self):
        with pytest.raises(ValueError, match="invalid perturbation"):
            Manifest.parse(
                "[node.a]\nperturb = ['meteor-strike']\n"
            )

    def test_disconnect_perturbation_accepted(self):
        m = _same_as_the_references("[node.a]\nperturb = ['disconnect']\n")
        assert m.nodes["a"].perturb == ["disconnect"]

    def test_rejects_bad_mode(self):
        with pytest.raises(ValueError, match="invalid mode"):
            Manifest.parse("[node.a]\nmode = 'seed'\n")

    def test_rejects_empty(self):
        with pytest.raises(ValueError, match="no nodes"):
            Manifest.parse("[testnet]\nchain_id='x'\n")

    def test_rejects_no_validators(self):
        with pytest.raises(ValueError, match="at least one validator"):
            Manifest.parse("[node.a]\nmode = 'full'\n")

    def test_ci_manifest_parses(self):
        path = os.path.join(REPO, "tendermint_tpu_torch", "e2e", "networks", "ci.toml")
        m = Manifest.load(path)
        assert len(m.nodes) == 5
        assert m.nodes["full0"].start_at == 4
        with open(os.path.join(REPO, "tendermint_tpu", "e2e", "networks", "ci.toml")) as fh:
            assert open(path).read() == fh.read()  # the reference's network, perturbations included
        assert dataclasses.asdict(m) == dataclasses.asdict(JManifest.load(path))

    def test_the_runner_spawns_the_ports_nodes_on_its_device(self, tmp_path, monkeypatch):
        """The held divergence: no CPU pin in the children's environment;
        each ``start`` gets the runner's ``--device`` (default CUDA)."""
        spawned = []

        class Proc:
            def __init__(self, argv, **kw):
                spawned.append((argv, kw["env"]))

            def poll(self):
                return None

        monkeypatch.setattr(runner_mod.subprocess, "Popen", Proc)
        monkeypatch.setenv("JAX_PLATFORMS", "tpu")
        m = Manifest.parse("[node.a]\n[node.b]\n")
        for device in ("cuda", "cpu"):
            kw = {} if device == "cuda" else {"device": "cpu"}
            r = Runner(m, str(tmp_path / device), log=lambda *_: None, **kw)
            r.setup()
            spawned.clear()
            r._spawn(r.nodes["a"])
            (argv, env), = spawned
            assert argv[1:] == ["-m", "tendermint_tpu_torch", "--home", r.nodes["a"].home, "start",
                                "--device", device]
            assert env["JAX_PLATFORMS"] == "tpu"  # passed through, never pinned
            assert env["PYTHONPATH"].split(os.pathsep)[0] == REPO


class TestRunnerLifecycle:
    def test_three_validators_with_kill(self, tmp_path):
        manifest = Manifest.parse(
            """
[testnet]
chain_id = "e2e-pytest"
load_tx_per_sec = 3.0
wait_heights = 4

[node.validator0]

[node.validator1]
perturb = ["kill"]

[node.validator2]
perturb = ["disconnect"]
"""
        )
        events = []
        runner = Runner(manifest, str(tmp_path), log=events.append, device="cpu")
        runner.run()  # raises E2EError on any stage/invariant failure
        joined = "\n".join(events)
        assert "perturb: kill validator1" in joined
        assert "recovered" in joined
        assert "invariants ok" in joined
        assert not runner.failures
        assert [(n, p) for n, p, _ in runner.recoveries] == [("validator1", "kill"), ("validator2", "disconnect")]


class TestExternalAppTransports:
    def test_testnet_with_grpc_and_socket_apps(self, tmp_path):
        """A 4-validator testnet where one node's app is out-of-process
        behind the gRPC transport and another behind the socket
        transport — the runner spawns and supervises the app processes
        and consensus proceeds across all of them (4 validators keep
        >2/3 power through any single slow node, the suite's load
        profile)."""
        manifest = Manifest.parse(
            """
[testnet]
chain_id = "e2e-transports"
load_tx_per_sec = 2.0
wait_heights = 3

[node.validator0]

[node.validator1]
proxy_app = "grpc"

[node.validator2]
proxy_app = "tcp"

[node.validator3]
"""
        )
        events = []
        runner = Runner(manifest, str(tmp_path), log=events.append, device="cpu")
        runner.run()
        joined = "\n".join(events)
        assert "invariants ok" in joined
        assert not runner.failures


class TestExternalSigners:
    def test_testnet_with_remote_and_grpc_signers(self, tmp_path):
        """One validator's key lives in a dialing socket signer process,
        another's in a serving gRPC signer process; the runner spawns
        and supervises both and consensus proceeds, including across a
        kill of the remote-signed node (the signer redials)."""
        manifest = Manifest.parse(
            """
[testnet]
chain_id = "e2e-signers"
load_tx_per_sec = 2.0
wait_heights = 3

[node.validator0]

[node.validator1]
privval = "remote"
perturb = ["kill"]

[node.validator2]
privval = "grpc"

[node.validator3]
"""
        )
        events = []
        runner = Runner(manifest, str(tmp_path), log=events.append, device="cpu")
        runner.run()
        joined = "\n".join(events)
        assert "invariants ok" in joined
        assert not runner.failures


class TestStateSyncJoin:
    def test_manifest_rejects_statesync_from_genesis(self):
        with pytest.raises(ValueError, match="statesync requires"):
            Manifest.parse("[node.a]\nstatesync = true\n")

    def test_late_joiner_statesyncs_in(self, tmp_path):
        """A late node joins via snapshot restore + light-verified
        backfill instead of replaying the whole chain: providers take
        app snapshots, the runner resolves the trust anchor from a
        running node's RPC at join time (the reference runner's flow),
        and the joiner converges with everyone else."""
        manifest = Manifest.parse(
            """
[testnet]
chain_id = "e2e-statesync"
load_tx_per_sec = 2.0
wait_heights = 4

[node.validator0]
snapshot_interval = 4

[node.validator1]
snapshot_interval = 4

[node.validator2]
snapshot_interval = 4

[node.joiner]
mode = "full"
start_at = 12
statesync = true
"""
        )
        events = []
        runner = Runner(manifest, str(tmp_path), log=events.append, device="cpu")
        runner.run()
        joined = "\n".join(events)
        assert "(statesync)" in joined
        assert "invariants ok" in joined
        assert not runner.failures
        # the joiner must NOT have replayed the whole chain: its block
        # store starts at the snapshot, not at height 1
        from tendermint_tpu_torch.storage import open_db

        db = open_db("filedb", str(tmp_path / "joiner" / "data"), "blockstore")
        try:
            from tendermint_tpu_torch.storage.blockstore import BlockStore

            bs = BlockStore(db)
            assert bs.base() > 1, f"joiner block store base {bs.base()}"
        finally:
            db.close()

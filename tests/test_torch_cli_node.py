"""The port's operator CLI node commands and stopped-home tools
(``tendermint_tpu_torch/cli.py``) on the CPU: the twins of
``tests/test_cli.py``'s ``TestInitAndKeys``, ``TestNodeLifecycle``,
``TestRollback``, ``TestDebugTools`` and ``test_key_migrate_roundtrip``.

Nodes run as ``python -m tendermint_tpu_torch --home H start --device
cpu`` processes; the stopped-home tools run in process through
``cli.main``. Across the packages: a home that the JAX package's
``init`` wrote starts under the port and commits; the port's
``rollback`` of a home whose stores the JAX package wrote leaves the
same store bytes as the JAX ``rollback`` of a copy; both ``wal2json``
print the same records. The held divergences (ROADMAP §C): ``start``
never runs on the CPU by itself (no card and no ``--device cpu``: exit 1
with ``resolve_device``'s error); the port's default home is its own.

Every wait is on something observable (a height or a route over the
RPC, a bound port) under a deadline, and fails early with the process's
output when the process has exited.
"""

import base64
import hashlib
import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import tarfile
import time
import urllib.request

import pytest

pytest.importorskip("torch")

import tendermint_tpu_torch
from tendermint_tpu.cli import main as jax_cli
from tendermint_tpu.config import Config as JConfig
from tendermint_tpu_torch import cli
from tendermint_tpu_torch.config import Config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT_S = 90.0


def _run(args) -> int:
    return cli.main(args)


def _free_ports(n):
    socks = []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def _consecutive_free_base(n):
    """A base port with ``n`` consecutive ports that all bind now."""
    for _ in range(50):
        base = _free_ports(1)[0]
        if base + n >= 65000:
            continue
        socks = []
        try:
            for p in range(base, base + n):
                s = socket.socket()
                socks.append(s)
                s.bind(("127.0.0.1", p))
            return base
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    pytest.fail(f"no {n} consecutive free ports")


def _rpc(port, method, params=None, timeout=3.0):
    body = json.dumps({"jsonrpc": "2.0", "id": 1, "method": method, "params": params or {}}).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}", body, {"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        doc = json.load(resp)
    if "error" in doc:
        raise RuntimeError(doc["error"])
    return doc["result"]


def _height(port) -> int:
    return int(_rpc(port, "status")["sync_info"]["latest_block_height"])


def _output(proc) -> str:
    with open(proc.log_path) as fh:
        return fh.read()


def _wait(cond, what, procs=(), timeout=WAIT_S):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        for p in procs:
            if p.poll() is not None:
                pytest.fail(f"{what}: the process exited rc={p.returncode}:\n{_output(p)[-3000:]}")
        try:
            if cond():
                return
        except Exception:
            pass
        time.sleep(0.2)
    logs = "".join(f"\n--- {p.args[-4:]}:\n{_output(p)[-2000:]}" for p in procs)
    pytest.fail(f"{what}: not within {timeout} s{logs}")


def _spawn(home, *args, command=("start", "--device", "cpu")):
    log_path = os.path.join(os.path.dirname(home), os.path.basename(home) + f"-{time.monotonic_ns()}.log")
    # one intra-op thread: the plain kernels' small tensors gain nothing
    # from more, and several node processes share the test machine
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(p for p in (REPO, os.environ.get("PYTHONPATH", "")) if p))
    with open(log_path, "w") as log:
        proc = subprocess.Popen([sys.executable, "-m", "tendermint_tpu_torch", "--home", home, *command, *args],
                                cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT)
    proc.log_path = log_path
    return proc


def _stop(*procs):
    """SIGTERM each, then wait; a process that outlives the wait is
    killed, and the test fails after every one is gone. The exit code
    (the first one's, or all of them)."""
    for p in procs:
        if p.poll() is None:
            p.send_signal(signal.SIGTERM)
    hung = []
    for p in procs:
        try:
            p.wait(timeout=30)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait(timeout=10)
            hung.append(p)
    if hung:
        pytest.fail("did not stop on SIGTERM:" + "".join(f"\n--- {p.args[-4:]}:\n{_output(p)[-2000:]}" for p in hung))
    rcs = [p.returncode for p in procs]
    return rcs[0] if len(rcs) == 1 else rcs


def _fast_genesis(home, jax=False):
    """Shrink consensus timeouts for test speed (operators tune these via
    genesis consensus_params; tests are just an aggressive operator)."""
    if jax:
        from tendermint_tpu.types.genesis import GenesisDoc
        from tendermint_tpu.types.params import TimeoutParams
    else:
        from tendermint_tpu_torch.types.genesis import GenesisDoc
        from tendermint_tpu_torch.types.params import TimeoutParams
    path = Config(home=home).genesis_file()
    doc = GenesisDoc.from_file(path)
    doc.consensus_params.timeout = TimeoutParams(propose=0.6, propose_delta=0.2, vote=0.3, vote_delta=0.1, commit=0.1)
    doc.save_as(path)


def _set_ports(home, cfg_cls=Config) -> int:
    """Free p2p and RPC ports in the home's config; the RPC port."""
    p2p, rpc = _free_ports(2)
    cfg = cfg_cls.load(home)
    cfg.p2p.laddr = f"127.0.0.1:{p2p}"
    cfg.rpc.laddr = f"127.0.0.1:{rpc}"
    cfg.save()
    return rpc


def _inspect(home, capsys) -> dict:
    capsys.readouterr()
    assert _run(["--home", home, "inspect"]) == 0
    return json.loads(capsys.readouterr().out)


def _copy(src, dst) -> str:
    shutil.copytree(src, dst, ignore=shutil.ignore_patterns("*.lock"))
    return str(dst)


TX = b"reidx=1"


@pytest.fixture(scope="module")
def chain_home(tmp_path_factory):
    """One port node from ``init``, started from the shell: it commits a
    tx, answers ``debug dump`` while it runs, and stops on SIGTERM. The
    tests work on copies of its stopped home."""
    tmp = tmp_path_factory.mktemp("cli-node")
    home = str(tmp / "n0")
    assert _run(["--home", home, "init", "--chain-id", "cli-one"]) == 0
    _fast_genesis(home)
    rpc = _set_ports(home)
    proc = _spawn(home)
    dump = str(tmp / "dump.tgz")
    try:
        _wait(lambda: _height(rpc) >= 2, "height 2", [proc])
        _rpc(rpc, "broadcast_tx_sync", {"tx": base64.b64encode(TX).decode()})
        tx_hash = hashlib.sha256(TX).hexdigest()
        _wait(lambda: _rpc(rpc, "tx", {"hash": "0x" + tx_hash}), "the tx committed", [proc])
        tx_height = int(_rpc(rpc, "tx", {"hash": "0x" + tx_hash})["height"])
        _wait(lambda: _height(rpc) >= tx_height + 2, "two heights past the tx", [proc])
        dump_rc = _run(["--home", home, "debug", "dump", "--rpc", f"http://127.0.0.1:{rpc}", "-o", dump])
    finally:
        rc = _stop(proc)
    return {"home": home, "rc": rc, "output": _output(proc), "dump": dump, "dump_rc": dump_rc,
            "tx_height": tx_height}


# --- init and keys ---------------------------------------------------------------------


class TestInitAndKeys:
    def test_init_creates_layout(self, tmp_path):
        home = str(tmp_path / "h")
        assert _run(["--home", home, "init", "--chain-id", "c1"]) == 0
        cfg = Config(home=home)
        for path in (cfg.config_file(), cfg.genesis_file(), cfg.node_key_file(), cfg.privval_key_file()):
            assert os.path.exists(path), path
        # refuses to clobber without --force
        assert _run(["--home", home, "init"]) == 1
        assert _run(["--home", home, "init", "--force"]) == 0
        # the reference's defaults: file DB, the RPC listener, the kv index
        cfg = Config.load(home)
        assert (cfg.base.db_backend, cfg.rpc.laddr, cfg.indexer.sinks) == ("filedb", "127.0.0.1:26657", ["kv"])
        assert open(cfg.config_file()).read() == JConfig(home=home).to_toml()

    def test_show_commands(self, tmp_path, capsys):
        home = str(tmp_path / "h")
        _run(["--home", home, "init"])
        capsys.readouterr()  # drain init output
        assert _run(["--home", home, "show-node-id"]) == 0
        node_id = capsys.readouterr().out.strip()
        assert len(node_id) == 40
        assert _run(["--home", home, "show-validator"]) == 0
        doc = json.loads(capsys.readouterr().out)
        assert doc["type"] == "ed25519" and doc["value"]
        # the JAX package reads the same identity from the same files
        assert jax_cli(["--home", home, "show-node-id"]) == 0
        assert capsys.readouterr().out.strip() == node_id
        assert jax_cli(["--home", home, "show-validator"]) == 0
        assert json.loads(capsys.readouterr().out) == doc

    def test_unsafe_reset_keeps_keys(self, tmp_path):
        home = str(tmp_path / "h")
        _run(["--home", home, "init"])
        cfg = Config(home=home)
        key_before = open(cfg.privval_key_file()).read()
        marker = os.path.join(cfg.data_dir(), "junk.db")
        open(marker, "w").write("x")
        assert _run(["--home", home, "unsafe-reset-all"]) == 0
        assert not os.path.exists(marker)
        assert open(cfg.privval_key_file()).read() == key_before

    def test_start_without_init_errors(self, tmp_path):
        assert _run(["--home", str(tmp_path / "nope"), "start", "--device", "cpu"]) == 1

    def test_the_default_home_is_the_ports_own(self, monkeypatch):
        from tendermint_tpu import cli as jcli

        monkeypatch.setenv("TMHOME", "/elsewhere")
        assert cli.DEFAULT_HOME == os.path.expanduser("~/.tendermint_tpu_torch") != jcli.DEFAULT_HOME
        assert cli.build_parser().parse_args(["init"]).home == cli.DEFAULT_HOME
        assert cli.build_parser().parse_args(["--home", "/h", "start"]).home == "/h"


def test_start_with_no_card_and_no_device_cpu_exits_non_zero(tmp_path, monkeypatch, capsys):
    """The held divergence: ``start`` runs on the card unless told
    ``--device cpu``, and never moves to the CPU by itself."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(tendermint_tpu_torch, "DEFAULT_DEVICE", "cuda")
    home = str(tmp_path / "h")
    _run(["--home", home, "init"])
    capsys.readouterr()
    assert _run(["--home", home, "start"]) == 1
    err = capsys.readouterr().err
    assert "device 'cuda' requested but torch.cuda.is_available() is False" in err
    assert tendermint_tpu_torch.DEFAULT_DEVICE == "cuda"
    assert _run(["--home", home, "replay"]) == 1
    assert "torch.cuda.is_available() is False" in capsys.readouterr().err


@pytest.fixture
def signals_restored():
    saved = {s: signal.getsignal(s) for s in (signal.SIGINT, signal.SIGTERM)}
    yield
    for s, handler in saved.items():
        signal.signal(s, handler)


def test_a_failed_node_prints_its_error_and_exits_1(tmp_path, monkeypatch, capsys, signals_restored):
    """``Node.failed`` (a device error among them) ends ``start`` with 1,
    and ``stop()`` raising the same error does not turn it into a
    traceback."""
    fault = RuntimeError("CUDA error 719 (sticky): unspecified launch failure")

    class FailingNode:
        node_key = type("K", (), {"node_id": "ab" * 20})()
        height = 3
        failed = None

        def start(self):
            self.failed = fault

        def stop(self):
            raise fault

    home = str(tmp_path / "h")
    _run(["--home", home, "init"])
    monkeypatch.setattr(tendermint_tpu_torch, "DEFAULT_DEVICE", "cuda")
    monkeypatch.setattr(cli, "_build_node", lambda cfg: FailingNode())
    capsys.readouterr()
    assert _run(["--home", home, "start", "--device", "cpu"]) == 1
    out = capsys.readouterr()
    assert "device cpu" in out.out
    assert out.err.count("error: CUDA error 719") == 1
    assert tendermint_tpu_torch.DEFAULT_DEVICE == "cpu"


# --- node lifecycle ----------------------------------------------------------------------


class TestNodeLifecycle:
    def test_single_node_commits_and_persists(self, chain_home, tmp_path, capsys):
        assert chain_home["rc"] == 0, chain_home["output"][-3000:]  # SIGTERM stops it with 0
        assert "started (p2p 127.0.0.1:" in chain_home["output"] and "device cpu" in chain_home["output"]
        # stores survived shutdown: inspect sees the committed chain
        doc = _inspect(_copy(chain_home["home"], tmp_path / "h"), capsys)
        assert doc["latest_block_height"] >= 3
        assert doc["chain_id"] == "cli-one"

    def test_four_process_testnet_commits(self, tmp_path):
        out_dir = str(tmp_path / "tn")
        base = _consecutive_free_base(8)
        assert _run(["testnet", "-v", "4", "-o", out_dir, "--chain-id", "cli-tn", "--starting-port", str(base)]) == 0
        homes = [os.path.join(out_dir, f"node{i}") for i in range(4)]
        for home in homes:
            _fast_genesis(home)
        procs = [_spawn(h) for h in homes]
        try:
            for i in range(4):
                _wait(lambda i=i: _height(base + 2 * i + 1) >= 2, f"node{i} at height 2", procs)
        finally:
            rcs = _stop(*procs)
        assert rcs == [0] * 4

    def test_a_home_the_jax_init_wrote_starts_under_the_port_and_commits(self, tmp_path, capsys):
        home = str(tmp_path / "jax-made")
        assert jax_cli(["--home", home, "init", "--chain-id", "jax-made"]) == 0
        _fast_genesis(home, jax=True)
        rpc = _set_ports(home, JConfig)
        proc = _spawn(home)
        try:
            _wait(lambda: _height(rpc) >= 2, "height 2", [proc])
        finally:
            assert _stop(proc) == 0
        doc = _inspect(home, capsys)
        assert doc["chain_id"] == "jax-made" and doc["state_height"] >= 2
        # the JAX package reads the port node's stores back
        assert jax_cli(["--home", home, "inspect"]) == 0
        assert json.loads(capsys.readouterr().out) == doc


# --- rollback -------------------------------------------------------------------------------


class TestRollback:
    def test_rollback_then_restart(self, chain_home, tmp_path, capsys):
        home = _copy(chain_home["home"], tmp_path / "h")
        top = _inspect(home, capsys)["state_height"]
        assert _run(["--home", home, "rollback"]) == 0
        assert _inspect(home, capsys)["state_height"] == top - 1
        # replay pushes the stored blocks back into a fresh app
        assert _run(["--home", home, "replay", "--device", "cpu"]) == 0
        # and the node restarts from the rolled-back home and goes on
        rpc = _set_ports(home)
        proc = _spawn(home)
        try:
            _wait(lambda: _height(rpc) >= top + 1, f"height {top + 1} after the restart", [proc])
        finally:
            assert _stop(proc) == 0

    @pytest.mark.parametrize("hard", [False, True])
    def test_the_ports_rollback_of_a_jax_written_home_equals_the_jax_rollbacks_bytes(self, tmp_path, hard):
        from tests.test_torch_durability import build_chain_homes

        env = build_chain_homes(tmp_path / "src", 6, which=("jax",))["jax"]
        JConfig(home=env["home"]).save()  # the default backend, filedb, as the homes were written
        homes = {pkg: _copy(env["home"], tmp_path / pkg) for pkg in ("port", "jax")}
        flags = ["--hard"] if hard else []
        assert _run(["--home", homes["port"], "rollback", *flags]) == 0
        assert jax_cli(["--home", homes["jax"], "rollback", *flags]) == 0
        for name in ("state.fdb", "blockstore.fdb"):
            with open(os.path.join(homes["port"], "data", name), "rb") as a, \
                    open(os.path.join(homes["jax"], "data", name), "rb") as b:
                assert a.read() == b.read(), name


# --- the stopped-home tools ---------------------------------------------------------------


class TestDebugTools:
    def test_wal2json(self, tmp_path, capsys):
        from tendermint_tpu.consensus.wal import WAL as JWAL
        from tendermint_tpu_torch.consensus.wal import WAL, EndHeightMessage, TimeoutInfo

        path = str(tmp_path / "cs.wal")
        w = WAL(path)
        w.start()
        w.write(TimeoutInfo(0.5, 3, 1, 2))
        w.write_sync(EndHeightMessage(3))
        w.stop()
        assert _run(["wal2json", path]) == 0
        out = capsys.readouterr().out
        lines = [json.loads(s) for s in out.splitlines()]
        assert [d["type"] for d in lines] == ["TimeoutInfo", "EndHeightMessage"]
        assert lines[0]["height"] == 3 and lines[0]["round"] == 1
        assert lines[1]["height"] == 3
        # the JAX package decodes the same records from the same file
        assert len(list(JWAL(path).iter_messages())) == 2
        assert jax_cli(["wal2json", path]) == 0
        assert capsys.readouterr().out == out

    def test_wal2json_of_a_missing_file_is_an_error(self, tmp_path, capsys):
        assert _run(["wal2json", str(tmp_path / "nope.wal")]) == 1
        assert "error:" in capsys.readouterr().err

    def test_abci_cli_against_socket_app(self, tmp_path, capsys):
        port = _free_ports(1)[0]
        proc = subprocess.Popen([sys.executable, "-m", "tendermint_tpu_torch.abci.socket_server",
                                 "--addr", f"127.0.0.1:{port}"], cwd=REPO)
        try:
            def bound():
                socket.create_connection(("127.0.0.1", port), 1).close()
                return True

            deadline = time.monotonic() + 30
            while time.monotonic() < deadline:
                assert proc.poll() is None, "the socket app exited"
                try:
                    if bound():
                        break
                except OSError:
                    time.sleep(0.1)
            else:
                pytest.fail("socket app never came up")
            addr = f"tcp://127.0.0.1:{port}"
            assert _run(["abci", "echo", "ping!", "--addr", addr]) == 0
            assert capsys.readouterr().out.strip() == "ping!"
            assert _run(["abci", "info", "--addr", addr]) == 0
            doc = json.loads(capsys.readouterr().out)
            assert doc["last_block_height"] == 0
            assert _run(["abci", "check-tx", "a=b", "--addr", addr]) == 0
            assert json.loads(capsys.readouterr().out)["code"] == 0
            assert _run(["abci", "query", "a", "--addr", addr]) == 0
            assert "log" in json.loads(capsys.readouterr().out)
        finally:
            proc.terminate()
            proc.wait(timeout=10)

    def test_compact_db(self, tmp_path):
        from tendermint_tpu_torch.storage import open_db

        home = str(tmp_path / "h")
        data = os.path.join(home, "data")
        os.makedirs(data)
        os.makedirs(os.path.join(home, "config"))
        db = open_db("filedb", data, "bloat")
        for _ in range(300):
            db.set(b"k", b"v" * 100)  # 299 dead versions
        db.set(b"other", b"live")
        db.close()
        before = os.path.getsize(os.path.join(data, "bloat.fdb"))
        assert _run(["--home", home, "compact-db"]) == 0
        after = os.path.getsize(os.path.join(data, "bloat.fdb"))
        assert after < before / 10
        db = open_db("filedb", data, "bloat")
        assert db.get(b"k") == b"v" * 100
        assert db.get(b"other") == b"live"
        db.close()

    def test_inspect_serve(self, chain_home, tmp_path):
        """inspect --serve: read-only RPC over a stopped node's stores
        (internal/inspect/inspect.go:31)."""
        home = _copy(chain_home["home"], tmp_path / "h")
        iport = _free_ports(1)[0]
        srv = _spawn(home, command=("inspect", "--serve", f"127.0.0.1:{iport}"))
        try:
            _wait(lambda: _rpc(iport, "block", {"height": 2}), "the inspect server", [srv])
            assert int(_rpc(iport, "block", {"height": 2})["block"]["header"]["height"]) == 2
            assert _rpc(iport, "validators", {"height": 2})["count"] == "1"
            found = _rpc(iport, "tx_search", {"query": "tx.height = %d" % chain_home["tx_height"]})
            assert [base64.b64decode(t["tx"]) for t in found["txs"]] == [TX]
            with pytest.raises(RuntimeError):
                _rpc(iport, "broadcast_tx_sync", {"tx": base64.b64encode(b"x=1").decode()})  # read-only
        finally:
            assert _stop(srv) == 0

    def test_reindex_event_rebuilds_lost_index(self, chain_home, tmp_path):
        """commands/reindex_event.go: wipe the tx index of a stopped
        node, rebuild it from stored blocks + persisted FinalizeBlock
        responses, and find the committed tx again."""
        from tendermint_tpu_torch.indexer import KVIndexer
        from tendermint_tpu_torch.storage import open_db

        home = _copy(chain_home["home"], tmp_path / "h")
        data = os.path.join(home, "data")
        before = {f: open(os.path.join(data, f), "rb").read() for f in os.listdir(data) if f.startswith("tx_index")}
        for f in before:
            os.unlink(os.path.join(data, f))
        assert _run(["--home", home, "reindex-event"]) == 0
        db = open_db("filedb", data, "tx_index")
        try:
            tr = KVIndexer(db).get_tx(hashlib.sha256(TX).digest())
            assert tr is not None and tr.tx == TX and tr.height == chain_home["tx_height"]
        finally:
            db.close()

    def test_confix_migrates_schema(self, tmp_path, capsys):
        home = str(tmp_path / "h")
        _run(["--home", home, "init", "--chain-id", "cfx"])
        capsys.readouterr()
        path = Config(home=home).config_file()
        text = open(path).read()
        text = text.replace('log_level = "info"\n', "")  # missing new key
        text = text.replace("[p2p]", "obsolete_flag = true\n\n[p2p]", 1)  # dead key
        open(path, "w").write(text)
        assert _run(["--home", home, "confix", "--dry-run"]) == 0
        out = capsys.readouterr().out
        assert "obsolete_flag" in out and "log_level" in out
        assert 'log_level = "info"' not in open(path).read()  # not rewritten
        assert _run(["--home", home, "confix"]) == 0
        capsys.readouterr()
        migrated = open(path).read()
        assert 'log_level = "info"' in migrated
        assert "obsolete_flag" not in migrated
        assert os.path.exists(path + ".bak")
        # idempotent
        assert _run(["--home", home, "confix"]) == 0
        assert "already matches" in capsys.readouterr().out
        # node still starts from the migrated config
        loaded = Config.load(home)
        assert loaded.base.log_level == "info"

    def test_debug_dump_against_a_running_node(self, chain_home):
        assert chain_home["dump_rc"] == 0
        with tarfile.open(chain_home["dump"]) as tar:
            names = set(tar.getnames())
            status = json.load(tar.extractfile("dump/status.json"))
            metrics = tar.extractfile("dump/metrics.prom").read().decode()
        assert {"dump/dump_consensus_state.json", "dump/net_info.json", "dump/home/config.toml",
                "dump/home/genesis.json", "dump/home/cs.wal"} <= names
        assert status["node_info"]["network"] == "cli-one"
        assert int(status["sync_info"]["latest_block_height"]) >= chain_home["tx_height"] + 2
        assert "tendermint_consensus_height" in metrics


def test_key_migrate_roundtrip(tmp_path):
    """key-migrate re-encodes every store into a fresh backend dir and
    the migrated stores contain identical data (scripts/keymigrate
    analog over this tree's backend seam)."""
    from tendermint_tpu_torch.storage import open_db

    home = str(tmp_path / "mig")
    assert _run(["--home", home, "init", "--chain-id", "mig-chain"]) == 0
    # put some data in a store the migrated dir must reproduce
    data_dir = os.path.join(home, "data")
    db = open_db("filedb", data_dir, "state")
    for i in range(100):
        db.set(b"k%03d" % i, b"v%d" % i)
    db.close()

    assert _run(["--home", home, "key-migrate", "--to-backend", "filedb-py"]) == 0
    out_dir = data_dir + "-migrated"
    assert os.path.isdir(out_dir)
    src = open_db("filedb", data_dir, "state")
    dst = open_db("filedb-py", out_dir, "state")
    src_kv = list(src.iterator())
    dst_kv = list(dst.iterator())
    assert src_kv == dst_kv and len(dst_kv) >= 100
    src.close()
    dst.close()
    # a stale output dir is refused
    assert _run(["--home", home, "key-migrate", "--to-backend", "filedb-py"]) == 1


def test_key_migrate_of_a_chain_home_inspects_alike(chain_home, tmp_path, capsys):
    home = _copy(chain_home["home"], tmp_path / "h")
    assert _run(["--home", home, "key-migrate", "--to-backend", "filedb-py"]) == 0
    copy = str(tmp_path / "migrated")
    os.makedirs(os.path.join(copy, "config"))
    shutil.copytree(os.path.join(home, "data") + "-migrated", os.path.join(copy, "data"))
    cfg = Config.load(home)
    cfg.home = copy
    cfg.base.db_backend = "filedb-py"
    cfg.save()
    assert _inspect(copy, capsys) == _inspect(home, capsys)

"""The port stands alone: no jax, nothing of the JAX package, and no
silent move of device work to the CPU."""

import ast
import contextlib
import os
import re
import subprocess
import sys
import types

import pytest

torch = pytest.importorskip("torch")
# The plain versions run thousands of tiny tensor ops: one intra-op thread
# is fastest, and keeps parallel test workers from oversubscribing cores.
torch.set_num_threads(1)

import tendermint_tpu_torch
from tendermint_tpu_torch.crypto import batch as tbatch
from tendermint_tpu_torch.ops import cuda_hash, cuda_verify, verify_batch
from tendermint_tpu_torch.types import validation as tval

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "tendermint_tpu_torch")
ALLOWED_ROOTS = {"torch", "numpy", "tendermint_tpu_torch"}


def _port_files():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PKG):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _port_modules():
    mods = []
    for path in _port_files():
        if not path.startswith(PKG + os.sep):
            continue
        rel = os.path.relpath(path, REPO)[: -len(".py")].split(os.sep)
        if rel[-1] == "__init__":
            rel = rel[:-1]
        mods.append(".".join(rel))
    return mods


def test_every_module_imports_without_jax_or_the_jax_package():
    mods = _port_modules()
    assert "tendermint_tpu_torch.ops.cuda_verify" in mods and len(mods) >= 15
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['jaxlib'] = None\n"
        "import importlib\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m == 'tendermint_tpu' or m.startswith('tendermint_tpu.'))\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: os.path.relpath(p, REPO))
def test_imports_are_torch_numpy_and_the_standard_library(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), filename=path)
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    assert not roots & {"jax", "jaxlib", "tendermint_tpu"}
    foreign = roots - ALLOWED_ROOTS - set(sys.stdlib_module_names)
    assert not foreign, f"{path} imports {sorted(foreign)}"


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(tendermint_tpu_torch, "DEFAULT_DEVICE", "cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _lanes(n=16):
    from tendermint_tpu_torch.crypto import ed25519_ref as ref

    priv, pub = ref.keypair_from_seed(b"\x07" * 32)
    msgs = [b"m%d" % i for i in range(n)]
    return [pub] * n, msgs, [ref.sign(priv, m) for m in msgs]


def test_cuda_default_entry_points_raise_without_cuda(no_cuda):
    pks, msgs, sigs = _lanes()
    with pytest.raises(RuntimeError, match="cuda"):
        verify_batch(pks, msgs, sigs)
    with pytest.raises(RuntimeError, match="cuda"):
        tbatch.Ed25519BatchVerifier()
    with pytest.raises(RuntimeError, match="cuda"):
        tbatch.tiered_verify_ed25519(pks, msgs, sigs)
    with pytest.raises(RuntimeError, match="cuda"):
        tval.verify_commit("c", None, None, 1, None)
    with pytest.raises(RuntimeError, match="cuda"):
        tval.verify_commit_light("c", None, None, 1, None)
    # An explicit CPU request is honoured.
    assert verify_batch(pks[:2], msgs[:2], sigs[:2], device="cpu") == [True, True]


def test_explicit_cuda_raises_and_unknown_devices_are_refused(no_cuda):
    with pytest.raises(RuntimeError, match="cuda"):
        verify_batch([b"\x00" * 32], [b""], [b"\x00" * 64], device="cuda")
    with pytest.raises(ValueError):
        verify_batch([b"\x00" * 32], [b""], [b"\x00" * 64], device="meta")


def test_kernel_wrappers_raise_instead_of_falling_back(monkeypatch):
    """Off the CPU a wrapper launches its kernel or raises: a failed
    build or a refused launch is never answered by the plain version."""
    fake = torch.zeros((4, 32), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_verify.verify(fake, fake, fake, fake)
    store = torch.zeros((8, 4, 32, 3), dtype=torch.uint8, device="meta")
    ok = torch.zeros(4, dtype=torch.uint8, device="meta")
    idx = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_verify.verify_resident(store, idx, ok, fake, fake, fake)
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_hash.challenge(torch.zeros((4, 128), dtype=torch.uint8, device="meta"))

    def failed_build(stem):
        raise RuntimeError(f"nvcc failed for {stem}.cu")

    monkeypatch.setattr(cuda_verify._build, "load", failed_build)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        cuda_verify._launcher("ed25519_verify_launch")
    with pytest.raises(RuntimeError, match="nvcc failed for sha512_challenge"):
        cuda_hash._launcher("sha512_challenge_launch")

    refused = lambda name: (lambda *args: 2)
    monkeypatch.setattr(cuda_verify, "_launcher", refused)
    monkeypatch.setattr(cuda_hash, "_launcher", refused)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(
        torch.cuda, "current_stream", lambda dev: types.SimpleNamespace(cuda_stream=0)
    )
    rows = torch.zeros((4, 32), dtype=torch.uint8)
    cpu = torch.device("cpu")
    before = (dict(cuda_verify.LAUNCHES), dict(cuda_hash.LAUNCHES))
    with pytest.raises(RuntimeError, match="CUDA error 2"):
        cuda_verify._launch("ed25519_verify_launch", "verify", (rows,) * 4, 4, cpu)
    with pytest.raises(RuntimeError, match="CUDA error 2"):
        cuda_verify._launch(
            "ed25519_verify_resident_launch", "verify_resident", (rows,) * 6, 4, cpu, 3
        )
    with pytest.raises(RuntimeError, match="CUDA error 2"):
        cuda_hash._run("sha512_challenge_launch", "challenge", (0, 1, 4, None, 0, 4), cpu)
    # a refused launch is not counted
    assert (cuda_verify.LAUNCHES, cuda_hash.LAUNCHES) == before


def test_kernel_attributes_name_every_field_and_raise_on_error(monkeypatch):
    """kernel_attributes gives each slot the C function writes its key,
    and a CUDA error raises."""
    for src in ("ed25519_verify.cu", "sha512_challenge.cu"):
        with open(os.path.join(PKG, "csrc", src)) as fh:
            written = sorted({int(i) for i in re.findall(r"out\[(\d)\] =", fh.read())})
        assert written == list(range(len(cuda_verify.ATTRIBUTE_KEYS))), src

    def fake(which, buf):
        for i in range(len(cuda_verify.ATTRIBUTE_KEYS)):
            buf[i] = 10 * which + i
        return 0

    monkeypatch.setattr(cuda_verify, "_launcher", lambda name: fake)
    got = cuda_verify.kernel_attributes()
    assert got["verify"]["registers"] == 0 and got["verify_tables"]["registers"] == 10
    assert got["verify_tables"]["resident_blocks_per_sm"] == 15
    assert got["verify_resident"]["registers"] == 20
    monkeypatch.setattr(cuda_hash, "_launcher", lambda name: (lambda buf: fake(3, buf)))
    assert cuda_hash.challenge_attributes()["threads_per_block"] == 33
    monkeypatch.setattr(cuda_verify, "_launcher", lambda name: (lambda which, buf: 98))
    with pytest.raises(RuntimeError, match="CUDA error 98"):
        cuda_verify.kernel_attributes()
    monkeypatch.setattr(cuda_hash, "_launcher", lambda name: (lambda buf: 98))
    with pytest.raises(RuntimeError, match="CUDA error 98"):
        cuda_hash.challenge_attributes()


def test_the_sr25519_and_health_modules_are_among_those_checked():
    """The modules of the sr25519 engine and the health machine stand
    alone too: the import checks above walk them."""
    mods = _port_modules()
    for mod in ("crypto.merlin", "crypto.ristretto", "crypto.sr25519", "ops.sr25519_batch",
                "ops.device_policy", "ops.fault_injection"):
        assert f"tendermint_tpu_torch.{mod}" in mods
    files = {os.path.relpath(p, REPO) for p in _port_files()}
    assert os.path.join("tendermint_tpu_torch", "ops", "sr25519_batch.py") in files


def test_sr25519_entry_points_raise_without_cuda(no_cuda):
    from tendermint_tpu_torch.crypto import sr25519 as tsr
    from tendermint_tpu_torch.ops import sr25519_batch as tsb

    with pytest.raises(RuntimeError, match="cuda"):
        tsb.verify_batch_sr([b"\x00" * 32], [b""], [b"\x00" * 64])
    with pytest.raises(RuntimeError, match="cuda"):
        tsr.Sr25519BatchVerifier()
    with pytest.raises(RuntimeError, match="cuda"):
        tbatch.MultiBatchVerifier()
    assert tsb.verify_batch_sr([b"\x00" * 32], [b""], [b"\x00" * 64], device="cpu") == [False]


def test_k5_wrapper_raises_a_typed_error_instead_of_falling_back(monkeypatch):
    fake = torch.zeros((4, 32), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_verify.verify_sr(fake, fake, fake, fake)
    monkeypatch.setattr(cuda_verify, "_launcher", lambda name: (lambda *args: 700))
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(
        torch.cuda, "current_stream", lambda dev: types.SimpleNamespace(cuda_stream=0)
    )
    rows = torch.zeros((4, 32), dtype=torch.uint8)
    before = cuda_verify.LAUNCHES["verify_sr"]
    with pytest.raises(cuda_verify._build.CudaError, match="CUDA error 700") as info:
        cuda_verify._launch("sr25519_verify_launch", "verify_sr", (rows,) * 4, 4, torch.device("cpu"))
    assert info.value.code == 700 and info.value.permanent
    assert cuda_verify.LAUNCHES["verify_sr"] == before


def test_the_light_and_blocksync_modules_are_checked_and_default_to_cuda(no_cuda):
    """The modules of the light client and the blocksync pipeline stand
    alone too, and their entry points raise without CUDA."""
    from tendermint_tpu_torch.light import verifier as tver
    from tendermint_tpu_torch.parallel import pipeline as tpipe
    from tendermint_tpu_torch.types.validation import Fraction

    mods = _port_modules()
    for mod in ("crypto.merkle", "light.verifier", "parallel.pipeline", "types.light",
                "types.carry"):
        assert f"tendermint_tpu_torch.{mod}" in mods
    with pytest.raises(RuntimeError, match="cuda"):
        tval.verify_commit_light_trusting("c", None, None, Fraction(1, 3))
    with pytest.raises(RuntimeError, match="cuda"):
        tpipe.verify_commits_pipelined([])
    for entry, n_args in ((tver.verify_adjacent, 6), (tver.verify_non_adjacent, 7)):
        with pytest.raises(RuntimeError, match="cuda"):
            entry(*[None] * n_args)
    assert tpipe.verify_commits_pipelined([], device="cpu") == []


def test_the_verify_service_modules_are_checked_and_default_to_cuda(no_cuda, capsys):
    """The verify service, its transport and its command line stand
    alone too; the server raises without CUDA unless asked for the CPU,
    and the CLI, as the reference's ``main`` does with such an error,
    prints it and exits 1. No module of the service reads an environment
    knob."""
    from tendermint_tpu_torch import cli
    from tendermint_tpu_torch.verifyd.server import VerifydServer

    mods = _port_modules()
    for mod in ("libs.log", "libs.evloop", "libs.grpc", "verifyd.protocol", "verifyd.server",
                "verifyd.client", "cli", "__main__"):
        assert f"tendermint_tpu_torch.{mod}" in mods
    with pytest.raises(RuntimeError, match="cuda"):
        VerifydServer()
    capsys.readouterr()
    assert cli.main(["verifyd", "--listen", "127.0.0.1:0"]) == 1
    assert "error: tendermint_tpu_torch: device 'cuda' requested" in capsys.readouterr().err
    srv = VerifydServer(device="cpu")
    try:
        assert srv.device == torch.device("cpu") and srv.dyn_batch
    finally:
        srv.stop()
    for rel in ("libs/evloop.py", "libs/grpc.py", "libs/log.py", "verifyd/protocol.py",
                "verifyd/server.py", "verifyd/client.py", "cli.py"):
        with open(os.path.join(PKG, rel)) as fh:
            src = fh.read()
        assert "os.environ" not in src and "getenv" not in src, rel


def test_the_consensus_modules_are_checked_and_default_to_cuda(no_cuda):
    """The state machine, its WAL, ticker, replay and signer stand alone
    too and read no environment knob; the state machine takes no device
    of its own, and the executor under it raises without CUDA."""
    from tendermint_tpu_torch.state import StateStore
    from tendermint_tpu_torch.state.execution import BlockExecutor
    from tendermint_tpu_torch.storage.blockstore import BlockStore
    from tendermint_tpu_torch.storage.kv import MemDB

    mods = _port_modules()
    for mod in ("consensus.state", "consensus.cstypes", "consensus.wal", "consensus.ticker", "consensus.replay",
                "privval", "privval.base", "privval.file_pv", "libs.autofile"):
        assert f"tendermint_tpu_torch.{mod}" in mods
    for rel in ("consensus/state.py", "consensus/cstypes.py", "consensus/wal.py", "consensus/ticker.py",
                "consensus/replay.py", "privval/file_pv.py", "libs/autofile.py"):
        with open(os.path.join(PKG, rel)) as fh:
            src = fh.read()
        assert "os.environ" not in src and "getenv" not in src, rel
    import inspect

    from tendermint_tpu_torch.consensus.state import ConsensusState

    assert "device" not in inspect.signature(ConsensusState).parameters
    with pytest.raises(RuntimeError, match="cuda"):
        BlockExecutor(StateStore(MemDB()), None, BlockStore(MemDB()))


def test_the_rpc_event_and_index_modules_are_checked_and_default_to_cuda(no_cuda):
    """The node's RPC, its event bus and index, the light proxy and the
    HTTP provider stand alone too and read no environment knob; a node
    that serves them raises without CUDA unless asked for the CPU."""
    from tendermint_tpu_torch import cli
    from tendermint_tpu_torch.abci.client import LocalClient
    from tendermint_tpu_torch.abci.kvstore import KVStoreApplication
    from tendermint_tpu_torch.node import Node, NodeConfig
    from tendermint_tpu_torch.types.genesis import GenesisDoc

    mods = _port_modules()
    new = ("libs.pubsub", "eventbus", "indexer", "indexer.kv", "indexer.sink", "rpc.core", "rpc.client",
           "rpc.websocket", "rpc.server", "rpc.encoding", "light.provider", "light.proxy")
    for mod in new:
        assert f"tendermint_tpu_torch.{mod}" in mods
    for rel in ("libs/pubsub.py", "eventbus.py", "indexer/kv.py", "indexer/sink.py", "rpc/core.py", "rpc/client.py",
                "rpc/websocket.py", "rpc/server.py", "light/provider.py", "light/proxy.py", "node/node.py"):
        with open(os.path.join(PKG, rel)) as fh:
            src = fh.read()
        assert "os.environ" not in src and "getenv" not in src, rel
    with pytest.raises(RuntimeError, match="cuda"):
        Node(NodeConfig(rpc_laddr="127.0.0.1:0"), GenesisDoc(chain_id="c"), LocalClient(KVStoreApplication()))
    for command in ("light", "lightd"):
        args = cli.build_parser().parse_args([command, "http://127.0.0.1:9", "--chain-id", "c",
                                              "--trust-height", "1", "--trust-hash", "00" * 32])
        assert args.device is None  # the package's device, CUDA


def test_the_file_store_state_sync_signer_and_abci_transport_modules_are_checked_and_default_to_cuda(
        no_cuda, tmp_path):
    """The file stores, rollback, state sync, the remote signers and the
    out-of-process ABCI transports stand alone too and read no
    environment knob (the native engine's build directory is
    ``ops/_build.py``'s); the state syncer and a node that would state
    sync raise without CUDA unless asked for the CPU."""
    from tendermint_tpu_torch.statesync import StateSyncConfig, StateSyncer

    mods = _port_modules()
    new = ("storage", "storage.filedb", "storage.cfiledb", "state.rollback", "statesync", "statesync.reactor",
           "statesync.syncer", "abci.codec", "abci.socket_server", "abci.socket_client", "abci.grpc_client",
           "abci.grpc_server", "privval.remote", "privval.grpc")
    for mod in new:
        assert f"tendermint_tpu_torch.{mod}" in mods
    for rel in ("storage/__init__.py", "storage/filedb.py", "storage/cfiledb.py", "state/rollback.py",
                "statesync/reactor.py", "statesync/syncer.py", "abci/codec.py", "abci/socket_server.py",
                "abci/socket_client.py", "abci/grpc_client.py", "abci/grpc_server.py", "privval/remote.py",
                "privval/grpc.py"):
        with open(os.path.join(PKG, rel)) as fh:
            src = fh.read()
        assert "os.environ" not in src and "getenv" not in src, rel
    assert os.path.exists(os.path.join(PKG, "native", "filedb.cc"))
    cfg = StateSyncConfig(enabled=True, trust_height=1, trust_hash=b"\x01" * 32)
    with pytest.raises(RuntimeError, match="cuda"):
        StateSyncer(None, None, None, None, None, cfg)
    assert StateSyncer(None, None, None, None, None, cfg, device="cpu").device == torch.device("cpu")

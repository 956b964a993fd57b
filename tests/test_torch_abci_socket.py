"""Out-of-process ABCI apps for the port: the twin of
``tests/test_abci_socket.py`` on ``tendermint_tpu_torch.abci``, the gRPC
transport beside the socket one, and held to the JAX package: the
codec's frames equal the JAX codec's for every request and response of
a seeded run, and a JAX app process serves a port node. Port nodes run
on ``device="cpu"``."""

import os
import re
import signal
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from tendermint_tpu.abci import codec as jcodec
from tendermint_tpu.abci import types as jabci
from tendermint_tpu.abci.kvstore import KVStoreApplication as JKVStoreApplication
from tendermint_tpu_torch.abci import codec
from tendermint_tpu_torch.abci import types as abci
from tendermint_tpu_torch.abci.grpc_client import GrpcClient
from tendermint_tpu_torch.abci.grpc_server import GrpcABCIServer
from tendermint_tpu_torch.abci.kvstore import KVStoreApplication
from tendermint_tpu_torch.abci.socket_client import SocketClient
from tendermint_tpu_torch.abci.socket_server import SocketServer
from tendermint_tpu_torch.node import Node, NodeConfig
from tendermint_tpu_torch.privval import FilePV
from tests.test_torch_node import fast_genesis, port_node_env, wait_for  # noqa: F401 (fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def spawn_app_process(package, db="", transport="socket", snapshot_interval=0):
    """The kvstore app of either package behind its ABCI server, as an OS
    process; returns it and the address it listens on."""
    cmd = [sys.executable, "-m", f"{package}.abci.socket_server", "--addr", "127.0.0.1:0", "--app", "kvstore",
           "--transport", transport, "--snapshot-interval", str(snapshot_interval)]
    if db:
        cmd += ["--db", db]
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
    line = proc.stdout.readline()
    m = re.search(r"listening on ([\d.]+):(\d+)", line)
    assert m, f"no listen line: {line!r}"
    return proc, (m.group(1), int(m.group(2)))


def _kill(proc):
    proc.send_signal(signal.SIGKILL)
    proc.wait(timeout=10)


# --- the codec -------------------------------------------------------------------


def _seeded_calls():
    """Each ABCI method's request, over a seeded kvstore run, in the
    order a node sends them (the statesync four included)."""
    rng = np.random.default_rng(11)
    val = b"val:" + __import__("base64").b64encode(bytes(range(32))) + b"!7"
    txs = [b"k%d=%s" % (i, rng.bytes(8).hex().encode()) for i in range(6)] + [val, b"bad\xff"]
    return [
        ("info", lambda m: m.RequestInfo(version="1", block_version=11, p2p_version=8, abci_version="2")),
        ("init_chain", lambda m: m.RequestInitChain(chain_id="c", initial_height=1)),
        ("check_tx", lambda m: m.RequestCheckTx(tx=txs[0])),
        ("prepare_proposal", lambda m: m.RequestPrepareProposal(max_tx_bytes=1 << 20, txs=txs, height=1)),
        ("process_proposal", lambda m: m.RequestProcessProposal(txs=txs, height=1, hash=b"\x01" * 32)),
        ("extend_vote", lambda m: m.RequestExtendVote(hash=b"\x01" * 32, height=1)),
        ("verify_vote_extension", lambda m: m.RequestVerifyVoteExtension(hash=b"\x01" * 32, height=1)),
        ("finalize_block", lambda m: m.RequestFinalizeBlock(txs=txs, hash=b"\x01" * 32, height=1)),
        ("commit", None),
        ("query", lambda m: m.RequestQuery(path="/key", data=b"k1", height=1)),
        ("list_snapshots", lambda m: m.RequestListSnapshots()),
        ("load_snapshot_chunk", lambda m: m.RequestLoadSnapshotChunk(height=1, format=1, chunk=0)),
        ("offer_snapshot", lambda m: m.RequestOfferSnapshot(snapshot=m.Snapshot(1, 1, 1, b"\x02" * 32), app_hash=b"")),
        ("apply_snapshot_chunk", lambda m: m.RequestApplySnapshotChunk(index=0, chunk=b"{}", sender="p")),
    ]


def test_the_codecs_frames_equal_the_jax_codecs_for_every_request_and_response():
    app, japp = KVStoreApplication(snapshot_interval=1), JKVStoreApplication(snapshot_interval=1)
    assert set(codec.METHODS) == set(jcodec.METHODS)
    seen = set()
    for method, make in _seeded_calls():
        req, jreq = (make(abci), make(jabci)) if make else (None, None)
        for kind, a, b in (("req", req, jreq),):
            assert codec.encode_frame(kind, method, a) == jcodec.encode_frame(kind, method, b), method
        res = getattr(app, method)(req) if req is not None else getattr(app, method)()
        jres = getattr(japp, method)(jreq) if jreq is not None else getattr(japp, method)()
        frame = codec.encode_frame("res", method, res)
        assert frame == jcodec.encode_frame("res", method, jres), method
        # and back: each package decodes the other's frame to its own type
        _, res_cls = codec.METHODS[method]
        kind, type_, body = codec.decode_frame(jcodec.encode_frame("res", method, jres)[4:])
        assert (kind, type_) == ("res", method)
        # (a Timestamp travels as a list and decodes as one, in both)
        back = codec.decode_obj(res_cls, body)
        assert codec.encode_obj(back) == codec.encode_obj(res), method
        if req is not None:
            req_cls, _ = codec.METHODS[method]
            _, _, rbody = codec.decode_frame(jcodec.encode_frame("req", method, jreq)[4:])
            assert codec.encode_obj(codec.decode_obj(req_cls, rbody)) == codec.encode_obj(req), method
        seen.add(method)
    assert seen == set(codec.METHODS)


# --- the transports ----------------------------------------------------------------


@pytest.mark.parametrize("transport", ["socket", "grpc"])
class TestTransport:
    def _serve(self, transport, app):
        server = SocketServer(app) if transport == "socket" else GrpcABCIServer(app)
        server.start()
        host, port = server.address
        client = SocketClient(host, port) if transport == "socket" else GrpcClient(host, port)
        return server, client

    def test_roundtrip_all_methods_in_process(self, transport):
        server, client = self._serve(transport, KVStoreApplication(snapshot_interval=1))
        try:
            client.start()
            assert client.echo("ping") == "ping"
            assert client.info(abci.RequestInfo()).last_block_height == 0
            fres = client.finalize_block(abci.RequestFinalizeBlock(height=1, txs=[b"a=1", b"b=2"]))
            assert [r.code for r in fres.tx_results] == [0, 0]
            assert fres.app_hash
            client.commit()
            info = client.info(abci.RequestInfo())
            assert info.last_block_height == 1 and info.last_block_app_hash == fres.app_hash
            assert client.query(abci.RequestQuery(path="/key", data=b"a")).value == b"1"
            snaps = client.list_snapshots(abci.RequestListSnapshots())
            assert [s.height for s in snaps.snapshots] == [1]
            chunk = client.load_snapshot_chunk(abci.RequestLoadSnapshotChunk(height=1, format=1, chunk=0))
            assert chunk.chunk
            client.stop()
        finally:
            server.stop()

    def test_app_error_surfaces_not_kills_connection(self, transport):
        class Exploding(KVStoreApplication):
            def query(self, req):
                raise RuntimeError("boom")

        server, client = self._serve(transport, Exploding())
        try:
            client.start()
            with pytest.raises(RuntimeError, match="boom"):
                client.query(abci.RequestQuery(path="/key", data=b"x"))
            assert client.echo("still-alive") == "still-alive"
            client.stop()
        finally:
            server.stop()


class TestOutOfProcessNode:
    def _make_node(self, home, privs, client):
        os.makedirs(home, exist_ok=True)
        cfg = NodeConfig(chain_id="node-chain", home=home, blocksync=False, wal_enabled=True, db_backend="filedb")
        return Node(cfg, fast_genesis(privs), client, priv_validator=privs[0], device="cpu")

    @pytest.mark.parametrize("package,transport", [("tendermint_tpu_torch", "socket"),
                                                   ("tendermint_tpu_torch", "grpc"),
                                                   ("tendermint_tpu", "socket")])
    def test_node_commits_against_external_app_and_replays_after_kill(self, port_node_env, tmp_path, package,
                                                                       transport):
        """A port node drives an app process (the port's over either
        transport, or the JAX package's over the socket), the app is
        killed, and a fresh app process is replayed to the node's height
        by the handshake."""
        home = str(tmp_path / "home")
        os.makedirs(home)
        privs = [FilePV.generate(home + "/pk.json", home + "/ps.json")]
        client_cls = SocketClient if transport == "socket" else GrpcClient
        proc, (host, port) = spawn_app_process(package, transport=transport)
        node = None
        try:
            client = client_cls(host, port)
            node = self._make_node(home, privs, client)
            node.start()
            node.submit_tx(b"color=red")
            assert wait_for(lambda: node.height >= 3, timeout=60), node.height
            h1 = node.height
            node.consensus.priv_validator = None
            node.stop()
            node = None
            client.stop()
        finally:
            if node is not None:
                node.stop()
            _kill(proc)
        proc2, (host2, port2) = spawn_app_process(package, transport=transport)
        node2 = None
        try:
            client2 = client_cls(host2, port2)
            node2 = self._make_node(home, privs, client2)
            info = client2.info(abci.RequestInfo())
            assert info.last_block_height == node2.sm_state.last_block_height >= h1
            assert client2.query(abci.RequestQuery(path="/key", data=b"color")).value == b"red"
            node2.start()
            assert wait_for(lambda: node2.height >= h1 + 2, timeout=60), node2.height
        finally:
            if node2 is not None:
                node2.consensus.priv_validator = None
                node2.stop()
            _kill(proc2)

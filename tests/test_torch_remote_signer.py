"""The port's remote signers: the twin of ``tests/test_remote_signer.py``
on ``tendermint_tpu_torch.privval.remote``, plus the gRPC signer, held to
the JAX package: the same frames on the wire, a JAX signer process
signing for a port node, and a port signer process signing for a JAX
node. Port nodes run on ``device="cpu"``."""

import base64
import os
import socket as socketlib
import subprocess
import sys
import time

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from tendermint_tpu.abci.client import LocalClient as JLocalClient
from tendermint_tpu.abci.kvstore import KVStoreApplication as JKVStoreApplication
from tendermint_tpu.node.node import Node as JNode, NodeConfig as JNodeConfig
from tendermint_tpu.privval import grpc as jgrpc_pv
from tendermint_tpu.privval import remote as jremote
from tendermint_tpu.privval.file_pv import FilePV as JFilePV
from tendermint_tpu.types.block import BlockID as JBlockID, PartSetHeader as JPartSetHeader, Vote as JVote
from tendermint_tpu.encoding.canonical import Timestamp as JTimestamp
from tendermint_tpu_torch.abci.client import LocalClient
from tendermint_tpu_torch.abci.kvstore import KVStoreApplication
from tendermint_tpu_torch.crypto.keys import Ed25519PrivKey
from tendermint_tpu_torch.encoding.canonical import Timestamp
from tendermint_tpu_torch.node.node import Node, NodeConfig
from tendermint_tpu_torch.privval.file_pv import FilePV
from tendermint_tpu_torch.privval.grpc import GrpcSignerServer
from tendermint_tpu_torch.privval.remote import (
    RemoteSignerError,
    SignerClient,
    SignerListenerEndpoint,
    SignerServer,
    parse_addr,
)
from tendermint_tpu_torch.types.block import BlockID, PartSetHeader, Proposal, Vote
from tests.test_torch_node import CHAIN, fast_genesis, port_node_env, wait_for  # noqa: F401 (fixture)
from tests.test_node import fast_genesis as jfast_genesis

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE_TS = Timestamp.from_unix_ns(1_700_000_000_000_000_000)


def _make_vote(height=1, round_=0, type_=1):
    return Vote(type=type_, height=height, round=round_,
                block_id=BlockID(b"\x01" * 32, PartSetHeader(1, b"\x02" * 32)),
                timestamp=BASE_TS, validator_address=b"\x03" * 20, validator_index=0)


@pytest.fixture()
def file_pv(tmp_path):
    return FilePV.generate(str(tmp_path / "key.json"), str(tmp_path / "state.json"))


def _pair(addr, file_pv):
    """A listener endpoint and an in-process signer dialing it."""
    ep = SignerListenerEndpoint(addr)
    ep.start()
    server = SignerServer(ep.listen_addr, CHAIN, file_pv)
    server.start()
    ep.wait_for_connection(10)
    return ep, server, SignerClient(ep, CHAIN)


class TestAddrParse:
    def test_tcp(self):
        assert parse_addr("tcp://1.2.3.4:567") == ("tcp", ("1.2.3.4", 567))

    def test_unix(self):
        assert parse_addr("unix:///tmp/x.sock") == ("unix", "/tmp/x.sock")

    def test_bad_scheme(self):
        with pytest.raises(ValueError):
            parse_addr("http://x")


class TestInProcess:
    def test_pubkey_and_vote_over_tcp(self, file_pv):
        ep, server, client = _pair("tcp://127.0.0.1:0", file_pv)
        try:
            assert client.get_pub_key().bytes() == file_pv.get_pub_key().bytes()
            client.ping()
            vote = _make_vote()
            client.sign_vote(CHAIN, vote)
            assert vote.signature
            assert file_pv.get_pub_key().verify_signature(vote.sign_bytes(CHAIN), vote.signature)
        finally:
            server.stop()
            ep.close()

    def test_proposal_over_unix(self, file_pv, tmp_path):
        ep, server, client = _pair(f"unix://{tmp_path}/signer.sock", file_pv)
        try:
            prop = Proposal(height=3, round=0, pol_round=-1,
                            block_id=BlockID(b"\x05" * 32, PartSetHeader(1, b"\x06" * 32)), timestamp=BASE_TS)
            client.sign_proposal(CHAIN, prop)
            assert prop.signature
            assert file_pv.get_pub_key().verify_signature(prop.sign_bytes(CHAIN), prop.signature)
        finally:
            server.stop()
            ep.close()

    def test_double_sign_refused_over_wire(self, file_pv):
        ep, server, client = _pair("tcp://127.0.0.1:0", file_pv)
        try:
            v1 = _make_vote(height=5)
            client.sign_vote(CHAIN, v1)
            v2 = _make_vote(height=5)
            v2.block_id = BlockID(b"\x09" * 32, PartSetHeader(1, b"\x0a" * 32))
            with pytest.raises(RemoteSignerError, match="double sign"):
                client.sign_vote(CHAIN, v2)
            with pytest.raises(RemoteSignerError):
                client.sign_vote(CHAIN, _make_vote(height=4))
        finally:
            server.stop()
            ep.close()

    def test_unauthorized_signer_rejected(self, file_pv):
        allowed_identity = Ed25519PrivKey.generate()
        ep = SignerListenerEndpoint("tcp://127.0.0.1:0", authorized_keys=[allowed_identity.pub_key().bytes()])
        ep.start()
        stranger = SignerServer(ep.listen_addr, CHAIN, file_pv, signer_identity=Ed25519PrivKey.generate(),
                                max_dial_retries=5)
        stranger.start()
        try:
            with pytest.raises(RemoteSignerError, match="timed out"):
                ep.wait_for_connection(2)
        finally:
            stranger.stop()
        legit = SignerServer(ep.listen_addr, CHAIN, file_pv, signer_identity=allowed_identity)
        legit.start()
        try:
            ep.wait_for_connection(30)
            SignerClient(ep, CHAIN).ping()
        finally:
            legit.stop()
            ep.close()

    def test_signer_reconnects_after_drop(self, file_pv):
        ep, server, client = _pair("tcp://127.0.0.1:0", file_pv)
        try:
            client.ping()
            with ep._lock:
                ep._drop_conn_locked()
            deadline = time.monotonic() + 10
            while True:
                try:
                    ep.wait_for_connection(2)
                    client.ping()
                    break
                except Exception:
                    if time.monotonic() > deadline:
                        raise
        finally:
            server.stop()
            ep.close()


def _signer_process(module, addr, key_file, state_file, chain=CHAIN, grpc=False):
    """A signer process of either package: the socket signer dials
    ``addr``; the gRPC signer serves on it and prints its address."""
    cmd = [sys.executable, "-m", module, "--addr", addr, "--chain-id", chain, "--key-file", key_file,
           "--state-file", state_file]
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    return subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE if grpc else None, text=True)


def _free_tcp_addr():
    probe = socketlib.socket()
    probe.setsockopt(socketlib.SOL_SOCKET, socketlib.SO_REUSEADDR, 1)
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    return f"tcp://127.0.0.1:{port}"


def _stop(proc):
    proc.terminate()
    proc.wait(timeout=10)


class TestOutOfProcess:
    def test_subprocess_signer_signs(self, tmp_path):
        key_file, state_file = str(tmp_path / "k.json"), str(tmp_path / "s.json")
        expected_pub = FilePV.generate(key_file, state_file).get_pub_key().bytes()
        ep = SignerListenerEndpoint("tcp://127.0.0.1:0")
        ep.start()
        proc = _signer_process("tendermint_tpu_torch.privval.remote", ep.listen_addr, key_file, state_file)
        try:
            ep.wait_for_connection(30)
            client = SignerClient(ep, CHAIN)
            assert client.get_pub_key().bytes() == expected_pub
            vote = _make_vote(height=2)
            client.sign_vote(CHAIN, vote)
            assert client.get_pub_key().verify_signature(vote.sign_bytes(CHAIN), vote.signature)
        finally:
            _stop(proc)
            ep.close()

    @pytest.mark.parametrize("signer", ["port", "jax"])
    def test_node_commits_via_remote_signer(self, port_node_env, tmp_path, signer):
        """A single-validator port node with no local key signs every
        proposal and vote through a signer process (the port's, or the
        JAX package's over the same wire) and commits."""
        key_file, state_file = str(tmp_path / "k.json"), str(tmp_path / "s.json")
        genesis = fast_genesis([FilePV.generate(key_file, state_file)])
        laddr = _free_tcp_addr()
        module = "tendermint_tpu_torch.privval.remote" if signer == "port" else "tendermint_tpu.privval.remote"
        proc = _signer_process(module, laddr, key_file, state_file)
        node = None
        try:
            cfg = NodeConfig(chain_id=CHAIN, listen_addr="127.0.0.1:0", wal_enabled=False, priv_validator_laddr=laddr,
                             signer_connect_timeout=60.0, moniker="remote-signed")
            node = Node(cfg, genesis, LocalClient(KVStoreApplication()), device="cpu")
            assert isinstance(node.priv_validator, SignerClient)
            node.start()
            assert wait_for(lambda: node.height >= 2, timeout=60), f"height: {node.height}"
        finally:
            if node is not None:
                node.stop()
            _stop(proc)


def test_a_port_signer_process_signs_for_a_jax_node(tmp_path):
    key_file, state_file = str(tmp_path / "k.json"), str(tmp_path / "s.json")
    genesis = jfast_genesis([JFilePV.generate(key_file, state_file)])
    laddr = _free_tcp_addr()
    proc = _signer_process("tendermint_tpu_torch.privval.remote", laddr, key_file, state_file, chain=genesis.chain_id)
    node = None
    try:
        cfg = JNodeConfig(chain_id=genesis.chain_id, listen_addr="127.0.0.1:0", wal_enabled=False,
                          priv_validator_laddr=laddr, moniker="remote-signed")
        node = JNode(cfg, genesis, JLocalClient(JKVStoreApplication()))
        node.start()
        assert wait_for(lambda: node.height >= 2, timeout=60), f"height: {node.height}"
    finally:
        if node is not None:
            node.stop()
        _stop(proc)


@pytest.mark.parametrize("signer", ["port", "jax"])
def test_node_commits_via_grpc_signer(port_node_env, tmp_path, signer):
    """The gRPC flavor: the node dials the signer's server (``grpc://``),
    the port's or the JAX package's."""
    key_file, state_file = str(tmp_path / "k.json"), str(tmp_path / "s.json")
    if signer == "port":
        pv = FilePV.generate(key_file, state_file)
        server = GrpcSignerServer(pv, CHAIN)
    else:
        pv = JFilePV.generate(key_file, state_file)
        server = jgrpc_pv.GrpcSignerServer(pv, CHAIN)
    server.start()
    genesis = fast_genesis([FilePV.load_or_generate(key_file, str(tmp_path / "unused.json"))])
    node = None
    try:
        host, port = server.address
        cfg = NodeConfig(chain_id=CHAIN, listen_addr="127.0.0.1:0", wal_enabled=False,
                         priv_validator_laddr=f"grpc://{host}:{port}", moniker="grpc-signed")
        node = Node(cfg, genesis, LocalClient(KVStoreApplication()), device="cpu")
        assert node._owned_signer is node.priv_validator
        node.start()
        assert wait_for(lambda: node.height >= 2, timeout=60), f"height: {node.height}"
    finally:
        if node is not None:
            node.stop()
        server.stop()


class _Recording:
    """A listener endpoint that records the node's requests and answers
    them with a signer's request handler."""

    def __init__(self, handle):
        self.sent, self._handle = [], handle

    def send_request(self, msg):
        self.sent.append(msg)
        return self._handle(msg)


def test_the_signer_frames_equal_the_jax_packages(tmp_path):
    """Requests a node sends and answers a signer gives, message for
    message, for one key and one stream of votes and a proposal."""
    kf, sf, jsf = str(tmp_path / "k.json"), str(tmp_path / "s.json"), str(tmp_path / "js.json")
    pv = FilePV.generate(kf, sf)
    jpv = JFilePV.load_or_generate(kf, jsf)
    assert jpv.get_pub_key().bytes() == pv.get_pub_key().bytes()
    port_side = _Recording(SignerServer("tcp://127.0.0.1:1", CHAIN, pv)._handle)
    jax_side = _Recording(jremote.SignerServer("tcp://127.0.0.1:1", CHAIN, jpv)._handle)
    client, jclient = SignerClient(port_side, CHAIN), jremote.SignerClient(jax_side, CHAIN)
    client.ping(), jclient.ping()
    assert client.get_pub_key().bytes() == jclient.get_pub_key().bytes()
    for h, round_, type_ in ((1, 0, 1), (1, 0, 2), (2, 1, 1), (2, 1, 2)):
        v = _make_vote(h, round_, type_)
        jv = JVote(type=type_, height=h, round=round_,
                   block_id=JBlockID(b"\x01" * 32, JPartSetHeader(1, b"\x02" * 32)),
                   timestamp=JTimestamp.from_unix_ns(BASE_TS.to_unix_ns()), validator_address=b"\x03" * 20,
                   validator_index=0)
        client.sign_vote(CHAIN, v)
        jclient.sign_vote(CHAIN, jv)
        assert v.signature == jv.signature
    v0 = _make_vote(1, 0, 1)  # a regression: refused by both, alike
    jv0 = JVote(type=1, height=1, round=0, block_id=JBlockID(b"\x01" * 32, JPartSetHeader(1, b"\x02" * 32)),
                timestamp=JTimestamp.from_unix_ns(BASE_TS.to_unix_ns()), validator_address=b"\x03" * 20,
                validator_index=0)
    with pytest.raises(RemoteSignerError):
        client.sign_vote(CHAIN, v0)
    with pytest.raises(jremote.RemoteSignerError):
        jclient.sign_vote(CHAIN, jv0)
    assert port_side.sent == jax_side.sent
    answers = [port_side._handle(m) for m in port_side.sent[:2]]
    assert answers == [jax_side._handle(m) for m in jax_side.sent[:2]]
    assert base64.b64decode(answers[1]["body"]["pub_key"]) == pv.get_pub_key().bytes()
    # the frame bytes, unencrypted (unix) and as the JSON both write
    import json

    assert [json.dumps(m, separators=(",", ":")) for m in port_side.sent] == \
        [json.dumps(m, separators=(",", ":")) for m in jax_side.sent]

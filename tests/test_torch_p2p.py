"""The port's p2p stack: secret connection, node key, peer manager,
router over the memory and TCP transports, handshake binding.

The twin of ``tests/test_p2p.py`` on ``tendermint_tpu_torch.p2p``, test
for test; the splice test builds its stale auth frame with the port's
own X25519 and AEAD, where the reference's takes them from
``cryptography``.
"""

import socket
import struct
import threading
import time

import pytest

torch = pytest.importorskip("torch")

from tendermint_tpu_torch.crypto import x25519
from tendermint_tpu_torch.crypto.chacha20poly1305 import ChaCha20Poly1305
from tendermint_tpu_torch.crypto.keys import Ed25519PrivKey
from tendermint_tpu_torch.p2p.key import NodeKey, validate_node_id
from tendermint_tpu_torch.p2p.peermanager import PeerAddress, PeerManager
from tendermint_tpu_torch.p2p.router import Envelope, Router
from tendermint_tpu_torch.p2p.secret_connection import (
    HKDF_INFO,
    SEALED_FRAME_SIZE,
    SecretConnection,
    SecretConnectionError,
    _hkdf,
)
from tendermint_tpu_torch.p2p.transport import MemoryNetwork, NodeInfo, TCPTransport
from tendermint_tpu_torch.storage.kv import MemDB

CHAIN = "p2p-chain"


class _PipeStream:
    """Stream over a socketpair end."""

    def __init__(self, sock):
        self.sock = sock

    def sendall(self, data):
        self.sock.sendall(data)

    def recv_exact(self, n):
        buf = b""
        while len(buf) < n:
            chunk = self.sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("EOF")
            buf += chunk
        return buf


def _pair(seed_a, seed_b):
    a, b = socket.socketpair()
    ka = Ed25519PrivKey.from_seed(seed_a * 32)
    kb = Ed25519PrivKey.from_seed(seed_b * 32)
    out = {}
    t = threading.Thread(target=lambda: out.update(b=SecretConnection(_PipeStream(b), kb)))
    t.start()
    sca = SecretConnection(_PipeStream(a), ka)
    t.join(timeout=5)
    return sca, out["b"], ka, kb, a


class TestSecretConnection:
    def test_handshake_authenticates_keys(self):
        sca, scb, ka, kb, _ = _pair(b"\x01", b"\x02")
        assert sca.remote_pubkey.bytes() == kb.pub_key().bytes()
        assert scb.remote_pubkey.bytes() == ka.pub_key().bytes()

    def test_bidirectional_messages(self):
        sca, scb, _, _, _ = _pair(b"\x01", b"\x02")
        sca.send_msg(b"hello from a")
        scb.send_msg(b"hello from b" * 500)  # multi-frame
        assert scb.recv_msg() == b"hello from a"
        assert sca.recv_msg() == b"hello from b" * 500

    def test_tampered_ciphertext_rejected(self):
        _, scb, _, _, a = _pair(b"\x01", b"\x02")
        # Write a corrupted sealed frame directly into the socket.
        a.sendall(b"\x00" * SEALED_FRAME_SIZE)
        with pytest.raises(SecretConnectionError):
            scb.recv()


class TestNodeKey:
    def test_node_id_format(self, tmp_path):
        nk = NodeKey.load_or_gen(str(tmp_path / "nk.json"))
        validate_node_id(nk.node_id)
        nk2 = NodeKey.load_or_gen(str(tmp_path / "nk.json"))
        assert nk.node_id == nk2.node_id


class TestPeerManager:
    def test_address_book_and_dialing(self):
        pm = PeerManager("a" * 40)
        addr = PeerAddress("b" * 40, "127.0.0.1:1234")
        assert pm.add_address(addr)
        assert not pm.add_address(addr)  # no new info
        cand = pm.dial_next()
        assert cand is not None and cand.node_id == "b" * 40
        assert pm.dial_next() is None  # already dialing
        pm.dialed(cand)
        assert pm.connected_peers() == ["b" * 40]

    def test_dial_failure_backoff(self):
        t = {"now": 0.0}
        pm = PeerManager("a" * 40, now=lambda: t["now"])
        pm.add_address(PeerAddress("b" * 40, "127.0.0.1:1"))
        cand = pm.dial_next()
        pm.dial_failed(cand)
        assert pm.dial_next() is None  # in backoff
        t["now"] = 100.0
        assert pm.dial_next() is not None

    def test_accepted_capacity(self):
        pm = PeerManager("a" * 40, max_connected=1)
        pm.accepted("b" * 40)
        with pytest.raises(ValueError, match="maximum"):
            pm.accepted("c" * 40)
        with pytest.raises(ValueError, match="already"):
            pm.accepted("b" * 40)

    def test_self_rejected(self):
        pm = PeerManager("a" * 40)
        assert not pm.add_address(PeerAddress("a" * 40, "127.0.0.1:1"))
        with pytest.raises(ValueError, match="self"):
            pm.accepted("a" * 40)

    def test_subscriptions(self):
        pm = PeerManager("a" * 40)
        updates = []
        pm.subscribe(updates.append)
        pm.accepted("b" * 40)
        pm.ready("b" * 40)
        pm.disconnected("b" * 40)
        assert [(u.node_id, u.status) for u in updates] == [("b" * 40, "up"), ("b" * 40, "down")]

    def test_persistence(self):
        db = MemDB()
        pm = PeerManager("a" * 40, db=db)
        pm.add_address(PeerAddress("b" * 40, "1.2.3.4:5"), persistent=True)
        pm2 = PeerManager("a" * 40, db=db)
        assert pm2.addresses("b" * 40) == ["1.2.3.4:5"]


def make_router(network, name, chain=CHAIN, **kwargs):
    nk = NodeKey.generate()
    info = NodeInfo(node_id=nk.node_id, network=chain, listen_addr=name)
    pm = PeerManager(nk.node_id)
    router = Router(info, pm, network.transport(name), **kwargs)
    return router, nk, pm


def wait_connected(router, timeout=5.0):
    deadline = time.monotonic() + timeout
    while not router.connected_peers() and time.monotonic() < deadline:
        time.sleep(0.02)


class TestRouterMemory:
    def test_two_nodes_exchange(self):
        net = MemoryNetwork()
        r1, nk1, pm1 = make_router(net, "n1")
        r2, nk2, pm2 = make_router(net, "n2")
        ch1 = r1.open_channel(0x7F)
        ch2 = r2.open_channel(0x7F)
        r1.start()
        r2.start()
        try:
            pm1.add_address(PeerAddress(nk2.node_id, "n2"))
            wait_connected(r1)
            assert r1.connected_peers() == [nk2.node_id]
            ch1.broadcast(b"ping")
            env = ch2.receive(timeout=5)
            assert env is not None and env.message == b"ping"
            assert env.from_peer == nk1.node_id
            ch2.send(Envelope(0x7F, b"pong", to_peer=nk1.node_id))
            env = ch1.receive(timeout=5)
            assert env is not None and env.message == b"pong"
        finally:
            r1.stop()
            r2.stop()

    def test_network_mismatch_rejected(self):
        net = MemoryNetwork()
        r1, nk1, pm1 = make_router(net, "n1", chain="chain-A")
        r2, nk2, pm2 = make_router(net, "n2", chain="chain-B")
        r1.start()
        r2.start()
        try:
            pm1.add_address(PeerAddress(nk2.node_id, "n2"))
            time.sleep(0.5)
            assert r1.connected_peers() == []
        finally:
            r1.stop()
            r2.stop()


class TestRouterTCP:
    def test_encrypted_tcp_exchange(self):
        nk1, nk2 = NodeKey.generate(), NodeKey.generate()
        t1, t2 = TCPTransport(nk1), TCPTransport(nk2)
        t2.listen("127.0.0.1:0")
        pm1, pm2 = PeerManager(nk1.node_id), PeerManager(nk2.node_id)
        r1 = Router(NodeInfo(node_id=nk1.node_id, network=CHAIN), pm1, t1)
        r2 = Router(NodeInfo(node_id=nk2.node_id, network=CHAIN), pm2, t2)
        ch1 = r1.open_channel(0x42)
        ch2 = r2.open_channel(0x42)
        r1.start()
        r2.start()
        try:
            pm1.add_address(PeerAddress(nk2.node_id, t2.listen_addr))
            wait_connected(r1)
            assert nk2.node_id in r1.connected_peers()
            ch1.broadcast(b"secret ping over tcp")
            env = ch2.receive(timeout=5)
            assert env is not None and env.message == b"secret ping over tcp"
        finally:
            r1.stop()
            r2.stop()


class TestHandshakeBinding:
    """The handshake challenge binds both ephemerals and the session: a
    signature made for one session is unusable in any other, and the
    direction-split keys separate the roles."""

    def test_challenge_binds_both_ephemerals(self):
        e1, e2, e3 = b"\x01" * 32, b"\x02" * 32, b"\x03" * 32
        shared = b"\x42" * 32

        def challenge(a, b):
            lo, hi = sorted([a, b])
            return _hkdf(shared, HKDF_INFO + lo + hi, 96)[64:96]

        c12 = challenge(e1, e2)
        assert challenge(e2, e1) == c12  # symmetric: both sides agree
        assert challenge(e1, e3) != c12  # responder ephemeral bound
        assert challenge(e3, e2) != c12  # initiator ephemeral bound
        lo, hi = sorted([e1, e2])
        assert _hkdf(b"\x43" * 32, HKDF_INFO + lo + hi, 96)[64:96] != c12

    def test_auth_from_another_session_rejected(self):
        """Splice attack: a (pubkey, signature) auth message made over
        another session's challenge is refused."""
        kb = Ed25519PrivKey.from_seed(b"\x0b" * 32)
        sig_session1 = kb.sign(b"\x99" * 32)
        a2, b2 = socket.socketpair()
        err = {}

        def victim():
            try:
                SecretConnection(_PipeStream(b2), kb)
            except SecretConnectionError as e:
                err["e"] = e

        t = threading.Thread(target=victim)
        t.start()
        s = _PipeStream(a2)
        eph, eph_pub = x25519.generate()
        s.sendall(eph_pub)
        remote_eph = s.recv_exact(32)
        shared = x25519.exchange(eph, remote_eph)
        lo, hi = sorted([eph_pub, remote_eph])
        material = _hkdf(shared, HKDF_INFO + lo + hi, 96)
        send_key = material[:32] if eph_pub == lo else material[32:64]
        payload = kb.pub_key().bytes() + sig_session1
        frame = struct.pack("<I", len(payload)) + payload
        frame += b"\x00" * (1028 - len(frame))
        nonce = b"\x00" * 4 + struct.pack("<Q", 0)
        s.sendall(ChaCha20Poly1305(send_key).encrypt(nonce, frame, None))
        t.join(timeout=5)
        assert "e" in err, "stale-signature auth must be rejected"
        assert "challenge" in str(err["e"])

    def test_direction_keys_differ(self):
        sca, scb, _, _, _ = _pair(b"\x11", b"\x12")
        assert sca._send_cipher is not sca._recv_cipher
        assert sca._send_cipher._key != sca._recv_cipher._key
        assert sca._send_cipher._key == scb._recv_cipher._key
        probe = b"direction probe"
        sca.send_msg(probe)
        assert scb.recv_msg() == probe

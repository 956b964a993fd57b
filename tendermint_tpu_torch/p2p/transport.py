"""Transports: connection establishment + channel-tagged messaging.

A copy of ``tendermint_tpu/p2p/transport.py``; ``NodeInfo``'s JSON is
the reference's, key for key, so the packages handshake with each other.

Mirrors internal/p2p/transport.go's split: a ``Transport`` accepts/dials
``Connection``s; each connection does a node-info handshake then carries
(channel-id, payload) messages. Two implementations, as in the reference:
TCP with SecretConnection encryption (transport_mconn.go) and an
in-memory pair for tests (transport_memory.go).
"""

from __future__ import annotations

import json
import queue
import select
import socket
import threading
import time
from dataclasses import dataclass, field as dc_field
from typing import Dict, List, Optional, Tuple

from tendermint_tpu_torch.p2p.key import NodeID, NodeKey, node_id_from_pubkey
from tendermint_tpu_torch.p2p.secret_connection import SecretConnection


@dataclass
class NodeInfo:
    """types/node_info.go subset: identity + capabilities."""

    node_id: NodeID
    network: str  # chain id
    moniker: str = ""
    channels: List[int] = dc_field(default_factory=list)
    listen_addr: str = ""
    version: str = "0.1.0"

    def to_json_bytes(self) -> bytes:
        return json.dumps(
            {
                "node_id": self.node_id,
                "network": self.network,
                "moniker": self.moniker,
                "channels": self.channels,
                "listen_addr": self.listen_addr,
                "version": self.version,
            }
        ).encode()

    @classmethod
    def from_json_bytes(cls, raw: bytes) -> "NodeInfo":
        doc = json.loads(raw.decode())
        return cls(
            node_id=doc["node_id"],
            network=doc["network"],
            moniker=doc.get("moniker", ""),
            channels=list(doc.get("channels", [])),
            listen_addr=doc.get("listen_addr", ""),
            version=doc.get("version", ""),
        )

    def compatible_with(self, other: "NodeInfo") -> None:
        if self.network != other.network:
            raise ValueError(
                f"peer is on network {other.network!r}, not {self.network!r}"
            )


class Connection:
    def handshake(self, local_info: NodeInfo) -> NodeInfo:
        raise NotImplementedError

    def send(self, channel_id: int, msg: bytes) -> None:
        raise NotImplementedError

    def receive(self) -> Tuple[int, bytes]:
        """Blocks; raises ConnectionClosed on EOF/close."""
        raise NotImplementedError

    def close(self) -> None:
        raise NotImplementedError


class ConnectionClosed(Exception):
    pass


class Transport:
    def listen(self, addr: str) -> None:
        raise NotImplementedError

    def accept(self, timeout: Optional[float] = None) -> Connection:
        raise NotImplementedError

    def dial(self, addr: str) -> Connection:
        raise NotImplementedError

    def close(self) -> None:
        raise NotImplementedError


# --- memory transport (internal/p2p/transport_memory.go) --------------------


class _MemoryConn(Connection):
    def __init__(self, out_q: "queue.Queue", in_q: "queue.Queue"):
        self._out = out_q
        self._in = in_q
        self._closed = threading.Event()

    def handshake(self, local_info: NodeInfo) -> NodeInfo:
        self._out.put(("__handshake__", local_info.to_json_bytes()))
        kind, raw = self._in.get(timeout=5)
        if kind != "__handshake__":
            raise ConnectionClosed("bad handshake")
        return NodeInfo.from_json_bytes(raw)

    def send(self, channel_id: int, msg: bytes) -> None:
        if self._closed.is_set():
            raise ConnectionClosed("connection closed")
        self._out.put((channel_id, msg))

    def receive(self) -> Tuple[int, bytes]:
        while True:
            if self._closed.is_set():
                raise ConnectionClosed("connection closed")
            try:
                item = self._in.get(timeout=0.1)
            except queue.Empty:
                continue
            if item is None:
                self._closed.set()
                raise ConnectionClosed("peer closed")
            return item

    def close(self) -> None:
        if not self._closed.is_set():
            self._closed.set()
            try:
                self._out.put_nowait(None)
            except queue.Full:
                pass


class MemoryNetwork:
    """A registry of in-process 'listeners' addressable by name."""

    def __init__(self):
        self._listeners: Dict[str, "queue.Queue"] = {}
        self._lock = threading.Lock()

    def transport(self, addr: str) -> "MemoryTransport":
        return MemoryTransport(self, addr)


class MemoryTransport(Transport):
    def __init__(self, network: MemoryNetwork, addr: str):
        self._network = network
        self.addr = addr
        self._accept_q: "queue.Queue" = queue.Queue()
        with network._lock:
            network._listeners[addr] = self._accept_q

    def listen(self, addr: str) -> None:
        pass  # registered at construction

    def accept(self, timeout: Optional[float] = None) -> Connection:
        conn = self._accept_q.get(timeout=timeout)
        return conn

    def dial(self, addr: str) -> Connection:
        with self._network._lock:
            listener = self._network._listeners.get(addr)
        if listener is None:
            raise ConnectionRefusedError(f"no memory listener at {addr}")
        a_to_b: "queue.Queue" = queue.Queue(maxsize=4096)
        b_to_a: "queue.Queue" = queue.Queue(maxsize=4096)
        local = _MemoryConn(a_to_b, b_to_a)
        remote = _MemoryConn(b_to_a, a_to_b)
        listener.put(remote)
        return local

    def close(self) -> None:
        with self._network._lock:
            self._network._listeners.pop(self.addr, None)


# --- TCP transport with SecretConnection ------------------------------------


class _SocketStream:
    def __init__(self, sock: socket.socket):
        self._sock = sock

    def sendall(self, data: bytes) -> None:
        self._sock.sendall(data)

    def recv_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self._sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionClosed("EOF")
            buf += chunk
        return buf

    def recv_available(self, n: int) -> bytes:
        """Up to ``n`` bytes already in the socket's buffer, without
        waiting (b"" when there are none, or at EOF: the next
        ``recv_exact`` reports that)."""
        poller = select.poll()
        poller.register(self._sock, select.POLLIN)
        if not poller.poll(0):
            return b""
        try:
            return self._sock.recv(n)
        except (BlockingIOError, socket.timeout):
            return b""


class _DeadlineStream(_SocketStream):
    """Stream with an ABSOLUTE deadline: every operation shrinks the
    socket timeout to the remaining budget, so a peer trickling one byte
    per timeout window cannot hold the handshake (and its per-IP slot)
    open indefinitely (transport_mconn.go SetDeadline semantics).
    ``disarm()`` turns it into a plain stream once the handshake is done."""

    def __init__(self, sock: socket.socket, deadline: float):
        super().__init__(sock)
        self._deadline: Optional[float] = deadline

    def disarm(self) -> None:
        self._deadline = None

    def _arm(self) -> None:
        if self._deadline is None:
            return
        remaining = self._deadline - time.monotonic()
        if remaining <= 0:
            raise socket.timeout("handshake deadline exceeded")
        self._sock.settimeout(remaining)

    def sendall(self, data: bytes) -> None:
        self._arm()
        super().sendall(data)

    def recv_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            self._arm()
            chunk = self._sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionClosed("EOF")
            buf += chunk
        return buf


class _TCPConn(Connection):
    """Encrypted TCP connection with MConnection multiplexing on top.

    SecretConnection authenticates and frames the stream; after the
    NodeInfo handshake the MConnection layer takes over every frame,
    adding per-channel priority scheduling, ~1400B packetization,
    send/recv rate limiting, and ping/pong keepalive
    (transport_mconn.go + conn/connection.go).
    """

    HANDSHAKE_TIMEOUT = 10.0  # transport_mconn.go handshake deadline

    def __init__(
        self,
        sock: socket.socket,
        node_key: NodeKey,
        mconn_config=None,
    ):
        # NO crypto here: __init__ runs on the accept/dial loop thread,
        # which must stay responsive. The SecretConnection key exchange
        # happens in handshake(), on the router's per-peer handshake
        # thread, under a socket deadline — a client that connects and
        # sends nothing cannot wedge the accept loop or force key
        # exchanges past the per-IP limit.
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock = sock
        self._node_key = node_key
        self._secret = None
        self._send_lock = threading.Lock()
        self._mconn_config = mconn_config
        self._mconn = None
        self._recv_q: "queue.Queue" = queue.Queue(maxsize=8192)
        self._closed_ev = threading.Event()
        try:
            self.remote_ip = sock.getpeername()[0]
        except OSError:
            self.remote_ip = None
        self.remote_node_id = None  # known after handshake()

    def handshake(self, local_info: NodeInfo) -> NodeInfo:
        deadline_stream = _DeadlineStream(
            self._sock, time.monotonic() + self.HANDSHAKE_TIMEOUT
        )
        try:
            self._secret = SecretConnection(
                deadline_stream, self._node_key.priv_key
            )
            self.remote_node_id = node_id_from_pubkey(
                self._secret.remote_pubkey
            )
            with self._send_lock:
                self._secret.send_msg(local_info.to_json_bytes())
            info = NodeInfo.from_json_bytes(self._secret.recv_msg())
        finally:
            self._sock.settimeout(None)
        # handshake done: the deadline no longer applies to steady state
        deadline_stream.disarm()
        # The authenticated transport key must match the claimed node id
        # (transport_mconn.go handshake validation).
        if info.node_id != self.remote_node_id:
            raise ValueError(
                f"peer claimed node id {info.node_id} but transport "
                f"authenticated {self.remote_node_id}"
            )
        # Handshake done: the multiplexer owns the stream from here.
        from tendermint_tpu_torch.p2p.mconn import MConnection

        self._mconn = MConnection(
            send_frame=self._secret.send_msg,
            recv_frame=self._secret.recv_msg,
            on_receive=self._deliver,
            on_error=self._conn_error,
            config=self._mconn_config,
            send_frames=self._secret.send_msgs,
        )
        self._mconn.start()
        return info

    def _deliver(self, channel_id: int, msg: bytes) -> None:
        if self._closed_ev.is_set():
            return
        try:
            self._recv_q.put((channel_id, msg), timeout=5)
        except queue.Full:
            pass  # backpressure: drop (router-side queues do the same)

    def _conn_error(self, e: Exception) -> None:
        # event, not an in-queue sentinel: a full queue can never lose it
        self._closed_ev.set()

    def send(self, channel_id: int, msg: bytes) -> None:
        mconn = self._mconn
        if mconn is None:
            raise ConnectionClosed("send before handshake")
        if self._closed_ev.is_set() or mconn.errored or mconn.stopped:
            # dead connection must surface so the router evicts the peer
            raise ConnectionClosed("mconn errored or closed")
        # full channel queue -> drop, matching the reference's
        # non-blocking Send-returns-false contract (connection.go Send);
        # gossip routines re-offer what a peer still lacks.
        mconn.send(channel_id, msg)

    def receive(self) -> Tuple[int, bytes]:
        # drain anything already delivered, then surface the close
        while True:
            try:
                return self._recv_q.get(timeout=0.2)
            except queue.Empty:
                if self._closed_ev.is_set():
                    raise ConnectionClosed("mconn errored or closed") from None

    def close(self) -> None:
        if self._mconn is not None:
            self._mconn.stop()
        self._closed_ev.set()
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()


class TCPTransport(Transport):
    def __init__(self, node_key: NodeKey, mconn_config=None):
        self.node_key = node_key
        self.mconn_config = mconn_config
        self._listener: Optional[socket.socket] = None
        self.listen_addr = ""

    def listen(self, addr: str) -> None:
        host, _, port = addr.rpartition(":")
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind((host or "127.0.0.1", int(port)))
        s.listen(64)
        self._listener = s
        self.listen_addr = f"{host or '127.0.0.1'}:{s.getsockname()[1]}"

    def accept(self, timeout: Optional[float] = None) -> Connection:
        if self._listener is None:
            raise RuntimeError("not listening")
        self._listener.settimeout(timeout)
        sock, _ = self._listener.accept()
        return _TCPConn(sock, self.node_key, mconn_config=self.mconn_config)

    def dial(self, addr: str) -> Connection:
        host, _, port = addr.rpartition(":")
        sock = socket.create_connection((host, int(port)), timeout=5)
        sock.settimeout(None)
        return _TCPConn(sock, self.node_key, mconn_config=self.mconn_config)

    def close(self) -> None:
        if self._listener is not None:
            self._listener.close()
            self._listener = None

"""Router: connects transports, the peer manager, and reactor channels.

A copy of ``tendermint_tpu/p2p/router.py``.

Mirrors internal/p2p/router.go:142-976: reactors open Channels
(send/receive queue pairs per channel id); the router runs accept and
dial loops, spawns per-peer send/receive threads, and routes Envelopes
between channel queues and peer connections. Broadcast envelopes fan out
to every connected peer.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass, field as dc_field
from typing import Dict, List, Optional

from tendermint_tpu_torch.p2p.conn_tracker import ConnTracker
from tendermint_tpu_torch.p2p.key import NodeID
from tendermint_tpu_torch.p2p.peermanager import PeerAddress, PeerManager
from tendermint_tpu_torch.p2p.transport import (
    Connection,
    ConnectionClosed,
    NodeInfo,
    Transport,
)


@dataclass
class Envelope:
    """internal/p2p/channel.go Envelope."""

    channel_id: int
    message: bytes
    from_peer: NodeID = ""
    to_peer: NodeID = ""  # empty + broadcast=False is invalid for sends
    broadcast: bool = False


class Channel:
    """A reactor's handle: send envelopes out, iterate received ones."""

    def __init__(self, channel_id: int, router: "Router"):
        self.channel_id = channel_id
        self._router = router
        self.in_queue: "queue.Queue[Envelope]" = queue.Queue(maxsize=10000)

    def send(self, env: Envelope) -> None:
        env.channel_id = self.channel_id
        self._router._route_out(env)

    def broadcast(self, message: bytes) -> None:
        self.send(Envelope(self.channel_id, message, broadcast=True))

    def receive(self, timeout: Optional[float] = None) -> Optional[Envelope]:
        try:
            return self.in_queue.get(timeout=timeout)
        except queue.Empty:
            return None


class Router:
    def __init__(
        self,
        node_info: NodeInfo,
        peer_manager: PeerManager,
        transport: Transport,
        metrics=None,
        logger=None,
        max_incoming_per_ip: int = 16,
        queue_type: str = "fifo",
        channel_priorities=None,
    ):
        from tendermint_tpu_torch.libs.log import NOP_LOGGER
        from tendermint_tpu_torch.libs.metrics import P2PMetrics
        from tendermint_tpu_torch.p2p.pqueue import QUEUE_TYPES

        if queue_type not in QUEUE_TYPES:
            raise ValueError(
                f"unknown p2p queue type {queue_type!r} (one of {QUEUE_TYPES})"
            )
        # Per-peer send-queue discipline (router.go:216-238): fifo,
        # priority (WDRR), or simple-priority.
        self.queue_type = queue_type
        self.channel_priorities = channel_priorities
        self.node_info = node_info
        self.peer_manager = peer_manager
        self.transport = transport
        self.metrics = metrics or P2PMetrics.nop()
        self.logger = (logger or NOP_LOGGER).with_fields(module="p2p")
        self._channels: Dict[int, Channel] = {}
        self._peer_conns: Dict[NodeID, Connection] = {}
        self._peer_send_queues: Dict[NodeID, "queue.Queue"] = {}
        self._peer_ips: Dict[NodeID, str] = {}
        self._conn_tracker = ConnTracker(max_per_ip=max_incoming_per_ip)
        self._mtx = threading.RLock()
        self._stop_flag = threading.Event()
        self._threads: List[threading.Thread] = []

    # --- channels ------------------------------------------------------------

    def open_channel(self, channel_id: int) -> Channel:
        """router.go OpenChannel."""
        with self._mtx:
            if channel_id in self._channels:
                raise ValueError(f"channel {channel_id} already open")
            ch = Channel(channel_id, self)
            self._channels[channel_id] = ch
            if channel_id not in self.node_info.channels:
                self.node_info.channels.append(channel_id)
            return ch

    # --- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        self._stop_flag.clear()
        self._spawn(self._accept_loop, "router-accept")
        self._spawn(self._dial_loop, "router-dial")

    def stop(self) -> None:
        self._stop_flag.set()
        self.transport.close()
        with self._mtx:
            for conn in self._peer_conns.values():
                conn.close()
            self._peer_conns.clear()
            self._peer_send_queues.clear()
            # release per-IP reservations: threads that exit on the stop
            # flag never reach _disconnect, and stale counts would reject
            # legitimate inbound after a restart
            for ip in self._peer_ips.values():
                self._conn_tracker.remove(ip)
            self._peer_ips.clear()
        for t in self._threads:
            t.join(timeout=2)
        self._threads.clear()

    def _spawn(self, fn, name: str, *args) -> None:
        t = threading.Thread(target=fn, args=args, name=name, daemon=True)
        t.start()
        self._threads.append(t)

    # --- accept / dial loops --------------------------------------------------

    def _accept_loop(self) -> None:
        """router.go acceptPeers:444 (+ conn_tracker.go per-IP limit)."""
        while not self._stop_flag.is_set():
            try:
                conn = self.transport.accept(timeout=0.2)
            except (TimeoutError, OSError, queue.Empty):
                continue
            except Exception:
                if self._stop_flag.is_set():
                    return
                continue
            if self._quarantined():
                try:
                    conn.close()
                except Exception:
                    pass
                continue
            ip = getattr(conn, "remote_ip", None)
            if ip is not None and not self._conn_tracker.add(ip):
                self.logger.info("inbound rejected: per-IP limit", ip=ip)
                try:
                    conn.close()
                except Exception:
                    pass
                continue
            self._spawn(self._handshake_peer, "router-handshake", conn, None)

    def _dial_loop(self) -> None:
        """router.go dialPeers:528."""
        while not self._stop_flag.is_set():
            if self._quarantined():
                self._stop_flag.wait(0.2)
                continue
            address = self.peer_manager.dial_next()
            if address is None:
                self._stop_flag.wait(0.1)
                continue
            try:
                conn = self.transport.dial(address.addr)
            except Exception:
                self.peer_manager.dial_failed(address)
                continue
            self._spawn(self._handshake_peer, "router-handshake", conn, address)

    def _handshake_peer(
        self, conn: Connection, dialed: Optional[PeerAddress]
    ) -> None:
        try:
            peer_info = conn.handshake(self.node_info)
            self.node_info.compatible_with(peer_info)
            if dialed is not None and peer_info.node_id != dialed.node_id:
                raise ValueError(
                    f"expected to dial {dialed.node_id}, got {peer_info.node_id}"
                )
            if dialed is not None:
                self.peer_manager.dialed(dialed)
            else:
                self.peer_manager.accepted(peer_info.node_id)
            # Record the peer's advertised listen address so PEX can hand
            # it to other peers (the reference learns this from NodeInfo
            # during the handshake too).
            if peer_info.listen_addr:
                self.peer_manager.add_address(
                    PeerAddress(peer_info.node_id, peer_info.listen_addr)
                )
        except Exception:
            if dialed is not None:
                self.peer_manager.dial_failed(dialed)
            else:
                ip = getattr(conn, "remote_ip", None)
                if ip is not None:
                    self._conn_tracker.remove(ip)
            conn.close()
            return
        if self._quarantined():
            # disconnect_all fired while this handshake was in flight: a
            # peer must not install itself during the quarantine.
            ip = getattr(conn, "remote_ip", None)
            if dialed is None and ip is not None:
                self._conn_tracker.remove(ip)
            conn.close()
            return
        peer_id = peer_info.node_id
        from tendermint_tpu_torch.p2p.pqueue import make_send_queue

        send_q = make_send_queue(
            self.queue_type, 10000, self.channel_priorities
        )
        with self._mtx:
            old = self._peer_conns.pop(peer_id, None)
            old_ip = self._peer_ips.pop(peer_id, None)
            if old is not None:
                old.close()
            if old_ip is not None:
                self._conn_tracker.remove(old_ip)
            self._peer_conns[peer_id] = conn
            self._peer_send_queues[peer_id] = send_q
            if dialed is None:
                ip = getattr(conn, "remote_ip", None)
                if ip is not None:
                    self._peer_ips[peer_id] = ip
        self._spawn(self._send_peer, f"router-send-{peer_id[:8]}", peer_id, conn, send_q)
        self._spawn(self._receive_peer, f"router-recv-{peer_id[:8]}", peer_id, conn)
        self.peer_manager.ready(peer_id)
        with self._mtx:
            self.metrics.peers.set(len(self._peer_conns))
        self.logger.info("peer connected", peer=peer_id[:16])

    # --- per-peer routines ----------------------------------------------------

    def _send_peer(self, peer_id: NodeID, conn: Connection, send_q) -> None:
        """router.go sendPeer:843."""
        while not self._stop_flag.is_set():
            env = send_q.get(timeout=0.2)
            if env is None:
                if send_q.closed:
                    return
                continue  # timeout: poll the stop flag
            try:
                conn.send(env.channel_id, env.message)
                self.metrics.message_send_bytes_total.labels(
                    chID=str(env.channel_id)
                ).inc(len(env.message))
            except Exception:
                self._disconnect(peer_id, expected_conn=conn)
                return

    def _receive_peer(self, peer_id: NodeID, conn: Connection) -> None:
        """router.go receivePeer:791."""
        while not self._stop_flag.is_set():
            try:
                channel_id, msg = conn.receive()
            except (ConnectionClosed, Exception):
                self._disconnect(peer_id, expected_conn=conn)
                return
            self.metrics.message_receive_bytes_total.labels(
                chID=str(channel_id)
            ).inc(len(msg))
            ch = self._channels.get(channel_id)
            if ch is None:
                continue  # unknown channel: drop (router logs in reference)
            try:
                ch.in_queue.put_nowait(
                    Envelope(channel_id, msg, from_peer=peer_id)
                )
            except queue.Full:
                pass  # backpressure: drop (priority queues in reference)

    def _disconnect(
        self, peer_id: NodeID, expected_conn: Optional[Connection] = None
    ) -> None:
        """Evict peer_id's connection. When ``expected_conn`` is given,
        only evict if it is still the installed one — a send/recv thread
        of an OLD connection must not tear down the replacement a
        reconnect just installed."""
        with self._mtx:
            current = self._peer_conns.get(peer_id)
            if expected_conn is not None and current is not expected_conn:
                return
            conn = self._peer_conns.pop(peer_id, None)
            sq = self._peer_send_queues.pop(peer_id, None)
            ip = self._peer_ips.pop(peer_id, None)
            self.metrics.peers.set(len(self._peer_conns))
        if ip is not None:
            self._conn_tracker.remove(ip)
        if conn is not None:
            self.logger.info("peer disconnected", peer=peer_id[:16])
            conn.close()
            if sq is not None:
                sq.close()
            self.peer_manager.disconnected(peer_id)

    # --- routing --------------------------------------------------------------

    def _route_out(self, env: Envelope) -> None:
        """router.go routeChannel:301. The queue discipline decides what
        a full queue drops (pqueue.py); drops are silent here, as in the
        reference."""
        if env.broadcast:
            with self._mtx:
                targets = list(self._peer_send_queues.items())
            for peer_id, sq in targets:
                sq.put(Envelope(env.channel_id, env.message, to_peer=peer_id))
        else:
            with self._mtx:
                sq = self._peer_send_queues.get(env.to_peer)
            if sq is not None:
                sq.put(env)

    def connected_peers(self) -> List[NodeID]:
        with self._mtx:
            return list(self._peer_conns.keys())

    def disconnect_all(self, duration: float = 5.0) -> int:
        """Drop every peer connection and refuse dial/accept for
        ``duration`` seconds — the process-level analog of the e2e
        runner's docker-network `disconnect` perturbation
        (test/e2e/runner/perturb.go:42-72). Returns the number of peers
        dropped; reconnection happens through the normal persistent-peer
        retry path once the quarantine lapses."""
        import time as _t

        with self._mtx:
            peers = list(self._peer_conns.keys())
            self._quarantine_until = _t.monotonic() + duration
        for peer_id in peers:
            self._disconnect(peer_id)
        return len(peers)

    def _quarantined(self) -> bool:
        import time as _t

        return _t.monotonic() < getattr(self, "_quarantine_until", 0.0)

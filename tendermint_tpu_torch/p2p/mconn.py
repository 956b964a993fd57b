"""MConnection: multiplexed, prioritized, flow-controlled peer connection.

A copy of ``tendermint_tpu/p2p/mconn.py``. The reference multiplexes
every reactor channel over one TCP connection with per-channel priority
queues, ~1400-byte packetization, flow-rate throttling, and ping/pong
keepalive (internal/p2p/conn/connection.go: 75-700). This module is that
layer, speaking over any length-delimited frame stream (here: the
SecretConnection message layer).

Scheduling follows the reference's least-sent-relative-to-priority rule
(sendPacketMsg -> channel with lowest recentlySent/priority); send and
receive sides are token-bucket rate-limited (flowrate analog); pings fly
every ``ping_interval`` and a missing pong for ``pong_timeout`` errors
the connection (connection.go:48-49 defaults).

Wire format inside each frame: 1 type byte (PING/PONG/MSG); MSG carries
u16 channel id, u8 eof, payload -- a logical message is the
concatenation of packet payloads up to the eof packet (PacketMsg
analog). The packets are the reference's, byte for byte.

One difference of pace, none of bytes: the send routine picks packets
by the same rule until the queues are empty or the batch holds a second
of the send rate (at most ``MAX_BATCH_BYTES``), pays the token bucket
for the batch, and hands it to ``send_frames`` in one call (over TCP the
SecretConnection's ``send_msgs``, which seals all its frames in one
pass; by default ``send_frame`` a packet at a time). The packets and
their order are those the reference's one-at-a-time loop picks from the
same queues.
"""

from __future__ import annotations

import struct
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

_PKT_PING = 0x01
_PKT_PONG = 0x02
_PKT_MSG = 0x03

# connection.go:29-49 / config.go P2P defaults. The rates are the
# reference's *config-level* defaults (config.go SendRate/RecvRate =
# 5120000), not connection.go's internal 512000 fallback — every real
# node runs with the former.
DEFAULT_MAX_PACKET_PAYLOAD = 1400
DEFAULT_SEND_RATE = 5120000  # bytes/sec (5MB/s)
DEFAULT_RECV_RATE = 5120000
DEFAULT_PING_INTERVAL = 60.0
DEFAULT_PONG_TIMEOUT = 90.0
DEFAULT_SEND_TIMEOUT = 10.0  # connection.go:47 defaultSendTimeout
DEFAULT_SEND_QUEUE_CAPACITY = 1024  # messages per channel
DEFAULT_RECV_MESSAGE_CAPACITY = 22020096  # 21MB
MAX_RECV_CHANNELS = 256  # distinct channel states per connection
MAX_BATCH_BYTES = 256 * 1024  # packets handed to send_frames in one call

# Reactor channel priorities, as each reference reactor registers them
# (consensus/reactor.go:38-68, blocksync:45, mempool:85, evidence:38,
# statesync:80-107, pex:62).
DEFAULT_CHANNEL_PRIORITIES: Dict[int, int] = {
    0x20: 8,   # consensus state
    0x21: 12,  # consensus data (block parts)
    0x22: 10,  # consensus votes
    0x23: 5,   # consensus vote-set bits
    0x30: 5,   # mempool
    0x38: 6,   # evidence
    0x40: 5,   # blocksync
    0x60: 6,   # statesync snapshot
    0x61: 3,   # statesync chunk
    0x62: 5,   # statesync light block
    0x63: 2,   # statesync params
    0x00: 1,   # pex
}


@dataclass
class MConnConfig:
    max_packet_payload: int = DEFAULT_MAX_PACKET_PAYLOAD
    send_rate: int = DEFAULT_SEND_RATE
    recv_rate: int = DEFAULT_RECV_RATE
    ping_interval: float = DEFAULT_PING_INTERVAL
    pong_timeout: float = DEFAULT_PONG_TIMEOUT
    send_timeout: float = DEFAULT_SEND_TIMEOUT
    send_queue_capacity: int = DEFAULT_SEND_QUEUE_CAPACITY
    recv_message_capacity: int = DEFAULT_RECV_MESSAGE_CAPACITY
    channel_priorities: Dict[int, int] = field(
        default_factory=lambda: dict(DEFAULT_CHANNEL_PRIORITIES)
    )


class _TokenBucket:
    """flowrate.Monitor-in-spirit: cap sustained bytes/sec, with one
    second of burst."""

    def __init__(self, rate: int):
        self.rate = max(1, rate)
        self.capacity = float(self.rate)
        self.tokens = self.capacity
        self.last = time.monotonic()
        self._lock = threading.Lock()

    def consume(self, n: int, cancelled: threading.Event) -> None:
        """Block until n tokens are available (sleeping off the deficit).

        n is clamped to the bucket capacity: a single packet larger than
        one second of rate must still eventually pass (paying a full
        bucket), never deadlock the connection.
        """
        n = min(n, int(self.capacity))
        while True:
            with self._lock:
                now = time.monotonic()
                self.tokens = min(
                    self.capacity, self.tokens + (now - self.last) * self.rate
                )
                self.last = now
                if self.tokens >= n:
                    self.tokens -= n
                    return
                deficit = (n - self.tokens) / self.rate
            if cancelled.wait(min(deficit, 0.25)):
                return


class _ChannelState:
    __slots__ = ("priority", "queue", "sending", "recently_sent", "recv_buf")

    def __init__(self, priority: int, capacity: int):
        self.priority = max(1, priority)
        self.queue: deque = deque(maxlen=capacity)
        self.sending: Optional[memoryview] = None  # partially-sent message
        self.recently_sent = 0.0
        self.recv_buf = bytearray()


class MConnectionError(Exception):
    pass


class MConnection:
    """One multiplexed connection over a frame stream.

    ``send_frame(bytes)`` / ``recv_frame() -> bytes`` are the underlying
    transport (SecretConnection messages for TCP). ``on_receive`` is
    called off the recv routine with complete (channel_id, message)
    pairs; ``on_error`` once, with the fatal exception.
    """

    def __init__(
        self,
        send_frame: Callable[[bytes], None],
        recv_frame: Callable[[], bytes],
        on_receive: Callable[[int, bytes], None],
        on_error: Callable[[Exception], None],
        config: Optional[MConnConfig] = None,
        send_frames: Optional[Callable[[List[bytes]], None]] = None,
    ):
        self.config = config or MConnConfig()
        self._send_frame = send_frame
        self._send_frames = send_frames if send_frames is not None else self._send_each
        self._recv_frame = recv_frame
        self._on_receive = on_receive
        self._on_error = on_error
        self._channels: Dict[int, _ChannelState] = {}
        self._chan_lock = threading.Lock()
        self._send_ready = threading.Event()
        self._stop = threading.Event()
        self._send_bucket = _TokenBucket(self.config.send_rate)
        self._recv_bucket = _TokenBucket(self.config.recv_rate)
        self._frame_lock = threading.Lock()
        self._last_pong = time.monotonic()
        self._ping_outstanding = False
        self._ping_sent = 0.0
        self._recv_buffered = 0
        self._threads = []
        self._errored = threading.Event()

    # --- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        for target, name in (
            (self._send_routine, "mconn-send"),
            (self._recv_routine, "mconn-recv"),
            (self._ping_routine, "mconn-ping"),
        ):
            t = threading.Thread(target=target, name=name, daemon=True)
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        self._stop.set()
        self._send_ready.set()

    def _error(self, e: Exception) -> None:
        if not self._errored.is_set():
            self._errored.set()
            self.stop()
            try:
                self._on_error(e)
            except Exception:
                pass

    # --- sending ------------------------------------------------------------

    def _chan(self, channel_id: int) -> _ChannelState:
        with self._chan_lock:
            st = self._channels.get(channel_id)
            if st is None:
                st = _ChannelState(
                    self.config.channel_priorities.get(channel_id, 1),
                    self.config.send_queue_capacity,
                )
                self._channels[channel_id] = st
            return st

    @property
    def errored(self) -> bool:
        return self._errored.is_set()

    @property
    def stopped(self) -> bool:
        return self._stop.is_set()

    def send(self, channel_id: int, msg: bytes) -> bool:
        """Enqueue a message, blocking up to ``send_timeout`` for queue
        space; False on timeout or stop (connection.go Send blocks on the
        channel sendQueue with defaultSendTimeout then reports false)."""
        st = self._chan(channel_id)
        deadline = time.monotonic() + self.config.send_timeout
        while True:
            if self._stop.is_set():
                return False
            with self._chan_lock:
                if len(st.queue) < st.queue.maxlen:
                    st.queue.append(msg)
                    self._send_ready.set()
                    return True
            if time.monotonic() >= deadline:
                return False
            time.sleep(0.01)  # send routine drains continuously

    def _pick_channel(self) -> Optional[Tuple[int, _ChannelState]]:
        """Lowest recently_sent/priority among channels with pending data
        (connection.go sendPacketMsg:390-420)."""
        best = None
        best_score = None
        with self._chan_lock:
            for cid, st in self._channels.items():
                if st.sending is None and not st.queue:
                    continue
                score = st.recently_sent / st.priority
                if best_score is None or score < best_score:
                    best, best_score = (cid, st), score
        return best

    def _send_each(self, packets: List[bytes]) -> None:
        for pkt in packets:
            self._send_frame(pkt)

    def _next_packet(self, max_payload: int) -> Optional[bytes]:
        """The next packet by the scheduling rule, or None when every
        queue is empty."""
        picked = self._pick_channel()
        if picked is None:
            return None
        cid, st = picked
        with self._chan_lock:
            if st.sending is None:
                if not st.queue:
                    return None
                st.sending = memoryview(st.queue.popleft())
            chunk = bytes(st.sending[:max_payload])
            st.sending = st.sending[max_payload:]
            eof = 1 if len(st.sending) == 0 else 0
            if eof:
                st.sending = None
            st.recently_sent += len(chunk)
        return bytes([_PKT_MSG]) + struct.pack(">HB", cid, eof) + chunk

    def _send_routine(self) -> None:
        max_payload = self.config.max_packet_payload
        budget = min(MAX_BATCH_BYTES, int(self._send_bucket.capacity))
        last_decay = time.monotonic()
        try:
            while not self._stop.is_set():
                pkt = self._next_packet(max_payload)
                if pkt is None:
                    self._send_ready.wait(timeout=0.1)
                    self._send_ready.clear()
                    continue
                batch, size = [pkt], len(pkt)
                while size < budget:
                    pkt = self._next_packet(max_payload)
                    if pkt is None:
                        break
                    batch.append(pkt)
                    size += len(pkt)
                self._send_bucket.consume(size, self._stop)
                if self._stop.is_set():
                    return
                with self._frame_lock:
                    self._send_frames(batch)
                now = time.monotonic()
                if now - last_decay >= 1.0:
                    # exponential decay so a quiet channel regains
                    # scheduling weight (flowrate's sliding window analog)
                    with self._chan_lock:
                        for s in self._channels.values():
                            s.recently_sent *= 0.5
                    last_decay = now
        except Exception as e:
            self._error(MConnectionError(f"send failed: {e}"))

    # --- receiving ----------------------------------------------------------

    def _recv_routine(self) -> None:
        try:
            while not self._stop.is_set():
                frame = self._recv_frame()
                self._recv_bucket.consume(len(frame), self._stop)
                if not frame:
                    raise MConnectionError("empty frame")
                ptype = frame[0]
                if ptype == _PKT_PING:
                    with self._frame_lock:
                        self._send_frame(bytes([_PKT_PONG]))
                    continue
                if ptype == _PKT_PONG:
                    self._last_pong = time.monotonic()
                    self._ping_outstanding = False
                    continue
                if ptype != _PKT_MSG:
                    raise MConnectionError(f"unknown packet type {ptype}")
                if len(frame) < 4:
                    raise MConnectionError("short msg packet")
                cid, eof = struct.unpack_from(">HB", frame, 1)
                payload = frame[4:]
                # Channels open dynamically (router reactors), so unknown
                # ids are accepted — but bounded: a hostile peer spraying
                # packets across the 64Ki id space must not allocate
                # unbounded channel states or reassembly buffers
                # (connection.go instead rejects unregistered channels;
                # same resource bound, looser coupling).
                with self._chan_lock:
                    known = cid in self._channels
                if not known and len(self._channels) >= MAX_RECV_CHANNELS:
                    raise MConnectionError(
                        f"too many distinct channels (> {MAX_RECV_CHANNELS})"
                    )
                st = self._chan(cid)
                st.recv_buf += payload
                self._recv_buffered += len(payload)
                if len(st.recv_buf) > self.config.recv_message_capacity:
                    raise MConnectionError(
                        f"message on channel {cid:#x} exceeds recv capacity"
                    )
                if self._recv_buffered > 3 * self.config.recv_message_capacity:
                    raise MConnectionError(
                        "aggregate reassembly buffers exceed capacity"
                    )
                if eof:
                    msg = bytes(st.recv_buf)
                    self._recv_buffered -= len(st.recv_buf)
                    st.recv_buf = bytearray()
                    self._on_receive(cid, msg)
        except Exception as e:
            self._error(MConnectionError(f"recv failed: {e}"))

    # --- keepalive ----------------------------------------------------------

    def _ping_routine(self) -> None:
        """Ping every ping_interval; the pong clock starts when the
        unanswered ping was SENT (connection.go arms pongTimeout in
        sendRoutine), checked at a finer wake so the effective timeout
        tracks the configured one."""
        wake = min(
            self.config.ping_interval, max(0.05, self.config.pong_timeout / 3)
        )
        last_ping = 0.0
        try:
            while not self._stop.wait(wake):
                now = time.monotonic()
                if (
                    self._ping_outstanding
                    and now - self._ping_sent > self.config.pong_timeout
                ):
                    raise MConnectionError("pong timeout")
                if now - last_ping >= self.config.ping_interval:
                    with self._frame_lock:
                        self._send_frame(bytes([_PKT_PING]))
                    last_ping = now
                    if not self._ping_outstanding:
                        self._ping_outstanding = True
                        self._ping_sent = now
        except Exception as e:
            self._error(e)

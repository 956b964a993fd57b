"""Minimal gRPC-over-HTTP/2: spec-compliant subset, zero dependencies.

Counterpart of ``tendermint_tpu/libs/grpc.py``, whole but for its
thread-per-connection serving mode and the environment knob that chose
it (``TENDERMINT_TPU_EVLOOP``): the server runs every connection on the
selector event loop (``libs/evloop.py``). The port's verify service
(``verifyd/``) is its only user.

The reference exposes gRPC variants of the ABCI transport
(abci/client/grpc_client.go:184, abci/server/grpc_server.go:83) and the
remote signer (privval/grpc/client.go, privval/grpc/server.go) via the
grpc-go stack. This image has no grpc/protobuf runtime, so this module
implements the slice of HTTP/2 (RFC 9113) + HPACK (RFC 7541) + the gRPC
wire protocol that unary RPC needs:

- connection preface, SETTINGS exchange (INITIAL_WINDOW_SIZE is parsed
  and applied to stream send windows, per RFC 9113 6.9.2), PING
  replies, GOAWAY;
- HEADERS/CONTINUATION with END_HEADERS, DATA with END_STREAM;
- flow control at BOTH levels: connection and per-stream send windows
  are tracked and WINDOW_UPDATE is credited to the stream it names, so
  a real grpc-go peer with default 64KB stream windows is paced
  correctly; the receiver replenishes the connection window after every
  DATA frame and advertises 2^31-1 initial stream windows so a unary
  message never stalls against THIS implementation;
- HPACK: full RFC 7541 static table, dynamic-table inserts and indexed
  lookups on DECODE; the ENCODER emits only "literal without indexing"
  with raw strings — a legal encoding every compliant peer accepts.
  Huffman-coded strings are rejected (this pair never emits them);
- gRPC message framing (1-byte compressed flag + 4-byte BE length),
  ``application/grpc`` content type, ``grpc-status``/``grpc-message``
  trailers, per-call deadlines;
- resource bounds mirroring the socket codec: 64MB max message
  (abci/codec.py MAX_FRAME analog), 1MB max header block, bounded
  in-flight streams per server connection.

Scope: unary calls, one in flight per client connection (the callers —
block executor, mempool, consensus signer — are synchronous, the same
trade the socket transports make). A call that fails before its request
finished reaching the peer is retried once on a fresh connection (safe:
the server dispatches only on END_STREAM); a failure after that is
surfaced, never retried — ABCI calls are not idempotent. Streams,
huffman, and padding generation are deliberately out of scope and
documented here rather than half-built.
"""

from __future__ import annotations

import collections
import socket
import struct
import threading
from typing import Callable, Dict, List, Optional, Tuple

from tendermint_tpu_torch.libs import evloop as evloop_mod
from tendermint_tpu_torch.libs import log

# --- frame types / flags ----------------------------------------------------

FRAME_DATA = 0x0
FRAME_HEADERS = 0x1
FRAME_PRIORITY = 0x2
FRAME_RST_STREAM = 0x3
FRAME_SETTINGS = 0x4
FRAME_PUSH_PROMISE = 0x5
FRAME_PING = 0x6
FRAME_GOAWAY = 0x7
FRAME_WINDOW_UPDATE = 0x8
FRAME_CONTINUATION = 0x9

FLAG_END_STREAM = 0x1
FLAG_END_HEADERS = 0x4
FLAG_ACK = 0x1
FLAG_PADDED = 0x8
FLAG_PRIORITY = 0x20

SETTINGS_INITIAL_WINDOW_SIZE = 0x4
SETTINGS_MAX_FRAME_SIZE = 0x5

PREFACE = b"PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n"
MAX_FRAME = 16384
BIG_WINDOW = 2**31 - 1
DEFAULT_WINDOW = 65535
# Same ceiling as the socket transport's codec (abci/codec.py): a peer
# cannot balloon memory with an endless DATA stream.
MAX_MESSAGE = 64 << 20
MAX_HEADER_BLOCK = 1 << 20
MAX_STREAMS_PER_CONN = 64

GRPC_OK = 0
GRPC_UNKNOWN = 2
GRPC_UNIMPLEMENTED = 12
GRPC_INTERNAL = 13


class GrpcError(Exception):
    def __init__(self, status: int, message: str = ""):
        super().__init__(f"grpc-status {status}: {message}")
        self.status = status
        self.message = message


class H2ProtocolError(ConnectionError):
    pass


# --- HPACK (RFC 7541) -------------------------------------------------------

# Appendix A static table, 1-indexed.
_STATIC_TABLE: List[Tuple[str, str]] = [
    (":authority", ""), (":method", "GET"), (":method", "POST"),
    (":path", "/"), (":path", "/index.html"), (":scheme", "http"),
    (":scheme", "https"), (":status", "200"), (":status", "204"),
    (":status", "206"), (":status", "304"), (":status", "400"),
    (":status", "404"), (":status", "500"), ("accept-charset", ""),
    ("accept-encoding", "gzip, deflate"), ("accept-language", ""),
    ("accept-ranges", ""), ("accept", ""), ("access-control-allow-origin", ""),
    ("age", ""), ("allow", ""), ("authorization", ""), ("cache-control", ""),
    ("content-disposition", ""), ("content-encoding", ""),
    ("content-language", ""), ("content-length", ""), ("content-location", ""),
    ("content-range", ""), ("content-type", ""), ("cookie", ""), ("date", ""),
    ("etag", ""), ("expect", ""), ("expires", ""), ("from", ""), ("host", ""),
    ("if-match", ""), ("if-modified-since", ""), ("if-none-match", ""),
    ("if-range", ""), ("if-unmodified-since", ""), ("last-modified", ""),
    ("link", ""), ("location", ""), ("max-forwards", ""),
    ("proxy-authenticate", ""), ("proxy-authorization", ""), ("range", ""),
    ("referer", ""), ("refresh", ""), ("retry-after", ""), ("server", ""),
    ("set-cookie", ""), ("strict-transport-security", ""),
    ("transfer-encoding", ""), ("user-agent", ""), ("vary", ""), ("via", ""),
    ("www-authenticate", ""),
]


def _encode_int(value: int, prefix_bits: int, pattern: int) -> bytes:
    """RFC 7541 5.1 integer with the high bits of the first byte set to
    ``pattern``."""
    limit = (1 << prefix_bits) - 1
    if value < limit:
        return bytes([pattern | value])
    out = bytearray([pattern | limit])
    value -= limit
    while value >= 128:
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    out.append(value)
    return bytes(out)


def _decode_int(data: bytes, pos: int, prefix_bits: int) -> Tuple[int, int]:
    limit = (1 << prefix_bits) - 1
    value = data[pos] & limit
    pos += 1
    if value < limit:
        return value, pos
    shift = 0
    while True:
        if pos >= len(data):
            raise H2ProtocolError("truncated HPACK integer")
        b = data[pos]
        pos += 1
        value += (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return value, pos


def hpack_encode(headers: List[Tuple[str, str]]) -> bytes:
    """Literal-without-indexing, raw (non-huffman) strings only —
    the simplest legal HPACK stream (RFC 7541 6.2.2)."""
    out = bytearray()
    for name, value in headers:
        nb = name.encode()
        vb = value.encode()
        out.append(0x00)  # literal, not indexed, new name
        out += _encode_int(len(nb), 7, 0x00)  # H bit clear: raw
        out += nb
        out += _encode_int(len(vb), 7, 0x00)
        out += vb
    return bytes(out)


class HpackDecoder:
    """Stateful decoder: static table + dynamic table + all literal
    forms. Huffman-coded strings raise (neither of our endpoints emits
    them; a third-party peer that does gets a clean protocol error, not
    silent corruption)."""

    def __init__(self, max_table_size: int = 4096):
        self._dynamic: List[Tuple[str, str]] = []
        self._max_size = max_table_size
        self._size = 0

    def _entry(self, index: int) -> Tuple[str, str]:
        if index == 0:
            raise H2ProtocolError("HPACK index 0")
        if index <= len(_STATIC_TABLE):
            return _STATIC_TABLE[index - 1]
        d = index - len(_STATIC_TABLE) - 1
        if d >= len(self._dynamic):
            raise H2ProtocolError(f"HPACK index {index} out of range")
        return self._dynamic[d]

    def _insert(self, name: str, value: str) -> None:
        self._dynamic.insert(0, (name, value))
        self._size += len(name) + len(value) + 32
        while self._size > self._max_size and self._dynamic:
            n, v = self._dynamic.pop()
            self._size -= len(n) + len(v) + 32

    def _string(self, data: bytes, pos: int) -> Tuple[str, int]:
        if pos >= len(data):
            # a block that ends right where a string should begin is a
            # protocol error, not an IndexError
            raise H2ProtocolError("truncated HPACK string")
        huffman = bool(data[pos] & 0x80)
        length, pos = _decode_int(data, pos, 7)
        if pos + length > len(data):
            raise H2ProtocolError("truncated HPACK string")
        raw = data[pos : pos + length]
        if huffman:
            raise H2ProtocolError("huffman-coded HPACK string unsupported")
        return raw.decode("utf-8", "surrogateescape"), pos + length

    def decode(self, data: bytes) -> List[Tuple[str, str]]:
        headers: List[Tuple[str, str]] = []
        pos = 0
        while pos < len(data):
            b = data[pos]
            if b & 0x80:  # indexed field
                index, pos = _decode_int(data, pos, 7)
                headers.append(self._entry(index))
            elif b & 0x40:  # literal with incremental indexing
                index, pos = _decode_int(data, pos, 6)
                name = self._entry(index)[0] if index else None
                if name is None:
                    name, pos = self._string(data, pos)
                value, pos = self._string(data, pos)
                self._insert(name, value)
                headers.append((name, value))
            elif b & 0x20:  # dynamic table size update
                size, pos = _decode_int(data, pos, 5)
                self._max_size = size
                while self._size > self._max_size and self._dynamic:
                    n, v = self._dynamic.pop()
                    self._size -= len(n) + len(v) + 32
            else:  # literal without indexing (0x00) / never indexed (0x10)
                index, pos = _decode_int(data, pos, 4)
                name = self._entry(index)[0] if index else None
                if name is None:
                    name, pos = self._string(data, pos)
                value, pos = self._string(data, pos)
                headers.append((name, value))
        return headers


# --- frame I/O --------------------------------------------------------------


def _read_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise H2ProtocolError("connection closed mid-frame")
        buf += chunk
    return bytes(buf)


def read_frame(sock: socket.socket) -> Tuple[int, int, int, bytes]:
    hdr = _read_exact(sock, 9)
    length = int.from_bytes(hdr[:3], "big")
    # we advertise SETTINGS_MAX_FRAME_SIZE=MAX_FRAME, so a larger frame
    # is a protocol violation — reject it before allocating up to 16MB-1
    # of peer-controlled buffer (RFC 9113 4.2 FRAME_SIZE_ERROR)
    if length > MAX_FRAME:
        raise H2ProtocolError(
            f"frame length {length} exceeds SETTINGS_MAX_FRAME_SIZE "
            f"{MAX_FRAME}"
        )
    ftype, flags = hdr[3], hdr[4]
    stream_id = int.from_bytes(hdr[5:9], "big") & 0x7FFFFFFF
    payload = _read_exact(sock, length) if length else b""
    return ftype, flags, stream_id, payload


def write_frame(
    sock: socket.socket, ftype: int, flags: int, stream_id: int, payload: bytes
) -> None:
    sock.sendall(
        len(payload).to_bytes(3, "big")
        + bytes([ftype, flags])
        + (stream_id & 0x7FFFFFFF).to_bytes(4, "big")
        + payload
    )


def _settings_payload() -> bytes:
    return struct.pack(
        "!HIHI",
        SETTINGS_INITIAL_WINDOW_SIZE,
        BIG_WINDOW,
        SETTINGS_MAX_FRAME_SIZE,
        MAX_FRAME,
    )


def grpc_frame(payload: bytes) -> bytes:
    """gRPC length-prefixed message: flag byte 0 (uncompressed) + len."""
    return b"\x00" + len(payload).to_bytes(4, "big") + payload


def grpc_unframe(data: bytes) -> bytes:
    if len(data) < 5:
        raise GrpcError(GRPC_INTERNAL, "short gRPC message")
    if data[0] != 0:
        raise GrpcError(GRPC_UNIMPLEMENTED, "compressed gRPC messages unsupported")
    n = int.from_bytes(data[1:5], "big")
    if len(data) < 5 + n:
        raise GrpcError(GRPC_INTERNAL, "truncated gRPC message")
    return data[5 : 5 + n]


class _ConnState:
    """Shared per-connection bookkeeping: HPACK decoder, send windows
    (connection + per-stream), and the one place connection-level frames
    (SETTINGS/PING/WINDOW_UPDATE/GOAWAY) are serviced — both read loops
    and a blocked sender go through :meth:`pump_once`, so the handling
    cannot diverge between copies."""

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.decoder = HpackDecoder()
        self.send_window = DEFAULT_WINDOW  # connection-level
        self.peer_initial_window = DEFAULT_WINDOW
        self.stream_send: Dict[int, int] = {}
        self.window_cv = threading.Condition()
        self.wlock = threading.Lock()  # frame-write atomicity
        # Stream-level frames read while waiting for window grants; read
        # loops drain this before touching the socket.
        self.inbox: List[Tuple[int, int, int, bytes]] = []

    def open_stream(self, stream_id: int) -> None:
        with self.window_cv:
            self.stream_send[stream_id] = self.peer_initial_window

    def close_stream(self, stream_id: int) -> None:
        with self.window_cv:
            self.stream_send.pop(stream_id, None)

    def _apply_settings(self, payload: bytes) -> None:
        for off in range(0, len(payload) - 5, 6):
            ident, value = struct.unpack_from("!HI", payload, off)
            if ident == SETTINGS_INITIAL_WINDOW_SIZE:
                # RFC 9113 6.9.2: delta applies to all open streams.
                with self.window_cv:
                    delta = value - self.peer_initial_window
                    self.peer_initial_window = value
                    for sid in self.stream_send:
                        self.stream_send[sid] += delta
                    self.window_cv.notify_all()

    def pump_once(self) -> None:
        """Read ONE frame. Connection-level traffic (settings, pings,
        window grants, goaway) is handled here; stream frames are queued
        to ``inbox`` for the owning read loop."""
        ftype, flags, sid, frame = read_frame(self.sock)
        if ftype == FRAME_WINDOW_UPDATE:
            inc = int.from_bytes(frame, "big") & 0x7FFFFFFF
            with self.window_cv:
                if sid == 0:
                    self.send_window += inc
                elif sid in self.stream_send:
                    self.stream_send[sid] += inc
                self.window_cv.notify_all()
        elif ftype == FRAME_SETTINGS:
            if not flags & FLAG_ACK:
                self._apply_settings(frame)
                with self.wlock:
                    write_frame(self.sock, FRAME_SETTINGS, FLAG_ACK, 0, b"")
        elif ftype == FRAME_PING:
            if not flags & FLAG_ACK:
                with self.wlock:
                    write_frame(self.sock, FRAME_PING, FLAG_ACK, 0, frame)
        elif ftype == FRAME_GOAWAY:
            raise H2ProtocolError("peer sent GOAWAY")
        elif ftype == FRAME_PRIORITY:
            pass
        else:
            if len(self.inbox) > 4 * MAX_STREAMS_PER_CONN:
                raise H2ProtocolError("stream-frame backlog overflow")
            self.inbox.append((ftype, flags, sid, frame))

    def next_stream_frame(self) -> Tuple[int, int, int, bytes]:
        """Next stream-level frame, servicing connection frames inline."""
        while not self.inbox:
            self.pump_once()
        return self.inbox.pop(0)

    def send_data(self, stream_id: int, data: bytes, end_stream: bool) -> None:
        """DATA frames chunked to MAX_FRAME, honoring BOTH send windows.
        The caller's thread owns the socket's read side in this design
        (single in-flight call / per-connection server thread), so a
        starved send services incoming frames itself via pump_once."""
        off = 0
        total = len(data)
        if total == 0:
            with self.wlock:
                write_frame(
                    self.sock, FRAME_DATA,
                    FLAG_END_STREAM if end_stream else 0, stream_id, b"",
                )
            return
        while off < total:
            n = 0
            with self.window_cv:
                stream_w = self.stream_send.get(stream_id, self.peer_initial_window)
                avail = min(self.send_window, stream_w)
                if avail > 0:
                    n = min(MAX_FRAME, total - off, avail)
                    self.send_window -= n
                    if stream_id in self.stream_send:
                        self.stream_send[stream_id] -= n
            if n == 0:
                self.pump_once()  # the grant can only arrive by reading
                continue
            chunk = data[off : off + n]
            off += n
            last = off >= total
            with self.wlock:
                write_frame(
                    self.sock, FRAME_DATA,
                    FLAG_END_STREAM if (end_stream and last) else 0,
                    stream_id, chunk,
                )

    def send_headers(
        self, stream_id: int, headers: List[Tuple[str, str]], end_stream: bool
    ) -> None:
        block = hpack_encode(headers)
        flags = FLAG_END_HEADERS | (FLAG_END_STREAM if end_stream else 0)
        with self.wlock:
            write_frame(self.sock, FRAME_HEADERS, flags, stream_id, block)

    def replenish(self, consumed: int) -> None:
        """Grant the peer back what we just consumed (connection level)."""
        if consumed <= 0:
            return
        with self.wlock:
            write_frame(
                self.sock, FRAME_WINDOW_UPDATE, 0, 0,
                consumed.to_bytes(4, "big"),
            )


def _strip_padding(flags: int, payload: bytes) -> bytes:
    if flags & FLAG_PADDED:
        # RFC 7540 §6.1/§6.2: the Pad Length field must exist and the
        # padding must fit inside the remaining payload. A malformed
        # frame is a connection error, not an IndexError.
        if not payload:
            raise H2ProtocolError("PADDED frame with empty payload")
        pad = payload[0]
        if pad >= len(payload):
            raise H2ProtocolError("padding exceeds frame payload")
        payload = payload[1 : len(payload) - pad]
    return payload


# --- client -----------------------------------------------------------------


class GrpcChannel:
    """Blocking unary-call client channel; one call in flight at a time
    (matches the synchronous socket transports' contract). A connection
    failure before the request finished reaching the peer retries once
    on a fresh connection; later failures surface to the caller."""

    def __init__(self, host: str, port: int, timeout: float = 10.0):
        self._addr = (host, port)
        self._timeout = timeout
        self._mtx = threading.Lock()
        self._conn: Optional[_ConnState] = None
        self._next_stream = 1

    def close(self) -> None:
        with self._mtx:
            self._close_locked()

    def _close_locked(self) -> None:
        if self._conn is not None:
            try:
                with self._conn.wlock:
                    write_frame(
                        self._conn.sock, FRAME_GOAWAY, 0, 0, b"\x00" * 8
                    )
                self._conn.sock.close()
            except OSError:
                pass  # best-effort GOAWAY/close on teardown
            self._conn = None

    def _connect_locked(self) -> _ConnState:
        if self._conn is not None:
            return self._conn
        sock = socket.create_connection(self._addr, timeout=self._timeout)
        sock.settimeout(self._timeout)
        # every call is a write-write-read (HEADERS frame, DATA frame,
        # then block on the response): with Nagle on, the DATA frame sits
        # behind a delayed ACK and every RPC eats a flat ~40ms stall
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        sock.sendall(PREFACE)
        write_frame(sock, FRAME_SETTINGS, 0, 0, _settings_payload())
        # open up the connection-level receive window for the peer
        write_frame(
            sock, FRAME_WINDOW_UPDATE, 0, 0,
            (BIG_WINDOW - DEFAULT_WINDOW).to_bytes(4, "big"),
        )
        conn = _ConnState(sock)
        self._conn = conn
        self._next_stream = 1
        return conn

    def unary(
        self,
        path: str,
        payload: bytes,
        timeout: Optional[float] = None,
    ) -> bytes:
        """One gRPC unary call; returns the response message payload or
        raises GrpcError with the peer's grpc-status."""
        with self._mtx:
            for attempt in (0, 1):
                try:
                    return self._unary_locked(path, payload, timeout)
                except _RequestNotSent:
                    self._close_locked()
                    if attempt == 1:
                        raise H2ProtocolError(
                            "connection failed before request delivery (retried)"
                        )
                    continue  # safe: the peer never saw END_STREAM
                except (OSError, H2ProtocolError):
                    self._close_locked()
                    raise

    def _unary_locked(
        self, path: str, payload: bytes, timeout: Optional[float]
    ) -> bytes:
        try:
            conn = self._connect_locked()
        except OSError as e:
            raise _RequestNotSent(str(e)) from e
        conn.sock.settimeout(timeout or self._timeout)
        stream_id = self._next_stream
        self._next_stream += 2
        conn.open_stream(stream_id)
        try:
            try:
                conn.send_headers(
                    stream_id,
                    [
                        (":method", "POST"),
                        (":scheme", "http"),
                        (":path", path),
                        (":authority", "%s:%d" % self._addr),
                        ("content-type", "application/grpc"),
                        ("te", "trailers"),
                    ],
                    end_stream=False,
                )
                conn.send_data(stream_id, grpc_frame(payload), end_stream=True)
            except (OSError, H2ProtocolError) as e:
                # END_STREAM never reached the peer: retryable.
                raise _RequestNotSent(str(e)) from e

            data = bytearray()
            headers: List[Tuple[str, str]] = []
            header_block = bytearray()
            block_end_stream = False
            while True:
                ftype, flags, sid, frame = conn.next_stream_frame()
                if sid != stream_id:
                    continue  # stale frame from an aborted stream
                if ftype == FRAME_RST_STREAM:
                    raise GrpcError(GRPC_INTERNAL, "stream reset by server")
                if ftype in (FRAME_HEADERS, FRAME_CONTINUATION):
                    if ftype == FRAME_HEADERS:
                        frame = _strip_padding(flags, frame)
                        if flags & FLAG_PRIORITY:
                            frame = frame[5:]
                        # END_STREAM rides the HEADERS frame, but the
                        # header block isn't complete (or decodable)
                        # until END_HEADERS — honoring it early would
                        # drop trailers split across CONTINUATION
                        # frames (losing grpc-status).
                        block_end_stream = bool(flags & FLAG_END_STREAM)
                    header_block += frame
                    if len(header_block) > MAX_HEADER_BLOCK:
                        raise H2ProtocolError("header block too large")
                    if flags & FLAG_END_HEADERS:
                        headers += conn.decoder.decode(bytes(header_block))
                        header_block.clear()
                        if block_end_stream:
                            break
                    continue
                if ftype == FRAME_DATA:
                    frame = _strip_padding(flags, frame)
                    data += frame
                    if len(data) > MAX_MESSAGE:
                        raise H2ProtocolError("gRPC message exceeds 64MB cap")
                    conn.replenish(len(frame))
                    if flags & FLAG_END_STREAM:
                        break
        finally:
            conn.close_stream(stream_id)
        hmap = dict(headers)
        status = int(hmap.get("grpc-status", "0") or "0")
        if status != GRPC_OK:
            raise GrpcError(status, hmap.get("grpc-message", ""))
        if hmap.get(":status", "200") != "200":
            raise GrpcError(GRPC_INTERNAL, f"http status {hmap.get(':status')}")
        return grpc_unframe(bytes(data))


class _RequestNotSent(Exception):
    """Connection died before END_STREAM was delivered — safe to retry."""


# --- server -----------------------------------------------------------------


Handler = Callable[[bytes], bytes]

# Per-dispatch connection identity: set around every handler call (both
# serving modes), so handlers that account per-connection (verifyd's
# cross-client flush counter) don't have to assume thread-per-connection.
_conn_tag = threading.local()


def current_conn_tag(default=None):
    """The connection identity of the request currently being handled
    on this thread, or ``default`` outside a dispatch."""
    return getattr(_conn_tag, "tag", default)


class _QuietClose(Exception):
    """Close the connection without logging (wrong client preface)."""


def _frame_bytes(ftype: int, flags: int, stream_id: int, payload: bytes) -> bytes:
    return (
        len(payload).to_bytes(3, "big")
        + bytes([ftype, flags])
        + (stream_id & 0x7FFFFFFF).to_bytes(4, "big")
        + payload
    )


class _H2ServerConn:
    """Sans-IO server half of one HTTP/2 connection.

    ``feed()`` consumes raw bytes (any chunking) and drives preface
    validation, HPACK, stream assembly, and connection-level frames;
    completed requests go to ``dispatch(sid, headers, body)`` and every
    byte out goes through ``send(bytes)``. Response DATA honors both
    send windows — what the windows can't take queues per stream and
    drains when the peer grants credit (WINDOW_UPDATE / SETTINGS), so
    no serving thread ever blocks on flow control.

    One machine serves two loops: the blocking per-socket loop
    (``GrpcServer._serve_conn``, dispatch inline on the reading thread)
    and the selector loop (``_H2Protocol``, dispatch deferred to
    the worker pool). ``_mtx`` is reentrant so the inline loop can
    respond from within ``feed`` while worker responses stay safe
    against a concurrently-feeding loop thread."""

    def __init__(self, server: "GrpcServer", send: Callable[[bytes], None],
                 dispatch: Optional[Callable[[int, Dict[str, str], bytes], None]] = None):
        self._server = server
        self._send = send
        self._dispatch = dispatch or (
            lambda sid, hdrs, body: server._dispatch(self, sid, hdrs, body)
        )
        self.decoder = HpackDecoder()
        self._mtx = threading.RLock()
        self._buf = bytearray()  # guarded-by: _mtx
        self._preface_ok = False  # guarded-by: _mtx
        self.send_window = DEFAULT_WINDOW  # guarded-by: _mtx
        self.peer_initial_window = DEFAULT_WINDOW  # guarded-by: _mtx
        self.stream_send: Dict[int, int] = {}  # guarded-by: _mtx
        # per-stream pending output: ["headers", hdrs, end] /
        # ["data", bytes, offset, end] items awaiting window credit
        self._outq: Dict[int, collections.deque] = {}  # guarded-by: _mtx
        self._finished: set = set()  # guarded-by: _mtx
        # stream_id -> [header_list or None, data bytearray, ended]
        self._streams: Dict[int, list] = {}  # guarded-by: _mtx
        self._header_block = bytearray()  # guarded-by: _mtx
        self._block_stream = 0  # guarded-by: _mtx

    # --- inbound -------------------------------------------------------------

    def feed(self, data: bytes) -> None:
        with self._mtx:
            self._buf += data
            if not self._preface_ok:
                if len(self._buf) < len(PREFACE):
                    return
                if bytes(self._buf[: len(PREFACE)]) != PREFACE:
                    raise _QuietClose()
                del self._buf[: len(PREFACE)]
                self._preface_ok = True
                self._send(
                    _frame_bytes(FRAME_SETTINGS, 0, 0, _settings_payload())
                    + _frame_bytes(
                        FRAME_WINDOW_UPDATE, 0, 0,
                        (BIG_WINDOW - DEFAULT_WINDOW).to_bytes(4, "big"),
                    )
                )
            while True:
                if len(self._buf) < 9:
                    return
                length = int.from_bytes(self._buf[:3], "big")
                # same FRAME_SIZE_ERROR bound as read_frame: don't sit
                # buffering up to 16MB-1 for a frame we will never accept
                if length > MAX_FRAME:
                    raise H2ProtocolError(
                        f"frame length {length} exceeds "
                        f"SETTINGS_MAX_FRAME_SIZE {MAX_FRAME}"
                    )
                if len(self._buf) < 9 + length:
                    return
                ftype, flags = self._buf[3], self._buf[4]
                sid = int.from_bytes(self._buf[5:9], "big") & 0x7FFFFFFF
                payload = bytes(self._buf[9 : 9 + length])
                del self._buf[: 9 + length]
                self._on_frame_locked(ftype, flags, sid, payload)

    def _apply_settings_locked(self, payload: bytes) -> None:
        for off in range(0, len(payload) - 5, 6):
            ident, value = struct.unpack_from("!HI", payload, off)
            if ident == SETTINGS_INITIAL_WINDOW_SIZE:
                # RFC 9113 6.9.2: delta applies to all open streams.
                delta = value - self.peer_initial_window
                self.peer_initial_window = value
                for sid in self.stream_send:
                    self.stream_send[sid] += delta

    def _on_frame_locked(
        self, ftype: int, flags: int, sid: int, frame: bytes
    ) -> None:
        if ftype == FRAME_WINDOW_UPDATE:
            inc = int.from_bytes(frame, "big") & 0x7FFFFFFF
            if sid == 0:
                self.send_window += inc
            elif sid in self.stream_send:
                self.stream_send[sid] += inc
            self._drain_all_locked()
            return
        if ftype == FRAME_SETTINGS:
            if not flags & FLAG_ACK:
                self._apply_settings_locked(frame)
                self._send(_frame_bytes(FRAME_SETTINGS, FLAG_ACK, 0, b""))
                self._drain_all_locked()
            return
        if ftype == FRAME_PING:
            if not flags & FLAG_ACK:
                self._send(_frame_bytes(FRAME_PING, FLAG_ACK, 0, frame))
            return
        if ftype == FRAME_GOAWAY:
            raise H2ProtocolError("peer sent GOAWAY")
        if ftype == FRAME_PRIORITY:
            return
        if ftype in (FRAME_HEADERS, FRAME_CONTINUATION):
            if ftype == FRAME_HEADERS:
                if self._block_stream != 0:
                    # RFC 7540 §4.3: a header block must not be
                    # interleaved with frames of any other kind or
                    # stream.
                    raise H2ProtocolError("HEADERS while a header block is open")
                frame = _strip_padding(flags, frame)
                if flags & FLAG_PRIORITY:
                    frame = frame[5:]
                self._block_stream = sid
                if len(self._streams) >= MAX_STREAMS_PER_CONN:
                    raise H2ProtocolError("too many in-flight streams")
                self._streams[sid] = [None, bytearray(), False]
                self.stream_send[sid] = self.peer_initial_window
            else:  # CONTINUATION
                if self._block_stream == 0:
                    raise H2ProtocolError(
                        "CONTINUATION without a preceding HEADERS"
                    )
                if sid != self._block_stream:
                    raise H2ProtocolError("CONTINUATION on the wrong stream")
            self._header_block += frame
            if len(self._header_block) > MAX_HEADER_BLOCK:
                raise H2ProtocolError("header block too large")
            if flags & FLAG_END_HEADERS:
                # Decode even if the stream was reset meanwhile: skipping
                # would desync the HPACK dynamic table for every later
                # stream on this connection.
                decoded = self.decoder.decode(bytes(self._header_block))
                if self._block_stream in self._streams:
                    self._streams[self._block_stream][0] = decoded
                self._header_block.clear()
                self._block_stream = 0
            if flags & FLAG_END_STREAM and sid in self._streams:
                self._streams[sid][2] = True
        elif ftype == FRAME_DATA and sid in self._streams:
            frame = _strip_padding(flags, frame)
            st = self._streams[sid]
            st[1] += frame
            if len(st[1]) > MAX_MESSAGE:
                raise H2ProtocolError("gRPC message exceeds 64MB cap")
            if frame:
                # replenish the connection-level receive window
                self._send(
                    _frame_bytes(
                        FRAME_WINDOW_UPDATE, 0, 0,
                        len(frame).to_bytes(4, "big"),
                    )
                )
            if flags & FLAG_END_STREAM:
                st[2] = True
        elif ftype == FRAME_RST_STREAM and sid in self._streams:
            del self._streams[sid]
            self.stream_send.pop(sid, None)
            self._outq.pop(sid, None)
            self._finished.discard(sid)
        # dispatch complete streams
        done = [
            s for s, st in self._streams.items()
            if st[2] and st[0] is not None
        ]
        for s in done:
            hdrs, body, _ = self._streams.pop(s)
            self._dispatch(s, dict(hdrs), bytes(body))

    # --- outbound ------------------------------------------------------------

    def send_headers(
        self, stream_id: int, headers: List[Tuple[str, str]], end_stream: bool
    ) -> None:
        with self._mtx:
            q = self._outq.get(stream_id)
            if q:
                # data is stalled on window credit ahead of us: keep the
                # frame order by queueing behind it
                q.append(["headers", headers, end_stream])
                return
            self._send_headers_now(stream_id, headers, end_stream)

    def _send_headers_now(
        self, stream_id: int, headers: List[Tuple[str, str]], end_stream: bool
    ) -> None:
        flags = FLAG_END_HEADERS | (FLAG_END_STREAM if end_stream else 0)
        self._send(
            _frame_bytes(FRAME_HEADERS, flags, stream_id, hpack_encode(headers))
        )

    def send_data(self, stream_id: int, data: bytes, end_stream: bool) -> None:
        with self._mtx:
            q = self._outq.setdefault(stream_id, collections.deque())
            q.append(["data", data, 0, end_stream])
            self._drain_stream_locked(stream_id)

    def finish_stream(self, stream_id: int) -> None:
        """The response is fully queued: reclaim window bookkeeping once
        (and only once) the stream's queue drains."""
        with self._mtx:
            self._finished.add(stream_id)
            self._drain_stream_locked(stream_id)

    def _drain_all_locked(self) -> None:
        for sid in list(self._outq):
            self._drain_stream_locked(sid)

    def _drain_stream_locked(self, sid: int) -> None:
        q = self._outq.get(sid)
        while q:
            item = q[0]
            if item[0] == "headers":
                self._send_headers_now(sid, item[1], item[2])
                q.popleft()
                continue
            _, data, off, end = item
            total = len(data)
            if total == 0:
                self._send(
                    _frame_bytes(
                        FRAME_DATA, FLAG_END_STREAM if end else 0, sid, b""
                    )
                )
                q.popleft()
                continue
            stalled = False
            while off < total:
                stream_w = self.stream_send.get(sid, self.peer_initial_window)
                avail = min(self.send_window, stream_w)
                if avail <= 0:
                    item[2] = off
                    stalled = True
                    break
                n = min(MAX_FRAME, total - off, avail)
                self.send_window -= n
                if sid in self.stream_send:
                    self.stream_send[sid] -= n
                last = off + n >= total
                self._send(
                    _frame_bytes(
                        FRAME_DATA,
                        FLAG_END_STREAM if (end and last) else 0,
                        sid,
                        data[off : off + n],
                    )
                )
                off += n
            if stalled:
                return
            q.popleft()
        if sid in self._outq and not self._outq[sid]:
            del self._outq[sid]
        if sid in self._finished and sid not in self._outq:
            self._finished.discard(sid)
            self.stream_send.pop(sid, None)


class _H2Protocol:
    """libs/evloop adapter: loop bytes feed the sans-IO machine; each
    completed request dispatches on the server's worker pool, responding
    through the transport's buffered writes."""

    def __init__(self, server: "GrpcServer", transport):
        self._server = server
        self._t = transport
        self._mc = _H2ServerConn(server, transport.write, self._defer_dispatch)

    def _defer_dispatch(self, sid: int, headers: Dict[str, str], body: bytes) -> None:
        self._t.defer(lambda: self._run(sid, headers, body))

    def _run(self, sid: int, headers: Dict[str, str], body: bytes) -> None:
        try:
            self._server._dispatch(self._mc, sid, headers, body)
        except Exception:
            # response could not even be queued — tear the connection
            # (the peer sees a reset; other connections keep serving)
            self._t.abort()

    def data_received(self, data: bytes) -> None:
        self._mc.feed(data)  # raises on protocol error; the loop closes us

    def eof_received(self) -> None:
        pass  # loop drops the connection after this

    def connection_lost(self, exc) -> None:
        pass


class GrpcServer:
    """Unary gRPC server, handlers dispatched by :path. Handler
    exceptions become grpc-status INTERNAL; unknown paths UNIMPLEMENTED
    (grpc_server.go:83 shape).

    Every connection runs on one selector event loop (libs/evloop) with
    a bounded worker pool for handlers: the thread count is O(workers),
    not O(connections). The loop drives the same sans-IO connection
    machine as the reference's thread-per-connection mode, so the wire
    behavior is identical byte for byte."""

    def __init__(self, handlers: Dict[str, Handler], host: str = "127.0.0.1",
                 port: int = 0, logger=None,
                 evloop_metrics=None, workers: Optional[int] = None):
        self._handlers = handlers
        self._logger = logger if logger is not None else log.NOP_LOGGER
        self._evloop_metrics = evloop_metrics
        self._workers = workers
        self._ev = None
        # Bind eagerly (SocketServer does the same) so `address` is
        # valid before start() and a busy port fails at construction.
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind((host, port))
        s.listen(128)
        self._lsock: Optional[socket.socket] = s

    @property
    def address(self) -> Tuple[str, int]:
        assert self._lsock is not None
        return self._lsock.getsockname()[:2]

    def start(self) -> None:
        kwargs = {}
        if self._evloop_metrics is not None:
            kwargs["metrics"] = self._evloop_metrics
        if self._workers is not None:
            kwargs["workers"] = self._workers
        self._ev = evloop_mod.EvloopServer(
            lambda t: _H2Protocol(self, t),
            listener_ref=lambda: self._lsock,
            name="grpc",
            logger=self._logger,
            **kwargs,
        )
        self._ev.start()

    def stop(self) -> None:
        if self._ev is not None:
            self._ev.stop()
            self._ev = None
        if self._lsock is not None:
            try:
                self._lsock.close()
            except OSError:
                pass  # listener may already be closed; stop() is idempotent
            self._lsock = None

    def _dispatch(
        self, conn: "_H2ServerConn", stream_id: int, headers: Dict[str, str],
        body: bytes,
    ) -> None:
        path = headers.get(":path", "")
        handler = self._handlers.get(path)
        resp_headers = [(":status", "200"), ("content-type", "application/grpc")]
        try:
            if handler is None:
                conn.send_headers(stream_id, resp_headers, end_stream=False)
                conn.send_headers(
                    stream_id,
                    [("grpc-status", str(GRPC_UNIMPLEMENTED)),
                     ("grpc-message", f"unknown method {path}")],
                    end_stream=True,
                )
                return
            try:
                _conn_tag.tag = id(conn)
                try:
                    result = handler(grpc_unframe(body))
                finally:
                    _conn_tag.tag = None
                conn.send_headers(stream_id, resp_headers, end_stream=False)
                conn.send_data(stream_id, grpc_frame(result), end_stream=False)
                conn.send_headers(
                    stream_id, [("grpc-status", "0")], end_stream=True
                )
            except GrpcError as e:
                conn.send_headers(stream_id, resp_headers, end_stream=False)
                conn.send_headers(
                    stream_id,
                    [("grpc-status", str(e.status)), ("grpc-message", e.message)],
                    end_stream=True,
                )
            except Exception as e:  # handler bug -> INTERNAL, connection survives
                conn.send_headers(stream_id, resp_headers, end_stream=False)
                conn.send_headers(
                    stream_id,
                    [("grpc-status", str(GRPC_INTERNAL)),
                     ("grpc-message", f"{type(e).__name__}: {e}")],
                    end_stream=True,
                )
        finally:
            conn.finish_stream(stream_id)

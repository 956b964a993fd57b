"""The port's gRPC transport and event loop (``libs/grpc.py``,
``libs/evloop.py``) against the JAX package's, on the CPU.

The port's channel calls the JAX server in both of its serving modes
(the selector event loop and thread-per-connection) and the port's
server, which runs only the event loop; the JAX channel calls the
port's server; the JAX thread-per-connection server is the
counterpart of the port's byte-level answers. The reference's
frame-level cases (CONTINUATION, PADDED, the declared-length cap,
truncated HPACK) run against the port; and the event loop's slow
reader, mid-frame disconnect and connection gauge. Every socket wait
is bounded.
"""

import socket
import struct
import threading
import time

import pytest

pytest.importorskip("torch")

from tendermint_tpu.libs import grpc as jgrpc
from tendermint_tpu_torch.libs import grpc as tgrpc
from tendermint_tpu_torch.libs.evloop import EvloopServer
from tendermint_tpu_torch.libs.metrics import EvloopMetrics, Registry

PACKAGES = {"jax": jgrpc, "port": tgrpc}


def _echo_server(pkg, evloop=True):
    """An echo server; ``evloop`` chooses the JAX server's mode (the
    port's server has only the event loop)."""
    def boom(payload):
        raise RuntimeError("kaput")

    handlers = {"/t.Svc/Echo": lambda p: p, "/t.Svc/Boom": boom}
    srv = jgrpc.GrpcServer(handlers, evloop=evloop) if pkg == "jax" else tgrpc.GrpcServer(handlers)
    srv.start()
    return srv


@pytest.mark.parametrize("chan_pkg,srv_pkg,evloop", [
    ("port", "jax", True), ("port", "jax", False), ("jax", "port", True), ("port", "port", True),
], ids=["port-to-jax-evloop", "port-to-jax-threaded", "jax-to-port-evloop", "port-to-port-evloop"])
def test_unary_calls_across_the_packages(chan_pkg, srv_pkg, evloop):
    srv = _echo_server(srv_pkg, evloop)
    ch = PACKAGES[chan_pkg].GrpcChannel(*srv.address, timeout=5)
    try:
        assert ch.unary("/t.Svc/Echo", b"hello") == b"hello"
        assert ch.unary("/t.Svc/Echo", b"") == b""
        big = bytes(range(256)) * 1024  # 256 KiB both ways: chunking, windows
        assert ch.unary("/t.Svc/Echo", big) == big
        with pytest.raises(PACKAGES[chan_pkg].GrpcError) as ei:
            ch.unary("/t.Svc/Boom", b"x")
        assert ei.value.status == tgrpc.GRPC_INTERNAL and "kaput" in ei.value.message
        with pytest.raises(PACKAGES[chan_pkg].GrpcError) as ei:
            ch.unary("/t.Svc/Nope", b"x")
        assert ei.value.status == tgrpc.GRPC_UNIMPLEMENTED
        for i in range(20):  # the connection survives the errors
            assert ch.unary("/t.Svc/Echo", b"call %d" % i) == b"call %d" % i
    finally:
        ch.close()
        srv.stop()


@pytest.mark.parametrize("evloop", [True, False], ids=["evloop", "threaded"])
def test_both_servers_answer_a_call_with_the_same_bytes(evloop):
    """The raw response frames of one scripted call are byte-identical:
    the port's server against the JAX server in the mode ``evloop``
    names."""
    answers = []
    for pkg in ("jax", "port"):
        srv = _echo_server(pkg, evloop)
        try:
            with socket.create_connection(srv.address, timeout=5) as c:
                block = tgrpc.hpack_encode([(":method", "POST"), (":path", "/t.Svc/Echo")])
                c.sendall(tgrpc.PREFACE
                          + _frame(tgrpc.FRAME_HEADERS, tgrpc.FLAG_END_HEADERS, 1, block)
                          + _frame(tgrpc.FRAME_DATA, tgrpc.FLAG_END_STREAM, 1,
                                   tgrpc.grpc_frame(b"same")))
                answers.append(_read_until_status(c)[2])
        finally:
            srv.stop()
    assert answers[0] == answers[1]


def test_hpack_matches_the_reference():
    headers = [(":method", "POST"), ("x-custom", "v" * 300), ("te", "trailers")]
    assert tgrpc.hpack_encode(headers) == jgrpc.hpack_encode(headers)
    block = bytes([0x82, 0x40, 0x05]) + b"x-abc" + bytes([0x03]) + b"yes" + bytes([0xBE])
    assert tgrpc.HpackDecoder().decode(block) == jgrpc.HpackDecoder().decode(block)
    for bad in (bytes([0x00, 0x81, 0xFF, 0x00]), bytes([0x00]), bytes([0x00, 0x05, 0x61])):
        with pytest.raises(jgrpc.H2ProtocolError) as jerr:
            jgrpc.HpackDecoder().decode(bad)
        with pytest.raises(tgrpc.H2ProtocolError) as terr:
            tgrpc.HpackDecoder().decode(bad)
        assert str(terr.value) == str(jerr.value)


# --- frame-level cases, against the port ------------------------------------


def _frame(ftype, flags, sid, payload):
    return struct.pack("!I", len(payload))[1:] + bytes([ftype, flags]) + struct.pack("!I", sid) + payload


def _drive_server_conn(payload_frames):
    """Feed raw bytes after the preface into one server connection's
    machine, in this thread: it must raise a protocol error (the event
    loop then closes the connection)."""
    srv = tgrpc.GrpcServer({}, port=0)
    sent = []
    try:
        machine = tgrpc._H2ServerConn(srv, sent.append)
        with pytest.raises(tgrpc.H2ProtocolError):
            machine.feed(tgrpc.PREFACE + payload_frames)
    finally:
        srv.stop()


def _recv_exact(sock, n):
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise AssertionError("server closed the connection early")
        buf += chunk
    return buf


def _read_until_status(sock):
    """Server frames until the trailers carrying grpc-status: (status,
    DATA payload, every byte read)."""
    dec = tgrpc.HpackDecoder()
    data, raw = b"", b""
    while True:
        head = _recv_exact(sock, 9)
        length = int.from_bytes(head[:3], "big")
        payload = _recv_exact(sock, length) if length else b""
        raw += head + payload
        if head[3] == tgrpc.FRAME_HEADERS:
            hdrs = dict(dec.decode(payload))
            if "grpc-status" in hdrs:
                return int(hdrs["grpc-status"]), data, raw
        elif head[3] == tgrpc.FRAME_DATA:
            data += payload


def _raw_echo_conn():
    srv = tgrpc.GrpcServer({"/t.Svc/Echo": lambda p: p}, port=0)
    srv.start()
    b = socket.create_connection(srv.address, timeout=5)
    b.sendall(tgrpc.PREFACE)
    return b, srv


@pytest.mark.parametrize("frames", [
    _frame(tgrpc.FRAME_CONTINUATION, tgrpc.FLAG_END_HEADERS, 1, tgrpc.hpack_encode([("a", "b")])),
    _frame(tgrpc.FRAME_HEADERS, 0, 1, tgrpc.hpack_encode([(":path", "/x")]))
    + _frame(tgrpc.FRAME_CONTINUATION, tgrpc.FLAG_END_HEADERS, 3, b""),
    _frame(tgrpc.FRAME_HEADERS, tgrpc.FLAG_END_HEADERS | tgrpc.FLAG_PADDED, 1, b""),
    (tgrpc.MAX_FRAME + 1).to_bytes(3, "big") + bytes([tgrpc.FRAME_DATA, 0]) + (1).to_bytes(4, "big"),
    _frame(tgrpc.FRAME_HEADERS, tgrpc.FLAG_END_HEADERS, 1, bytes([0x00, 0x05, 0x61])),
], ids=["continuation-without-headers", "continuation-wrong-stream", "empty-padded-headers",
        "oversized-declared-frame", "truncated-hpack"])
def test_server_protocol_errors_are_handled(frames):
    _drive_server_conn(frames)


def test_strip_padding_and_read_frame_reject_malformed():
    assert tgrpc._strip_padding(tgrpc.FLAG_PADDED, b"\x02abXX") == b"ab"
    assert tgrpc._strip_padding(tgrpc.FLAG_PADDED, b"\x03\x00\x00\x00") == b""
    for bad in (b"", b"\x05abc"):
        with pytest.raises(tgrpc.H2ProtocolError):
            tgrpc._strip_padding(tgrpc.FLAG_PADDED, bad)
    a, b = socket.socketpair()
    a.settimeout(5)
    try:
        b.sendall((tgrpc.MAX_FRAME + 1).to_bytes(3, "big") + bytes([tgrpc.FRAME_DATA, 0])
                  + (1).to_bytes(4, "big"))
        with pytest.raises(tgrpc.H2ProtocolError, match="exceeds"):
            tgrpc.read_frame(a)
    finally:
        a.close()
        b.close()


def test_server_assembles_continuation_and_padded_frames():
    b, srv = _raw_echo_conn()
    try:
        block = tgrpc.hpack_encode([(":method", "POST"), (":path", "/t.Svc/Echo")])
        # request headers split across HEADERS + CONTINUATION
        b.sendall(_frame(tgrpc.FRAME_HEADERS, 0, 1, block[:3])
                  + _frame(tgrpc.FRAME_CONTINUATION, tgrpc.FLAG_END_HEADERS, 1, block[3:])
                  + _frame(tgrpc.FRAME_DATA, tgrpc.FLAG_END_STREAM, 1, tgrpc.grpc_frame(b"ping")))
        status, data, _ = _read_until_status(b)
        assert status == 0 and tgrpc.grpc_unframe(data) == b"ping"
        # END_STREAM on HEADERS, END_HEADERS on the CONTINUATION, no body
        b.sendall(_frame(tgrpc.FRAME_HEADERS, tgrpc.FLAG_END_STREAM, 3, block[:4])
                  + _frame(tgrpc.FRAME_CONTINUATION, tgrpc.FLAG_END_HEADERS, 3, block[4:]))
        status, _, _ = _read_until_status(b)
        assert status == tgrpc.GRPC_INTERNAL
        # PADDED|PRIORITY headers and a PADDED DATA frame
        pad = b"\x00" * 4
        b.sendall(_frame(tgrpc.FRAME_HEADERS,
                         tgrpc.FLAG_END_HEADERS | tgrpc.FLAG_PADDED | tgrpc.FLAG_PRIORITY, 5,
                         bytes([len(pad)]) + b"\x00\x00\x00\x00\x10" + block + pad)
                  + _frame(tgrpc.FRAME_DATA, tgrpc.FLAG_END_STREAM | tgrpc.FLAG_PADDED, 5,
                           bytes([len(pad)]) + tgrpc.grpc_frame(b"pad-me") + pad))
        status, data, _ = _read_until_status(b)
        assert status == 0 and tgrpc.grpc_unframe(data) == b"pad-me"
    finally:
        b.close()
        srv.stop()


def test_client_reads_trailers_split_across_continuation():
    a, b = socket.socketpair()
    a.settimeout(5)
    b.settimeout(5)
    ch = tgrpc.GrpcChannel("127.0.0.1", 1)
    ch._conn = tgrpc._ConnState(a)  # the peer is scripted

    def fake_server():
        while True:
            _, flags, sid, _ = tgrpc.read_frame(b)
            if flags & tgrpc.FLAG_END_STREAM:
                break
        hdrs = tgrpc.hpack_encode([(":status", "200"), ("content-type", "application/grpc")])
        tgrpc.write_frame(b, tgrpc.FRAME_HEADERS, tgrpc.FLAG_END_HEADERS, sid, hdrs)
        tgrpc.write_frame(b, tgrpc.FRAME_DATA, 0, sid, tgrpc.grpc_frame(b"ignored"))
        trailers = tgrpc.hpack_encode([("grpc-status", "7"), ("grpc-message", "denied")])
        tgrpc.write_frame(b, tgrpc.FRAME_HEADERS, tgrpc.FLAG_END_STREAM, sid, trailers[:3])
        tgrpc.write_frame(b, tgrpc.FRAME_CONTINUATION, tgrpc.FLAG_END_HEADERS, sid, trailers[3:])

    t = threading.Thread(target=fake_server, daemon=True)
    t.start()
    try:
        with pytest.raises(tgrpc.GrpcError) as ei:
            ch.unary("/svc/method", b"req")
        assert ei.value.status == 7 and "denied" in ei.value.message
    finally:
        t.join(timeout=5)
        a.close()
        b.close()


def test_client_and_server_sockets_set_tcp_nodelay(monkeypatch):
    seen = []

    class Spy(tgrpc._H2Protocol):
        def __init__(self, server, transport):
            seen.append(transport.sock)
            super().__init__(server, transport)

    monkeypatch.setattr(tgrpc, "_H2Protocol", Spy)
    srv = tgrpc.GrpcServer({"/t.Svc/Echo": lambda p: p})
    srv.start()
    ch = tgrpc.GrpcChannel(*srv.address, timeout=5)
    try:
        assert ch.unary("/t.Svc/Echo", b"x") == b"x"
        assert ch._conn.sock.getsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY)
        assert len(seen) == 1 and seen[0].getsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY)
    finally:
        ch.close()
        srv.stop()


# --- the event loop ----------------------------------------------------------

BLAST = bytes(range(256)) * 65536  # 16 MiB written for every byte received: more than
# the kernel's socket buffers take, so the out-buffer must hold the rest


class BlastProto:
    def __init__(self, transport):
        self.transport = transport

    def data_received(self, data):
        for _ in data:
            self.transport.write(BLAST)

    def eof_received(self):
        self.transport.close()

    def connection_lost(self, exc):
        pass


def _start_evloop(factory, **kw):
    lsock = socket.socket()
    lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    lsock.bind(("127.0.0.1", 0))
    lsock.listen(128)
    srv = EvloopServer(factory, listener_ref=lambda: lsock, **kw)
    srv.start()
    return srv, lsock


def _recv_blast(c):
    got = bytearray()
    while len(got) < len(BLAST):
        chunk = c.recv(65536)
        assert chunk, "server dropped a backpressured connection"
        got += chunk
    return bytes(got)


def test_evloop_slow_reader_gets_every_byte():
    transports = []

    def factory(t):
        transports.append(t)
        return BlastProto(t)

    srv, lsock = _start_evloop(factory, name="blast", high_water=64 * 1024, low_water=16 * 1024)
    try:
        with socket.create_connection(lsock.getsockname(), timeout=5) as c:
            c.sendall(b"x")
            deadline = time.monotonic() + 5
            while not (transports and transports[0].buffered() > 0):
                assert time.monotonic() < deadline
                time.sleep(0.01)
            assert _recv_blast(c) == BLAST
            c.sendall(b"y")  # reads resumed after the drain
            assert _recv_blast(c) == BLAST
    finally:
        srv.stop()
        lsock.close()


def test_evloop_connection_gauge_tracks_sockets():
    reg = Registry()
    srv, lsock = _start_evloop(BlastProto, name="gauged", metrics=EvloopMetrics(reg))
    try:
        conns = [socket.create_connection(lsock.getsockname(), timeout=5) for _ in range(3)]
        deadline = time.monotonic() + 5
        while srv.connection_count() < 3:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        assert 'tendermint_evloop_connections{server="gauged"} 3' in reg.expose()
        for c in conns:
            c.close()
        while srv.connection_count() > 0:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        assert 'tendermint_evloop_connections{server="gauged"} 0' in reg.expose()
    finally:
        srv.stop()
        lsock.close()


@pytest.mark.parametrize("evloop", [True, False], ids=["evloop", "threaded"])
def test_server_survives_mid_frame_disconnects(evloop):
    """The port's server, and beside it the JAX server in the mode
    ``evloop`` names, answer after the same torn connections."""
    for pkg in ("jax", "port"):
        srv = _echo_server(pkg, evloop)
        try:
            for torn in (b"", tgrpc.PREFACE[:7], tgrpc.PREFACE + b"\x00\x00",
                         tgrpc.PREFACE + b"\x00\x00\x20\x01\x04\x00\x00\x00\x01"):
                with socket.create_connection(srv.address, timeout=5) as c:
                    if torn:
                        c.sendall(torn)
            ch = tgrpc.GrpcChannel(*srv.address, timeout=5)
            try:
                assert ch.unary("/t.Svc/Echo", b"still alive") == b"still alive"
            finally:
                ch.close()
        finally:
            srv.stop()


def test_evloop_metrics_families_are_the_reference_s():
    from tendermint_tpu.libs.metrics import EvloopMetrics as JEvloopMetrics, Registry as JRegistry

    jreg, treg = JRegistry(), Registry()
    JEvloopMetrics(jreg).connections.labels(server="grpc").set(2)
    EvloopMetrics(treg).connections.labels(server="grpc").set(2)
    assert treg.expose() == jreg.expose()

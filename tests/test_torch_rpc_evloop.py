"""The port's event-loop RPC transport (``rpc/server.py`` over
``libs/evloop.py``) beside its threaded transport and the JAX package's
server, on the CPU.

``RPCServer()`` serves on the event loop by default, as the reference's
does. Over real HTTP, every read-only route of the seeded chain of
``tests/test_torch_rpc.py`` answers the same body on the port's event
loop as on its ``ThreadingHTTPServer``, and the same JSON as the JAX
server's event loop. Keep-alive and pipelined requests are served in
order, HTTP/1.0 and ``Connection: close`` close; the websocket upgrade
leaves the loop and serves subscriptions with the frames of the
threaded transport; a body over 64 MiB is answered 413 and the
connection closes. lightd takes ``workers`` and rides the
event loop. Every wait is bounded.
"""

import http.client
import json
import socket

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from tendermint_tpu.rpc.server import RPCServer as JRPCServer
from tendermint_tpu_torch import eventbus as eb
from tendermint_tpu_torch.libs.metrics import EvloopMetrics, Registry
from tendermint_tpu_torch.light.lightd import LightServer
from tendermint_tpu_torch.rpc.server import RPCServer
from tests.test_torch_lightd import _after_a_refused_body
from tests.test_torch_rpc import _requests, chain_envs  # noqa: F401  (chain_envs: a fixture)
from tests.test_torch_websocket import _recv_frame
from tests.test_websocket import WSClient

WAIT = 10.0
MUTATING = {"broadcast_tx_sync", "broadcast_tx_async", "check_tx", "remove_tx", "subscribe"}


@pytest.fixture
def serve():
    started = []

    def start(server):
        server.start()
        started.append(server)
        return server

    yield start
    for s in started:
        s.stop()


def _post(server, body: bytes):
    conn = http.client.HTTPConnection(*server.address, timeout=WAIT)
    try:
        conn.request("POST", "/", body=body, headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.getheader("Content-Type"), resp.read()
    finally:
        conn.close()


def _get(server, path: str):
    conn = http.client.HTTPConnection(*server.address, timeout=WAIT)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.getheader("Content-Type"), resp.read()
    finally:
        conn.close()


def _answer(body: bytes):
    resp = json.loads(body)
    if "error" in resp:
        return ("error", resp["error"]["code"], resp["error"]["message"])
    return json.dumps(resp["result"], sort_keys=True)


def test_the_event_loop_is_the_default_transport():
    s = RPCServer({})
    try:
        assert (s.evloop, s.transport) == (True, "evloop")
    finally:
        s.stop()
    t = RPCServer({}, evloop=False)
    try:
        assert t.transport == "threaded"
    finally:
        t.stop()


def test_route_json_over_the_event_loop_equals_the_threaded_and_the_jax_servers(chain_envs, serve):
    (env, _, executor), (jenv, _, _) = chain_envs
    ev = serve(RPCServer(env.routes()))
    th = serve(RPCServer(env.routes(), evloop=False))
    jx = serve(JRPCServer(jenv.routes(), evloop=True))
    reqs = [(m, p) for m, p in _requests(executor) if m not in MUTATING]
    assert len(reqs) > 60
    for i, (method, params) in enumerate(reqs):
        body = json.dumps({"jsonrpc": "2.0", "id": i, "method": method, "params": params}).encode()
        got_ev, got_th = _post(ev, body), _post(th, body)
        if method != "events":  # the event log's cursor is a clock reading
            assert got_ev == got_th, (method, params)
        assert got_ev[0] == 200 and got_ev[1] == "application/json"
        assert _answer(got_ev[2]) == _answer(_post(jx, body)[2]), (method, params)
    batch = b'[{"jsonrpc": "2.0", "id": 1, "method": "health"}, {"jsonrpc": "2.0", "id": 2, "method": "nope"}]'
    for body in (batch, b"[]", b"{not json", b'"a string"'):
        assert _post(ev, body) == _post(th, body), body
    for path in ("/", "/health", "/block?height=3", "/validators?height=2&per_page=2", "/nope",
                 "/debug/memstats"):
        got = _get(ev, path)
        assert got[0] == 200
        if path != "/debug/memstats":
            assert got == _get(th, path), path
    assert _get(ev, "/")[2] == _get(jx, "/")[2]


def test_keep_alive_and_pipelined_requests_are_served_in_order(serve):
    s = serve(RPCServer({"echo": lambda x=None: {"x": x}}))
    reqs = b"".join(
        b"GET /echo?x=%d HTTP/1.1\r\nHost: h\r\n\r\n" % i for i in range(3)
    ) + b"GET /echo?x=9 HTTP/1.0\r\nHost: h\r\n\r\n"
    with socket.create_connection(s.address, timeout=WAIT) as sock:
        sock.sendall(reqs)
        data = b""
        while True:  # the HTTP/1.0 request closes the connection
            chunk = sock.recv(65536)
            if not chunk:
                break
            data += chunk
    bodies = [json.loads(part.split(b"\r\n\r\n", 1)[1]) for part in data.split(b"HTTP/1.1 200 OK")[1:]]
    assert [b["result"]["x"] for b in bodies] == [0, 1, 2, 9]
    assert data.count(b"Connection: close") == 1
    with socket.create_connection(s.address, timeout=WAIT) as sock:
        sock.sendall(b"PUT / HTTP/1.1\r\nHost: h\r\nConnection: close\r\n\r\n")
        assert sock.recv(65536).startswith(b"HTTP/1.1 501 Not Implemented")


def test_a_body_over_64_mib_is_answered_413_and_the_connection_closes(serve):
    s = serve(RPCServer({"echo": lambda x=None: {"x": x}}))
    assert _after_a_refused_body(s) == [b"HTTP/1.1 413 Request Entity Too Large"]
    assert json.loads(_get(s, "/echo?x=1")[2])["result"] == {"x": 1}  # the server serves on


def test_the_websocket_upgrade_leaves_the_loop_and_sends_the_threaded_frames(serve):
    frames = []
    for evloop in (True, False):
        bus = eb.EventBus()
        s = serve(RPCServer({"health": lambda: {}}, event_bus=bus, evloop=evloop))
        client = WSClient(*s.address)
        got = []
        try:
            for rid, (method, params) in enumerate(
                    [("subscribe", {"query": "tm.event = 'Tx'"}), ("health", {}), ("nope", {})]):
                client.send_text(json.dumps({"jsonrpc": "2.0", "id": rid, "method": method, "params": params}))
                got.append(_recv_frame(client))
            assert json.loads(_get(s, "/health")[2])["result"] == {}  # the loop still serves
        finally:
            client.close()
        frames.append(got)
        assert _get(s, "/websocket")[0] == 400  # no upgrade headers
    assert frames[0] == frames[1]
    assert json.loads(frames[0][1]) == {"jsonrpc": "2.0", "id": 1, "result": {}}


def test_jax_and_port_event_loops_answer_an_unknown_route_alike(serve):
    s = serve(RPCServer({}))
    j = serve(JRPCServer({}, evloop=True))
    body = b'{"jsonrpc": "2.0", "id": 3, "method": "nope"}'
    assert _post(s, body)[2] == _post(j, body)[2]
    assert _get(s, "/nope")[2] == _get(j, "/nope")[2]


def test_lightd_takes_workers_and_rides_the_event_loop(serve):
    reg = Registry()
    lightd = LightServer(None, workers=2, registry=reg, evloop_metrics=EvloopMetrics(reg))
    serve(lightd)
    assert lightd.server.transport == "evloop" and lightd.server._ev._workers == 2
    status, _, text = _get(lightd.server, "/metrics")
    assert status == 200 and b"tendermint_evloop_connections" in text
    threaded = LightServer(None, evloop=False)
    try:
        assert threaded.server.transport == "threaded"
    finally:
        threaded.stop()

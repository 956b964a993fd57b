"""The port's RPC server's debug routes and trace context, on the CPU:
the twins of the ``/debug/traces`` cases of ``tests/test_metrics.py``
(bounded valid JSON, ``?limit``, ``?clear``, an off tracer serving an
empty document), ``?format=chrome``, ``/debug/memstats``, and the
``trace`` member of a JSON-RPC request, over HTTP on 127.0.0.1.
"""

import json
import urllib.request
from collections import deque

import pytest

torch = pytest.importorskip("torch")

from tendermint_tpu_torch.libs import tracing
from tendermint_tpu_torch.libs.metrics import OpsMetrics, Registry
from tendermint_tpu_torch.ops import introspect
from tendermint_tpu_torch.rpc.server import RPCServer


@pytest.fixture
def server():
    def echo(x=0):
        with tracing.span("echo_handler", x=x):
            return {"x": x}

    reg = Registry()
    OpsMetrics(reg)
    srv = RPCServer({"echo": echo}, metrics_registry=reg)
    srv.start()
    yield srv
    srv.stop()


@pytest.fixture
def ring_tracer():
    saved = (tracing.tracer.mode, tracing.tracer._observer, tracing.tracer._profile,
             list(tracing.tracer._ring), tracing.tracer._ring.maxlen)
    tracing.tracer.set_metrics_observer(None)
    tracing.tracer.set_profile_sink(None)
    tracing.configure("ring")
    tracing.tracer.clear()
    yield tracing.tracer
    tracing.configure(saved[0])
    tracing.tracer.set_metrics_observer(saved[1])
    tracing.tracer.set_profile_sink(saved[2])
    with tracing.tracer._lock:
        tracing.tracer._ring = deque(saved[3], maxlen=saved[4])


def _get(url):
    with urllib.request.urlopen(url, timeout=5) as resp:
        assert resp.headers["Content-Type"] == "application/json"
        return json.loads(resp.read().decode())


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=5) as resp:
        return json.loads(resp.read().decode())


def _spans(doc, name=None):
    return [e for e in doc["traceEvents"] if e.get("ph") == "X" and name in (None, e["name"])]


def test_serves_bounded_valid_json(server, ring_tracer):
    for i in range(12):
        with tracing.span("rpc_traced", i=i):
            pass
    doc = _get(f"{server.url}/debug/traces")
    assert len(_spans(doc, "rpc_traced")) == 12
    assert doc["displayTimeUnit"] == "ms" and doc["otherData"]["mode"] == "ring"
    doc = _get(f"{server.url}/debug/traces?limit=5")
    assert [e["args"]["i"] for e in _spans(doc, "rpc_traced")] == list(range(7, 12))
    chrome = _get(f"{server.url}/debug/traces?format=chrome&limit=bad")
    assert set(chrome["otherData"]) == {"epoch_unix_us"} and len(_spans(chrome)) == 12


def test_clear_drains_ring(server, ring_tracer):
    with tracing.span("once"):
        pass
    assert len(_spans(_get(f"{server.url}/debug/traces?clear=1"))) == 1
    assert not _spans(_get(f"{server.url}/debug/traces"))


def test_off_mode_serves_empty_document(server, ring_tracer):
    tracing.configure("off")
    tracing.tracer.clear()
    with tracing.span("dropped"):
        pass
    doc = _get(f"{server.url}/debug/traces")
    assert doc["otherData"]["mode"] == "off" and not _spans(doc)


def test_memstats_route_serves_the_device_tier_snapshot(server):
    doc = _get(f"{server.url}/debug/memstats")
    assert doc == json.loads(introspect.memstats_json())
    assert {"device_bytes", "resident", "profile", "exec_cache_entries", "builds"} <= set(doc)


def test_a_trace_member_puts_the_handler_under_the_callers_span(server, ring_tracer):
    ctx = tracing.TraceContext("00000000000000c1", "00000000000000c2", 1)
    resp = _post(server.url, {"jsonrpc": "2.0", "id": 7, "method": "echo",
                              "params": {"x": 3}, "trace": ctx.to_header()})
    assert resp == {"jsonrpc": "2.0", "id": 7, "result": {"x": 3}}
    doc = _get(f"{server.url}/debug/traces")
    (dispatch,) = _spans(doc, "rpc_dispatch")
    (handler,) = _spans(doc, "echo_handler")
    assert dispatch["args"] == {"method": "echo", "parent": "remote"}
    assert dispatch["trace_id"] == handler["trace_id"] == ctx.trace_id
    assert dispatch["parent_span_id"] == ctx.span_id
    assert handler["parent_span_id"] == dispatch["span_id"]


@pytest.mark.parametrize("member", [None, 42, "not-a-context", "0123-4567-01"])
def test_a_missing_or_malformed_trace_member_changes_nothing(server, ring_tracer, member):
    body = {"jsonrpc": "2.0", "id": 1, "method": "echo", "params": [5]}
    if member is not None:
        body["trace"] = member
    assert _post(server.url, body)["result"] == {"x": 5}
    doc = _get(f"{server.url}/debug/traces")
    assert not _spans(doc, "rpc_dispatch")
    (handler,) = _spans(doc, "echo_handler")
    assert "parent" not in handler["args"]

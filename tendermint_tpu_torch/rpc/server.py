"""JSON-RPC 2.0 server over HTTP.

A copy of ``tendermint_tpu/rpc/server.py`` cut to one transport: a
route table served over ``ThreadingHTTPServer`` (the reference's
``evloop=False`` transport, the same HTTP surface, with the listen
backlog of the reference's event-loop listener, 128), with

- POST: a JSON-RPC envelope, single or batch (an empty batch is one
  ``INVALID_REQUEST`` error), its body bounded at 64 MiB;
- GET ``/<method>?k=v``: URI parameters decoded by the reference's
  heuristics (quoted strings, bools, integers);
- GET ``/``: the route index; GET ``/metrics``: the text exposition of
  the registry, when one is given;
- GET ``/debug/traces``: the tracer's ring as Chrome trace JSON
  (``?limit=N`` keeps the newest N events, ``?clear=1`` empties the ring
  after the read, ``?format=chrome`` keeps only the epoch anchor of
  ``otherData``), written outside the tracer lock; GET ``/debug/memstats``: the device-tier
  snapshot of ``ops/introspect.py``;
- GET ``/websocket``: the upgrade to a websocket session
  (``rpc/websocket.py``) that serves the route table and, over
  ``event_bus``, ``subscribe``, ``unsubscribe`` and ``unsubscribe_all``
  (a request without the upgrade headers gets 400);
- a request's optional ``trace`` member (``<trace_id>-<span_id>-<flags>``,
  ``TraceContext.to_header``): the handler runs in an ``rpc_dispatch``
  span under the caller's span, so the spans it causes share the
  caller's trace. A missing or malformed member changes nothing.

Left out: the selector event-loop transport and its knob (ROADMAP §A
item 12).
"""

from __future__ import annotations

import json
import threading
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Optional, Tuple
from urllib.parse import parse_qsl, urlparse

from tendermint_tpu_torch.libs import tracing
from tendermint_tpu_torch.rpc import websocket as ws


class RPCError(Exception):
    """JSON-RPC error with code (rpc/jsonrpc/types/types.go)."""

    def __init__(self, code: int, message: str, data: str = ""):
        super().__init__(message)
        self.code = code
        self.message = message
        self.data = data


PARSE_ERROR = -32700
INVALID_REQUEST = -32600
METHOD_NOT_FOUND = -32601
INVALID_PARAMS = -32602
INTERNAL_ERROR = -32603

_MAX_BODY_BYTES = 64 << 20

# what _get_response returns for GET /websocket: the handler owns the
# upgrade (it needs the raw connection, not a body)
_WS_UPGRADE = object()


class _HTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    # The listen backlog of the reference's event-loop listener: with the
    # default of 5, a burst of concurrent connects waits out SYN retries.
    request_queue_size = 128


class RPCServer:
    """HTTP JSON-RPC server bound to a route table."""

    def __init__(
        self,
        routes: Dict[str, Callable],
        host: str = "127.0.0.1",
        port: int = 0,
        metrics_registry=None,
        event_bus=None,
    ):
        self.routes = routes
        # Prometheus text exposition at GET /metrics (the reference serves
        # it on the RPC listener too).
        self.metrics_registry = metrics_registry
        # the bus behind websocket subscribe/unsubscribe (routes.go:31-34)
        self.event_bus = event_bus
        self._thread: Optional[threading.Thread] = None
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # quiet
                pass

            def do_POST(self):
                length = int(self.headers.get("Content-Length", 0))
                # a declared Content-Length is peer data, not an
                # allocation size; the unread body would be read as the
                # next request, so the connection closes
                if length > _MAX_BODY_BYTES:
                    self.close_connection = True
                    self._send(413, "application/json", b'{"error": "request body too large"}')
                    return
                body = self.rfile.read(length) if length else b""
                self._send(200, "application/json", server._post_body(body))

            def do_GET(self):
                got = server._get_response(self.path)
                if got is _WS_UPGRADE:
                    self._upgrade()
                    return
                self._send(*got)

            def _upgrade(self):
                if not ws.is_upgrade_request(self.headers):
                    self._send(400, "application/json", b'{"error": "websocket upgrade required"}')
                    return
                self.send_response_only(101)
                self.send_header("Upgrade", "websocket")
                self.send_header("Connection", "Upgrade")
                self.send_header("Sec-WebSocket-Accept", ws.accept_key(self.headers["Sec-WebSocket-Key"]))
                self.end_headers()
                self.close_connection = True
                try:
                    ws.WSSession(ws.WSConn(self.rfile, self.wfile), server.routes, server.event_bus).run()
                except OSError:
                    pass  # the peer vanished mid-session

            def _send(self, status: int, ctype: str, body: bytes):
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                try:
                    self.wfile.write(body)
                except (BrokenPipeError, ConnectionResetError):
                    pass  # client hung up mid-response; nothing to answer

        self._httpd = _HTTPServer((host, port), Handler)

    @property
    def address(self) -> Tuple[str, int]:
        return self._httpd.server_address[:2]

    @property
    def url(self) -> str:
        host, port = self.address
        return f"http://{host}:{port}"

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True, name="rpc-server"
        )
        self._thread.start()

    def stop(self) -> None:
        # shutdown() blocks forever unless serve_forever is running, so a
        # server never started gets only server_close().
        if self._thread is not None:
            self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None

    # -- request core ----------------------------------------------------------

    def _post_body(self, body: bytes) -> bytes:
        """POST surface: JSON-RPC envelope (single or batch) -> response
        body bytes. Always HTTP 200 + application/json."""
        try:
            req = json.loads(body or b"{}")
        except (json.JSONDecodeError, UnicodeDecodeError):
            return json.dumps(_error_envelope(PARSE_ERROR, "parse error")).encode()
        if isinstance(req, list):
            if not req:
                # JSON-RPC 2.0: an empty batch is a single invalid
                # request error, not an empty array
                return json.dumps(_error_envelope(INVALID_REQUEST, "empty batch")).encode()
            return json.dumps([self._dispatch(r) for r in req]).encode()
        return json.dumps(self._dispatch(req)).encode()

    def _get_response(self, target: str):
        """GET surface: target (path?query) -> (status, content-type,
        body), or ``_WS_UPGRADE`` for GET /websocket."""
        parsed = urlparse(target)
        method = parsed.path.strip("/")
        if method == "websocket":
            return _WS_UPGRADE
        if method == "":
            return 200, "application/json", self._index().encode()
        if method == "debug/traces":
            q = dict(parse_qsl(parsed.query))
            try:
                limit = int(q["limit"]) if "limit" in q else None
            except ValueError:
                limit = None
            clear = q.get("clear") in ("1", "true")
            fmt = "chrome" if q.get("format") == "chrome" else "full"
            body = b"".join(tracing.tracer.export_chunks(limit=limit, clear=clear, fmt=fmt))
            return 200, "application/json", body
        if method == "debug/memstats":
            from tendermint_tpu_torch.ops import introspect

            return 200, "application/json", introspect.memstats_json().encode()
        if method == "metrics" and self.metrics_registry is not None:
            return 200, "text/plain; version=0.0.4", self.metrics_registry.expose().encode()
        params: Dict[str, Any] = {}
        for k, v in parse_qsl(parsed.query):
            # the reference's URI parameter decoding: quoted strings,
            # bools, integers, else the raw string
            if v.startswith('"') and v.endswith('"') and len(v) >= 2:
                params[k] = v[1:-1]
            elif v in ("true", "false"):
                params[k] = v == "true"
            else:
                try:
                    params[k] = int(v)
                except ValueError:
                    params[k] = v
        req = {"jsonrpc": "2.0", "id": -1, "method": method, "params": params}
        return 200, "application/json", json.dumps(self._dispatch(req)).encode()

    def _dispatch(self, req: Dict[str, Any]) -> Dict[str, Any]:
        if not isinstance(req, dict):
            # a valid-JSON scalar or string is an invalid request, not a
            # server error
            return _error_envelope(INVALID_REQUEST, "request must be a JSON object")
        id_ = req.get("id")
        resp: Dict[str, Any] = {"jsonrpc": "2.0", "id": id_}
        method = req.get("method")
        fn = self.routes.get(method or "")
        if fn is None:
            resp["error"] = {"code": METHOD_NOT_FOUND, "message": f"method not found: {method}"}
            return resp
        params = req.get("params") or {}
        raw_trace = req.get("trace")
        ctx = tracing.TraceContext.from_header(raw_trace) if isinstance(raw_trace, str) else None
        try:
            with tracing.attach(ctx):
                if ctx is not None:
                    with tracing.span("rpc_dispatch", method=method or ""):
                        result = _invoke(fn, params)
                else:
                    result = _invoke(fn, params)
            resp["result"] = result
        except RPCError as e:
            resp["error"] = {"code": e.code, "message": e.message, "data": e.data}
        except TypeError as e:
            resp["error"] = {"code": INVALID_PARAMS, "message": str(e)}
        except Exception as e:  # a handler's failure is the caller's answer
            resp["error"] = {
                "code": INTERNAL_ERROR,
                "message": str(e),
                "data": traceback.format_exc(limit=5),
            }
        return resp

    def _index(self) -> str:
        lines = ["Available endpoints:"]
        lines += sorted(f"  /{name}" for name in self.routes)
        return "\n".join(lines)


def _invoke(fn: Callable, params: Any) -> Any:
    if isinstance(params, dict):
        return fn(**params)
    if isinstance(params, list):
        return fn(*params)
    raise RPCError(INVALID_PARAMS, "params must be object or array")


def _error_envelope(code: int, message: str, data: str = "") -> Dict[str, Any]:
    return {
        "jsonrpc": "2.0",
        "id": None,
        "error": {"code": code, "message": message, "data": data},
    }

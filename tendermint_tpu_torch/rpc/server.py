"""JSON-RPC 2.0 server over HTTP.

A copy of ``tendermint_tpu/rpc/server.py`` without its environment knob
(``TENDERMINT_TPU_EVLOOP``): ``RPCServer(evloop=)`` chooses the
transport. The default, as in the reference, multiplexes every
connection on one selector event loop (``libs/evloop.py``) with a
bounded pool of ``workers`` for the route handlers, so a serving tier
holds many idle keep-alive sockets without a thread each;
``evloop=False`` serves over ``ThreadingHTTPServer`` instead. Both
transports answer through one dispatch core with a listen backlog of
128, so the HTTP surface is the same:

- POST: a JSON-RPC envelope, single or batch (an empty batch is one
  ``INVALID_REQUEST`` error), its body bounded at 64 MiB: a larger
  declared body is answered 413 and the connection closes (the
  reference's event loop drops such a connection without an answer);
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
  (a request without the upgrade headers gets 400); on the event loop
  the upgraded socket leaves the loop for a thread of its own;
- a request's optional ``trace`` member (``<trace_id>-<span_id>-<flags>``,
  ``TraceContext.to_header``): the handler runs in an ``rpc_dispatch``
  span under the caller's span, so the spans it causes share the
  caller's trace. A missing or malformed member changes nothing.
"""

from __future__ import annotations

import json
import socket
import threading
import traceback
from email.utils import formatdate
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Optional, Tuple
from urllib.parse import parse_qsl, urlparse

from tendermint_tpu_torch.libs import tracing
from tendermint_tpu_torch.libs.evloop import EvloopServer
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
_MAX_HEADER_BYTES = 64 * 1024
_LISTEN_BACKLOG = 128

# what _get_response returns for GET /websocket: the handler owns the
# upgrade (it needs the raw connection, not a body)
_WS_UPGRADE = object()

# what the event loop's parser hands on for a body over _MAX_BODY_BYTES
_TOO_LARGE = object()

_STATUS_PHRASES = {
    200: "OK",
    400: "Bad Request",
    413: "Request Entity Too Large",
    501: "Not Implemented",
}
_TOO_LARGE_BODY = b'{"error": "request body too large"}'


class _HTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    # The listen backlog of the event-loop listener: with the default of
    # 5, a burst of concurrent connects waits out SYN retries.
    request_queue_size = _LISTEN_BACKLOG


class _HttpProtocol:
    """The event loop's connection state machine for the HTTP/1.1
    surface.

    The loop thread feeds raw bytes; a small parser assembles one
    request at a time (the requests of one connection are served in
    order, as a per-connection handler thread serves them) and defers
    the route handler to the worker pool, which queues the response
    through the transport. Keep-alive is the HTTP/1.1 default;
    ``Connection: close`` and HTTP/1.0 behave as usual."""

    def __init__(self, server: "RPCServer", transport):
        self._server = server
        self._t = transport
        self._mtx = threading.Lock()
        self._buf = bytearray()  # guarded-by: _mtx
        self._busy = False  # a request is in flight; guarded-by: _mtx
        self._detached = False  # guarded-by: _mtx

    # --- loop-thread callbacks ----------------------------------------------

    def data_received(self, data: bytes) -> None:
        with self._mtx:
            if self._detached:
                return
            self._buf += data
        self._pump()

    def eof_received(self) -> None:
        pass  # the loop drops the connection after this

    def connection_lost(self, exc) -> None:
        pass

    # --- request assembly ----------------------------------------------------

    def _pump(self) -> None:
        with self._mtx:
            if self._busy or self._detached:
                return
            req = self._parse_locked()
            if req is None:
                return
            self._busy = True
            if req is _TOO_LARGE:
                # the unread body would be read as the next request:
                # nothing more is read from this connection
                self._detached = True
                self._buf.clear()
        if req is _TOO_LARGE:
            self._t.write(_http_head(413, "application/json", len(_TOO_LARGE_BODY), True)
                          + _TOO_LARGE_BODY)
            self._t.close()
            return
        self._t.defer(lambda: self._run(req))

    def _parse_locked(self):
        idx = self._buf.find(b"\r\n\r\n")
        if idx < 0:
            if len(self._buf) > _MAX_HEADER_BYTES:
                raise ValueError("HTTP header block too large")
            return None
        head = bytes(self._buf[:idx]).decode("latin-1")
        lines = head.split("\r\n")
        parts = lines[0].split(" ")
        if len(parts) != 3:
            raise ValueError("malformed HTTP request line")
        method, target, version = parts
        headers: Dict[str, str] = {}
        for ln in lines[1:]:
            k, _, v = ln.partition(":")
            headers[k.strip().lower()] = v.strip()
        try:
            blen = int(headers.get("content-length", "0") or "0")
        except ValueError:
            raise ValueError("malformed Content-Length")
        if blen > _MAX_BODY_BYTES:
            return _TOO_LARGE
        total = idx + 4 + blen
        if len(self._buf) < total:
            return None
        body = bytes(self._buf[idx + 4:total])
        del self._buf[:total]
        return (method, target, version, headers, body)

    # --- worker-side handling -------------------------------------------------

    def _run(self, req) -> None:
        method, target, version, headers, body = req
        try:
            conn_hdr = headers.get("connection", "").lower()
            close = "close" in conn_hdr or (version == "HTTP/1.0" and "keep-alive" not in conn_hdr)
            if method == "POST":
                status, ctype, out = 200, "application/json", self._server._post_body(body)
            elif method == "GET":
                got = self._server._get_response(target)
                if got is _WS_UPGRADE:
                    self._upgrade(headers)
                    return
                status, ctype, out = got
            else:
                status, ctype, out = 501, "application/json", b'{"error": "unsupported method"}'
            self._t.write(_http_head(status, ctype, len(out), close) + out)
            if close:
                self._t.close()
                return
        except Exception:
            # a failure with the response half planned: drop the
            # connection, never a half-written payload
            self._t.abort()
            return
        with self._mtx:
            self._busy = False
        self._pump()  # serve the next pipelined request, if buffered

    def _upgrade(self, headers: Dict[str, str]) -> None:
        shaped = {
            "Upgrade": headers.get("upgrade", ""),
            "Connection": headers.get("connection", ""),
            "Sec-WebSocket-Key": headers.get("sec-websocket-key"),
        }
        if not ws.is_upgrade_request(shaped):
            out = b'{"error": "websocket upgrade required"}'
            self._t.write(_http_head(400, "application/json", len(out), True) + out)
            self._t.close()
            return
        with self._mtx:
            self._detached = True
        sock = self._t.detach()  # the loop hands the raw socket over
        server = self._server

        def session():
            try:
                sock.sendall(
                    b"HTTP/1.1 101 Switching Protocols\r\n"
                    b"Upgrade: websocket\r\n"
                    b"Connection: Upgrade\r\n"
                    b"Sec-WebSocket-Accept: "
                    + ws.accept_key(shaped["Sec-WebSocket-Key"]).encode()
                    + b"\r\n\r\n"
                )
                conn = ws.WSConn(sock.makefile("rb"), sock.makefile("wb"))
                ws.WSSession(conn, server.routes, server.event_bus).run()
            except OSError:
                pass  # the peer vanished mid-session
            finally:
                try:
                    sock.close()
                except OSError:
                    pass  # the session is over either way

        # a thread of its own, not a pool worker: a session lives as
        # long as its client and would pin the bounded pool
        threading.Thread(target=session, name="rpc-ws-session", daemon=True).start()


def _http_head(status: int, ctype: str, length: int, close: bool) -> bytes:
    phrase = _STATUS_PHRASES.get(status, "OK")
    head = (
        f"HTTP/1.1 {status} {phrase}\r\n"
        f"Server: {BaseHTTPRequestHandler.server_version}\r\n"
        f"Date: {formatdate(usegmt=True)}\r\n"
        f"Content-Type: {ctype}\r\n"
        f"Content-Length: {length}\r\n"
    )
    if close:
        head += "Connection: close\r\n"
    return (head + "\r\n").encode("latin-1")


class RPCServer:
    """HTTP JSON-RPC server bound to a route table, on the event loop
    (``evloop=True``, the default) or on ``ThreadingHTTPServer``."""

    def __init__(
        self,
        routes: Dict[str, Callable],
        host: str = "127.0.0.1",
        port: int = 0,
        metrics_registry=None,
        event_bus=None,
        evloop: bool = True,
        evloop_metrics=None,
        workers: Optional[int] = None,
    ):
        self.routes = routes
        # Prometheus text exposition at GET /metrics (the reference serves
        # it on the RPC listener too).
        self.metrics_registry = metrics_registry
        # the bus behind websocket subscribe/unsubscribe (routes.go:31-34)
        self.event_bus = event_bus
        self.evloop = bool(evloop)
        self._evloop_metrics = evloop_metrics
        self._workers = workers
        self._ev: Optional[EvloopServer] = None
        self._lsock: Optional[socket.socket] = None
        self._httpd: Optional[_HTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        if self.evloop:
            s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            try:
                s.bind((host, port))
                s.listen(_LISTEN_BACKLOG)
            except OSError:
                s.close()
                raise
            self._lsock = s
            return
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
                    self._send(413, "application/json", _TOO_LARGE_BODY)
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
    def transport(self) -> str:
        """``"evloop"`` or ``"threaded"``."""
        return "evloop" if self.evloop else "threaded"

    @property
    def address(self) -> Tuple[str, int]:
        if self._httpd is not None:
            return self._httpd.server_address[:2]
        return self._lsock.getsockname()[:2]

    @property
    def url(self) -> str:
        host, port = self.address
        return f"http://{host}:{port}"

    def start(self) -> None:
        if self.evloop:
            kwargs = {}
            if self._evloop_metrics is not None:
                kwargs["metrics"] = self._evloop_metrics
            if self._workers is not None:
                kwargs["workers"] = self._workers
            self._ev = EvloopServer(
                lambda t: _HttpProtocol(self, t),
                listener_ref=lambda: self._lsock,
                name="rpc",
                **kwargs,
            )
            self._ev.start()
            return
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True, name="rpc-server"
        )
        self._thread.start()

    def stop(self) -> None:
        if self._ev is not None:
            self._ev.stop()
            self._ev = None
        if self._lsock is not None:
            try:
                self._lsock.close()
            except OSError:
                pass  # already closed: stop() is idempotent
            self._lsock = None
        if self._httpd is not None:
            # shutdown() blocks forever unless serve_forever is running,
            # so a server never started gets only server_close().
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

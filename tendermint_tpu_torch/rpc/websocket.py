"""JSON-RPC over WebSocket: /websocket endpoint with event subscriptions.

A copy of ``tendermint_tpu/rpc/websocket.py``, whole. The reference serves subscribe/unsubscribe/unsubscribe_all exclusively
over websocket (internal/rpc/core/routes.go:31-34, rpc/jsonrpc/server
websocket handler); this is a from-scratch RFC 6455 server endpoint
grafted onto the stdlib HTTP server the RPC layer already runs:

- handshake: Sec-WebSocket-Accept = b64(SHA1(key + GUID)), 101 upgrade
- frames: client-masked text/ping/close handled; server replies unmasked
- JSON-RPC: every request on the socket goes through the normal route
  table, PLUS the three websocket-only methods backed by the event bus.

Event delivery matches the reference contract: each match is pushed as a
JSON-RPC response whose id is the original subscribe request id and
whose result carries {query, data: {type, value}, events}.
"""

from __future__ import annotations

import base64
import hashlib
import json
import struct
import threading
from typing import Any, Dict, Optional

_WS_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"

OP_CONT = 0x0
OP_TEXT = 0x1
OP_BIN = 0x2
OP_CLOSE = 0x8
OP_PING = 0x9
OP_PONG = 0xA

MAX_WS_FRAME = 16 << 20


class WSClosed(Exception):
    pass


def accept_key(client_key: str) -> str:
    digest = hashlib.sha1((client_key + _WS_GUID).encode()).digest()
    return base64.b64encode(digest).decode()


def is_upgrade_request(headers) -> bool:
    return (
        headers.get("Upgrade", "").lower() == "websocket"
        and "upgrade" in headers.get("Connection", "").lower()
        and headers.get("Sec-WebSocket-Key") is not None
    )


class WSConn:
    """One upgraded connection: framed send/recv over the raw socket."""

    def __init__(self, rfile, wfile):
        self._rfile = rfile
        self._wfile = wfile
        self._send_lock = threading.Lock()
        self.closed = threading.Event()

    # --- frame IO -----------------------------------------------------------

    def _read_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self._rfile.read(n - len(buf))
            if not chunk:
                raise WSClosed("connection closed")
            buf += chunk
        return buf

    def recv_message(self) -> Optional[str]:
        """Next text message; None when the peer closes. Handles ping,
        pong, fragmentation, and masking (clients MUST mask: RFC 6455
        §5.1)."""
        fragments = []
        while True:
            hdr = self._read_exact(2)
            fin = bool(hdr[0] & 0x80)
            opcode = hdr[0] & 0x0F
            masked = bool(hdr[1] & 0x80)
            length = hdr[1] & 0x7F
            if length == 126:
                (length,) = struct.unpack(">H", self._read_exact(2))
            elif length == 127:
                (length,) = struct.unpack(">Q", self._read_exact(8))
            if length > MAX_WS_FRAME:
                raise WSClosed("frame too large")
            mask = self._read_exact(4) if masked else b""
            payload = self._read_exact(length)
            if masked:
                payload = bytes(
                    b ^ mask[i % 4] for i, b in enumerate(payload)
                )
            if opcode == OP_CLOSE:
                try:
                    self._send_frame(OP_CLOSE, payload[:2])
                except Exception:
                    pass
                return None
            if opcode == OP_PING:
                self._send_frame(OP_PONG, payload)
                continue
            if opcode == OP_PONG:
                continue
            if opcode in (OP_TEXT, OP_BIN, OP_CONT):
                fragments.append(payload)
                # the per-frame cap must also bound the reassembled
                # message, or endless continuations grow without limit
                if sum(len(f) for f in fragments) > MAX_WS_FRAME:
                    raise WSClosed("message too large")
                if fin:
                    return b"".join(fragments).decode("utf-8", "replace")
                continue
            raise WSClosed(f"unsupported opcode {opcode}")

    def _send_frame(self, opcode: int, payload: bytes) -> None:
        hdr = bytearray([0x80 | opcode])
        n = len(payload)
        if n < 126:
            hdr.append(n)
        elif n < 1 << 16:
            hdr.append(126)
            hdr += struct.pack(">H", n)
        else:
            hdr.append(127)
            hdr += struct.pack(">Q", n)
        with self._send_lock:
            self._wfile.write(bytes(hdr) + payload)
            self._wfile.flush()

    def send_json(self, doc: Dict[str, Any]) -> None:
        self._send_frame(
            OP_TEXT, json.dumps(doc, separators=(",", ":")).encode()
        )

    def close(self) -> None:
        if not self.closed.is_set():
            self.closed.set()
            try:
                self._send_frame(OP_CLOSE, b"")
            except Exception:
                pass


class WSSession:
    """JSON-RPC dispatch + subscription pump for one websocket client
    (rpc/jsonrpc/server ws handler + internal/rpc/core/events.go)."""

    _ids = threading.Lock()
    _next_id = [0]

    def __init__(self, conn: WSConn, routes: Dict[str, Any], event_bus):
        self.conn = conn
        self.routes = routes
        self.event_bus = event_bus
        with self._ids:
            self._next_id[0] += 1
            self.subscriber = f"ws-{self._next_id[0]}"

    # --- main loop ----------------------------------------------------------

    def run(self) -> None:
        try:
            while True:
                raw = self.conn.recv_message()
                if raw is None:
                    return
                try:
                    req = json.loads(raw)
                except json.JSONDecodeError:
                    self.conn.send_json(
                        _err(None, -32700, "parse error")
                    )
                    continue
                self._dispatch(req)
        except WSClosed:
            pass
        finally:
            self._teardown()

    def _teardown(self) -> None:
        if self.event_bus is not None:
            try:
                self.event_bus.unsubscribe_all(self.subscriber)
            except Exception:
                pass
        self.conn.close()

    # --- dispatch -----------------------------------------------------------

    def _dispatch(self, req: Dict[str, Any]) -> None:
        rid = req.get("id")
        method = req.get("method")
        params = req.get("params") or {}
        if not isinstance(params, dict):
            self.conn.send_json(_err(rid, -32602, "params must be a map"))
            return
        try:
            if method in ("subscribe", "unsubscribe", "unsubscribe_all"):
                if self.event_bus is None:
                    self.conn.send_json(
                        _err(rid, -32603, "event bus not configured")
                    )
                    return
                if method == "subscribe":
                    self._subscribe(rid, params)
                elif method == "unsubscribe":
                    query = params.get("query", "")
                    self.event_bus.unsubscribe(self.subscriber, query)
                    self.conn.send_json(_ok(rid, {}))
                else:
                    self.event_bus.unsubscribe_all(self.subscriber)
                    self.conn.send_json(_ok(rid, {}))
            elif method in self.routes:
                result = self.routes[method](**params)
                self.conn.send_json(_ok(rid, result))
            else:
                self.conn.send_json(
                    _err(rid, -32601, f"method not found: {method}")
                )
        except WSClosed:
            raise
        except Exception as e:
            code = getattr(e, "code", -32603)
            self.conn.send_json(_err(rid, code, str(e)))

    def _subscribe(self, rid, params: Dict[str, Any]) -> None:
        query = params.get("query", "")
        if not query:
            self.conn.send_json(_err(rid, -32602, "query required"))
            return
        sub = self.event_bus.subscribe(self.subscriber, query, capacity=256)
        self.conn.send_json(_ok(rid, {}))

        def pump():
            from tendermint_tpu_torch.rpc.core import _event_data_json

            while not self.conn.closed.is_set() and not sub.cancelled.is_set():
                msg = sub.next(timeout=0.5)
                if msg is None:
                    continue
                data = _event_data_json(msg.data)
                try:
                    self.conn.send_json(
                        _ok(
                            rid,
                            {
                                "query": query,
                                "data": data,
                                "events": _events_json(msg.events),
                            },
                        )
                    )
                except Exception:
                    self.conn.close()
                    return

        threading.Thread(
            target=pump, name=f"{self.subscriber}-pump", daemon=True
        ).start()


def _events_json(events) -> Dict[str, list]:
    out: Dict[str, list] = {}
    try:
        for key, values in events.items():
            out[key] = [str(v) for v in values]
    except AttributeError:
        pass
    return out


def _ok(rid, result) -> Dict[str, Any]:
    return {"jsonrpc": "2.0", "id": rid, "result": result}


def _err(rid, code: int, message: str) -> Dict[str, Any]:
    return {
        "jsonrpc": "2.0",
        "id": rid,
        "error": {"code": code, "message": message, "data": ""},
    }

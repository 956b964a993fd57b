"""HTTP JSON-RPC client (rpc/client/http analog, stdlib urllib only).

A copy of ``tendermint_tpu/rpc/client.py``, whole.
"""

from __future__ import annotations

import base64
import itertools
import json
import urllib.request
from typing import Any, Dict, Optional

from tendermint_tpu_torch.libs import tracing


class RPCClientError(Exception):
    def __init__(self, code: int, message: str, data: str = ""):
        super().__init__(f"RPC error {code}: {message}")
        self.code = code
        self.message = message
        self.data = data


class HTTPClient:
    """JSON-RPC over HTTP POST. Method calls are plain dicts in/out."""

    def __init__(self, url: str, timeout: float = 10.0):
        self.url = url.rstrip("/")
        self.timeout = timeout
        self._ids = itertools.count(1)

    def call(self, method: str, params: Optional[Dict[str, Any]] = None, timeout: Optional[float] = None) -> Any:
        req = {
            "jsonrpc": "2.0",
            "id": next(self._ids),
            "method": method,
            "params": params or {},
        }
        # cross-process trace propagation: when this thread is inside a
        # recorded span, ride its context as the optional "trace" member
        # so the server's handler spans link under ours in a merged
        # fleet timeline (rpc/server._dispatch attaches it)
        ctx = tracing.current_context()
        if ctx is not None:
            req["trace"] = ctx.to_header()
        data = json.dumps(req).encode()
        http_req = urllib.request.Request(
            self.url,
            data=data,
            headers={"Content-Type": "application/json"},
            method="POST",
        )
        with urllib.request.urlopen(http_req, timeout=timeout or self.timeout) as resp:
            body = json.loads(resp.read().decode())
        if "error" in body and body["error"] is not None:
            e = body["error"]
            raise RPCClientError(e.get("code", -1), e.get("message", ""), e.get("data", ""))
        return body.get("result")

    # -- convenience wrappers (rpc/client/client.go surface) ------------------

    def status(self):
        return self.call("status")

    def health(self):
        return self.call("health")

    def block(self, height: Optional[int] = None):
        return self.call("block", {"height": height} if height is not None else {})

    def commit(self, height: Optional[int] = None):
        return self.call("commit", {"height": height} if height is not None else {})

    def validators(self, height: Optional[int] = None, page: int = 1, per_page: int = 100):
        p: Dict[str, Any] = {"page": page, "per_page": per_page}
        if height is not None:
            p["height"] = height
        return self.call("validators", p)

    def broadcast_tx_sync(self, tx: bytes):
        return self.call("broadcast_tx_sync", {"tx": base64.b64encode(tx).decode()})

    def broadcast_tx_commit(self, tx: bytes, timeout: float = 30.0):
        return self.call(
            "broadcast_tx_commit",
            {"tx": base64.b64encode(tx).decode()},
            timeout=timeout + 5.0,
        )

    def abci_query(self, path: str, data: bytes, height: int = 0, prove: bool = False):
        return self.call(
            "abci_query",
            {"path": path, "data": "0x" + data.hex(), "height": height, "prove": prove},
        )

    def abci_info(self):
        return self.call("abci_info")

    def tx(self, tx_hash: bytes):
        return self.call("tx", {"hash": "0x" + tx_hash.hex()})

    def tx_search(self, query: str, page: int = 1, per_page: int = 30):
        return self.call(
            "tx_search", {"query": query, "page": page, "per_page": per_page}
        )

    def block_search(self, query: str, page: int = 1, per_page: int = 30):
        return self.call(
            "block_search", {"query": query, "page": page, "per_page": per_page}
        )

    def events(self, query: str = "", after: int = 0, wait_time: float = 5.0, max_items: int = 100):
        params: Dict[str, Any] = {
            "maxItems": max_items,
            "after": after,
            "waitTime": wait_time,
        }
        if query:
            params["filter"] = {"query": query}
        return self.call("events", params, timeout=wait_time + 5.0)

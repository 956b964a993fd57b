"""ABCI socket client: drive an out-of-process app.

A copy of ``tendermint_tpu/abci/socket_client.py``: the counterpart of
abci/client/socket_client.go:417 with synchronous call semantics (the
executor, the mempool and the syncers are synchronous callers). One TCP
connection, one in-flight request at a time behind a mutex, bounded
per-call timeout, auto-reconnect on the next call after a connection
failure.
"""

from __future__ import annotations

import socket
import threading
from typing import Optional

from tendermint_tpu_torch.abci import codec
from tendermint_tpu_torch.abci import types as abci
from tendermint_tpu_torch.abci.client import AbciClient


class ABCIConnectionError(ConnectionError):
    pass


class SocketClient(AbciClient):
    def __init__(self, host: str, port: int, timeout: float = 10.0):
        self._addr = (host, port)
        self._timeout = timeout
        self._sock: Optional[socket.socket] = None
        self._mtx = threading.Lock()
        self._running = False

    # --- lifecycle ------------------------------------------------------------

    def start(self) -> None:
        with self._mtx:
            self._connect()
            self._running = True

    def stop(self) -> None:
        with self._mtx:
            self._running = False
            self._close()

    def is_running(self) -> bool:
        return self._running

    def _connect(self) -> None:
        if self._sock is not None:
            return
        s = socket.create_connection(self._addr, timeout=self._timeout)
        s.settimeout(self._timeout)
        self._sock = s

    def _close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    # --- request plumbing -------------------------------------------------------

    def _call(self, type_: str, body) -> dict:
        with self._mtx:
            try:
                self._connect()
                self._sock.sendall(codec.encode_frame("req", type_, body))
                raw = codec.read_frame(self._sock)
            except (OSError, ValueError) as exc:
                self._close()
                raise ABCIConnectionError(f"abci {type_}: {exc}") from exc
            if raw is None:
                self._close()
                raise ABCIConnectionError(f"abci {type_}: connection closed")
        kind, rtype, rbody = codec.decode_frame(raw)
        if kind == "exc":
            raise RuntimeError(f"abci {type_} failed: {rbody.get('error')}")
        if rtype != type_:
            self._close()
            raise ABCIConnectionError(
                f"abci response type {rtype!r} != request {type_!r}"
            )
        return rbody

    def _request(self, type_: str, req):
        _, res_cls = codec.METHODS[type_]
        body = codec.encode_obj(req) if req is not None else None
        return codec.decode_obj(res_cls, self._call(type_, body))

    # --- AbciClient -------------------------------------------------------------

    def echo(self, msg: str) -> str:
        return self._call("echo", {"message": msg}).get("message", "")

    def flush(self) -> None:
        self._call("flush", None)

    def info(self, req):
        return self._request("info", req)

    def query(self, req):
        return self._request("query", req)

    def check_tx(self, req):
        return self._request("check_tx", req)

    def init_chain(self, req):
        return self._request("init_chain", req)

    def prepare_proposal(self, req):
        return self._request("prepare_proposal", req)

    def process_proposal(self, req):
        return self._request("process_proposal", req)

    def extend_vote(self, req):
        return self._request("extend_vote", req)

    def verify_vote_extension(self, req):
        return self._request("verify_vote_extension", req)

    def finalize_block(self, req):
        return self._request("finalize_block", req)

    def commit(self):
        return self._request("commit", None)

    def list_snapshots(self, req):
        return self._request("list_snapshots", req)

    def offer_snapshot(self, req):
        return self._request("offer_snapshot", req)

    def load_snapshot_chunk(self, req):
        return self._request("load_snapshot_chunk", req)

    def apply_snapshot_chunk(self, req):
        return self._request("apply_snapshot_chunk", req)

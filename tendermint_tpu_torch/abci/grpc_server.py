"""ABCI gRPC transport: server side (abci/server/grpc_server.go:83).

A copy of ``tendermint_tpu/abci/grpc_server.py``: serves an in-process
Application over the port's gRPC stack. One handler per ABCI method,
payloads in the shared dataclass codec (see grpc_client.py). App calls
are serialized under one mutex — ABCI apps are single-threaded by
contract, same as the socket server.
"""

from __future__ import annotations

import json
import threading
from typing import Optional

from tendermint_tpu_torch.abci import codec
from tendermint_tpu_torch.abci import types as abci
from tendermint_tpu_torch.abci.grpc_client import SERVICE, _camel
from tendermint_tpu_torch.libs.grpc import GRPC_INTERNAL, GrpcError, GrpcServer


class GrpcABCIServer:
    def __init__(self, app: abci.Application, host: str = "127.0.0.1",
                 port: int = 0):
        self.app = app
        self._app_mtx = threading.Lock()
        handlers = {SERVICE + "Echo": self._echo, SERVICE + "Flush": self._flush}
        for type_ in codec.METHODS:
            handlers[SERVICE + _camel(type_)] = self._make_handler(type_)
        self._server = GrpcServer(handlers, host, port)

    @property
    def address(self):
        return self._server.address

    def start(self) -> None:
        self._server.start()

    def stop(self) -> None:
        self._server.stop()

    def serve_forever(self) -> None:
        self.start()
        threading.Event().wait()

    # --- handlers -----------------------------------------------------------

    def _echo(self, payload: bytes) -> bytes:
        body = json.loads(payload.decode() or "{}")
        return json.dumps({"message": body.get("message", "")}).encode()

    def _flush(self, payload: bytes) -> bytes:
        return b"{}"

    def _make_handler(self, type_: str):
        req_cls, _ = codec.METHODS[type_]

        def handle(payload: bytes) -> bytes:
            body = json.loads(payload.decode() or "{}")
            try:
                req = (
                    codec.decode_obj(req_cls, body)
                    if req_cls is not type(None)
                    else None
                )
                with self._app_mtx:
                    method = getattr(self.app, type_)
                    resp = method(req) if req is not None else method()
            except Exception as exc:
                raise GrpcError(GRPC_INTERNAL, f"abci {type_}: {exc}") from exc
            return json.dumps(codec.encode_obj(resp)).encode()

        return handle

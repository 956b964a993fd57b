"""ABCI gRPC transport: client side.

A copy of ``tendermint_tpu/abci/grpc_client.py``: the reference's third
ABCI transport (abci/client/grpc_client.go:184; the others are local and
socket). Calls ride the port's gRPC stack (libs/grpc.py — HTTP/2
framing + HPACK) as unary RPCs on
``/tendermint.abci.ABCIApplication/<Method>``. Message payloads use the
same dataclass-reflection codec as the socket transport (abci/codec.py)
serialized as JSON bytes, the reference's bytes.
"""

from __future__ import annotations

import json
from typing import Optional

from tendermint_tpu_torch.abci import codec
from tendermint_tpu_torch.abci import types as abci
from tendermint_tpu_torch.abci.client import AbciClient
from tendermint_tpu_torch.libs.grpc import GrpcChannel, GrpcError

SERVICE = "/tendermint.abci.ABCIApplication/"

# method name on AbciClient -> gRPC method (CamelCase, reference naming)
def _camel(name: str) -> str:
    return "".join(w.capitalize() for w in name.split("_"))


class GrpcClient(AbciClient):
    """Synchronous ABCI client over gRPC; same call surface and
    single-in-flight semantics as SocketClient."""

    def __init__(self, host: str, port: int, timeout: float = 10.0):
        self._chan = GrpcChannel(host, port, timeout=timeout)
        self._running = False

    def start(self) -> None:
        # Probe with echo so a dead endpoint fails at start, not mid-block.
        self._running = True
        self.echo("grpc-start")

    def stop(self) -> None:
        self._running = False
        self._chan.close()

    def is_running(self) -> bool:
        return self._running

    def _call(self, type_: str, body) -> dict:
        payload = json.dumps(body if body is not None else {}).encode()
        try:
            raw = self._chan.unary(SERVICE + _camel(type_), payload)
        except GrpcError as e:
            raise RuntimeError(f"abci {type_} failed: {e.message}") from e
        return json.loads(raw.decode()) if raw else {}

    def _request(self, type_: str, req):
        _, res_cls = codec.METHODS[type_]
        body = codec.encode_obj(req) if req is not None else None
        return codec.decode_obj(res_cls, self._call(type_, body))

    # --- AbciClient ---------------------------------------------------------

    def echo(self, msg: str) -> str:
        return self._call("echo", {"message": msg}).get("message", "")

    def flush(self) -> None:
        self._call("flush", {})

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

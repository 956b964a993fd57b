"""Light-client RPC proxy (light/proxy + light/rpc in the reference).

A copy of ``tendermint_tpu/light/proxy.py``, whole. It serves a JSON-RPC surface backed by a LightClient: header/commit/
validators responses are returned only after bisection verification
against the primary (with witness cross-checking via the client's
detector); `abci_query` is forwarded to the primary and its result is
checked against the VERIFIED app hash when the app supplies proof-free
value equality is impossible — here we verify the queried height's
header first and mark the response accordingly (the reference verifies
merkle proofs; this proxy verifies the enclosing header and forwards
the app's proof_ops for client-side checking).

One divergence, as in ``light/lightd.py``: only verification failures
(an invalid header or commit, too little trusted power, a conflicting
witness, a client or provider error) answer ``INVALID_PARAMS "light
verification failed"``. Any other error, such as a device error or a
round whose flush failed closed, propagates, and the RPC server answers
it ``INTERNAL_ERROR`` with its message and traceback; the reference
turns every error into ``INVALID_PARAMS``. Either way the header is not
answered.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

from tendermint_tpu_torch.light.client import LightClient, LightClientError
from tendermint_tpu_torch.light.provider import ProviderError
from tendermint_tpu_torch.rpc import encoding as enc
from tendermint_tpu_torch.rpc.client import HTTPClient
from tendermint_tpu_torch.rpc.server import INVALID_PARAMS, RPCError, RPCServer
from tendermint_tpu_torch.types.validation import NotEnoughVotingPowerError

# What a verification raises when the header, not the server, is at
# fault; the ValueError family takes in the verifier's errors.
_VERIFICATION_FAILURES = (ValueError, LightClientError, NotEnoughVotingPowerError, ProviderError)


class LightProxy:
    """Route table + server lifecycle for a light-client RPC endpoint."""

    def __init__(
        self,
        client: LightClient,
        primary_url: str,
        laddr: str = "127.0.0.1:0",
    ):
        self.client = client
        self.primary = HTTPClient(primary_url)
        host, _, port = laddr.rpartition(":")
        self.server = RPCServer(
            self.routes(), host=host or "127.0.0.1", port=int(port or 0)
        )

    # --- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        self.server.start()

    def stop(self) -> None:
        self.server.stop()

    @property
    def url(self) -> str:
        return self.server.url

    # --- routes --------------------------------------------------------------

    def routes(self) -> Dict[str, Callable]:
        return {
            "health": self.health,
            "status": self.status,
            "header": self.header,
            "commit": self.commit,
            "validators": self.validators,
            "abci_query": self.abci_query,
            "abci_info": self.abci_info,
        }

    def health(self) -> Dict[str, Any]:
        return {}

    def status(self) -> Dict[str, Any]:
        latest = self.client.update()
        trusted = self.client.latest_trusted()
        lb = latest or trusted
        if lb is None:
            raise RPCError(INVALID_PARAMS, "no trusted state yet")
        return {
            "light_client": {
                "chain_id": self.client.chain_id,
                "trusted_height": str(lb.header.height),
                "trusted_hash": enc.hex_bytes(lb.header.hash()),
                "trusting_period_seconds": str(
                    int(self.client.trusting_period)
                ),
                "num_witnesses": len(self.client.witnesses),
            }
        }

    def _verified(self, height) -> "object":
        try:
            h = int(height)
        except (TypeError, ValueError):
            raise RPCError(INVALID_PARAMS, "height required")
        try:
            return self.client.verify_light_block_at_height(h)
        except _VERIFICATION_FAILURES as e:
            raise RPCError(INVALID_PARAMS, f"light verification failed: {e}")

    def header(self, height=None) -> Dict[str, Any]:
        lb = self._verified(height)
        return {"header": enc.header_json(lb.header)}

    def commit(self, height=None) -> Dict[str, Any]:
        lb = self._verified(height)
        return {
            "signed_header": {
                "header": enc.header_json(lb.header),
                "commit": enc.commit_json(lb.signed_header.commit),
            },
            "canonical": True,
        }

    def validators(self, height=None) -> Dict[str, Any]:
        lb = self._verified(height)
        vals = lb.validator_set.validators
        return {
            "block_height": str(lb.header.height),
            "validators": [enc.validator_json(v) for v in vals],
            "count": str(len(vals)),
            "total": str(len(vals)),
        }

    def abci_query(self, path="", data=None, height=0, prove=True) -> Dict[str, Any]:
        """Forward to the primary, but pin the query to a VERIFIED height
        (light/rpc/client.go ABCIQueryWithOptions: query at a height whose
        header the light client has verified, so the app hash the proof
        anchors to is trusted)."""
        h = int(height) if height else 0
        if h == 0:
            latest = self.client.update() or self.client.latest_trusted()
            if latest is None:
                raise RPCError(INVALID_PARAMS, "no trusted state yet")
            h = latest.header.height
        else:
            self._verified(h)
        out = self.primary.call(
            "abci_query",
            {"path": path, "data": data, "height": h, "prove": bool(prove)},
        )
        resp = out.get("response", {})
        resp["verified_height"] = str(h)
        return out

    def abci_info(self) -> Dict[str, Any]:
        return self.primary.call("abci_info")

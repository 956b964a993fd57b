"""gRPC remote signer (privval/grpc/client.go, privval/grpc/server.go).

A copy of ``tendermint_tpu/privval/grpc.py`` over the port's gRPC stack
(libs/grpc.py), with the reference's bytes. Direction matches the
reference's gRPC flavor: the NODE is the gRPC client dialing the
signer's server (the socket flavor is inverted — the signer dials in).
Unary methods on ``/tendermint.privval.PrivValidatorAPI/``:

- GetPubKey  {chain_id} -> {key_type, pub_key}
- SignVote   {chain_id, vote} -> {vote} | {error}
- SignProposal {chain_id, proposal} -> {proposal} | {error}

Payloads are JSON with proto-encoded vote/proposal bytes in base64 —
the same bodies the socket remote signer exchanges (privval/remote.py),
so the two transports stay behaviorally identical: the wrapped FilePV's
last-sign-state double-sign guard refuses conflicting requests and the
refusal surfaces as a remote signer error on the node.

Runnable: ``python -m tendermint_tpu_torch.privval.grpc --addr HOST:PORT
--chain-id ... --key-file ... --state-file ...`` prints ``grpc signer
serving on HOST:PORT``.
"""

from __future__ import annotations

import base64
import json
import threading
from typing import Optional

from tendermint_tpu_torch.crypto.keys import PubKey, pubkey_from_type_and_bytes
from tendermint_tpu_torch.libs.grpc import (
    GRPC_INTERNAL,
    GrpcChannel,
    GrpcError,
    GrpcServer,
)
from tendermint_tpu_torch.privval.base import PrivValidator
from tendermint_tpu_torch.privval.remote import RemoteSignerError
from tendermint_tpu_torch.types.block import Proposal, Vote

SERVICE = "/tendermint.privval.PrivValidatorAPI/"


class GrpcSignerClient(PrivValidator):
    """types.PrivValidator backed by a remote gRPC signer
    (privval/grpc/client.go:1)."""

    def __init__(self, host: str, port: int, chain_id: str,
                 timeout: float = 10.0):
        self._chan = GrpcChannel(host, port, timeout=timeout)
        self._chain_id = chain_id
        self._cached_pubkey: Optional[PubKey] = None

    def close(self) -> None:
        self._chan.close()

    def _call(self, method: str, body: dict) -> dict:
        try:
            raw = self._chan.unary(
                SERVICE + method, json.dumps(body).encode()
            )
        except GrpcError as e:
            raise RemoteSignerError(e.message or str(e)) from e
        resp = json.loads(raw.decode()) if raw else {}
        if resp.get("error"):
            raise RemoteSignerError(resp["error"])
        return resp

    def get_pub_key(self) -> PubKey:
        if self._cached_pubkey is not None:
            return self._cached_pubkey
        body = self._call("GetPubKey", {"chain_id": self._chain_id})
        pub = pubkey_from_type_and_bytes(
            body["key_type"], base64.b64decode(body["pub_key"])
        )
        self._cached_pubkey = pub
        return pub

    def sign_vote(self, chain_id: str, vote: Vote) -> None:
        body = self._call(
            "SignVote",
            {
                "chain_id": chain_id,
                "vote": base64.b64encode(vote.to_proto_bytes()).decode(),
            },
        )
        signed = Vote.from_proto_bytes(base64.b64decode(body["vote"]))
        vote.signature = signed.signature
        vote.timestamp = signed.timestamp
        vote.extension_signature = signed.extension_signature

    def sign_proposal(self, chain_id: str, proposal: Proposal) -> None:
        body = self._call(
            "SignProposal",
            {
                "chain_id": chain_id,
                "proposal": base64.b64encode(proposal.to_proto_bytes()).decode(),
            },
        )
        signed = Proposal.from_proto_bytes(base64.b64decode(body["proposal"]))
        proposal.signature = signed.signature
        proposal.timestamp = signed.timestamp


class GrpcSignerServer:
    """Signer-side gRPC service wrapping a local PrivValidator (usually
    FilePV — its HRS guard is the double-sign protection;
    privval/grpc/server.go:1)."""

    def __init__(self, priv_validator: PrivValidator, chain_id: str,
                 host: str = "127.0.0.1", port: int = 0):
        self._pv = priv_validator
        self._chain_id = chain_id
        self._mtx = threading.Lock()
        self._server = GrpcServer(
            {
                SERVICE + "GetPubKey": self._get_pub_key,
                SERVICE + "SignVote": self._sign_vote,
                SERVICE + "SignProposal": self._sign_proposal,
            },
            host,
            port,
        )

    @property
    def address(self):
        return self._server.address

    def start(self) -> None:
        self._server.start()

    def stop(self) -> None:
        self._server.stop()

    def _check_chain(self, body: dict) -> Optional[bytes]:
        if body.get("chain_id") != self._chain_id:
            return json.dumps(
                {"error": f"chain id mismatch: {body.get('chain_id')!r}"}
            ).encode()
        return None

    def _get_pub_key(self, payload: bytes) -> bytes:
        body = json.loads(payload.decode() or "{}")
        err = self._check_chain(body)
        if err is not None:
            return err
        pub = self._pv.get_pub_key()
        return json.dumps(
            {
                "key_type": pub.type,
                "pub_key": base64.b64encode(pub.bytes()).decode(),
            }
        ).encode()

    def _sign_vote(self, payload: bytes) -> bytes:
        body = json.loads(payload.decode() or "{}")
        err = self._check_chain(body)
        if err is not None:
            return err
        try:
            vote = Vote.from_proto_bytes(base64.b64decode(body["vote"]))
            with self._mtx:
                self._pv.sign_vote(body["chain_id"], vote)
            return json.dumps(
                {"vote": base64.b64encode(vote.to_proto_bytes()).decode()}
            ).encode()
        except Exception as exc:  # double-sign refusal etc. -> error body
            return json.dumps({"error": str(exc)}).encode()

    def _sign_proposal(self, payload: bytes) -> bytes:
        body = json.loads(payload.decode() or "{}")
        err = self._check_chain(body)
        if err is not None:
            return err
        try:
            proposal = Proposal.from_proto_bytes(
                base64.b64decode(body["proposal"])
            )
            with self._mtx:
                self._pv.sign_proposal(body["chain_id"], proposal)
            return json.dumps(
                {
                    "proposal": base64.b64encode(
                        proposal.to_proto_bytes()
                    ).decode()
                }
            ).encode()
        except Exception as exc:
            return json.dumps({"error": str(exc)}).encode()


def main(argv=None) -> int:
    """Run a serving gRPC signer around a FilePV (the node dials us —
    privval/grpc/server.go's process shape)."""
    import argparse

    from tendermint_tpu_torch.privval.file_pv import FilePV

    ap = argparse.ArgumentParser(
        prog="python -m tendermint_tpu_torch.privval.grpc",
        description="out-of-process validator signer (gRPC server; node dials)",
    )
    ap.add_argument("--addr", required=True, help="host:port to serve on")
    ap.add_argument("--chain-id", required=True)
    ap.add_argument("--key-file", required=True)
    ap.add_argument("--state-file", required=True)
    args = ap.parse_args(argv)

    pv = FilePV.load_or_generate(args.key_file, args.state_file)
    host, _, port = args.addr.rpartition(":")
    server = GrpcSignerServer(
        pv, args.chain_id, host or "127.0.0.1", int(port)
    )
    server.start()
    print(
        f"grpc signer serving on {server.address[0]}:{server.address[1]}",
        flush=True,
    )
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

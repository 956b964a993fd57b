"""Remote signer: socket privval client/server.

A copy of ``tendermint_tpu/privval/remote.py``, byte for byte on the
wire, so a JAX signer serves a port node and the reverse. The validator
node keeps no key material; it exposes a listener that an
out-of-process signer dials into, and every GetPubKey/SignVote/
SignProposal round-trips over that connection. Direction matches the
reference (privval/signer_listener_endpoint.go / signer_dialer_endpoint.go):
the NODE listens, the SIGNER dials — so the key-holding process makes
only outbound connections. Double-sign protection lives on the signer
side (FilePV's last-sign-state), exactly as in the reference
(privval/file.go:135-170 behind signer_server.go).

Transports: ``tcp://host:port`` (wrapped in the port's p2p
SecretConnection — privval/secret_connection.go is the reference's own
copy of the same scheme) and ``unix:///path`` (plain; filesystem
permissions are the boundary, matching the reference's
IsConnFromUnixSocket handling).

Wire format: 4-byte big-endian length frames carrying JSON
``{"type": ..., "body": {...}}`` with proto-encoded votes/proposals
base64ed inside — the same self-describing framing the ABCI socket
transport uses (abci/codec.py) in place of the reference's
varint-delimited proto unions (privval/msgs.go).

Runnable: ``python -m tendermint_tpu_torch.privval.remote --addr tcp://... \
    --chain-id ... --key-file ... --state-file ...`` starts a dialing
signer process.
"""

from __future__ import annotations

import base64
import json
import socket
import struct
import threading
import time
from typing import Optional, Tuple

from tendermint_tpu_torch.crypto.keys import (
    Ed25519PrivKey,
    PubKey,
    pubkey_from_type_and_bytes,
)
from tendermint_tpu_torch.p2p.secret_connection import SecretConnectionError
from tendermint_tpu_torch.privval.base import PrivValidator
from tendermint_tpu_torch.privval.file_pv import DoubleSignError
from tendermint_tpu_torch.types.block import Proposal, Vote

FRAME_HDR = struct.Struct(">I")
MAX_FRAME = 1 << 20  # signing payloads are small; 1 MiB is generous

DEFAULT_TIMEOUT_READ_WRITE = 5.0  # privval/signer_endpoint.go:21
DEFAULT_TIMEOUT_ACCEPT = 30.0
DEFAULT_DIAL_RETRY_INTERVAL = 0.1


class RemoteSignerError(Exception):
    """An error string returned by the remote signer (privval/errors.go)."""


class UnauthorizedSignerError(RemoteSignerError):
    """A dialer whose handshake identity is not in the allowlist."""


def parse_addr(addr: str) -> Tuple[str, object]:
    """Split ``tcp://h:p`` / ``unix:///path`` into (scheme, target)."""
    if addr.startswith("tcp://"):
        host, _, port = addr[6:].rpartition(":")
        return "tcp", (host or "127.0.0.1", int(port))
    if addr.startswith("unix://"):
        return "unix", addr[7:]
    raise ValueError(f"privval address must be tcp:// or unix://, got {addr}")


class _SocketStream:
    """sendall/recv_exact adapter SecretConnection expects.

    Partial reads persist in ``_buf`` across calls, so a socket timeout
    mid-frame loses nothing: the retried recv_exact resumes exactly where
    the interrupted one stopped (the signer's idle loop relies on this —
    a timeout is always safe to retry).
    """

    def __init__(self, sock: socket.socket):
        self._sock = sock
        self._buf = b""

    def sendall(self, data: bytes) -> None:
        self._sock.sendall(data)

    def recv_exact(self, n: int) -> bytes:
        while len(self._buf) < n:
            chunk = self._sock.recv(n - len(self._buf))
            if not chunk:
                raise ConnectionError("privval connection closed")
            self._buf += chunk
        out, self._buf = self._buf[:n], self._buf[n:]
        return out


class _Conn:
    """One framed connection, optionally SecretConnection-encrypted."""

    def __init__(self, sock: socket.socket, priv: Optional[Ed25519PrivKey]):
        self._sock = sock
        self._stream = _SocketStream(sock)
        self._secret = None
        if priv is not None:
            from tendermint_tpu_torch.p2p.secret_connection import SecretConnection

            self._secret = SecretConnection(self._stream, priv)

    def send_msg(self, msg: dict) -> None:
        payload = json.dumps(msg, separators=(",", ":")).encode()
        if self._secret is not None:
            # the secure channel already length-delimits messages
            self._secret.send_msg(payload)
        else:
            self._stream.sendall(FRAME_HDR.pack(len(payload)) + payload)

    def recv_msg(self) -> dict:
        if self._secret is not None:
            payload = self._secret.recv_msg(max_size=MAX_FRAME)
        else:
            (n,) = FRAME_HDR.unpack(self._stream.recv_exact(4))
            if n > MAX_FRAME:
                raise ConnectionError("privval: frame too large")
            payload = self._stream.recv_exact(n)
        return json.loads(payload.decode())

    @property
    def remote_pubkey(self) -> Optional[PubKey]:
        return self._secret.remote_pubkey if self._secret else None

    def close(self) -> None:
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()


# --- node side --------------------------------------------------------------


class SignerListenerEndpoint:
    """Node-side endpoint: accepts the signer's inbound connection and
    serializes request/response exchanges over it
    (privval/signer_listener_endpoint.go:23-198)."""

    def __init__(
        self,
        addr: str,
        node_priv: Optional[Ed25519PrivKey] = None,
        accept_timeout: float = DEFAULT_TIMEOUT_ACCEPT,
        io_timeout: float = DEFAULT_TIMEOUT_READ_WRITE,
        authorized_keys: Optional[list] = None,
    ):
        self._scheme, self._target = parse_addr(addr)
        # tcp gets a SecretConnection; generate an ephemeral node identity
        # if the caller didn't supply one (the signer authenticates us, we
        # learn its identity from the handshake).
        if self._scheme == "tcp" and node_priv is None:
            node_priv = Ed25519PrivKey.generate()
        self._priv = node_priv if self._scheme == "tcp" else None
        self._accept_timeout = accept_timeout
        self._io_timeout = io_timeout
        # Optional allowlist of signer ed25519 pubkey bytes. Without it,
        # whoever dials first becomes the signer — bind to localhost or a
        # unix socket in that case (the reference has the same property;
        # its SecretConnection authenticates the channel, not a roster).
        self._authorized = (
            {bytes(k) for k in authorized_keys} if authorized_keys else None
        )
        if self._authorized is not None and self._scheme == "unix":
            # no SecretConnection on unix sockets -> no handshake identity
            # to check against; filesystem permissions are the boundary
            raise ValueError(
                "authorized_keys requires a tcp:// privval address"
            )
        self._lock = threading.Lock()
        self._conn: Optional[_Conn] = None
        self._listener: Optional[socket.socket] = None
        self._closed = False

    def start(self) -> None:
        if self._scheme == "tcp":
            ls = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            ls.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            ls.bind(self._target)
        else:
            import os

            try:
                os.unlink(self._target)
            except FileNotFoundError:
                pass
            ls = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            ls.bind(self._target)
        # backlog > 1: a dead dial sitting in the queue must not make the
        # real signer's connection attempt bounce off a full backlog
        ls.listen(8)
        ls.settimeout(self._accept_timeout)
        self._listener = ls

    @property
    def listen_addr(self) -> str:
        assert self._listener is not None
        if self._scheme == "tcp":
            host, port = self._listener.getsockname()[:2]
            return f"tcp://{host}:{port}"
        return f"unix://{self._target}"

    def _ensure_conn(self, accept_timeout: Optional[float] = None) -> _Conn:
        if self._conn is not None:
            return self._conn
        if self._closed:
            raise RemoteSignerError("signer endpoint closed")
        if self._listener is None:
            raise RemoteSignerError("listener not started")
        if accept_timeout is not None:
            self._listener.settimeout(accept_timeout)
        sock, _ = self._listener.accept()
        sock.settimeout(self._io_timeout)
        try:
            conn = _Conn(sock, self._priv)
        except Exception:
            # handshake failure (port scanner, dropped dial, garbage):
            # release the accepted socket before surfacing
            sock.close()
            raise
        if self._authorized is not None:
            remote = conn.remote_pubkey
            if remote is None or remote.bytes() not in self._authorized:
                conn.close()
                raise UnauthorizedSignerError(
                    "signer connection rejected: unauthorized identity"
                )
        self._conn = conn
        return self._conn

    def wait_for_connection(self, max_wait: float) -> None:
        """Block until a signer has dialed in (SignerClient.WaitForConnection).

        Rejected or failed dial attempts — unauthorized identities, port
        scanners dropping mid-handshake — do not end the wait; only the
        deadline does.
        """
        deadline = time.monotonic() + max_wait
        rejected = 0
        with self._lock:
            old = self._listener.gettimeout() if self._listener else None
            try:
                while True:
                    try:
                        self._ensure_conn(
                            accept_timeout=max(
                                0.05, deadline - time.monotonic()
                            )
                        )
                        return
                    except socket.timeout:
                        pass
                    except (
                        UnauthorizedSignerError,
                        ConnectionError,
                        SecretConnectionError,
                        OSError,
                    ):
                        rejected += 1
                    if time.monotonic() >= deadline:
                        suffix = (
                            f" ({rejected} dial attempts rejected)"
                            if rejected
                            else ""
                        )
                        raise RemoteSignerError(
                            "timed out waiting for signer to connect"
                            + suffix
                        ) from None
            finally:
                if self._listener is not None and old is not None:
                    self._listener.settimeout(old)

    def send_request(self, msg: dict) -> dict:
        """One request/response exchange; drops the connection on IO error
        so the signer's redial can re-establish it.

        When no signer is connected, waits at most ``io_timeout`` for one
        to dial in — the caller is usually the consensus thread, which
        must fail fast and skip its vote rather than stall a round
        (accept_timeout is only for explicit wait_for_connection calls).
        """
        with self._lock:
            conn = self._ensure_conn(accept_timeout=self._io_timeout)
            try:
                conn.send_msg(msg)
                return conn.recv_msg()
            except (
                OSError,
                ConnectionError,
                SecretConnectionError,
                json.JSONDecodeError,
            ):
                self._drop_conn_locked()
                raise

    def _drop_conn_locked(self) -> None:
        if self._conn is not None:
            self._conn.close()
            self._conn = None

    def close(self) -> None:
        self._closed = True
        with self._lock:
            self._drop_conn_locked()
            if self._listener is not None:
                self._listener.close()
                self._listener = None


class SignerClient(PrivValidator):
    """types.PrivValidator backed by the remote signer
    (privval/signer_client.go:18-151)."""

    def __init__(self, endpoint: SignerListenerEndpoint, chain_id: str):
        self._endpoint = endpoint
        self._chain_id = chain_id
        self._cached_pubkey: Optional[PubKey] = None

    def ping(self) -> None:
        resp = self._endpoint.send_request({"type": "ping", "body": {}})
        if resp.get("type") != "ping":
            raise RemoteSignerError(f"unexpected ping response: {resp}")

    def get_pub_key(self) -> PubKey:
        if self._cached_pubkey is not None:
            return self._cached_pubkey
        resp = self._endpoint.send_request(
            {"type": "pubkey_request", "body": {"chain_id": self._chain_id}}
        )
        body = _require(resp, "pubkey_response")
        pub = pubkey_from_type_and_bytes(
            body["key_type"], base64.b64decode(body["pub_key"])
        )
        self._cached_pubkey = pub
        return pub

    def sign_vote(self, chain_id: str, vote: Vote) -> None:
        resp = self._endpoint.send_request(
            {
                "type": "sign_vote_request",
                "body": {
                    "chain_id": chain_id,
                    "vote": base64.b64encode(vote.to_proto_bytes()).decode(),
                },
            }
        )
        body = _require(resp, "signed_vote_response")
        signed = Vote.from_proto_bytes(base64.b64decode(body["vote"]))
        vote.signature = signed.signature
        vote.timestamp = signed.timestamp
        vote.extension_signature = signed.extension_signature

    def sign_proposal(self, chain_id: str, proposal: Proposal) -> None:
        resp = self._endpoint.send_request(
            {
                "type": "sign_proposal_request",
                "body": {
                    "chain_id": chain_id,
                    "proposal": base64.b64encode(
                        proposal.to_proto_bytes()
                    ).decode(),
                },
            }
        )
        body = _require(resp, "signed_proposal_response")
        signed = Proposal.from_proto_bytes(base64.b64decode(body["proposal"]))
        proposal.signature = signed.signature
        proposal.timestamp = signed.timestamp


def _require(resp: dict, expected_type: str) -> dict:
    body = resp.get("body", {})
    if body.get("error"):
        raise RemoteSignerError(body["error"])
    if resp.get("type") != expected_type:
        raise RemoteSignerError(
            f"expected {expected_type}, got {resp.get('type')}"
        )
    return body


# --- signer side ------------------------------------------------------------


class SignerServer:
    """Signer-side service: dials the node and answers signing requests
    from the wrapped PrivValidator (privval/signer_server.go:20-108 +
    signer_dialer_endpoint.go). The wrapped FilePV enforces double-sign
    protection; refusals travel back as error strings."""

    def __init__(
        self,
        addr: str,
        chain_id: str,
        priv_val: PrivValidator,
        signer_identity: Optional[Ed25519PrivKey] = None,
        dial_retry_interval: float = DEFAULT_DIAL_RETRY_INTERVAL,
        max_dial_retries: Optional[int] = None,
    ):
        self._scheme, self._target = parse_addr(addr)
        self._chain_id = chain_id
        self._priv_val = priv_val
        if self._scheme == "tcp" and signer_identity is None:
            signer_identity = Ed25519PrivKey.generate()
        self._identity = signer_identity if self._scheme == "tcp" else None
        self._dial_retry_interval = dial_retry_interval
        self._max_dial_retries = max_dial_retries
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._run, name="signer-server", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def serve_forever(self) -> None:
        self._run()

    def _dial(self) -> _Conn:
        """Dial with retries. ``max_dial_retries=None`` (the default)
        retries until stopped — a signer that gives up after a node
        restart window silently halts the validator, so bounded retries
        are opt-in (tests)."""
        last_err: Optional[Exception] = None
        attempts = 0
        while self._max_dial_retries is None or attempts < self._max_dial_retries:
            attempts += 1
            if self._stop.is_set():
                raise ConnectionError("signer stopped")
            try:
                if self._scheme == "tcp":
                    sock = socket.create_connection(self._target, timeout=5)
                else:
                    sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
                    sock.connect(self._target)
                sock.settimeout(DEFAULT_TIMEOUT_READ_WRITE)
                return _Conn(sock, self._identity)
            except (OSError, SecretConnectionError, ConnectionError) as e:
                last_err = e
                time.sleep(self._dial_retry_interval)
        raise ConnectionError(f"signer could not dial node: {last_err}")

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                conn = self._dial()
            except ConnectionError:
                return
            try:
                while not self._stop.is_set():
                    try:
                        req = conn.recv_msg()
                    except socket.timeout:
                        # safe: _SocketStream buffers partial reads, so a
                        # mid-frame timeout resumes without desync
                        continue
                    conn.send_msg(self._handle(req))
            except (
                OSError,
                ConnectionError,
                SecretConnectionError,
                json.JSONDecodeError,
            ):
                conn.close()
                continue

    def _handle(self, req: dict) -> dict:
        """privval/signer_requestHandler.go:14-78: every failure becomes a
        response-with-error, never a dropped connection."""
        typ = req.get("type")
        body = req.get("body", {})
        try:
            if typ == "ping":
                return {"type": "ping", "body": {}}
            if typ == "pubkey_request":
                pub = self._priv_val.get_pub_key()
                return {
                    "type": "pubkey_response",
                    "body": {
                        "key_type": pub.type,
                        "pub_key": base64.b64encode(pub.bytes()).decode(),
                    },
                }
            if typ == "sign_vote_request":
                vote = Vote.from_proto_bytes(base64.b64decode(body["vote"]))
                self._priv_val.sign_vote(body["chain_id"], vote)
                return {
                    "type": "signed_vote_response",
                    "body": {
                        "vote": base64.b64encode(
                            vote.to_proto_bytes()
                        ).decode()
                    },
                }
            if typ == "sign_proposal_request":
                proposal = Proposal.from_proto_bytes(
                    base64.b64decode(body["proposal"])
                )
                self._priv_val.sign_proposal(body["chain_id"], proposal)
                return {
                    "type": "signed_proposal_response",
                    "body": {
                        "proposal": base64.b64encode(
                            proposal.to_proto_bytes()
                        ).decode()
                    },
                }
            return {
                "type": "error",
                "body": {"error": f"unknown request type {typ!r}"},
            }
        except DoubleSignError as e:
            return {
                "type": f"signed_{'vote' if typ == 'sign_vote_request' else 'proposal'}_response",
                "body": {"error": f"double sign: {e}"},
            }
        except Exception as e:  # defensive: never kill the serve loop
            return {"type": "error", "body": {"error": str(e)}}


def main(argv: Optional[list] = None) -> int:
    """Run a dialing signer process around a FilePV."""
    import argparse

    from tendermint_tpu_torch.privval.file_pv import FilePV

    ap = argparse.ArgumentParser(
        prog="python -m tendermint_tpu_torch.privval.remote",
        description="out-of-process validator signer (dials the node)",
    )
    ap.add_argument("--addr", required=True, help="node privval listen addr")
    ap.add_argument("--chain-id", required=True)
    ap.add_argument("--key-file", required=True)
    ap.add_argument("--state-file", required=True)
    args = ap.parse_args(argv)

    pv = FilePV.load_or_generate(args.key_file, args.state_file)
    server = SignerServer(args.addr, args.chain_id, pv)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

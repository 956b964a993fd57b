"""Authenticated encrypted connections (internal/p2p/conn/secret_connection.go).

A copy of ``tendermint_tpu/p2p/secret_connection.py``, byte for byte on
the wire, so a port peer and a JAX peer talk: X25519 ephemeral ECDH ->
HKDF-SHA256 -> two ChaCha20-Poly1305 keys (one per direction, chosen by
ephemeral-key sort order), then each side signs the session challenge
with its ed25519 identity key and sends (pubkey, sig) encrypted. Frames
are 1,024 data bytes behind a 4-byte little-endian length, sealed with a
12-byte nonce of 4 zero bytes and a little-endian u64 counter
(secret_connection.go:92-181, deriveSecrets:337). A message is a 4-byte
little-endian length and its bytes, cut into frames from a fresh one.

X25519 and the AEAD are the port's own (``crypto/x25519.py``,
``crypto/chacha20poly1305.py``); the reference takes them from the
``cryptography`` wheel. The AEAD's keystream is numpy, so frames are
sealed and opened in batches: :meth:`SecretConnection.send_msgs` seals
every frame of its messages in one pass and writes them in one
``sendall``; :meth:`SecretConnection.recv_msg` opens, in one pass, the
frames of the message it waits for together with every whole frame
already in the socket's buffer, and keeps the messages they complete.
What crosses the wire is the same either way.
"""

from __future__ import annotations

import hashlib
import hmac as _hmac
import struct
from collections import deque
from typing import List, Optional

from tendermint_tpu_torch.crypto import x25519
from tendermint_tpu_torch.crypto.chacha20poly1305 import ChaCha20Poly1305, InvalidTag
from tendermint_tpu_torch.crypto.keys import Ed25519PrivKey, Ed25519PubKey, PubKey

DATA_LEN_SIZE = 4
DATA_MAX_SIZE = 1024
TOTAL_FRAME_SIZE = DATA_MAX_SIZE + DATA_LEN_SIZE
AEAD_TAG_SIZE = 16
SEALED_FRAME_SIZE = TOTAL_FRAME_SIZE + AEAD_TAG_SIZE
# The most sealed frames one read takes from the socket's buffer beyond
# the one it waits for (about 267 KB; a 500-validator block is ~100).
READ_AHEAD_FRAMES = 256
HKDF_INFO = b"TENDERMINT_TPU_SECRET_CONNECTION"


def _hkdf(secret: bytes, info: bytes, length: int) -> bytes:
    """HKDF-SHA256 (extract with zero salt + expand)."""
    prk = _hmac.new(b"\x00" * 32, secret, hashlib.sha256).digest()
    okm = b""
    t = b""
    i = 1
    while len(okm) < length:
        t = _hmac.new(prk, t + info + bytes([i]), hashlib.sha256).digest()
        okm += t
        i += 1
    return okm[:length]


def _nonce(n: int) -> bytes:
    # 12-byte nonce: 4 zero bytes + u64 LE counter (reference layout).
    return b"\x00" * 4 + struct.pack("<Q", n)


def _frames(data: bytes) -> List[bytes]:
    """``data`` cut into plaintext frames (at least one)."""
    out = []
    view = memoryview(data)
    while True:
        chunk = bytes(view[:DATA_MAX_SIZE])
        view = view[DATA_MAX_SIZE:]
        frame = struct.pack("<I", len(chunk)) + chunk
        out.append(frame + b"\x00" * (TOTAL_FRAME_SIZE - len(frame)))
        if not view:
            return out


class SecretConnectionError(Exception):
    pass


class SecretConnection:
    """Wraps a stream-like object (must expose sendall/recv_exact; a
    ``recv_available(n)`` that returns what is buffered without waiting
    lets a read take more than one frame)."""

    def __init__(self, stream, local_priv: Ed25519PrivKey):
        self._stream = stream
        self._local_priv = local_priv
        self.remote_pubkey: Optional[PubKey] = None
        self._send_cipher: Optional[ChaCha20Poly1305] = None
        self._recv_cipher: Optional[ChaCha20Poly1305] = None
        self._send_nonce = 0
        self._recv_nonce = 0
        self._raw = bytearray()  # sealed bytes read, short of a frame
        self._recv_buffer = bytearray()  # opened payload bytes, short of a message
        self._msgs: deque = deque()  # messages opened, not yet returned
        self._handshake()

    # --- handshake -----------------------------------------------------------

    def _handshake(self) -> None:
        """secret_connection.go MakeSecretConnection."""
        eph_priv, eph_pub = x25519.generate()
        # 1. Exchange ephemeral pubkeys in the clear.
        self._stream.sendall(eph_pub)
        remote_eph = self._stream.recv_exact(32)
        # 2. Shared secret + key derivation. Key order by ephemeral sort:
        # the lexicographically lower key is the "first" party.
        try:
            shared = x25519.exchange(eph_priv, remote_eph)
        except ValueError as e:
            raise SecretConnectionError(str(e)) from e
        lo, hi = sorted([eph_pub, remote_eph])
        material = _hkdf(shared, HKDF_INFO + lo + hi, 96)
        key1, key2, challenge = material[:32], material[32:64], material[64:96]
        if eph_pub == lo:
            send_key, recv_key = key1, key2
        else:
            send_key, recv_key = key2, key1
        self._send_cipher = ChaCha20Poly1305(send_key)
        self._recv_cipher = ChaCha20Poly1305(recv_key)
        # 3. Authenticate: sign the challenge, swap (pubkey, sig) encrypted.
        sig = self._local_priv.sign(challenge)
        auth = self._local_priv.pub_key().bytes() + sig
        self.send(auth)
        remote_auth = self.recv()
        if len(remote_auth) != 32 + 64:
            raise SecretConnectionError("malformed auth message")
        remote_pub = Ed25519PubKey(remote_auth[:32])
        if not remote_pub.verify_signature(challenge, remote_auth[32:]):
            raise SecretConnectionError("challenge verification failed")
        self.remote_pubkey = remote_pub

    # --- framing -------------------------------------------------------------

    def _seal(self, frames: List[bytes]) -> bytes:
        nonces = [_nonce(self._send_nonce + i) for i in range(len(frames))]
        self._send_nonce += len(frames)
        return b"".join(self._send_cipher.seal_many(nonces, frames))

    def send(self, data: bytes) -> None:
        """Chunk into sealed 1024-byte frames (secret_connection.go Write)."""
        self._stream.sendall(self._seal(_frames(data)))

    def _read_frames(self, max_frames: Optional[int] = None) -> List[bytes]:
        """Wait for one whole sealed frame, take whatever more whole frames
        are already buffered (up to ``max_frames``), open them in one pass
        and return their payloads."""
        if len(self._raw) < SEALED_FRAME_SIZE:
            self._raw += self._stream.recv_exact(SEALED_FRAME_SIZE - len(self._raw))
        ahead = getattr(self._stream, "recv_available", None)
        if ahead is not None and max_frames is None:
            room = (1 + READ_AHEAD_FRAMES) * SEALED_FRAME_SIZE - len(self._raw)
            if room > 0:
                self._raw += ahead(room)
        n = len(self._raw) // SEALED_FRAME_SIZE
        if max_frames is not None:
            n = min(n, max_frames)
        sealed = [bytes(self._raw[i * SEALED_FRAME_SIZE : (i + 1) * SEALED_FRAME_SIZE]) for i in range(n)]
        del self._raw[: n * SEALED_FRAME_SIZE]
        nonces = [_nonce(self._recv_nonce + i) for i in range(n)]
        try:
            frames = self._recv_cipher.open_many(nonces, sealed)
        except InvalidTag as e:
            raise SecretConnectionError(f"failed to decrypt frame: {e}") from e
        self._recv_nonce += n
        out = []
        for frame in frames:
            (length,) = struct.unpack_from("<I", frame)
            if length > DATA_MAX_SIZE:
                raise SecretConnectionError("frame length exceeds max")
            out.append(frame[DATA_LEN_SIZE : DATA_LEN_SIZE + length])
        return out

    def recv(self) -> bytes:
        """One frame's payload (the handshake's auth message)."""
        return self._read_frames(max_frames=1)[0]

    # --- length-prefixed messages --------------------------------------------

    def send_msgs(self, msgs: List[bytes]) -> None:
        """Length-prefixed messages, each from a fresh frame, every frame
        sealed in one pass and written in one ``sendall``."""
        frames = []
        for msg in msgs:
            frames += _frames(struct.pack("<I", len(msg)) + msg)
        self._stream.sendall(self._seal(frames))

    def send_msg(self, msg: bytes) -> None:
        """Length-prefixed message of arbitrary size over frames."""
        self.send_msgs([msg])

    def recv_msg(self, max_size: int = 64 * 1024 * 1024) -> bytes:
        while not self._msgs:
            for payload in self._read_frames():
                self._recv_buffer += payload
            buf = self._recv_buffer
            while len(buf) >= 4:
                (length,) = struct.unpack_from("<I", buf)
                if length > max_size:
                    raise SecretConnectionError(f"message size {length} exceeds max")
                if len(buf) < 4 + length:
                    break
                self._msgs.append(bytes(buf[4 : 4 + length]))
                del buf[: 4 + length]
        return self._msgs.popleft()

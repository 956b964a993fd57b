"""ChaCha20-Poly1305 AEAD (RFC 8439 §2.8), for ``p2p/secret_connection.py``.

The JAX package takes it from the ``cryptography`` wheel, which the
port may not import. The ChaCha20 keystream is computed with numpy
``uint32`` arrays, one a state word, whose elements are the 64-byte
blocks of a whole batch of messages: :meth:`ChaCha20Poly1305.seal_many`
seals (and :meth:`open_many` opens) many frames, each with its own
nonce, in one pass of 20 rounds (one a :data:`CHUNK_BLOCKS` blocks), so
numpy's per-call cost is paid once for a batch instead of once a frame.
Poly1305 and the XOR run on Python integers (RFC 8439 §2.5).

``encrypt`` and ``decrypt`` take the arguments of ``cryptography``'s
``ChaCha20Poly1305`` (nonce, data, associated data) and give the same
bytes: the ciphertext followed by the 16-byte tag.
"""

from __future__ import annotations

import hmac
import struct
import sys
from typing import List, Optional, Sequence

import numpy as np

KEY_SIZE = 32
NONCE_SIZE = 12
TAG_SIZE = 16

_SIGMA = np.frombuffer(b"expand 32-byte k", dtype="<u4").astype(np.uint32)
_P1305 = (1 << 130) - 5
_R_CLAMP = 0x0FFFFFFC0FFFFFFC0FFFFFFC0FFFFFFF
_MASK128 = (1 << 128) - 1

# Blocks a pass of the rounds takes at once. numpy lets go of the GIL
# for a loop over more than 500 elements, and in a process whose other
# threads run Python the op then waits out their switch interval (5 ms)
# to get it back; at 500 blocks each operand is one state word's row of
# 500 elements, so a pass never lets go of it.
CHUNK_BLOCKS = 500
# The quarter rounds of a double round (RFC 8439 §2.3): columns, then
# diagonals.
_ROUNDS = ((0, 4, 8, 12), (1, 5, 9, 13), (2, 6, 10, 14), (3, 7, 11, 15),
           (0, 5, 10, 15), (1, 6, 11, 12), (2, 7, 8, 13), (3, 4, 9, 14))


class InvalidTag(ValueError):
    """The tag does not authenticate the ciphertext."""


def _rotl(v: np.ndarray, n: int) -> np.ndarray:
    return (v << np.uint32(n)) | (v >> np.uint32(32 - n))


def chacha20_blocks(key: bytes, counters: np.ndarray, nonces: np.ndarray) -> bytes:
    """The keystream blocks for ``counters[i]`` under ``nonces[i]`` (an
    (N, 3) ``uint32`` array of the 12-byte nonces' words), as N * 64
    bytes, block i at offset 64 * i (RFC 8439 §2.3). The state is 16
    rows, one a word, each holding that word of up to
    :data:`CHUNK_BLOCKS` blocks."""
    n = len(counters)
    out = np.empty((n, 16), dtype=np.uint32)
    words = [int(w) for w in _SIGMA] + [int(w) for w in np.frombuffer(key, dtype="<u4")]
    with np.errstate(over="ignore"):
        for lo in range(0, n, CHUNK_BLOCKS):
            hi = min(n, lo + CHUNK_BLOCKS)
            x = [np.full(hi - lo, w, dtype=np.uint32) for w in words]
            x += [counters[lo:hi].copy(), nonces[lo:hi, 0].copy(), nonces[lo:hi, 1].copy(),
                  nonces[lo:hi, 2].copy()]
            start = [v.copy() for v in x]
            for _ in range(10):
                for a, b, c, d in _ROUNDS:
                    x[a] += x[b]
                    x[d] = _rotl(x[d] ^ x[a], 16)
                    x[c] += x[d]
                    x[b] = _rotl(x[b] ^ x[c], 12)
                    x[a] += x[b]
                    x[d] = _rotl(x[d] ^ x[a], 8)
                    x[c] += x[d]
                    x[b] = _rotl(x[b] ^ x[c], 7)
            for j in range(16):
                out[lo:hi, j] = x[j] + start[j]
    if sys.byteorder != "little":
        out = out.byteswap()
    return out.tobytes()


def poly1305(key: bytes, msg: bytes) -> bytes:
    """RFC 8439 §2.5.1, two blocks a step: acc = ((acc + m1) r^2 + m2 r)
    mod p, the same value as one block a step with half the reductions."""
    r = int.from_bytes(key[:16], "little") & _R_CLAMP
    s = int.from_bytes(key[16:32], "little")
    full = len(msg) - len(msg) % 16
    w = struct.unpack("<%dQ" % (full // 8), msg[:full])
    hibit = 1 << 128
    r2 = r * r % _P1305
    acc = 0
    n = full // 16
    i = 0
    while i + 1 < n:
        m1 = w[2 * i] | (w[2 * i + 1] << 64) | hibit
        m2 = w[2 * i + 2] | (w[2 * i + 3] << 64) | hibit
        acc = ((acc + m1) * r2 + m2 * r) % _P1305
        i += 2
    if i < n:
        acc = (acc + (w[2 * i] | (w[2 * i + 1] << 64) | hibit)) * r % _P1305
    if full < len(msg):
        tail = msg[full:]
        acc = (acc + int.from_bytes(tail, "little") + (1 << (8 * len(tail)))) * r % _P1305
    return ((acc + s) & _MASK128).to_bytes(16, "little")


def _pad16(n: int) -> bytes:
    return bytes(-n % 16)


def _mac_data(aad: bytes, ct: bytes) -> bytes:
    return aad + _pad16(len(aad)) + ct + _pad16(len(ct)) + struct.pack("<QQ", len(aad), len(ct))


class ChaCha20Poly1305:
    """The AEAD of RFC 8439 §2.8 under one 32-byte key."""

    def __init__(self, key: bytes):
        if len(key) != KEY_SIZE:
            raise ValueError("ChaCha20Poly1305 key must be 32 bytes")
        self._key = bytes(key)

    def _streams(self, nonces: Sequence[bytes], lengths: Sequence[int]) -> List[bytes]:
        """For each (nonce, length): its Poly1305 key (block 0) followed by
        ``length`` bytes of keystream (blocks 1, 2, ...), all in one pass."""
        counts = [1 + -(-n // 64) for n in lengths]
        total = sum(counts)
        counters = np.empty(total, dtype=np.uint32)
        words = np.empty((total, 3), dtype=np.uint32)
        at = 0
        for nonce, k in zip(nonces, counts):
            if len(nonce) != NONCE_SIZE:
                raise ValueError("ChaCha20Poly1305 nonce must be 12 bytes")
            counters[at : at + k] = np.arange(k, dtype=np.uint32)
            words[at : at + k] = np.frombuffer(nonce, dtype="<u4")
            at += k
        stream = chacha20_blocks(self._key, counters, words)
        out, at = [], 0
        for n, k in zip(lengths, counts):
            out.append(stream[64 * at : 64 * at + 64 + n])
            at += k
        return out

    @staticmethod
    def _xor(data: bytes, stream: bytes) -> bytes:
        """``data`` XOR the keystream after the Poly1305 block, on Python
        integers (a numpy XOR of a frame would let go of the GIL)."""
        n = len(data)
        if not n:
            return b""
        k = int.from_bytes(stream[64 : 64 + n], "little")
        return (int.from_bytes(data, "little") ^ k).to_bytes(n, "little")

    def seal_many(self, nonces: Sequence[bytes], plaintexts: Sequence[bytes], aad: bytes = b"") -> List[bytes]:
        """``encrypt`` of each (nonce, plaintext), the keystream of all in
        one pass."""
        streams = self._streams(nonces, [len(p) for p in plaintexts])
        out = []
        for pt, stream in zip(plaintexts, streams):
            ct = self._xor(pt, stream)
            out.append(ct + poly1305(stream[:32], _mac_data(aad, ct)))
        return out

    def open_many(self, nonces: Sequence[bytes], sealed: Sequence[bytes], aad: bytes = b"") -> List[bytes]:
        """``decrypt`` of each (nonce, ciphertext + tag), the keystream of
        all in one pass; raises :class:`InvalidTag` at the first frame
        whose tag does not match."""
        for s in sealed:
            if len(s) < TAG_SIZE:
                raise InvalidTag("ciphertext shorter than its tag")
        streams = self._streams(nonces, [len(s) - TAG_SIZE for s in sealed])
        out = []
        for s, stream in zip(sealed, streams):
            ct, tag = s[:-TAG_SIZE], s[-TAG_SIZE:]
            if not hmac.compare_digest(poly1305(stream[:32], _mac_data(aad, ct)), tag):
                raise InvalidTag("ChaCha20Poly1305: tag mismatch")
            out.append(self._xor(ct, stream))
        return out

    def encrypt(self, nonce: bytes, data: bytes, associated_data: Optional[bytes] = None) -> bytes:
        return self.seal_many([nonce], [data], associated_data or b"")[0]

    def decrypt(self, nonce: bytes, data: bytes, associated_data: Optional[bytes] = None) -> bytes:
        return self.open_many([nonce], [data], associated_data or b"")[0]

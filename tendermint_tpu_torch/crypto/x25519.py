"""X25519 Diffie-Hellman (RFC 7748), on Python integers.

The key exchange of ``p2p/secret_connection.py``. The JAX package takes
it from the ``cryptography`` wheel; the port may not import that (and
the card's machine need not have it), so this is the RFC's Montgomery
ladder (§5) with its clamping, as ``crypto/secp256k1.py`` is for its
curve. One exchange is 255 ladder steps of about ten field operations
each: about a millisecond, once per connection.

Not constant-time: Python integers never are. The keys it handles are
one connection's ephemerals, made fresh for each handshake.
"""

from __future__ import annotations

import secrets
from typing import Tuple

P = 2**255 - 19
A24 = 121665
BASE_POINT = (9).to_bytes(32, "little")
KEY_SIZE = 32


def _clamp(k: bytes) -> int:
    """RFC 7748 §5 decodeScalar25519."""
    b = bytearray(k)
    b[0] &= 248
    b[31] &= 127
    b[31] |= 64
    return int.from_bytes(b, "little")


def _decode_u(u: bytes) -> int:
    """RFC 7748 §5 decodeUCoordinate: the top bit is masked, and values
    of p or more are taken mod p (non-canonical encodings are accepted)."""
    b = bytearray(u)
    b[31] &= 127
    return int.from_bytes(b, "little") % P


def x25519(k: bytes, u: bytes) -> bytes:
    """The scalar multiplication X25519(k, u) of RFC 7748 §5."""
    if len(k) != KEY_SIZE or len(u) != KEY_SIZE:
        raise ValueError("x25519: scalar and u-coordinate must be 32 bytes")
    scalar = _clamp(k)
    x1 = _decode_u(u)
    x2, z2, x3, z3 = 1, 0, x1, 1
    swap = 0
    for t in range(254, -1, -1):
        bit = (scalar >> t) & 1
        swap ^= bit
        if swap:
            x2, x3, z2, z3 = x3, x2, z3, z2
        swap = bit
        a = x2 + z2
        aa = a * a % P
        b = x2 - z2
        bb = b * b % P
        e = aa - bb
        c = x3 + z3
        d = x3 - z3
        da = d * a % P
        cb = c * b % P
        x3 = (da + cb) ** 2 % P
        z3 = x1 * (da - cb) ** 2 % P
        x2 = aa * bb % P
        z2 = e * (aa + A24 * e) % P
    if swap:
        x2, z2 = x3, z3
    return (x2 * pow(z2, P - 2, P) % P).to_bytes(32, "little")


def public_key(priv: bytes) -> bytes:
    return x25519(priv, BASE_POINT)


def generate() -> Tuple[bytes, bytes]:
    """A fresh (private, public) pair."""
    priv = secrets.token_bytes(KEY_SIZE)
    return priv, public_key(priv)


def exchange(priv: bytes, peer_public: bytes) -> bytes:
    """The shared secret; refuses the all-zero output of a small-order
    peer key, as ``cryptography``'s ``X25519PrivateKey.exchange`` does."""
    shared = x25519(priv, peer_public)
    if shared == bytes(KEY_SIZE):
        raise ValueError("x25519: the peer's public key is of small order")
    return shared

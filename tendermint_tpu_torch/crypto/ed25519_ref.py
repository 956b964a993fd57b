"""Pure-Python Ed25519 with ZIP-215 verification semantics.

This is the host-side reference implementation: the correctness oracle for
the CUDA batch verifier in :mod:`tendermint_tpu_torch.ops`, the source of
the basepoint and per-validator tables, and the verifier of sub-threshold
batches. It is a copy of ``tendermint_tpu/crypto/ed25519_ref.py``, kept
here so the port imports nothing from the JAX package.

Semantics mirror the reference framework's crypto layer, which verifies
with ZIP-215 rules (reference: crypto/ed25519/ed25519.go:24-29, using
curve25519-voi ``VerifyOptionsZIP_215``):

- ``s`` must be canonical (``s < L``); reject otherwise.
- ``A`` and ``R`` are decompressed *liberally*: the y-coordinate canonicity
  check of RFC 8032 section 5.1.3 is omitted (encodings with ``y >= p`` are
  accepted and reduced mod p). The ``x == 0 && sign == 1`` rejection of
  RFC 8032 decoding is kept. Small-order and mixed-order points are
  accepted.
- The *cofactored* verification equation is used:
  ``[8][s]B == [8]R + [8][k]A`` with ``k = SHA512(R || A || M) mod L``.

Signing / key generation follow RFC 8032 exactly (as the reference does:
its PrivKey.Sign defers to the standard Ed25519 signing flow).

The reference package's optional pre-pass through the ``cryptography``
package is left out: the port depends on torch, numpy and the standard
library only.
"""

from __future__ import annotations

import hashlib
from typing import Optional, Tuple

# --- curve constants -------------------------------------------------------

P = 2**255 - 19
L = 2**252 + 27742317777372353535851937790883648493
D = (-121665 * pow(121666, P - 2, P)) % P
SQRT_M1 = pow(2, (P - 1) // 4, P)  # sqrt(-1) mod p

# Base point: y = 4/5, x recovered with even parity... sign bit 0 means even.
_BY = (4 * pow(5, P - 2, P)) % P


def _recover_x(y: int, sign: int) -> Optional[int]:
    """RFC 8032 5.1.3 x-recovery (y already reduced mod p). None if invalid."""
    y2 = y * y % P
    u = (y2 - 1) % P
    v = (D * y2 + 1) % P
    # candidate root of u/v
    x = u * pow(v, 3, P) % P * pow(u * pow(v, 7, P) % P, (P - 5) // 8, P) % P
    vx2 = v * x * x % P
    if vx2 == u:
        pass
    elif vx2 == (-u) % P:
        x = x * SQRT_M1 % P
    else:
        return None
    if x == 0 and sign == 1:
        return None
    if x & 1 != sign:
        x = P - x
    return x


_BX = _recover_x(_BY, 0)
assert _BX is not None

# --- extended twisted Edwards point arithmetic (python ints) ---------------
# Point = (X, Y, Z, T) with x = X/Z, y = Y/Z, T = XY/Z.

IDENT = (0, 1, 1, 0)
B_POINT = (_BX, _BY, 1, _BX * _BY % P)
_2D = 2 * D % P


def pt_add(p, q):
    X1, Y1, Z1, T1 = p
    X2, Y2, Z2, T2 = q
    A = (Y1 - X1) * (Y2 - X2) % P
    Bv = (Y1 + X1) * (Y2 + X2) % P
    C = T1 * _2D % P * T2 % P
    Dv = 2 * Z1 * Z2 % P
    E = Bv - A
    F = Dv - C
    G = Dv + C
    H = Bv + A
    return (E * F % P, G * H % P, F * G % P, E * H % P)


def pt_double(p):
    X1, Y1, Z1, _ = p
    A = X1 * X1 % P
    Bv = Y1 * Y1 % P
    C = 2 * Z1 * Z1 % P
    H = A + Bv
    E = H - (X1 + Y1) * (X1 + Y1)
    G = A - Bv
    F = C + G
    return (E * F % P, G * H % P, F * G % P, E * H % P)


def pt_neg(p):
    X, Y, Z, T = p
    return ((-X) % P, Y, Z, (-T) % P)


def pt_mul(k: int, p) -> Tuple[int, int, int, int]:
    q = IDENT
    while k > 0:
        if k & 1:
            q = pt_add(q, p)
        p = pt_double(p)
        k >>= 1
    return q


def pt_is_identity(p) -> bool:
    X, Y, Z, _ = p
    return X % P == 0 and (Y - Z) % P == 0


def pt_compress(p) -> bytes:
    X, Y, Z, _ = p
    zinv = pow(Z, P - 2, P)
    x = X * zinv % P
    y = Y * zinv % P
    return int.to_bytes(y | ((x & 1) << 255), 32, "little")


def pt_decompress_liberal(b: bytes):
    """ZIP-215 decompression: no y-canonicity check. None if not on curve."""
    if len(b) != 32:
        return None
    n = int.from_bytes(b, "little")
    sign = n >> 255
    y = (n & ((1 << 255) - 1)) % P
    x = _recover_x(y, sign)
    if x is None:
        return None
    return (x, y, 1, x * y % P)


# --- scalars ---------------------------------------------------------------


def sc_reduce(b: bytes) -> int:
    return int.from_bytes(b, "little") % L


def _sha512(*parts: bytes) -> bytes:
    h = hashlib.sha512()
    for part in parts:
        h.update(part)
    return h.digest()


def _clamp(h32: bytes) -> int:
    a = bytearray(h32)
    a[0] &= 248
    a[31] &= 127
    a[31] |= 64
    return int.from_bytes(bytes(a), "little")


# --- keygen / sign / verify ------------------------------------------------


def pubkey_from_seed(seed: bytes) -> bytes:
    a = _clamp(_sha512(seed)[:32])
    return pt_compress(pt_mul(a, B_POINT))


def keypair_from_seed(seed: bytes) -> Tuple[bytes, bytes]:
    """Returns (privkey64, pubkey32) in the reference's 64-byte privkey
    layout: seed || pubkey (reference: crypto/ed25519/ed25519.go:76-82)."""
    pub = pubkey_from_seed(seed)
    return seed + pub, pub


def sign(privkey64: bytes, msg: bytes) -> bytes:
    seed, pub = privkey64[:32], privkey64[32:]
    h = _sha512(seed)
    a = _clamp(h[:32])
    prefix = h[32:]
    r = sc_reduce(_sha512(prefix, msg))
    r_point = pt_mul(r, B_POINT)
    r_bytes = pt_compress(r_point)
    k = sc_reduce(_sha512(r_bytes, pub, msg))
    s = (r + k * a) % L
    return r_bytes + int.to_bytes(s, 32, "little")


def verify_zip215_slow(pubkey: bytes, msg: bytes, sig: bytes) -> bool:
    """Pure-Python ZIP-215 cofactored verification. The oracle."""
    if len(sig) != 64 or len(pubkey) != 32:
        return False
    s = int.from_bytes(sig[32:], "little")
    if s >= L:
        return False
    a_point = pt_decompress_liberal(pubkey)
    if a_point is None:
        return False
    r_point = pt_decompress_liberal(sig[:32])
    if r_point is None:
        return False
    k = sc_reduce(_sha512(sig[:32], pubkey, msg))
    # [8]([s]B - R - [k]A) == identity
    diff = pt_add(pt_mul(s, B_POINT), pt_neg(pt_add(r_point, pt_mul(k, a_point))))
    for _ in range(3):
        diff = pt_double(diff)
    return pt_is_identity(diff)


def verify_zip215(pubkey: bytes, msg: bytes, sig: bytes) -> bool:
    """ZIP-215 verification of one signature (the oracle above)."""
    return verify_zip215_slow(pubkey, msg, sig)

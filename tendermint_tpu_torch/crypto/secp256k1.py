"""secp256k1 ECDSA on the standard library's integers, and RIPEMD-160.

The reference verifies and signs secp256k1 through the ``cryptography``
package (``tendermint_tpu/crypto/keys.py:160-258``), which the port may
not import. This is the same verification on Python integers: a 33-byte
compressed SEC1 key (prefix 02 or 03, x < p, on the curve), a 64-byte
``r || s`` signature with r and s in [1, n) and s in the low half
(crypto/secp256k1/secp256k1.go:188-217 rejects a malleable high s), and
the message hashed with SHA-256. The signer takes its nonce by RFC 6979
(HMAC-SHA256), so a key signs a message the same way every time; the
reference's nonce is random, so the two sign differently and only
verification is held to it. The signer is for tests and fixtures: it is
not constant-time (the table walk branches on each nonce digit, and
Python's integers take time that depends on their values), so its
timings can leak nonce bits. The reference signs through OpenSSL.

Jacobian coordinates, ``a = 0``. The base point's multiples come from a
table of 4-bit windows built at first use; any other point is
multiplied by 4-bit windows over its first 15 multiples. Host only: no
kernel verifies this key type, in either package.

:func:`ripemd160` is hashlib's where the host's OpenSSL offers it (an
OpenSSL 3 host often does not) and :func:`ripemd160_pure` otherwise.
"""

from __future__ import annotations

import hashlib
import hmac
import threading
from typing import List, Optional, Tuple

P = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEFFFFFC2F
N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
B = 7
GX = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
GY = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8

PUBKEY_SIZE = 33
SIG_SIZE = 64

# A point in Jacobian coordinates (X, Y, Z), affine (X / Z^2, Y / Z^3);
# Z = 0 is the point at infinity.
Jacobian = Tuple[int, int, int]
INFINITY: Jacobian = (1, 1, 0)


def _double(p1: Jacobian) -> Jacobian:
    x1, y1, z1 = p1
    if z1 == 0 or y1 == 0:
        return INFINITY
    a = x1 * x1 % P
    b = y1 * y1 % P
    c = b * b % P
    d = 2 * ((x1 + b) * (x1 + b) - a - c) % P
    e = 3 * a % P
    x3 = (e * e - 2 * d) % P
    return x3, (e * (d - x3) - 8 * c) % P, 2 * y1 * z1 % P


def _add(p1: Jacobian, p2: Jacobian) -> Jacobian:
    x1, y1, z1 = p1
    x2, y2, z2 = p2
    if z1 == 0:
        return p2
    if z2 == 0:
        return p1
    z1z1 = z1 * z1 % P
    z2z2 = z2 * z2 % P
    u1 = x1 * z2z2 % P
    u2 = x2 * z1z1 % P
    s1 = y1 * z2 * z2z2 % P
    s2 = y2 * z1 * z1z1 % P
    h = (u2 - u1) % P
    r = (s2 - s1) % P
    if h == 0:
        return _double(p1) if r == 0 else INFINITY
    hh = h * h % P
    hhh = h * hh % P
    v = u1 * hh % P
    x3 = (r * r - hhh - 2 * v) % P
    return x3, (r * (v - x3) - s1 * hhh) % P, h * z1 * z2 % P


def _affine(p1: Jacobian) -> Optional[Tuple[int, int]]:
    x, y, z = p1
    if z == 0:
        return None
    zi = pow(z, -1, P)
    zi2 = zi * zi % P
    return x * zi2 % P, y * zi2 * zi % P


_G_TABLE: List[List[Jacobian]] = []  # [window][digit] = digit * 16^window * G
_g_table_lock = threading.Lock()


def _g_table() -> List[List[Jacobian]]:
    with _g_table_lock:
        if not _G_TABLE:
            base: Jacobian = (GX, GY, 1)
            for _ in range(64):
                row = [INFINITY, base]
                for _ in range(14):
                    row.append(_add(row[-1], base))
                _G_TABLE.append(row)
                for _ in range(4):
                    base = _double(base)
        return _G_TABLE


def _mul_g(k: int) -> Jacobian:
    """k * G by the fixed-base table: one addition a 4-bit window."""
    table = _g_table()
    acc = INFINITY
    for w in range(64):
        digit = (k >> (4 * w)) & 15
        if digit:
            acc = _add(acc, table[w][digit])
    return acc


def _mul(k: int, pt: Jacobian) -> Jacobian:
    """k * pt by 4-bit windows, most significant first."""
    multiples = [INFINITY, pt]
    for _ in range(14):
        multiples.append(_add(multiples[-1], pt))
    acc = INFINITY
    for w in range(63, -1, -1):
        for _ in range(4):
            acc = _double(acc)
        digit = (k >> (4 * w)) & 15
        if digit:
            acc = _add(acc, multiples[digit])
    return acc


def decompress(data: bytes) -> Optional[Tuple[int, int]]:
    """The affine point of a 33-byte SEC1 compressed key, or None: prefix
    02 or 03, x < p, and x^3 + 7 a square mod p."""
    if len(data) != PUBKEY_SIZE or data[0] not in (2, 3):
        return None
    x = int.from_bytes(data[1:], "big")
    if x >= P:
        return None
    y2 = (x * x * x + B) % P
    y = pow(y2, (P + 1) // 4, P)
    if y * y % P != y2:
        return None
    if (y & 1) != (data[0] & 1):
        y = P - y
    return x, y


def compress(x: int, y: int) -> bytes:
    return bytes([2 | (y & 1)]) + x.to_bytes(32, "big")


def _digest(msg: bytes) -> int:
    """SHA-256 of the message as an integer; n has 256 bits, so all of
    it is the ECDSA e."""
    return int.from_bytes(hashlib.sha256(msg).digest(), "big")


def verify(pub: bytes, msg: bytes, sig: bytes) -> bool:
    """ECDSA verification with the reference's checks: a 64-byte r || s,
    s in the low half, r and s in [1, n), a valid compressed key."""
    if len(sig) != SIG_SIZE:
        return False
    r = int.from_bytes(sig[:32], "big")
    s = int.from_bytes(sig[32:], "big")
    if s > N // 2:  # malleable high s
        return False
    if not (0 < r < N and 0 < s < N):
        return False
    q = decompress(pub)
    if q is None:
        return False
    w = pow(s, -1, N)
    u1 = _digest(msg) * w % N
    u2 = r * w % N
    pt = _affine(_add(_mul_g(u1), _mul(u2, (q[0], q[1], 1))))
    return pt is not None and pt[0] % N == r


def public_key(secret: int) -> bytes:
    """The compressed key of a secret scalar in [1, n)."""
    if not 0 < secret < N:
        raise ValueError("secp256k1 secret out of range")
    x, y = _affine(_mul_g(secret))
    return compress(x, y)


def _rfc6979_nonces(secret: int, h1: bytes):
    """RFC 6979 section 3.2 with HMAC-SHA256 and qlen = 256: the candidate
    nonces in order."""
    x = secret.to_bytes(32, "big")
    h1o = (int.from_bytes(h1, "big") % N).to_bytes(32, "big")
    v = b"\x01" * 32
    k = b"\x00" * 32
    k = hmac.new(k, v + b"\x00" + x + h1o, hashlib.sha256).digest()
    v = hmac.new(k, v, hashlib.sha256).digest()
    k = hmac.new(k, v + b"\x01" + x + h1o, hashlib.sha256).digest()
    v = hmac.new(k, v, hashlib.sha256).digest()
    while True:
        v = hmac.new(k, v, hashlib.sha256).digest()
        cand = int.from_bytes(v, "big")
        if 0 < cand < N:
            yield cand
        k = hmac.new(k, v + b"\x00", hashlib.sha256).digest()
        v = hmac.new(k, v, hashlib.sha256).digest()


def sign(secret: int, msg: bytes) -> bytes:
    """A 64-byte r || s signature with low s, the nonce by RFC 6979. Not
    constant-time: for tests and fixtures only (see the module's text)."""
    if not 0 < secret < N:
        raise ValueError("secp256k1 secret out of range")
    h1 = hashlib.sha256(msg).digest()
    e = int.from_bytes(h1, "big")
    for k in _rfc6979_nonces(secret, h1):
        x, _ = _affine(_mul_g(k))
        r = x % N
        if r == 0:
            continue
        s = pow(k, -1, N) * (e + r * secret) % N
        if s == 0:
            continue
        if s > N // 2:
            s = N - s
        return r.to_bytes(32, "big") + s.to_bytes(32, "big")
    raise AssertionError("unreachable")


# --- RIPEMD-160 ----------------------------------------------------------------

_RL = [
    0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
    7, 4, 13, 1, 10, 6, 15, 3, 12, 0, 9, 5, 2, 14, 11, 8,
    3, 10, 14, 4, 9, 15, 8, 1, 2, 7, 0, 6, 13, 11, 5, 12,
    1, 9, 11, 10, 0, 8, 12, 4, 13, 3, 7, 15, 14, 5, 6, 2,
    4, 0, 5, 9, 7, 12, 2, 10, 14, 1, 3, 8, 11, 6, 15, 13,
]
_RR = [
    5, 14, 7, 0, 9, 2, 11, 4, 13, 6, 15, 8, 1, 10, 3, 12,
    6, 11, 3, 7, 0, 13, 5, 10, 14, 15, 8, 12, 4, 9, 1, 2,
    15, 5, 1, 3, 7, 14, 6, 9, 11, 8, 12, 2, 10, 0, 4, 13,
    8, 6, 4, 1, 3, 11, 15, 0, 5, 12, 2, 13, 9, 7, 10, 14,
    12, 15, 10, 4, 1, 5, 8, 7, 6, 2, 13, 14, 0, 3, 9, 11,
]
_SL = [
    11, 14, 15, 12, 5, 8, 7, 9, 11, 13, 14, 15, 6, 7, 9, 8,
    7, 6, 8, 13, 11, 9, 7, 15, 7, 12, 15, 9, 11, 7, 13, 12,
    11, 13, 6, 7, 14, 9, 13, 15, 14, 8, 13, 6, 5, 12, 7, 5,
    11, 12, 14, 15, 14, 15, 9, 8, 9, 14, 5, 6, 8, 6, 5, 12,
    9, 15, 5, 11, 6, 8, 13, 12, 5, 12, 13, 14, 11, 8, 5, 6,
]
_SR = [
    8, 9, 9, 11, 13, 15, 15, 5, 7, 7, 8, 11, 14, 14, 12, 6,
    9, 13, 15, 7, 12, 8, 9, 11, 7, 7, 12, 7, 6, 15, 13, 11,
    9, 7, 15, 11, 8, 6, 6, 14, 12, 13, 5, 14, 13, 13, 7, 5,
    15, 5, 8, 11, 14, 14, 6, 14, 6, 9, 12, 9, 12, 5, 15, 8,
    8, 5, 12, 9, 12, 5, 14, 6, 8, 13, 6, 5, 15, 13, 11, 11,
]
_KL = (0x00000000, 0x5A827999, 0x6ED9EBA1, 0x8F1BBCDC, 0xA953FD4E)
_KR = (0x50A28BE6, 0x5C4DD124, 0x6D703EF3, 0x7A6D76E9, 0x00000000)
_M32 = 0xFFFFFFFF


def _f(j: int, x: int, y: int, z: int) -> int:
    if j < 16:
        return x ^ y ^ z
    if j < 32:
        return (x & y) | (~x & z)
    if j < 48:
        return ((x | ~y) & _M32) ^ z
    if j < 64:
        return (x & z) | (y & ~z)
    return x ^ ((y | ~z) & _M32)


def _rol(x: int, n: int) -> int:
    return ((x << n) | (x >> (32 - n))) & _M32


def ripemd160_pure(data: bytes) -> bytes:
    """RIPEMD-160 in Python (Dobbertin, Bosselaers, Preneel 1996)."""
    h = [0x67452301, 0xEFCDAB89, 0x98BADCFE, 0x10325476, 0xC3D2E1F0]
    msg = bytes(data) + b"\x80" + b"\x00" * ((55 - len(data)) % 64)
    msg += (8 * len(data) & 0xFFFFFFFFFFFFFFFF).to_bytes(8, "little")
    for off in range(0, len(msg), 64):
        x = [int.from_bytes(msg[off + 4 * i:off + 4 * i + 4], "little") for i in range(16)]
        al, bl, cl, dl, el = h
        ar, br, cr, dr, er = h
        for j in range(80):
            t = _rol((al + (_f(j, bl, cl, dl) & _M32) + x[_RL[j]] + _KL[j >> 4]) & _M32, _SL[j])
            al, el, dl, cl, bl = el, dl, _rol(cl, 10), bl, (t + el) & _M32
            t = _rol((ar + (_f(79 - j, br, cr, dr) & _M32) + x[_RR[j]] + _KR[j >> 4]) & _M32, _SR[j])
            ar, er, dr, cr, br = er, dr, _rol(cr, 10), br, (t + er) & _M32
        t = (h[1] + cl + dr) & _M32
        h[1] = (h[2] + dl + er) & _M32
        h[2] = (h[3] + el + ar) & _M32
        h[3] = (h[4] + al + br) & _M32
        h[4] = (h[0] + bl + cr) & _M32
        h[0] = t
    return b"".join(v.to_bytes(4, "little") for v in h)


def _hashlib_ripemd160(data: bytes) -> bytes:
    return hashlib.new("ripemd160", data).digest()


try:
    _hashlib_ripemd160(b"")
    ripemd160 = _hashlib_ripemd160
except ValueError:  # OpenSSL 3 without the legacy provider
    ripemd160 = ripemd160_pure

"""ristretto255 group encoding over edwards25519 (RFC 9496).

A copy of ``tendermint_tpu/crypto/ristretto.py`` over the port's own
:mod:`tendermint_tpu_torch.crypto.ed25519_ref`: points are its
``(X, Y, Z, T)`` extended-coordinate tuples; ristretto adds the
quotient-group encode / decode and the coset-aware equality. It is the
group sr25519 (schnorrkel) works in, and the host oracle of the sr25519
kernel.
"""

from __future__ import annotations

from typing import Optional, Tuple

from tendermint_tpu_torch.crypto.ed25519_ref import (
    B_POINT,
    D,
    IDENT,
    L,
    P,
    pt_add,
    pt_mul,
    pt_neg,
)

Point = Tuple[int, int, int, int]

# sqrt(-1) = 2^((p-1)/4), choosing the value that is "nonnegative"
# (even canonical encoding) per RFC 9496 §3.1.
SQRT_M1 = pow(2, (P - 1) // 4, P)
if SQRT_M1 & 1:
    SQRT_M1 = P - SQRT_M1

_A = P - 1  # curve coefficient a = -1


def _is_negative(x: int) -> bool:
    """RFC 9496 §3.1: negative iff the canonical encoding's low bit is set."""
    return (x % P) & 1 == 1


def _abs(x: int) -> int:
    x %= P
    return P - x if _is_negative(x) else x


def sqrt_ratio_m1(u: int, v: int) -> Tuple[bool, int]:
    """Compute sqrt(u/v) per RFC 9496 §4.2 (SQRT_RATIO_M1).

    Returns ``(was_square, r)`` with r nonnegative. When u/v is not a
    square, r = sqrt(SQRT_M1 * u / v).
    """
    u %= P
    v %= P
    v3 = v * v % P * v % P
    v7 = v3 * v3 % P * v % P
    r = u * v3 % P * pow(u * v7 % P, (P - 5) // 8, P) % P
    check = v * r % P * r % P
    u_neg = (P - u) % P
    correct = check == u
    flipped = check == u_neg
    flipped_i = check == u_neg * SQRT_M1 % P
    if flipped or flipped_i:
        r = r * SQRT_M1 % P
    return (correct or flipped), _abs(r)


def invsqrt(x: int) -> Tuple[bool, int]:
    return sqrt_ratio_m1(1, x)


INVSQRT_A_MINUS_D = invsqrt((_A - D) % P)[1]


def decompress(data: bytes) -> Optional[Point]:
    """Decode a 32-byte ristretto255 encoding; None if invalid (RFC 9496 §4.3.1)."""
    if len(data) != 32:
        return None
    s = int.from_bytes(data, "little")
    # canonical and nonnegative
    if s >= P or s & 1:
        return None
    ss = s * s % P
    u1 = (1 - ss) % P
    u2 = (1 + ss) % P
    u2_sqr = u2 * u2 % P
    # v = -(D * u1^2) - u2^2
    v = (-(D * u1 % P * u1 % P) - u2_sqr) % P
    ok, i = invsqrt(v * u2_sqr % P)
    if not ok:
        return None
    dx = i * u2 % P
    dy = i * dx % P * v % P
    x = _abs(2 * s % P * dx % P)
    y = u1 * dy % P
    t = x * y % P
    if _is_negative(t) or y == 0:
        return None
    return (x, y, 1, t)


def compress(p: Point) -> bytes:
    """Encode a point to its canonical 32-byte ristretto255 form (RFC 9496 §4.3.2)."""
    x0, y0, z0, t0 = p
    u1 = (z0 + y0) % P * ((z0 - y0) % P) % P
    u2 = x0 * y0 % P
    _, inv = invsqrt(u1 * u2 % P * u2 % P)
    den1 = inv * u1 % P
    den2 = inv * u2 % P
    z_inv = den1 * den2 % P * t0 % P
    ix = x0 * SQRT_M1 % P
    iy = y0 * SQRT_M1 % P
    enchanted = den1 * INVSQRT_A_MINUS_D % P
    if _is_negative(t0 * z_inv % P):
        x, y = iy, ix
        den_inv = enchanted
    else:
        x, y = x0, y0
        den_inv = den2
    if _is_negative(x * z_inv % P):
        y = (P - y) % P
    s = _abs(den_inv * ((z0 - y) % P) % P)
    return s.to_bytes(32, "little")


def equals(p: Point, q: Point) -> bool:
    """Ristretto (coset-aware) equality: X1·Y2 == Y1·X2 or Y1·Y2 == X1·X2."""
    x1, y1, _, _ = p
    x2, y2, _, _ = q
    return (x1 * y2 - y1 * x2) % P == 0 or (y1 * y2 - x1 * x2) % P == 0


def is_identity(p: Point) -> bool:
    return equals(p, IDENT)


def scalar_from_wide(data: bytes) -> int:
    """64 uniform bytes → scalar mod L (Scalar::from_bytes_mod_order_wide)."""
    if len(data) != 64:
        raise ValueError("wide scalar input must be 64 bytes")
    return int.from_bytes(data, "little") % L


def scalar_from_canonical(data: bytes) -> Optional[int]:
    """32 bytes → scalar, requiring canonical (< L) encoding."""
    if len(data) != 32:
        return None
    s = int.from_bytes(data, "little")
    if s >= L:
        return None
    return s


__all__ = [
    "B_POINT",
    "IDENT",
    "L",
    "P",
    "Point",
    "SQRT_M1",
    "INVSQRT_A_MINUS_D",
    "compress",
    "decompress",
    "equals",
    "invsqrt",
    "is_identity",
    "pt_add",
    "pt_mul",
    "pt_neg",
    "scalar_from_canonical",
    "scalar_from_wide",
    "sqrt_ratio_m1",
]

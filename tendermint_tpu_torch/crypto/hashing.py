"""Host-side challenge hashing for the device verifier.

A copy of the hashlib path and the vectorized mod-L reduction of
``tendermint_tpu/crypto/hashing.py`` (the C extension is not carried
over): ``sha512_batch_prefixed`` hashes prefix_i || msg_i and
``reduce_mod_l`` reduces each 512-bit digest mod the ed25519 group order
L with a numpy Barrett reduction, with no per-signature Python
arithmetic.
"""

from __future__ import annotations

import hashlib
from typing import List, Sequence

import numpy as np

L = 2**252 + 27742317777372353535851937790883648493


def sha512_batch(msgs: Sequence[bytes]) -> np.ndarray:
    """N messages -> (N, 64) uint8 digests."""
    out = np.empty((len(msgs), 64), dtype=np.uint8)
    for i, m in enumerate(msgs):
        out[i] = np.frombuffer(hashlib.sha512(m).digest(), dtype=np.uint8)
    return out


def sha512_batch_prefixed(prefix: np.ndarray, msgs: Sequence[bytes]) -> np.ndarray:
    """Hash prefix_i || msg_i for a (N, 64) uint8 prefix block -> (N, 64).

    The verifier's challenge is SHA-512(R || A || M); R and A already
    live in (N, 32) arrays, so the 64-byte prefix block costs one
    concatenate instead of N Python byte-string builds.
    """
    n = len(msgs)
    if prefix.shape != (n, 64) or prefix.dtype != np.uint8:
        raise ValueError(f"prefix must be ({n}, 64) uint8, got {prefix.shape} {prefix.dtype}")
    out = np.empty((n, 64), dtype=np.uint8)
    pb = np.ascontiguousarray(prefix)
    for i, m in enumerate(msgs):
        h = hashlib.sha512(pb[i].tobytes())
        h.update(m)
        out[i] = np.frombuffer(h.digest(), dtype=np.uint8)
    return out


# --- vectorized Barrett reduction mod L -------------------------------------
#
# Values are little-endian 16-bit limb vectors; all products accumulate
# in int64 (max column ~ 40 * 2^32 < 2^38, exact). Barrett with
# mu = floor(2^512 / L): q = floor(floor(x / 2^240) * mu / 2^272),
# r = x - q*L, then at most three conditional subtracts of L.

_L_LIMBS = np.array([(L >> (16 * i)) & 0xFFFF for i in range(16)], dtype=np.int64)
_MU = (1 << 512) // L
_MU_LIMBS = np.array(
    [(_MU >> (16 * i)) & 0xFFFF for i in range((_MU.bit_length() + 15) // 16)],
    dtype=np.int64,
)


def _carry16(cols: np.ndarray, nlimbs: int) -> np.ndarray:
    """Carry-propagate int64 columns into nlimbs 16-bit limbs (drop overflow)."""
    out = np.zeros((cols.shape[0], nlimbs), dtype=np.int64)
    c = np.zeros(cols.shape[0], dtype=np.int64)
    for i in range(nlimbs):
        v = c + (cols[:, i] if i < cols.shape[1] else 0)
        out[:, i] = v & 0xFFFF
        c = v >> 16
    return out


def _mul_const(x: np.ndarray, const_limbs: np.ndarray) -> np.ndarray:
    """(N, a) 16-bit limbs times constant (b,) limbs -> (N, a+b) columns."""
    n, a = x.shape
    b = const_limbs.shape[0]
    cols = np.zeros((n, a + b), dtype=np.int64)
    for j in range(b):
        cols[:, j : j + a] += x * const_limbs[j]
    return cols


def _ge(x: np.ndarray, y_limbs: np.ndarray) -> np.ndarray:
    """(N, 16) >= const (16,) comparison, little-endian limbs."""
    diff = x - y_limbs[None, :]
    nz = diff != 0
    first = np.argmax(nz[:, ::-1], axis=1)
    val = diff[:, ::-1][np.arange(x.shape[0]), first]
    return np.where(nz.any(axis=1), val > 0, True)


def reduce_mod_l(digests: np.ndarray) -> np.ndarray:
    """(N, 64) uint8 little-endian 512-bit values -> (N, 32) uint8 mod L."""
    n = digests.shape[0]
    pairs = digests.reshape(n, 32, 2).astype(np.int64)
    x16 = pairs[:, :, 0] + (pairs[:, :, 1] << 8)  # (N, 32) 16-bit limbs
    q1 = x16[:, 15:]  # (N, 17) limbs: x >> 240
    q2 = _carry16(_mul_const(q1, _MU_LIMBS), q1.shape[1] + _MU_LIMBS.shape[0])
    q = q2[:, 17:]  # >> 272
    # r = x - q*L (mod 2^256 is safe: r < 4L < 2^255)
    ql = _carry16(_mul_const(q, _L_LIMBS), 16)
    r = np.zeros((n, 16), dtype=np.int64)
    borrow = np.zeros(n, dtype=np.int64)
    for i in range(16):
        v = x16[:, i] - ql[:, i] - borrow
        borrow = (v < 0).astype(np.int64)
        r[:, i] = v + (borrow << 16)
    for _ in range(3):
        ge = _ge(r, _L_LIMBS)
        borrow = np.zeros(n, dtype=np.int64)
        sub = np.zeros_like(r)
        for i in range(16):
            v = r[:, i] - _L_LIMBS[i] - borrow
            borrow = (v < 0).astype(np.int64)
            sub[:, i] = v + (borrow << 16)
        r = np.where(ge[:, None], sub, r)
    out = np.zeros((n, 32), dtype=np.uint8)
    out[:, 0::2] = (r & 0xFF).astype(np.uint8)
    out[:, 1::2] = ((r >> 8) & 0xFF).astype(np.uint8)
    return out


def sha512_batch_mod_l(msgs: Sequence[bytes]) -> List[bytes]:
    """N messages -> N 32-byte little-endian scalars SHA-512(m) mod L."""
    if not msgs:
        return []
    reduced = reduce_mod_l(sha512_batch(msgs))
    return [row.tobytes() for row in reduced]

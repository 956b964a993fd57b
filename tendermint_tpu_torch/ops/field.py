"""GF(2^255 - 19) arithmetic in float32 radix-2^8 limbs, in PyTorch.

The plain-PyTorch counterpart of ``tendermint_tpu/ops/field32.py``, in
the same layout and with the same exactness bounds, limb for limb: a
field-element batch is a float32 tensor of shape ``(32, N)``, 32 limbs
of radix 2^8 (little-endian), lanes minor. Every value is an integer
below 2^24, so float32 arithmetic is exact and the order of additions
does not change a result.

- values are loosely reduced below 2^256; the fold constant is
  2^256 ≡ 38 (mod p);
- between ops every limb lies in [0, 450] (the "loose invariant");
- products of two loose elements give 63 columns < 32 * 450^2 < 2^23;
- a carry round computes all 32 digit/carry pairs at once and shifts
  the carries up one limb, folding the limb-31 carry into limb 0 * 38.
  Three rounds after a multiply bound limbs by 293; one round after
  add/sub bounds them by 407.

These functions are the plain versions behind the CUDA kernels of
``csrc/ed25519_verify.cu``; they run on any device.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

NLIMBS = 32
RADIX_BITS = 8
RADIX = 1 << RADIX_BITS  # 256
MASK = RADIX - 1

P = 2**255 - 19
FOLD = 38.0  # 2^256 mod p
D = (-121665 * pow(121666, P - 2, P)) % P
D2 = (2 * D) % P
SQRT_M1 = pow(2, (P - 1) // 4, P)

# Bias ≡ 0 (mod p) with every limb >= 450 so (a + BIAS - b) is limb-wise
# non-negative for loose a, b: 3*(2^256 - 1) ≡ 111 (mod p), minus 111
# from limb 0 -> limbs [654, 765, ..., 765].
_BIAS = [3 * MASK - 111] + [3 * MASK] * (NLIMBS - 1)
_P_LIMBS = [RADIX - 19] + [MASK] * 30 + [127]
_2P_LIMBS = [RADIX - 38] + [MASK] * 31  # 2p = 2^256 - 38

INV_RADIX = 1.0 / RADIX  # exact power of two


def int_to_limbs(x: int) -> List[int]:
    """Python int -> 32 limbs (host-side)."""
    x %= P
    return [(x >> (RADIX_BITS * i)) & MASK for i in range(NLIMBS)]


def const_np(x: int) -> np.ndarray:
    """Field constant as a (32, 1) float32 array."""
    return np.array(int_to_limbs(x), dtype=np.float32).reshape(NLIMBS, 1)


ONE = const_np(1)
D_FE = const_np(D)
D2_FE = const_np(D2)
SQRT_M1_FE = const_np(SQRT_M1)
BIAS_FE = np.array(_BIAS, dtype=np.float32).reshape(NLIMBS, 1)
P_FE = np.array(_P_LIMBS, dtype=np.float32).reshape(NLIMBS, 1)
P2_FE = np.array(_2P_LIMBS, dtype=np.float32).reshape(NLIMBS, 1)

_ON_DEVICE: Dict[Tuple[int, torch.device], torch.Tensor] = {}


def on(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """A module constant as a tensor on ``like``'s device (cached)."""
    key = (id(arr), like.device)
    t = _ON_DEVICE.get(key)
    if t is None:
        t = _ON_DEVICE[key] = torch.as_tensor(arr, device=like.device)
    return t


def upload(x, device) -> torch.Tensor:
    """A host array or CPU tensor on ``device``. To a CUDA device it goes
    through pinned memory without blocking the host: a copy from pageable
    memory waits for every kernel queued before it on the stream, which
    would hold the next chunk's host prep behind this chunk's kernel."""
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(x)
    device = torch.device(device)
    if device.type != "cuda" or t.device.type != "cpu":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


# Column index i + j of the product limb pair (i, j), for fe_mul.
_COL_IDX = (np.arange(NLIMBS)[:, None] + np.arange(NLIMBS)[None, :]).reshape(-1)


def fe_zero(n: int, device) -> torch.Tensor:
    return torch.zeros((NLIMBS, n), dtype=torch.float32, device=device)


def fe_one(n: int, device) -> torch.Tensor:
    out = fe_zero(n, device)
    out[0] = 1.0
    return out


def _carry_round(v: torch.Tensor) -> torch.Tensor:
    """One vectorized carry round, exact for |v| < 2^24."""
    c = torch.floor(v * INV_RADIX)
    r = v - c * RADIX
    return r + torch.cat([FOLD * c[NLIMBS - 1 :], c[: NLIMBS - 1]], dim=0)


def fe_carry(t: torch.Tensor) -> torch.Tensor:
    """Three rounds: any input < 2^23 per limb -> limbs <= 293."""
    return _carry_round(_carry_round(_carry_round(t)))


def fe_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sum <= 900 per limb; one round -> limbs <= 369."""
    return _carry_round(a + b)


def fe_sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a + BIAS - b in [0, 1215]; one round -> limbs <= 407."""
    return _carry_round(a + on(BIAS_FE, a) - b)


def fe_neg(a: torch.Tensor) -> torch.Tensor:
    return _carry_round(on(BIAS_FE, a) - a)


def fe_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact schoolbook product with the 2^256 ≡ 38 fold.

    The 63 columns are the sums of limb products a_i * b_j at i + j
    (< 32 * 450^2 < 2^23). The 31 high columns split into 8-bit digit +
    carry so the * 38 fold terms stay < 2^20 and the folded low columns
    < 2^23.1. Output limbs <= 293.
    """
    n = max(a.shape[1], b.shape[1])
    prod = (a[:, None, :] * b[None, :, :]).expand(NLIMBS, NLIMBS, n)
    cols = torch.zeros((2 * NLIMBS - 1, n), dtype=torch.float32, device=a.device)
    cols.index_add_(0, on(_COL_IDX, a), prod.reshape(NLIMBS * NLIMBS, n))
    lo, hi = cols[:NLIMBS], cols[NLIMBS:]
    hi_hi = torch.floor(hi * INV_RADIX)
    hi_lo = hi - hi_hi * RADIX
    zero = torch.zeros((1, n), dtype=torch.float32, device=a.device)
    lo = lo + FOLD * torch.cat([hi_lo, zero], dim=0) + FOLD * torch.cat([zero, hi_hi], dim=0)
    return fe_carry(lo)


def fe_sq(a: torch.Tensor) -> torch.Tensor:
    return fe_mul(a, a)


def fe_sqn(a: torch.Tensor, n: int) -> torch.Tensor:
    """a^(2^n)."""
    for _ in range(n):
        a = fe_sq(a)
    return a


def fe_mul_const(a: torch.Tensor, c: np.ndarray) -> torch.Tensor:
    return fe_mul(a, on(c, a))


def fe_tight(a: torch.Tensor) -> torch.Tensor:
    """Exact limbs in [0, 255], value < 2^256 (still mod-p loose).

    Two sequential ripple chains. Chain 1 folds its carry-out (<= 1 for
    loose input) as +38 into limb 0, leaving value <= 2^256 + 37; if
    chain 2 carries out, the residual value was <= 37, so limb 0 <= 75.
    """
    x = a
    for _ in range(2):
        out = []
        c = torch.zeros_like(x[0])
        for i in range(NLIMBS):
            v = x[i] + c
            c = torch.floor(v * INV_RADIX)
            out.append(v - c * RADIX)
        out[0] = out[0] + FOLD * c
        x = torch.stack(out)
    return x


def _ge_const(t: torch.Tensor, limbs: List[int]) -> torch.Tensor:
    """(N,) bool: tight-limb value >= the constant (lexicographic from
    the top limb; needs exact limbs)."""
    ge = torch.ones(t.shape[1], dtype=torch.bool, device=t.device)
    gt = torch.zeros(t.shape[1], dtype=torch.bool, device=t.device)
    for i in range(NLIMBS - 1, -1, -1):
        gt = gt | (ge & (t[i] > limbs[i]))
        ge = ge & (t[i] >= limbs[i])
    return gt | ge


def _tight_is_zero(t: torch.Tensor) -> torch.Tensor:
    """(N,) bool: a tight value ≡ 0 (mod p) is one of {0, p, 2p}."""
    return (
        (t == 0).all(dim=0)
        | (t == on(P_FE, t)).all(dim=0)
        | (t == on(P2_FE, t)).all(dim=0)
    )


def fe_is_zero(a: torch.Tensor) -> torch.Tensor:
    """(N,) bool: a ≡ 0 (mod p)."""
    return _tight_is_zero(fe_tight(a))


def fe_eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return fe_is_zero(fe_sub(a, b))


def _tight_parity(t: torch.Tensor) -> torch.Tensor:
    """p is odd, so each conditional subtract of p flips the parity of
    the tight limb-0 digit: parity = (t0 + [t>=p] + [t>=2p]) mod 2."""
    k = _ge_const(t, _P_LIMBS).float() + _ge_const(t, _2P_LIMBS).float()
    v = t[0] + k
    return v - 2.0 * torch.floor(v * 0.5)


def fe_parity(a: torch.Tensor) -> torch.Tensor:
    """(N,) f32 in {0,1}: lsb of the canonical representative."""
    return _tight_parity(fe_tight(a))


def fe_reduce_full(a: torch.Tensor) -> torch.Tensor:
    """Canonical representative in [0, p), limbs strictly reduced."""
    t = fe_tight(a)
    k = _ge_const(t, _P_LIMBS).float() + _ge_const(t, _2P_LIMBS).float()
    v = t - k[None, :] * on(P_FE, t)
    out = []
    c = torch.zeros_like(v[0])
    for i in range(NLIMBS):  # ripple the borrows; the result is >= 0
        x = v[i] + c
        c = torch.floor(x * INV_RADIX)
        out.append(x - c * RADIX)
    return torch.stack(out)


def fe_select(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """cond: (N,) bool -> a where cond else b."""
    return torch.where(cond[None, :], a, b)


def fe_pow22523(z: torch.Tensor) -> torch.Tensor:
    """z^((p-5)/8) = z^(2^252 - 3), the exponent chain of the combined
    sqrt/division in point decompression (RFC 8032 5.1.3)."""
    t0 = fe_sq(z)  # z^2
    t1 = fe_mul(z, fe_sqn(t0, 2))  # z^9
    t0 = fe_mul(t0, t1)  # z^11
    t0 = fe_sq(t0)  # z^22
    t0 = fe_mul(t1, t0)  # z^31 = z^(2^5 - 1)
    t1 = fe_sqn(t0, 5)
    t0 = fe_mul(t1, t0)  # z^(2^10 - 1)
    t1 = fe_sqn(t0, 10)
    t1 = fe_mul(t1, t0)  # z^(2^20 - 1)
    t2 = fe_sqn(t1, 20)
    t1 = fe_mul(t2, t1)  # z^(2^40 - 1)
    t1 = fe_sqn(t1, 10)
    t0 = fe_mul(t1, t0)  # z^(2^50 - 1)
    t1 = fe_sqn(t0, 50)
    t1 = fe_mul(t1, t0)  # z^(2^100 - 1)
    t2 = fe_sqn(t1, 100)
    t1 = fe_mul(t2, t1)  # z^(2^200 - 1)
    t1 = fe_sqn(t1, 50)
    t0 = fe_mul(t1, t0)  # z^(2^250 - 1)
    t0 = fe_sqn(t0, 2)  # z^(2^252 - 4)
    return fe_mul(t0, z)  # z^(2^252 - 3)

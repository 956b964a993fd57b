"""Batched twisted-Edwards curve ops for ed25519, in PyTorch.

The plain-PyTorch counterpart of ``tendermint_tpu/ops/curve32.py``.
Points are tuples ``(X, Y, Z, T)`` of :mod:`field` batches (extended
coordinates, x = X/Z, y = Y/Z, T = XY/Z). The unified a=-1 addition law
is complete for every pair of curve points, so the small-order and
mixed-order inputs that ZIP-215 accepts (reference:
crypto/ed25519/ed25519.go:24-31) need no special case.

Each point op batches its independent field multiplies through one
wide :func:`field.fe_mul` by concatenating operands along the lane axis,
as the reference does. Precomputed operands come in two forms:

- *Niels* ``(Y+X, Y-X, 2dT)`` with implied Z=1 for the constant
  basepoint table (7-mul mixed add);
- *cached* ``(Y+X, Y-X, Z, 2dT)`` for the per-lane table (8-mul add).

Decompression is the liberal ZIP-215 variant: y >= p encodings are
accepted; the x == 0 && sign == 1 rejection is kept (RFC 8032 5.1.3).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from tendermint_tpu_torch.ops import field as F

Point = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]
NielsPoint = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
CachedPoint = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _mul_many(xs: Sequence[torch.Tensor], ys: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Elementwise products of k operand pairs via one lane-stacked fe_mul."""
    n = xs[0].shape[1]
    m = F.fe_mul(torch.cat(list(xs), dim=1), torch.cat(list(ys), dim=1))
    return list(torch.split(m, n, dim=1))


def pt_identity(n: int, device) -> Point:
    return (F.fe_zero(n, device), F.fe_one(n, device), F.fe_one(n, device), F.fe_zero(n, device))


def pt_neg(p: Point) -> Point:
    x, y, z, t = p
    return (F.fe_neg(x), y, z, F.fe_neg(t))


def pt_to_cached(p: Point) -> CachedPoint:
    x, y, z, t = p
    return (F.fe_add(y, x), F.fe_sub(y, x), z, F.fe_mul_const(t, F.D2_FE))


def _finish_add(a, b, c, d2) -> Point:
    e = F.fe_sub(b, a)
    f = F.fe_sub(d2, c)
    g = F.fe_add(d2, c)
    h = F.fe_add(b, a)
    x3, y3, z3, t3 = _mul_many([e, g, f, e], [f, h, g, h])
    return (x3, y3, z3, t3)


def pt_add_cached(p: Point, q: CachedPoint) -> Point:
    """Unified a=-1 addition against a cached operand (add-2008-hwcd-3
    with the 2dT pre-scale folded into q). 2 stacked fe_mul calls."""
    x1, y1, z1, t1 = p
    yplusx, yminusx, z2, td2 = q
    a, b, c, d = _mul_many(
        [F.fe_sub(y1, x1), F.fe_add(y1, x1), t1, z1], [yminusx, yplusx, td2, z2]
    )
    return _finish_add(a, b, c, F.fe_add(d, d))


def pt_add(p: Point, q: Point) -> Point:
    """General complete addition (builds the cached form on the fly)."""
    return pt_add_cached(p, pt_to_cached(q))


def pt_madd(p: Point, q: NielsPoint) -> Point:
    """Mixed addition with a precomputed affine Niels point (Z2=1)."""
    x1, y1, z1, t1 = p
    yplusx, yminusx, td2 = q
    a, b, c = _mul_many([F.fe_sub(y1, x1), F.fe_add(y1, x1), t1], [yminusx, yplusx, td2])
    return _finish_add(a, b, c, F.fe_add(z1, z1))


def pt_double(p: Point) -> Point:
    """dbl-2008-hwcd, valid for all inputs. 2 stacked fe_mul calls."""
    x1, y1, z1, _ = p
    sxy_in = F.fe_add(x1, y1)
    a, b, zz, sxy = _mul_many([x1, y1, z1, sxy_in], [x1, y1, z1, sxy_in])
    c = F.fe_add(zz, zz)
    h = F.fe_add(a, b)
    e = F.fe_sub(h, sxy)
    g = F.fe_sub(a, b)
    f = F.fe_add(c, g)
    x3, y3, z3, t3 = _mul_many([e, g, f, e], [f, h, g, h])
    return (x3, y3, z3, t3)


def pt_select(cond: torch.Tensor, p: Point, q: Point) -> Point:
    """cond: (N,) bool — p where cond else q, coordinate-wise."""
    return tuple(F.fe_select(cond, a, b) for a, b in zip(p, q))  # type: ignore[return-value]


def niels_cneg(cond: torch.Tensor, q: NielsPoint) -> NielsPoint:
    """Per-lane conditional negation of a Niels point:
    -(Y+X, Y-X, 2dT) = (Y-X, Y+X, -2dT)."""
    yplusx, yminusx, td2 = q
    return (
        F.fe_select(cond, yminusx, yplusx),
        F.fe_select(cond, yplusx, yminusx),
        F.fe_select(cond, F.fe_neg(td2), td2),
    )


def cached_cneg(cond: torch.Tensor, q: CachedPoint) -> CachedPoint:
    """Per-lane conditional negation of a cached point; Z is unchanged."""
    yplusx, yminusx, z, td2 = q
    return (
        F.fe_select(cond, yminusx, yplusx),
        F.fe_select(cond, yplusx, yminusx),
        z,
        F.fe_select(cond, F.fe_neg(td2), td2),
    )


def pt_is_identity(p: Point) -> torch.Tensor:
    """(N,) bool: X ≡ 0 and Y ≡ Z (projective identity test)."""
    x, y, z, _ = p
    return F.fe_is_zero(x) & F.fe_is_zero(F.fe_sub(y, z))


def pt_decompress(y: torch.Tensor, sign: torch.Tensor) -> Tuple[Point, torch.Tensor]:
    """Liberal (ZIP-215) decompression of a batch.

    y: (32, N) f32 limbs of the 255-bit y-coordinate (any value below
    2^255; non-canonical encodings reduce implicitly); sign: (N,) f32 in
    {0, 1}. Returns (point, valid); invalid lanes hold the identity.
    """
    n = y.shape[1]
    y2 = F.fe_sq(y)
    one = F.fe_one(n, y.device)
    u = F.fe_sub(y2, one)
    v = F.fe_add(F.fe_mul_const(y2, F.D_FE), one)
    v3 = F.fe_mul(F.fe_sq(v), v)
    v7 = F.fe_mul(F.fe_sq(v3), v)
    x = F.fe_mul(F.fe_mul(u, v3), F.fe_pow22523(F.fe_mul(u, v7)))
    vx2 = F.fe_mul(v, F.fe_sq(x))
    root1 = F.fe_eq(vx2, u)
    root2 = F.fe_eq(vx2, F.fe_neg(u))
    x = F.fe_select(root2, F.fe_mul_const(x, F.SQRT_M1_FE), x)
    on_curve = root1 | root2
    # One tight pass serves the x == 0 test and the parity.
    xt = F.fe_tight(x)
    valid = on_curve & ~(F._tight_is_zero(xt) & (sign == 1))
    x = F.fe_select(F._tight_parity(xt) != sign, F.fe_neg(x), x)
    pt: Point = (x, y, one, F.fe_mul(x, y))
    return pt_select(valid, pt, pt_identity(n, y.device)), valid

"""Limb parity of the port's field and curve ops with field32/curve32.

Every value is an integer below 2^24 in float32 on both sides, so the
comparisons are exact (tolerance 0). Inputs are random loose limbs
(<= 450) from a numpy seed, fed to both packages.
"""

import pytest

torch = pytest.importorskip("torch")
# The plain versions run thousands of tiny tensor ops: one intra-op thread
# is fastest, and keeps parallel test workers from oversubscribing cores.
torch.set_num_threads(1)

import jax
import jax.numpy as jnp
import numpy as np

from tendermint_tpu.crypto import ed25519_ref as jref
from tendermint_tpu.ops import curve32, field32
from tendermint_tpu_torch.ops import curve, field

N = 16


def _loose(rng, n=N):
    return rng.integers(0, 451, (32, n)).astype(np.float32)


def _same(port_out, jax_out):
    got = port_out.numpy() if isinstance(port_out, torch.Tensor) else port_out
    want = np.asarray(jax_out)
    assert got.shape == want.shape
    assert got.dtype == want.dtype or (got.dtype == np.float32 and want.dtype == np.float32)
    np.testing.assert_array_equal(got, want)


BINARY = ["fe_add", "fe_sub", "fe_mul", "fe_eq"]
UNARY = [
    "fe_neg", "fe_sq", "fe_tight", "fe_is_zero", "fe_parity", "fe_reduce_full",
    "fe_pow22523", "fe_carry",
]


@pytest.mark.parametrize("name", BINARY)
def test_field_binary_ops(name):
    rng = np.random.default_rng(100 + BINARY.index(name))
    a, b = _loose(rng), _loose(rng)
    b[:, :2] = a[:, :2]  # equal lanes for fe_eq
    want = jax.jit(getattr(field32, name))(jnp.asarray(a), jnp.asarray(b))
    _same(getattr(field, name)(torch.from_numpy(a), torch.from_numpy(b)), want)


@pytest.mark.parametrize("name", UNARY)
def test_field_unary_ops(name):
    rng = np.random.default_rng(200 + UNARY.index(name))
    a = _loose(rng)
    a[:, 0] = 0  # zero
    a[:, 1] = field32.P_FE[:, 0]  # p
    a[:, 2] = field32.P2_FE[:, 0]  # 2p
    if name == "fe_carry":
        a = rng.integers(0, 2**22, (32, N)).astype(np.float32)  # post-multiply range
    want = jax.jit(getattr(field32, name))(jnp.asarray(a))
    _same(getattr(field, name)(torch.from_numpy(a)), want)


def test_field_sqn_select_and_const_mul():
    rng = np.random.default_rng(300)
    a, b = _loose(rng), _loose(rng)
    cond = rng.integers(0, 2, N).astype(bool)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    _same(field.fe_sqn(ta, 5), jax.jit(lambda x: field32.fe_sqn(x, 5))(jnp.asarray(a)))
    _same(
        field.fe_select(torch.from_numpy(cond), ta, tb),
        field32.fe_select(jnp.asarray(cond), jnp.asarray(a), jnp.asarray(b)),
    )
    _same(
        field.fe_mul_const(ta, field.D2_FE),
        jax.jit(lambda x: field32.fe_mul_const(x, field32.D2_FE))(jnp.asarray(a)),
    )


def test_field_constants_match():
    for name in ("P", "D", "D2", "SQRT_M1"):
        assert getattr(field, name) == getattr(field32, name)
    for name in ("ONE", "D_FE", "D2_FE", "SQRT_M1_FE", "BIAS_FE", "P_FE", "P2_FE"):
        np.testing.assert_array_equal(getattr(field, name), getattr(field32, name))


def _point(rng):
    return tuple(_loose(rng) for _ in range(4))


def _t(p):
    return tuple(torch.from_numpy(c) for c in p)


def _j(p):
    return tuple(jnp.asarray(c) for c in p)


def _same_point(port_pt, jax_pt):
    assert len(port_pt) == len(jax_pt)
    for a, b in zip(port_pt, jax_pt):
        _same(a, b)


CURVE_OPS = ["pt_add_cached", "pt_madd", "pt_double", "pt_neg", "pt_to_cached", "pt_add"]


@pytest.mark.parametrize("name", CURVE_OPS)
def test_curve_ops(name):
    rng = np.random.default_rng(400 + CURVE_OPS.index(name))
    p, q = _point(rng), _point(rng)
    if name == "pt_madd":
        q = q[:3]
    if name in ("pt_double", "pt_neg", "pt_to_cached"):
        want = jax.jit(getattr(curve32, name))(_j(p))
        got = getattr(curve, name)(_t(p))
    else:
        want = jax.jit(getattr(curve32, name))(_j(p), _j(q))
        got = getattr(curve, name)(_t(p), _t(q))
    _same_point(got, want)


def test_curve_conditional_negation_and_identity():
    rng = np.random.default_rng(500)
    q = _point(rng)
    cond = rng.integers(0, 2, N).astype(bool)
    tc, jc = torch.from_numpy(cond), jnp.asarray(cond)
    _same_point(curve.cached_cneg(tc, _t(q)), curve32.cached_cneg(jc, _j(q)))
    _same_point(curve.niels_cneg(tc, _t(q[:3])), curve32.niels_cneg(jc, _j(q[:3])))
    p = _point(rng)
    ident = [np.asarray(c) for c in curve32.pt_identity(N)]
    for c in range(4):  # half the lanes are projective identities
        p[c][:, ::2] = ident[c][:, ::2] * (3 if c in (1, 2) else 1)
    want = jax.jit(curve32.pt_is_identity)(_j(p))
    assert np.asarray(want)[::2].all() and not np.asarray(want)[1::2].any()
    _same(curve.pt_is_identity(_t(p)), want)


def _decompress_vectors():
    """The vectors of tests/test_ops_ed25519.py::test_decompress_*."""
    pks = [jref.keypair_from_seed(bytes([i + 1]) * 32)[1] for i in range(6)]
    pks.append((1).to_bytes(32, "little"))  # identity
    pks.append((jref.P + 1).to_bytes(32, "little"))  # non-canonical identity
    pks.append(bytes([2] + [0] * 31))  # y = 2: off the curve
    pks.append(bytes(31) + b"\x80")  # y = 0 with sign 1: x == 0, rejected? (x != 0 here)
    return np.stack([np.frombuffer(p, dtype=np.uint8) for p in pks])


def test_decompress_parity():
    from tendermint_tpu.ops import ed25519_batch as jeb
    from tendermint_tpu_torch.ops import ed25519_batch as teb

    raw = _decompress_vectors()
    jy, js = jeb._strip_sign(jeb._bytes_to_fe(jnp.asarray(raw)))
    ty, ts = teb._strip_sign(teb._bytes_to_fe(torch.from_numpy(raw)))
    _same(ty, jy)
    _same(ts, js)
    jpt, jok = jax.jit(curve32.pt_decompress)(jy, js)
    tpt, tok = curve.pt_decompress(ty, ts)
    _same_point(tpt, jpt)
    _same(tok, jok)
    want = [jref.pt_decompress_liberal(r.tobytes()) is not None for r in raw]
    assert list(tok.numpy()) == want
    assert want[:8] == [True] * 8 and want[8] is False

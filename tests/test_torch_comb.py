"""CPU rehearsal of the fixed-base comb of ``csrc/ed25519_verify.cu``.

The kernels compute [s]B in a warp of its own, one lane a thread, in
ref10's ``ge_scalarmult_base`` order over a table of (e + 1) 256^j B, and
the quads run the Straus loop on [k](-A) alone, adding the cached [s]B
after it. The functions below are that order written over the port's
plain curve ops (``ops/curve.py``); every input is made from a numpy
seed. They are held to ``crypto/ed25519_ref.py``, to the plain engine's
``_straus_core`` (points compared as canonical affine coordinates,
tolerance 0) and, through ``verify_kernel_resident``'s inputs, to the
JAX package's ``verify_batch``.
"""

import hashlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from tendermint_tpu.ops import ed25519_batch as jeb
from tendermint_tpu_torch.crypto import ed25519_ref as ref
from tendermint_tpu_torch.ops import cuda_verify, curve, ed25519_batch as teb, field as F
from tendermint_tpu_torch.ops import precompute as tpc
from tests.test_torch_resident import _parity_lanes

P, L = ref.P, ref.L
# sha256 of the 27 constant rows ([1..8]B Niels, d, sqrt(-1), 2d) that the
# kernels took before the comb was appended.
CONSTS_V1_SHA256 = "27fdc7093785eae7155e08521fc4aef58ddcb88c93e247a81e134dce321c588e"


def _to_ints(t):
    """(32, N) radix-2^8 limbs -> N ints mod p."""
    limbs = t.numpy().astype(np.int64)
    return [sum(int(limbs[i, j]) << (8 * i) for i in range(32)) % P for j in range(limbs.shape[1])]


def _affine(pt):
    """(x, y) canonical ints of a point given as four (32, N) limb batches."""
    x, y, z = (_to_ints(c) for c in pt[:3])
    out = []
    for xi, yi, zi in zip(x, y, z):
        assert zi, "Z = 0"
        inv = pow(zi, P - 2, P)
        out.append((xi * inv % P, yi * inv % P))
    return out


def _ref_affine(pt):
    x, y, z, _ = pt
    inv = pow(z, P - 2, P)
    return (x * inv % P, y * inv % P)


def _niels_ints(x, y):
    return ((y + x) % P, (y - x) % P, 2 * ref.D * x * y % P)


def comb_sb(digits):
    """[s]B from (64, N) signed digits, most significant first (digit w
    weighs 16^(63 - w)), in the kernels' order: the digits of 16 * 256^j,
    then 4 doublings, then those of 256^j. Digits lie in [-8, 8]."""
    n = digits.shape[1]
    table = torch.from_numpy(cuda_verify.COMB_NIELS)
    acc = curve.pt_identity(n, "cpu")
    for half, exponent_parity in ((0, 1), (1, 0)):
        if half:
            for _ in range(4):
                acc = curve.pt_double(acc)
        for j in range(cuda_verify.COMB_ROWS):
            d = digits[63 - (2 * j + exponent_parity)]
            acc = curve.pt_madd(acc, teb._select_b_niels(d, table[j]))
    return acc


def k_chain(a_table, k_win):
    """[k](-A) over a lane table: the quads' loop without the B half."""
    acc = curve.pt_identity(a_table.shape[3], a_table.device)
    for i in range(teb.NWINDOWS):
        for _ in range(4):
            acc = curve.pt_double(acc)
        acc = curve.pt_add_cached(acc, teb._select_lane_cached(k_win[i], a_table))
    return acc


def _scalar_bytes(vals):
    return torch.from_numpy(np.array([list(v.to_bytes(32, "little")) for v in vals], dtype=np.uint8))


# --- the table and the constants buffer ------------------------------------


@pytest.mark.parametrize("row", [0, 1, 13, 31])
def test_comb_rows_equal_multiples_of_256j_b(row):
    got = cuda_verify.COMB_NIELS[row]  # (8, 3, 32) f32
    for e in range(8):
        x, y = _ref_affine(ref.pt_mul((e + 1) * 256**row, ref.B_POINT))
        for comp, want in enumerate(_niels_ints(x, y)):
            assert sum(int(v) << (8 * i) for i, v in enumerate(got[e, comp])) == want, (row, e, comp)


def test_all_256_comb_entries():
    """Every (j, e) entry, (e + 1) 256^j B, against the reference's
    double-and-add on the scalar."""
    flat = cuda_verify.COMB_NIELS.reshape(-1, 3, 32)
    for j in range(cuda_verify.COMB_ROWS):
        for e in range(8):
            x, y = _ref_affine(ref.pt_mul((e + 1) << (8 * j), ref.B_POINT))
            got = [sum(int(v) << (8 * i) for i, v in enumerate(flat[j * 8 + e, c])) for c in range(3)]
            assert got == list(_niels_ints(x, y)), (j, e)


def test_consts_layout_keeps_the_first_27_rows():
    c = cuda_verify.CONSTS
    assert c.dtype == np.uint8 and c.shape == (27 + 32 * 8 * 3, 32)
    assert hashlib.sha256(c[:27].tobytes()).hexdigest() == CONSTS_V1_SHA256
    np.testing.assert_array_equal(c[:24], teb.B_NIELS.reshape(24, 32).astype(np.uint8))
    # The comb follows, row 27 + (j * 8 + e) * 3 + component.
    for j, e, comp in ((0, 0, 0), (0, 7, 2), (5, 3, 1), (31, 7, 2)):
        row = c[27 + (j * 8 + e) * 3 + comp]
        np.testing.assert_array_equal(row, cuda_verify.COMB_NIELS[j, e, comp].astype(np.uint8))
    # Row j = 0 of the comb is [1..8]B, the table of the first 24 rows.
    np.testing.assert_array_equal(c[27:51], c[:24])


# --- the comb order ----------------------------------------------------------


@pytest.mark.parametrize("name,scalar", [
    ("zero", 0),
    ("one", 1),
    ("l_minus_1", L - 1),
    ("2^253-1", 2**253 - 1),
    ("zero_windows", int.from_bytes(bytes([0x08, 0x80] * 16), "little") >> 3),
    ("seeded", int.from_bytes(np.random.default_rng(7).bytes(32), "little") % L),
])
def test_comb_equals_reference_scalar_mult(name, scalar):
    digits = teb._to_windows_signed(_scalar_bytes([scalar]))
    if name == "zero":
        assert (digits == 0).all()  # the recode of 0: every window is 0
    if name == "zero_windows":
        assert (digits == 0).sum() >= 20
    got = _affine(comb_sb(digits))[0]
    assert got == _ref_affine(ref.pt_mul(scalar % L, ref.B_POINT))


def test_comb_takes_digits_plus_and_minus_8():
    """The recode yields [-8, 7]; the comb's table reaches |d| = 8, so
    +8 and -8 in every position, and seeded mixes, give sum d 16^e B."""
    rng = np.random.default_rng(11)
    cols = [np.full(64, 8.0), np.full(64, -8.0), np.where(np.arange(64) % 2, 8.0, -8.0)]
    cols += [rng.integers(-8, 9, 64).astype(np.float64) for _ in range(5)]
    digits = torch.from_numpy(np.stack(cols, axis=1).astype(np.float32))
    got = _affine(comb_sb(digits))
    for lane, col in enumerate(cols):
        value = sum(int(d) * 16 ** (63 - w) for w, d in enumerate(col))
        assert got[lane] == _ref_affine(ref.pt_mul(value % L, ref.B_POINT)), lane


def test_k_chain_plus_cached_sb_equals_straus_core():
    """64 seeded lanes: [k](-A) + cached([s]B) is the point the shared-
    doubling loop gives."""
    rng = np.random.default_rng(3)
    n = 64
    pts = [ref.pt_mul(int.from_bytes(rng.bytes(32), "little") % L, ref.B_POINT) for _ in range(n)]
    a = tuple(torch.from_numpy(np.array([F.int_to_limbs(p[c] % P) for p in pts], dtype=np.float32).T.copy())
              for c in range(4))
    s = _scalar_bytes([int.from_bytes(rng.bytes(32), "little") >> 3 for _ in range(n)])
    k = _scalar_bytes([int.from_bytes(rng.bytes(32), "little") % L for _ in range(n)])
    s_win, k_win = teb._to_windows_signed(s), teb._to_windows_signed(k)
    table = teb._build_lane_table(curve.pt_neg(a))
    want = teb._straus_core(table, s_win, k_win)
    got = curve.pt_add_cached(k_chain(table, k_win), curve.pt_to_cached(comb_sb(s_win)))
    assert _affine(got) == _affine(want)


def test_resident_verdicts_unchanged_and_equal_jax_verify_batch():
    """The resident kernel's plain version and the kernels' order (k
    chain, then [s]B, then R) give the same verdicts on a store of the
    parity lanes' keys, and they equal the JAX package's verify_batch."""
    pks, msgs, sigs = _parity_lanes()
    keys = list(dict.fromkeys(pks))
    keys = [keys[i] for i in np.random.default_rng(12).permutation(len(keys))]
    built = [tpc.build_table(pk) for pk in keys]
    cols = [teb._pad_table()] + [t for t, _ in built]
    oks = np.array([True] + [ok for _, ok in built], dtype=np.uint8)
    store = torch.from_numpy(np.ascontiguousarray(np.stack(cols).transpose(1, 2, 3, 0)))
    col_of = {pk: 1 + i for i, pk in enumerate(keys)}
    idxs = np.array([col_of[pk] for pk in pks], dtype=np.int32)
    n = len(pks)
    inp, host_ok = teb._prep_resident_chunk(pks, msgs, sigs, idxs, oks[idxs], store, n)
    args = [torch.from_numpy(inp[key]) for key in ("idx", "ok", "r", "s", "k")]
    plain = teb.verify_kernel_resident(store, *args).numpy()

    idx, ok, r, s, k = args
    tab = store.index_select(3, idx.long()).to(torch.float32)
    r_pt, r_ok = curve.pt_decompress(*teb._strip_sign(teb._bytes_to_fe(r)))
    acc = k_chain(tab, teb._to_windows_signed(k))
    acc = curve.pt_add_cached(acc, curve.pt_to_cached(comb_sb(teb._to_windows_signed(s))))
    reordered = teb._finish_verify(acc, r_pt, (ok != 0) & r_ok).numpy()
    np.testing.assert_array_equal(reordered, plain)

    want = np.asarray(jeb.verify_batch(pks, msgs, sigs))
    np.testing.assert_array_equal(plain & host_ok, want)
    assert want.any() and not want.all()

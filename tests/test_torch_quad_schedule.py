"""CPU rehearsal of the quad schedule of ``csrc/ed25519_verify.cu``.

K1 and K2 split a lane over a quad of four threads: thread c holds
coordinate c of the extended point (X, Y, Z, T) and slot c of an added
operand in cached order (Y+X, Y-X, Z, 2dT). Every point operation is a
fixed list of steps that all four threads take together:

- an exchange, in which every thread copies one register of a named
  thread of its quad (``__shfl_sync(..., width = 4)`` in the kernel);
- a round, in which each thread applies its own field operation to its
  own registers.

The functions below are the kernel's step tables (labels D1-D4, A1-A4,
C1-C2, X1-X2 and F1-F3, as in the source note) written over the port's
field ops in ``ops/field.py``. Each is checked on 64 seeded points
against the plain curve ops of ``ops/curve.py`` as equal points:
coordinates cross-multiplied by the other side's Z and compared as
canonical integers, tolerance 0.
"""

import os
import re

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import numpy as np

from tendermint_tpu_torch.crypto import ed25519_ref as ref
from tendermint_tpu_torch.ops import curve, field as F

N = 64
P = ref.P
SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "tendermint_tpu_torch", "csrc", "ed25519_verify.cu")

# Round 2 (D3-D4, A3-A4). Thread c publishes p, reads six terms from the
# published p of the threads its route names, and multiplies
# L = lu + lw - lz by R = ru + rw - rz; the quad then holds X = EF, Y = GH,
# Z = FG, T = EH. Per thread: ((lu, lw, lz), (ru, rw, rz)), None for a term
# that is 0. In the addition sources 0 and 1 name B and A, and swap on
# lanes that subtract. The kernel packs the same tables (kDoubleRoute,
# kAddRoute); test_routes_match_cuda_source holds the two together.
DOUBLE_ROUTE = (  # p = (X^2, Y^2, 2 Z^2, (X + Y)^2)
    ((0, 1, 3), (0, 2, 1)),  # E = p0 + p1 - p3, F = p0 + p2 - p1
    ((0, None, 1), (0, 1, None)),  # G = p0 - p1, H = p0 + p1
    ((0, 2, 1), (0, None, 1)),  # F, G
    ((0, 1, 3), (0, 1, None)),  # E, H
)
ADD_ROUTE = (  # p = (B, A, D, C), C negated on lanes that subtract
    ((0, None, 1), (2, None, 3)),  # E = B - A, F = D - C
    ((2, 3, None), (0, 1, None)),  # G = D + C, H = B + A
    ((2, None, 3), (2, 3, None)),  # F, G
    ((0, None, 1), (0, 1, None)),  # E, H
)
TERMS = ("lu", "lw", "lz", "ru", "rw", "rz")


class Quad:
    """The registers of the four threads of a quad, for N lanes at once:
    ``regs[c][name]`` is a (32, N) field batch."""

    def __init__(self, coords):
        self.regs = [{"v": coords[c]} for c in range(4)]

    def load(self, name, values):
        """Thread c's register ``name`` := values[c] (a per-thread load)."""
        for c, r in enumerate(self.regs):
            r[name] = values[c]

    def gather(self, dst, srcs, reg="v", swap=None):
        """Exchange: thread c copies ``reg`` of thread srcs[c] (0 for
        None); with ``swap``, on those lanes sources 0 and 1 trade places."""
        vals = []
        for src in srcs:
            if src is None:
                vals.append(torch.zeros_like(self.regs[0][reg]))
            elif swap is not None and src < 2:
                vals.append(F.fe_select(swap, self.regs[src ^ 1][reg], self.regs[src][reg]))
            else:
                vals.append(self.regs[src][reg])
        self.load(dst, vals)

    def shfl(self, dst, src, reg="v"):
        """Exchange: every thread copies ``reg`` of thread ``src``."""
        self.gather(dst, [src] * 4, reg)

    def shfl_xor(self, dst, mask, reg):
        """Exchange: thread c copies ``reg`` of thread c ^ mask."""
        self.gather(dst, [c ^ mask for c in range(4)], reg)

    def round(self, dst, ops):
        """Thread c sets ``dst`` to ops[c](its registers)."""
        self.load(dst, [op(r) for op, r in zip(ops, self.regs)])

    def get(self, reg="v"):
        return tuple(r[reg] for r in self.regs)


def _lin(u, w, z):
    return F.fe_sub(F.fe_add(u, w), z)


def _round2(q, route, neg):
    """D3 / A3 publish, D4 / A4 read the terms and multiply."""
    keep = lambda R: R["r"]  # noqa: E731
    q.round("p", [  # thread 2 doubles, thread 3 negates on subtracting lanes
        keep, keep, lambda R: F.fe_add(R["r"], R["r"]),
        lambda R: F.fe_select(neg, F.fe_neg(R["r"]), R["r"]),
    ])
    for k, name in enumerate(TERMS):
        q.gather(name, [route[c][k // 3][k % 3] for c in range(4)], "p", neg)
    q.round("v", [lambda R: F.fe_mul(_lin(R["lu"], R["lw"], R["lz"]),
                                     _lin(R["ru"], R["rw"], R["rz"]))] * 4)


def q_double(q):
    q.shfl("x", 0)  # D1
    q.shfl("y", 1)
    sq = lambda R: F.fe_sq(R["v"])  # noqa: E731
    q.round("r", [sq, sq, sq, lambda R: F.fe_sq(F.fe_add(R["x"], R["y"]))])  # D2
    _round2(q, DOUBLE_ROUTE, torch.zeros(N, dtype=torch.bool))  # D3, D4


def q_add(q, operand, neg, mixed):
    """acc + (neg ? -operand : operand). ``operand`` is in cached slot
    order; with ``mixed`` its Z is 1 and thread 2 skips its multiply."""
    q.load("q", operand)
    q.gather("u", [1, 1, 2, 3])  # A1: y, or the thread's own v
    q.shfl("x", 0)
    ypx = lambda R: _lin(R["u"], R["x"], torch.zeros_like(R["x"]))  # noqa: E731
    ymx = lambda R: _lin(R["u"], torch.zeros_like(R["x"]), R["x"])  # noqa: E731
    q.round("r", [  # A2
        lambda R: F.fe_mul(F.fe_select(neg, ymx(R), ypx(R)), R["q"]),
        lambda R: F.fe_mul(F.fe_select(neg, ypx(R), ymx(R)), R["q"]),
        (lambda R: R["u"]) if mixed else (lambda R: F.fe_mul(R["u"], R["q"])),
        lambda R: F.fe_mul(R["u"], R["q"]),
    ])
    _round2(q, ADD_ROUTE, neg)  # A3, A4


def q_cached(q, dst):
    q.shfl("x", 0)  # C1
    q.shfl("y", 1)
    q.round(dst, [  # C2
        lambda R: F.fe_add(R["y"], R["x"]),
        lambda R: F.fe_sub(R["y"], R["x"]),
        lambda R: R["v"],
        lambda R: F.fe_mul_const(R["v"], F.D2_FE),
    ])


def q_table(q):
    """K1's table: the quad holds -A; entry t is [t + 1](-A), cached."""
    no = torch.zeros(N, dtype=torch.bool)
    q_cached(q, "t")  # T1
    entries = [q.get("t")]
    for _ in range(7):  # T2
        q_add(q, entries[0], no, mixed=False)
        q_cached(q, "t")
        entries.append(q.get("t"))
    return entries


def q_setup(a_pt, r_pt):
    """K1 after decompression: even threads hold A, odd threads R, each in
    full. Returns the quad holding A and thread c's slot c of cached(R)."""
    q = Quad([None] * 4)
    q.load("P", [r_pt if c & 1 else a_pt for c in range(4)])
    q.round("C", [lambda R: curve.pt_to_cached(R["P"])] * 4)
    own = [lambda R, c=c: (R["C"] if c & 1 else R["P"])[c] for c in range(4)]
    partner = [lambda R, c=c: (R["C"] if c & 1 else R["P"])[c ^ 1] for c in range(4)]
    q.round("own", own)  # X1
    q.round("send", partner)
    q.shfl_xor("got", 1, "send")  # X2
    q.round("v", [lambda R, c=c: R["got"] if c & 1 else R["own"] for c in range(4)])
    q.round("rq", [lambda R, c=c: R["own"] if c & 1 else R["got"] for c in range(4)])
    return q


def q_finish(q, rq):
    """acc - R, times 8; the identity test reads X, Y, Z of threads 0..2."""
    q_add(q, rq, torch.ones(N, dtype=torch.bool), mixed=True)  # F1
    for _ in range(3):  # F2
        q_double(q)
    q.shfl("x", 0)  # F3
    q.shfl("y", 1)
    q.shfl("z", 2)
    R = q.regs[0]
    return F.fe_is_zero(R["x"]) & F.fe_is_zero(F.fe_sub(R["y"], R["z"]))


# --- inputs and comparison ----------------------------------------------------


def _to_limbs(vals):
    return torch.from_numpy(np.array([F.int_to_limbs(v) for v in vals], dtype=np.float32).T.copy())


def _to_ints(t):
    limbs = t.numpy().astype(np.int64)
    return [sum(int(limbs[i, j]) << (8 * i) for i in range(32)) % P for j in range(limbs.shape[1])]


def _batch(points):
    return tuple(_to_limbs([p[c] for p in points]) for c in range(4))


def _points(seed, affine=False):
    """N seeded points with Z != 1 (Z = 1 with ``affine``): lane 0 the
    identity, lane 1 the point of order 2, the rest [k]B."""
    rng = np.random.default_rng(seed)
    pts = [ref.IDENT, (0, P - 1, 1, 0)]
    pts += [ref.pt_mul(int.from_bytes(rng.bytes(32), "little") % ref.L, ref.B_POINT)
            for _ in range(N - 2)]
    out = []
    for x, y, z, t in pts:
        zi = pow(z, P - 2, P)
        x, y, t = x * zi % P, y * zi % P, t * zi % P
        lam = 1 if affine else int.from_bytes(rng.bytes(32), "little") % (P - 1) + 1
        out.append((x * lam % P, y * lam % P, lam, t * lam % P))
    return out


def _assert_same(got, want, what):
    """Equal projective tuples: every component times the other's Z
    (component 2 of both forms) agrees mod p; no Z is 0."""
    g = [_to_ints(c) for c in got]
    w = [_to_ints(c) for c in want]
    for lane in range(N):
        gz, wz = g[2][lane], w[2][lane]
        assert gz and wz, f"{what}: lane {lane} has Z = 0"
        for comp in range(4):
            assert g[comp][lane] * wz % P == w[comp][lane] * gz % P, (
                f"{what}: lane {lane}, component {comp}")


NEG = torch.from_numpy(np.arange(N) % 3 == 1)


def test_double():
    p = _batch(_points(1))
    q = Quad(p)
    q_double(q)
    _assert_same(q.get(), curve.pt_double(p), "double")


def test_cached_add_with_negation():
    p, o = _batch(_points(2)), _batch(_points(3))
    cached = curve.pt_to_cached(o)
    q = Quad(p)
    q_add(q, cached, NEG, mixed=False)
    _assert_same(q.get(), curve.pt_add_cached(p, curve.cached_cneg(NEG, cached)), "cached add")


def test_mixed_add_with_negation():
    p, o = _batch(_points(4)), _batch(_points(5, affine=True))
    yplusx, yminusx, _, td2 = curve.pt_to_cached(o)
    niels = (yplusx, yminusx, td2)
    q = Quad(p)
    q_add(q, (yplusx, yminusx, o[2], td2), NEG, mixed=True)
    _assert_same(q.get(), curve.pt_madd(p, curve.niels_cneg(NEG, niels)), "mixed add")


def test_k1_table():
    a = _batch(_points(6))
    neg_a = curve.pt_neg(a)
    entries = q_table(Quad(neg_a))
    cached = curve.pt_to_cached(neg_a)
    acc = neg_a
    for t, entry in enumerate(entries):
        if t:
            acc = curve.pt_add_cached(acc, cached)
        _assert_same(entry, curve.pt_to_cached(acc), f"table entry {t}")


def test_k1_setup_and_finish():
    a, r = _batch(_points(7, affine=True)), _batch(_points(8, affine=True))
    q = q_setup(a, r)
    for c in range(4):  # copies, so limb for limb
        torch.testing.assert_close(q.regs[c]["v"], a[c], rtol=0, atol=0)
        torch.testing.assert_close(q.regs[c]["rq"], curve.pt_to_cached(r)[c], rtol=0, atol=0)
    # acc = R on even lanes (the check passes), 2R on odd lanes (it fails).
    acc = curve.pt_select(torch.from_numpy(np.arange(N) % 2 == 0), r, curve.pt_double(r))
    got = q_finish(Quad(acc), q.get("rq"))
    want = acc
    want = curve.pt_add(want, curve.pt_neg(r))
    for _ in range(3):
        want = curve.pt_double(want)
    np.testing.assert_array_equal(got.numpy(), curve.pt_is_identity(want).numpy())
    # Lanes 0 and 1 of _points are the identity and a point of order 2,
    # so [8](2R - R) is the identity there too.
    assert got.numpy()[0::2].all() and got.numpy()[1] and not got.numpy()[3::2].any()


def _cuda_route(name):
    """The kernel's packed route ``name``, unpacked to DOUBLE_ROUTE's form."""
    with open(SOURCE) as fh:
        body = re.search(rf"constexpr uint64_t {name} = route\((.*?)\);", fh.read(), re.S).group(1)
    srcs = [tuple(map(int, m)) for m in re.findall(r"quad_src\((\d), (\d), (\d), (\d)\)", body)]
    keeps = [tuple(map(int, m)) for m in re.findall(r"quad_keep\((\d), (\d), (\d), (\d)\)", body)]
    assert len(srcs) == 6 and len(keeps) == 4
    kept = dict(zip((1, 2, 4, 5), keeps))  # keep bits of lw, lz, rw, rz
    terms = [[srcs[k][c] if kept.get(k, (1,) * 4)[c] else None for k in range(6)]
             for c in range(4)]
    return tuple((tuple(t[:3]), tuple(t[3:])) for t in terms)


def test_routes_match_cuda_source():
    assert _cuda_route("kDoubleRoute") == DOUBLE_ROUTE
    assert _cuda_route("kAddRoute") == ADD_ROUTE

"""The port's verifier against the JAX package: host prep, tables and
both plain kernels, on the CPU.

The plain kernels (``verify_kernel``, ``verify_kernel_tables``) are
compared with the JAX XLA graphs of the same names, jitted on the CPU at
the 64-lane bucket, and both with the ZIP-215 oracle on the edge and
mutation vectors of tests/test_ops_ed25519.py. Every value is an integer
or a boolean, so every comparison is exact (tolerance 0). Inputs come
from fixed seeds and go to both packages.
"""

import pytest

torch = pytest.importorskip("torch")
# The plain versions run thousands of tiny tensor ops: one intra-op thread
# is fastest, and keeps parallel test workers from oversubscribing cores.
torch.set_num_threads(1)

import jax
import jax.numpy as jnp
import numpy as np

from tendermint_tpu.ops import ed25519_batch as jeb, precompute as jpc
from tendermint_tpu_torch.crypto import ed25519_ref as ref
from tendermint_tpu_torch.ops import cuda_verify, ed25519_batch as teb, field, precompute as tpc

LANES = 64  # the bucket the JAX tests compile


def keypair(i):
    return ref.keypair_from_seed(bytes([i + 1]) * 32)


def _batch8():
    pks, msgs, sigs = [], [], []
    for i in range(8):
        priv, pub = keypair(i)
        msg = b"vote %d" % i
        pks.append(pub)
        msgs.append(msg)
        sigs.append(ref.sign(priv, msg))
    return pks, msgs, sigs


def _bad_entries(pks, msgs, sigs):
    """test_ops_ed25519.py::test_verify_flags_bad_entries."""
    sigs[1] = sigs[1][:32] + bytes(32)  # wrong s
    msgs[3] = b"tampered"
    sigs[5] = bytes(32) + sigs[5][32:]  # R replaced (y = 0 is on the curve)
    pks[6] = keypair(7)[1]  # wrong key


def _zip215_edges(pks, msgs, sigs):
    """test_ops_ed25519.py::test_verify_zip215_edge_cases, plus an
    off-curve R and an off-curve key (y = 2)."""
    ident = (1).to_bytes(32, "little")
    s = 12345
    rb = ref.pt_compress(ref.pt_mul(s, ref.B_POINT))
    sig215 = rb + s.to_bytes(32, "little")
    pks[0], msgs[0], sigs[0] = ident, b"x", sig215
    pks[1], msgs[1], sigs[1] = (ref.P + 1).to_bytes(32, "little"), b"x", sig215
    pks[2], msgs[2], sigs[2] = ident, b"x", rb + (s + ref.L).to_bytes(32, "little")
    sigs[3] = bytes([2] + [0] * 31) + sigs[3][32:]
    pks[4] = bytes([2] + [0] * 31)


def _random_mutations(pks, msgs, sigs):
    """test_ops_ed25519.py::test_verify_agrees_with_oracle_on_random_mutations."""
    rng = np.random.RandomState(7)
    for i in range(8):
        mode = i % 4
        if mode == 0:
            continue
        b = bytearray(sigs[i])
        if mode == 1:
            b[rng.randint(32)] ^= 1 << rng.randint(8)  # corrupt R
        elif mode == 2:
            b[32 + rng.randint(31)] ^= 1 << rng.randint(8)  # corrupt s (low bytes)
        else:
            pk = bytearray(pks[i])
            pk[rng.randint(32)] ^= 1 << rng.randint(8)
            pks[i] = bytes(pk)
        sigs[i] = bytes(b)


@pytest.fixture(scope="module")
def lanes():
    """32 lanes: the valid batch, then the bad-entry, edge and mutation
    variants of it; with the oracle's verdicts."""
    pks, msgs, sigs = [], [], []
    for mutate in (None, _bad_entries, _zip215_edges, _random_mutations):
        p, m, s = (list(x) for x in _batch8())
        if mutate is not None:
            mutate(p, m, s)
        pks += p
        msgs += m
        sigs += s
    want = np.array([ref.verify_zip215(p, m, s) for p, m, s in zip(pks, msgs, sigs)])
    assert want[:8].all() and not want.all()
    return pks, msgs, sigs, want


def _same_inputs(port, jax_side):
    assert sorted(port) == sorted(jax_side)
    for key in port:
        got, exp = np.asarray(port[key]), np.asarray(jax_side[key])
        assert got.dtype == exp.dtype and got.shape == exp.shape, key
        np.testing.assert_array_equal(got, exp, err_msg=key)


def test_prepare_batch_matches_jax(lanes):
    pks, msgs, sigs, _ = lanes
    port, port_ok = teb.prepare_batch(pks, msgs, sigs, pad_to=LANES)
    ref_in, ref_ok = jeb.prepare_batch(pks, msgs, sigs, pad_to=LANES)
    _same_inputs(port, ref_in)
    np.testing.assert_array_equal(port_ok, ref_ok)


def test_prepare_batch_malformed_lanes_match_jax(lanes):
    pks, msgs, sigs, _ = (list(x) for x in lanes)
    pks[2] = pks[2][:31]
    sigs[5] = sigs[5][:63]
    sigs[9] = sigs[9] + b"\x00"
    port, port_ok = teb.prepare_batch(pks, msgs, sigs)
    ref_in, ref_ok = jeb.prepare_batch(pks, msgs, sigs)
    _same_inputs(port, ref_in)
    np.testing.assert_array_equal(port_ok, ref_ok)
    assert not port_ok[[2, 5, 9]].any()


def test_buckets_chunks_and_padding_match_jax():
    for n in (1, 63, 64, 65, 256, 1000, 1024, 4096, 4097, 10_000):
        assert teb._bucket(n) == jeb._bucket(n), n
    assert teb.CHUNK == jeb.CHUNK and teb.NWINDOWS == jeb.NWINDOWS
    rows = np.arange(9000)
    got, exp = teb._chunk_rows(rows), jeb._chunk_rows(rows)
    assert [list(c) for c in got] == [list(c) for c in exp]
    for a, b in zip(teb._pad_rows(), jeb._pad_rows()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(teb._pad_table(), jeb._pad_table())


def test_signed_windows_and_sign_strip_match_jax():
    rng = np.random.default_rng(3)
    vals = [0, 1, ref.L - 1, 2**253 - 1] + [
        int.from_bytes(rng.integers(0, 256, 31, dtype=np.uint8).tobytes(), "little")
        for _ in range(12)
    ]
    raw = np.stack([np.frombuffer(v.to_bytes(32, "little"), dtype=np.uint8) for v in vals])
    got = teb._to_windows_signed(torch.from_numpy(raw)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jeb._to_windows_signed(jnp.asarray(raw))))
    for j, v in enumerate(vals):
        acc = 0
        for d in got[:, j]:
            assert -8 <= d <= 7
            acc = acc * 16 + int(d)
        assert acc == v
    keys = raw.copy()
    keys[::2, 31] |= 0x80
    ty, ts = teb._strip_sign(teb._bytes_to_fe(torch.from_numpy(keys)))
    jy, js = jeb._strip_sign(jeb._bytes_to_fe(jnp.asarray(keys)))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def _table_keys(lanes):
    pks = list(dict.fromkeys(lanes[0]))  # distinct, in order
    return pks + [bytes(31), bytes([2] + [0] * 31)]  # a short key, an off-curve key


def test_build_table_and_b_niels_match_jax(lanes):
    np.testing.assert_array_equal(teb.B_NIELS, jeb.B_NIELS)
    oks = []
    for pk in _table_keys(lanes):
        tab, ok = tpc.build_table(pk)
        jtab, jok = jpc.build_table(pk)
        assert tab.dtype == np.uint8 and tab.shape == (8, 4, 32)
        np.testing.assert_array_equal(tab, np.asarray(jtab))
        assert ok == jok
        oks.append(ok)
    assert any(oks) and not all(oks)
    # The kernels' constants: [1..8]B Niels rows, then d, sqrt(-1), 2d.
    np.testing.assert_array_equal(
        cuda_verify.CONSTS[:24], teb.B_NIELS.reshape(24, 32).astype(np.uint8)
    )
    for row, c in zip(cuda_verify.CONSTS[24:], (field.D, field.SQRT_M1, field.D2)):
        assert int.from_bytes(row.tobytes(), "little") == c


def test_from_reference_tables_loads_jax_tables(lanes):
    keys = _table_keys(lanes)
    jax_tables = {pk: jpc.build_table(pk) for pk in keys if len(pk) == 32}
    tpc.reset()
    try:
        assert tpc.from_reference_tables(jax_tables) == len(jax_tables)
        entries, has_table = tpc.tables.gather(list(jax_tables))
        assert has_table.all() and tpc.tables.builds == 0
        for pk, (tab, ok) in zip(jax_tables, entries):
            want_tab, want_ok = tpc.build_table(pk)
            np.testing.assert_array_equal(tab, want_tab)
            assert ok == want_ok
        with pytest.raises(ValueError):
            tpc.from_reference_tables({keys[0]: (np.zeros((8, 4, 31)), True)})
        with pytest.raises(ValueError):
            tpc.from_reference_tables({keys[0]: (np.full((8, 4, 32), 300.0), True)})
    finally:
        tpc.reset()


def _table_inputs(pkg_prep, build, lanes):
    pks, msgs, sigs, _ = lanes
    tabs, oks = zip(*(build(pk) for pk in pks))
    return pkg_prep(pks, msgs, sigs, [np.asarray(t) for t in tabs], list(oks), LANES)


def test_prep_table_chunk_matches_jax(lanes):
    port, port_ok = _table_inputs(teb._prep_table_chunk, tpc.build_table, lanes)
    ref_in, ref_ok = _table_inputs(jeb._prep_table_chunk, jpc.build_table, lanes)
    _same_inputs(port, ref_in)
    np.testing.assert_array_equal(port_ok, ref_ok)
    assert port["tab"].shape == (8, 4, 32, LANES)


K1_KEYS = ("pk", "r", "s", "k")
K2_KEYS = ("tab", "ok", "r", "s", "k")


def test_plain_verify_kernel_matches_jax_and_oracle(lanes):
    pks, msgs, sigs, want = lanes
    inputs, host_ok = teb.prepare_batch(pks, msgs, sigs, pad_to=LANES)
    got = teb.verify_kernel(*(torch.from_numpy(inputs[k]) for k in K1_KEYS)).numpy()
    exp = np.asarray(jax.jit(jeb.verify_kernel)(*(jnp.asarray(inputs[k]) for k in K1_KEYS)))
    assert got.dtype == np.bool_ and got.shape == (LANES,)
    np.testing.assert_array_equal(got, exp)
    np.testing.assert_array_equal(got[: len(pks)] & host_ok, want)
    assert got[len(pks):].all()  # padding lanes verify


def test_plain_verify_kernel_tables_matches_jax_and_oracle(lanes):
    pks, msgs, sigs, want = lanes
    inputs, host_ok = _table_inputs(teb._prep_table_chunk, tpc.build_table, lanes)
    got = teb.verify_kernel_tables(*(torch.from_numpy(inputs[k]) for k in K2_KEYS)).numpy()
    exp = np.asarray(
        jax.jit(jeb.verify_kernel_tables)(*(jnp.asarray(inputs[k]) for k in K2_KEYS))
    )
    np.testing.assert_array_equal(got, exp)
    np.testing.assert_array_equal(got[: len(pks)] & host_ok, want)
    assert got[len(pks):].all()


def test_wrappers_run_plain_versions_on_cpu_tensors(lanes):
    pks, msgs, sigs, want = (x[:8] for x in lanes)
    inputs, _ = teb.prepare_batch(pks, msgs, sigs, pad_to=8)
    args = [torch.from_numpy(inputs[k]) for k in K1_KEYS]
    before = dict(cuda_verify.LAUNCHES)
    np.testing.assert_array_equal(cuda_verify.verify(*args).numpy(), want)
    tabs, oks = zip(*(tpc.build_table(pk) for pk in pks))
    t_in, _ = teb._prep_table_chunk(pks, msgs, sigs, list(tabs), list(oks), 8)
    got = cuda_verify.verify_tables(*(torch.from_numpy(t_in[k]) for k in K2_KEYS))
    np.testing.assert_array_equal(got.numpy(), want)
    assert cuda_verify.LAUNCHES == before  # the plain versions launch nothing


@pytest.mark.parametrize(
    "bad, err",
    [
        (lambda a: [a[0].to(torch.int32)] + a[1:], TypeError),
        (lambda a: [a[0][:7]] + a[1:], ValueError),
        (lambda a: [a[0].t().contiguous().t()] + a[1:], ValueError),
        (lambda a: [a[0].to("meta")] + [t.to("meta") for t in a[1:]], ValueError),
    ],
    ids=["dtype", "shape", "contiguity", "device"],
)
def test_wrapper_rejects_bad_inputs(lanes, bad, err):
    inputs, _ = teb.prepare_batch(*lanes[:3], pad_to=LANES)
    args = [torch.from_numpy(inputs[k]) for k in K1_KEYS]
    with pytest.raises(err):
        cuda_verify.verify(*bad(args))

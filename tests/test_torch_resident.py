"""The port's device-resident table store (ops/resident.py) and resident
verify path, on the CPU, against the contracts of tests/test_resident.py
and the JAX package.

Forced on with ``resident.configure("on")`` (by default it follows the
device, and the CPU is not CUDA), the store is a CPU tensor here and K3
runs its plain version. A set's tables go to the store once; later
batches ship only column indices; rotation, LRU eviction and a cache
clear drop the store; an error in the store propagates. The resident
kernel's verdicts and ``verify_batch``'s are compared with the JAX
package's, exactly (tolerance 0).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# The plain versions run thousands of tiny tensor ops: one intra-op thread
# is fastest, and keeps parallel test workers from oversubscribing cores.
torch.set_num_threads(1)

import jax.numpy as jnp

from tendermint_tpu.ops import ed25519_batch as jeb, precompute as jpc, resident as jres
from tendermint_tpu_torch.crypto import ed25519_ref as ref
from tendermint_tpu_torch.crypto.keys import Ed25519PrivKey, Ed25519PubKey
from tendermint_tpu_torch.ops import cuda_verify, ed25519_batch as teb, precompute as tpc, resident
from tendermint_tpu_torch.types.validator import Validator
from tendermint_tpu_torch.types.validator_set import ValidatorSet
from tests.test_torch_verify import _bad_entries, _batch8, _zip215_edges

LANES = 64  # the bucket the JAX tests compile


@pytest.fixture(autouse=True)
def _resident_on():
    resident.configure("on")
    tpc.reset()
    resident.reset()
    yield
    resident.configure(None)
    tpc.reset()
    resident.reset()


def _batch(n, seed=50):
    pks, msgs, sigs = [], [], []
    for i in range(n):
        sk, pk = ref.keypair_from_seed(bytes([seed + i]) * 32)
        m = b"resident lane %03d" % i
        pks.append(pk)
        msgs.append(m)
        sigs.append(ref.sign(sk, m))
    return pks, msgs, sigs


def _activate(pks):
    """Make the keys table-eligible: activate a validator set of them."""
    vals = [Validator(Ed25519PubKey(pk), 10) for pk in dict.fromkeys(pks)]
    tpc.activate_validator_set(ValidatorSet(vals))


def _verify(pks, msgs, sigs):
    tpc.results.clear()  # every call reaches the engine
    return teb.verify_batch(pks, msgs, sigs, device="cpu")


def _h2d_total():
    s = resident.stats()
    return s["h2d_bytes"] + s["gathered_h2d_bytes"]


# --- steady state: one upload, then index-only batches ----------------------


def test_second_batch_ships_zero_table_bytes():
    pks, msgs, sigs = _batch(16)
    _activate(pks)
    sigs[3] = bytes(64)
    launches = dict(cuda_verify.LAUNCHES)
    oks = _verify(pks, msgs, sigs)
    assert not oks[3] and sum(oks) == 15
    after_first = _h2d_total()
    assert after_first == resident.stats()["h2d_bytes"] == 17 * 1024  # pad column + 16 keys
    for _ in range(2):
        oks = _verify(pks, msgs, sigs)
        assert not oks[3] and sum(oks) == 15
    assert _h2d_total() == after_first
    s = resident.stats()
    assert s["uploads"] == 1 and s["hits"] == 48 and s["misses"] == 0
    assert s["gathered_h2d_bytes"] == 0
    assert cuda_verify.LAUNCHES == launches  # the plain versions launch nothing


def test_committee_growth_refreshes_store_once():
    pks, msgs, sigs = _batch(6)
    _activate(pks[:4])
    assert all(_verify(pks[:4], msgs[:4], sigs[:4]))
    assert resident.stats()["uploads"] == 1
    _activate(pks)  # two newcomers
    assert all(_verify(pks, msgs, sigs))
    s = resident.stats()
    assert s["uploads"] == 2 and s["resident_keys"] == 6
    before = _h2d_total()
    assert all(_verify(pks, msgs, sigs))
    assert _h2d_total() == before and resident.stats()["uploads"] == 2


# --- invalidation in lockstep with the host cache ---------------------------


def _vset(offset, n=3):
    privs = [Ed25519PrivKey.from_seed((200_000 * offset + i).to_bytes(32, "big")) for i in range(n)]
    vset = ValidatorSet([Validator(p.pub_key(), 10) for p in privs])
    by_addr = {p.pub_key().address(): p for p in privs}
    return [by_addr[v.address] for v in vset.validators], vset


def test_rotation_invalidates_device_copy():
    privs, vset1 = _vset(1)
    tpc.activate_validator_set(vset1)
    pks = [v.pub_key.bytes() for v in vset1.validators]
    msgs = [b"rotation msg %d" % i for i in range(len(pks))]
    sigs = [p.sign(m) for p, m in zip(privs, msgs)]
    assert all(_verify(pks, msgs, sigs))
    assert resident.stats()["resident_keys"] == len(pks)
    for off in range(2, 11):  # push vset1 out of the 8 live sets
        tpc.activate_validator_set(_vset(off)[1])
    s = resident.stats()
    assert s["invalidations"] == 1 and s["resident_keys"] == 0
    bad = list(sigs)
    bad[1] = bytes(64)
    oks = _verify(pks, msgs, bad)  # rotated-out keys take the legacy path
    assert not oks[1] and sum(oks) == len(pks) - 1
    s = resident.stats()
    assert s["resident_keys"] == 0 and s["uploads"] == 1 and s["declined_no_table"] == 1


def test_cache_clear_clears_store():
    pks, msgs, sigs = _batch(4)
    _activate(pks)
    _verify(pks, msgs, sigs)
    assert resident.stats()["resident_keys"] == 4
    tpc.reset()
    s = resident.stats()
    assert s["resident_keys"] == 0 and s["invalidations"] == 1


def test_lru_eviction_invalidates_device_copy(monkeypatch):
    monkeypatch.setattr(tpc.tables, "cap", 4)
    pks, msgs, sigs = _batch(4)
    _activate(pks)
    assert all(_verify(pks, msgs, sigs))
    assert resident.stats()["resident_keys"] == 4
    # Two more eligible keys overflow the cap: their builds evict the two
    # least recent columns mid-batch, which drops the store; the batch
    # uploads the surviving committee.
    extra_p, extra_m, extra_s = _batch(2, seed=120)
    _activate(extra_p)
    assert all(_verify(extra_p, extra_m, extra_s))
    s = resident.stats()
    assert s["invalidations"] == 1 and s["uploads"] == 2
    assert all(_verify(pks + extra_p, msgs + extra_m, sigs + extra_s))


def test_invalidation_racing_an_upload_drops_it(monkeypatch):
    """An eviction delivered while a refresh uploads: the version moves,
    so the stale snapshot is not installed."""
    pks, msgs, sigs = _batch(3)
    _activate(pks)
    tpc.tables.gather(pks)
    upload = resident.ResidentTableStore._upload

    def racing_upload(host_tab, device):
        resident.store.invalidate([pks[0]])
        return upload(host_tab, device)

    monkeypatch.setattr(resident.ResidentTableStore, "_upload", staticmethod(racing_upload))
    assert resident.store.refresh("cpu") is False
    assert resident.stats()["uploads"] == 0 and resident.stats()["resident_keys"] == 0


# --- result cache, off mode, errors -------------------------------------------


def test_cached_batch_skips_table_gather(monkeypatch):
    pks, msgs, sigs = _batch(8)
    _activate(pks)
    assert all(_verify(pks, msgs, sigs))
    calls = []
    orig = tpc.tables.gather

    def spy(pubkeys):
        calls.append(len(pubkeys))
        return orig(pubkeys)

    monkeypatch.setattr(tpc.tables, "gather", spy)
    before = _h2d_total()
    assert all(teb.verify_batch(pks, msgs, sigs, device="cpu"))  # answered by the result cache
    assert calls == [] and _h2d_total() == before


@pytest.mark.parametrize("mode", ["off", None], ids=["configure", "auto_on_cpu"])
def test_off_mode_ships_gathered_bytes(mode):
    resident.configure(mode)  # None follows the device, and the CPU is not CUDA
    pks, msgs, sigs = _batch(4)
    _activate(pks)
    assert all(_verify(pks, msgs, sigs))
    s = resident.stats()
    assert s["uploads"] == 0 and s["resident_keys"] == 0 and s["declined_off"] == 1
    assert s["gathered_h2d_bytes"] == LANES * 1024  # the (8, 4, 32, 64) chunk


def test_auto_mode_is_on_for_cuda_only():
    resident.configure(None)
    assert resident.enabled("cuda") and not resident.enabled("cpu")
    resident.configure("off")
    assert not resident.enabled("cuda")
    with pytest.raises(ValueError, match="resident mode"):
        resident.configure("auto")


def test_acquire_error_propagates_out_of_verify_batch(monkeypatch):
    """The opposite of the reference's fail-safe: a store failure is not
    turned into the gathered path."""

    def boom(pubkeys, has_table, device):
        raise RuntimeError("injected store failure")

    monkeypatch.setattr(resident, "acquire", boom)
    pks, msgs, sigs = _batch(4)
    _activate(pks)
    with pytest.raises(RuntimeError, match="injected store failure"):
        _verify(pks, msgs, sigs)


def test_upload_error_in_refresh_propagates(monkeypatch):
    def failed_upload(host_tab, device):
        raise RuntimeError("CUDA error: out of memory")

    monkeypatch.setattr(resident.ResidentTableStore, "_upload", staticmethod(failed_upload))
    pks, msgs, sigs = _batch(4)
    _activate(pks)
    with pytest.raises(RuntimeError, match="out of memory"):
        _verify(pks, msgs, sigs)
    assert resident.stats()["uploads"] == 0


# --- parity with the JAX package --------------------------------------------


def _parity_lanes():
    """24 lanes: the valid batch, the bad-entry and the ZIP-215 edge
    variants (tests/test_torch_verify.py)."""
    pks, msgs, sigs = [], [], []
    for mutate in (None, _bad_entries, _zip215_edges):
        p, m, s = (list(x) for x in _batch8())
        if mutate is not None:
            mutate(p, m, s)
        pks += p
        msgs += m
        sigs += s
    return pks, msgs, sigs


def test_plain_verify_kernel_resident_matches_jax_and_oracle():
    pks, msgs, sigs = _parity_lanes()
    keys = list(dict.fromkeys(pks)) + [_batch(1, seed=200 + i)[0][0] for i in range(8)]
    rng = np.random.default_rng(12)
    keys = [keys[i] for i in rng.permutation(len(keys))]  # columns not in lane order
    assert len(keys) == 19
    cols = [jeb._pad_table()] + [np.asarray(jpc.build_table(pk)[0]) for pk in keys]
    oks = np.array([True] + [jpc.build_table(pk)[1] for pk in keys], dtype=np.uint8)
    store = np.ascontiguousarray(np.stack(cols).transpose(1, 2, 3, 0))
    col_of = {pk: 1 + i for i, pk in enumerate(keys)}
    idxs = np.array([col_of[pk] for pk in pks], dtype=np.int32)
    store_t = torch.from_numpy(store)
    port, host_ok = teb._prep_resident_chunk(pks, msgs, sigs, idxs, oks[idxs], store_t, LANES)
    ref_in, ref_ok = jeb._prep_resident_chunk(
        pks, msgs, sigs, idxs, oks[idxs], jnp.asarray(store), None, LANES
    )
    np.testing.assert_array_equal(host_ok, ref_ok)
    for key in ("idx", "ok", "r", "s", "k"):
        np.testing.assert_array_equal(port[key], np.asarray(ref_in[key]), err_msg=key)
    assert (port["idx"][len(pks):] == 0).all() and (port["ok"][len(pks):] == 1).all()
    args = [torch.from_numpy(port[k]) for k in ("idx", "ok", "r", "s", "k")]
    got = teb.verify_kernel_resident(store_t, *args).numpy()
    # The compiled graph verify_batch itself takes (same cache key).
    mul_impl = jeb._mul_impl_for_chunk(jeb.active_impl(None), None, LANES)
    exp = np.asarray(jeb._compiled_kernel_resident(LANES, None, mul_impl)(
        jnp.asarray(store), *(jnp.asarray(port[k]) for k in ("idx", "ok", "r", "s", "k"))
    ))
    np.testing.assert_array_equal(got, exp)
    want = [ref.verify_zip215(p, m, s) for p, m, s in zip(pks, msgs, sigs)]
    np.testing.assert_array_equal(got[: len(pks)] & host_ok, want)
    assert got[len(pks):].all() and not all(want)
    np.testing.assert_array_equal(cuda_verify.verify_resident(store_t, *args).numpy(), got)


def test_verify_batch_matches_jax_with_both_stores_on(monkeypatch):
    monkeypatch.setenv(jres._ENV, "on")
    jres.reset()
    pks, msgs, sigs = _parity_lanes()
    keys = list(dict.fromkeys(pk for pk in pks))
    # The port's cache takes the JAX package's table bytes.
    assert tpc.from_reference_tables({pk: jpc.build_table(pk) for pk in keys}) == len(keys)
    _activate(keys)
    jpc.pin_pubkeys(keys)  # the JAX package's own way to make keys eligible
    try:
        got = _verify(pks, msgs, sigs)
        exp = jeb.verify_batch(pks, msgs, sigs)
        assert got == exp
        assert got == [ref.verify_zip215(p, m, s) for p, m, s in zip(pks, msgs, sigs)]
        s, js = resident.stats(), jres.stats()
        assert s["uploads"] == js["uploads"] == 1
        assert s["h2d_bytes"] == js["h2d_bytes"] == (1 + len(keys)) * 1024
        assert s["hits"] == js["hits"] == len(pks) and tpc.tables.builds == 0
    finally:
        jres.reset()


@pytest.mark.parametrize(
    "bad, err",
    [
        (lambda a: [a[0], a[1].to(torch.int64)] + a[2:], TypeError),
        (lambda a: [a[0], a[1] + 5] + a[2:], ValueError),
        (lambda a: [a[0], a[1] - 2] + a[2:], ValueError),
        (lambda a: [a[0][..., :3]] + a[1:], ValueError),
        (lambda a: [a[0][:4]] + a[1:], ValueError),
        (lambda a: [a[0], a[1].to("meta")] + a[2:], ValueError),
    ],
    ids=["idx-dtype", "idx-too-large", "idx-negative", "store-not-contiguous", "store-shape",
         "idx-off-host"],
)
def test_verify_resident_rejects_bad_inputs(bad, err):
    pks, msgs, sigs = _batch(4)
    cols = [teb._pad_table()] + [tpc.build_table(pk)[0] for pk in pks]
    store = torch.from_numpy(np.ascontiguousarray(np.stack(cols).transpose(1, 2, 3, 0)))
    inputs, _ = teb._prep_resident_chunk(
        pks, msgs, sigs, np.arange(1, 5, dtype=np.int32), np.ones(4, np.uint8), store, 4
    )
    args = [store] + [torch.from_numpy(inputs[k]) for k in ("idx", "ok", "r", "s", "k")]
    assert cuda_verify.verify_resident(*args).all()
    with pytest.raises(err):
        cuda_verify.verify_resident(*bad(args))

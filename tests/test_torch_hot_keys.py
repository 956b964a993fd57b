"""The verify service's hot-key pins (``ops/resident.py``
``note_hot_keys``, ``ops/precompute.py`` ``pin_pubkeys``) against the
JAX package's, on the CPU.

A key is pinned on its second sighting, within its tenant's quota, and
the pin sets, tenant counts and quota denials equal the reference's for
the same seeded traffic. Pinned keys become table-eligible; the ledger's
``resident_tables/<tenant>`` rows split the store's bytes by pins and
sum to them. Through the server, set-less traffic first takes the
build-on-device kernel and, once its keys are pinned, the resident one.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import tendermint_tpu_torch
from tendermint_tpu.ops import introspect as jintrospect, precompute as jpc, resident as jres
from tendermint_tpu_torch.crypto import ed25519_ref as ref
from tendermint_tpu_torch.ops import cuda_verify, introspect, precompute, resident

SEED = 20261017


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.setattr(tendermint_tpu_torch, "DEFAULT_DEVICE", "cpu")
    for mod in (precompute, resident, jpc, jres):
        mod.reset()
    yield
    resident.configure(None)
    for mod in (precompute, resident, jpc, jres):
        mod.reset()


def _traffic(seed, tenants=("chain-a", "chain-b"), keys=24, events=160):
    """Seeded (tenant, batch of pubkeys) sightings over a small universe
    of keys per tenant, some keys shared between tenants."""
    rng = np.random.default_rng(seed)
    universe = {t: [rng.bytes(32) for _ in range(keys)] for t in tenants}
    shared = rng.bytes(32)
    out = []
    for _ in range(events // 8):
        t = tenants[int(rng.integers(0, len(tenants)))]
        batch = [universe[t][int(i)] for i in rng.integers(0, keys, size=8)]
        if rng.random() < 0.2:
            batch.append(shared)
        if rng.random() < 0.1:
            batch.append(b"short")  # not a key: ignored by both
        out.append((t, batch))
    return out


@pytest.mark.parametrize("quota", [0, 4, 10])
@pytest.mark.parametrize("seed", range(3))
def test_pins_equal_the_reference_s(seed, quota):
    for tenant, batch in _traffic(SEED + seed):
        resident.note_hot_keys(batch, tenant=tenant, quota=quota)
        jres.note_hot_keys(batch, tenant=tenant, quota=quota)
    assert resident.pinned_keys() == jres.pinned_keys()
    assert resident.tenant_pins() == jres.store.tenant_pins()
    assert resident.stats()["pin_quota_denials"] == jres.stats()["pin_quota_denials"]
    assert resident.stats()["pinned_keys"] == len(resident.pinned_keys()) > 0
    if quota:
        assert all(n <= quota for n in resident.tenant_pins().values())
    # every pin is table-eligible in both caches
    pinned = [bytes.fromhex(h) for h in resident.pinned_keys()]
    assert pinned and all(pk in precompute.tables._eligible for pk in pinned)
    assert all(pk in jpc.tables._eligible for pk in pinned)


def test_a_key_is_pinned_on_its_second_sighting():
    pk = b"\x05" * 32
    resident.note_hot_keys([pk], tenant="t", quota=1)
    assert resident.pinned_keys() == []
    resident.note_hot_keys([pk], tenant="t", quota=1)
    assert resident.pinned_keys() == [pk.hex()] and resident.tenant_pins() == {"t": 1}
    resident.note_hot_keys([b"\x06" * 32] * 2, tenant="t", quota=1)
    assert resident.stats()["pin_quota_denials"] == 1 and len(resident.pinned_keys()) == 1


def test_pin_pubkeys_makes_keys_eligible_and_a_clear_drops_them():
    _, pub = ref.keypair_from_seed(b"\x07" * 32)
    entries, has = precompute.tables.gather([pub])
    assert entries is None and not has.any()  # set-less: no table
    precompute.pin_pubkeys([pub])
    entries, has = precompute.tables.gather([pub])
    assert has.all() and precompute.tables.stats()["pinned"] == 1
    precompute.reset()
    assert precompute.tables.stats()["pinned"] == 0
    assert not precompute.tables.gather([pub])[1].any()


@pytest.mark.parametrize("pins", [{"a": 3, "b": 1}, {"a": 5}, {"a": 2, "b": 2, "c": 3}, {}])
def test_tenant_rows_split_the_store_bytes_as_the_reference_s(pins):
    introspect.accountant.clear()
    jintrospect.accountant.clear()
    for acc in (introspect.accountant, jintrospect.accountant):
        acc.set_tenant_bytes(7 * 1024, {"stale": 1})
        acc.set_tenant_bytes(7 * 1024, pins)
    got = introspect.accountant.snapshot()["device_bytes"]
    want = jintrospect.accountant.snapshot()["device_bytes"]
    assert got == want
    assert "resident_tables/stale" not in got
    introspect.accountant.clear()
    jintrospect.accountant.clear()


def _signed(seed, n_keys, per_key):
    """``per_key`` signatures from each of ``n_keys`` seeded keys."""
    pks, msgs, sigs = [], [], []
    for k in range(n_keys):
        priv, pub = ref.keypair_from_seed(bytes([seed, k]) + b"\x00" * 30)
        for j in range(per_key):
            m = b"hot-%d-%d-%d" % (seed, k, j)
            pks.append(pub)
            msgs.append(m)
            sigs.append(ref.sign(priv, m))
    return pks, msgs, sigs


def test_set_less_server_traffic_is_pinned_then_served_from_the_store(monkeypatch):
    """Two tenants of 16 signers each (a request reaches the device
    tier), every signer seen 3 times, quota 16:
    the first sightings run the build-on-device kernel (K1's plain
    version here), the keys are pinned after the second, and the third
    round hits the resident store (K3's plain version); the ledger's
    tenant rows sum to the store tensor's bytes."""
    from tendermint_tpu_torch.verifyd.client import VerifydClient
    from tendermint_tpu_torch.verifyd.protocol import CLASS_CONSENSUS
    from tendermint_tpu_torch.verifyd.server import VerifydServer

    resident.configure("on")  # the store follows the device: force it on the CPU
    calls = {"verify": 0, "verify_resident": 0}
    for name in calls:
        real = getattr(cuda_verify, name)

        def counted(*args, _real=real, _name=name):
            calls[_name] += 1
            return _real(*args)

        monkeypatch.setattr(cuda_verify, name, counted)
    srv = VerifydServer(max_batch=64, max_delay=0.01, tenant_pin_quota=16, device="cpu")
    srv.start()
    clients = {t: VerifydClient("%s:%d" % srv.address, tenant=t) for t in ("chain-a", "chain-b")}
    lanes = {t: _signed(s, 16, 3) for s, t in enumerate(clients)}
    try:
        for rnd in range(3):
            before = dict(calls)
            for t, c in clients.items():
                pks, msgs, sigs = lanes[t]
                sel = slice(rnd, None, 3)
                sub_sigs = list(sigs[sel])
                sub_sigs[0] = bytes(64)  # one bad lane a round
                # consensus: the CPU's plain kernels would trip the
                # service-time shed of the sheddable classes
                got = c.verify(pks[sel], msgs[sel], sub_sigs, klass=CLASS_CONSENSUS)
                assert got == [False] + [True] * 15
            if rnd < 2:
                assert calls["verify"] > before["verify"]
                assert calls["verify_resident"] == before["verify_resident"]
            else:
                assert calls["verify_resident"] > before["verify_resident"]
        assert resident.tenant_pins() == {"chain-a": 16, "chain-b": 16}
        assert resident.stats()["hits"] > 0 and srv.stats()["pin_errors"] == 0
        rows = {k: v for k, v in introspect.accountant.snapshot()["device_bytes"].items()
                if k.startswith("resident_tables/")}
        assert set(rows) == {"resident_tables/chain-a", "resident_tables/chain-b"}
        assert sum(rows.values()) == resident.store.device_nbytes() > 0
    finally:
        for c in clients.values():
            c.close()
        srv.stop()

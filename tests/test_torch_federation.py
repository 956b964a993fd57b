"""The port's verifyd federation (``verifyd/federation.py``) against the
JAX package's, on the CPU: the twin of ``tests/test_federation.py``.

``HashRing.preference``/``route`` and ``digest_validator_set`` equal the
reference's for the same shard ids and keys. Two in-process port shards
on the CPU take disjoint slices of the noted committees, every response
carries its shard's id, and a committee never splits. The failover
ladder re-routes a dead shard's and a shedding shard's lanes, bumps
``route_epoch`` and quarantines the dead one. The held divergence
(ROADMAP §C): with every shard gone the last rung raises
``VerifydUnavailableError``, counted, unless host fallback is on, where
the reference answers on the host in any case. ``crypto/batch`` ranks
the federation above a single remote and forwards the sorted committee
of ``note_validator_set``. The port reads no environment variable:
``set_federation`` chooses the shards. Every wait is bounded.
"""

import hashlib

import numpy as np
import pytest

pytest.importorskip("torch")

import tendermint_tpu_torch
from tendermint_tpu.crypto.keys import Ed25519PrivKey as JPrivKey
from tendermint_tpu.types.validator import Validator as JValidator
from tendermint_tpu.types.validator_set import ValidatorSet as JValidatorSet
from tendermint_tpu.verifyd import federation as jfed
from tendermint_tpu.verifyd.client import VerifydClient as JClient
from tendermint_tpu.verifyd.server import VerifydServer as JServer
from tendermint_tpu_torch.crypto import batch as tbatch, ed25519_ref as ref
from tendermint_tpu_torch.ops import device_policy, introspect, precompute, resident
from tendermint_tpu_torch.types import carry
from tendermint_tpu_torch.verifyd import client as vclient, federation, protocol
from tendermint_tpu_torch.verifyd.client import VerifydClient, VerifydRejectedError, VerifydUnavailableError
from tendermint_tpu_torch.verifyd.federation import FederationClient, HashRing, digest_validator_set
from tendermint_tpu_torch.verifyd.server import VerifydServer


def make_keys(n, tag=b"fed"):
    return [hashlib.sha256(b"%s-%d" % (tag, i)).digest() for i in range(n)]


def seeded_committee(n, seed):
    """n signers from a numpy seed; returns (pks, sign) with sign(i, m)."""
    rng = np.random.default_rng(seed)
    keys = [ref.keypair_from_seed(rng.bytes(32)) for _ in range(n)]
    return [pub for _, pub in keys], (lambda i, m: ref.sign(keys[i][0], m))


def lanes_of(pks, sign, tag, bad=()):
    msgs = [b"%s-%d" % (tag, i) for i in range(len(pks))]
    sigs = [bytes(64) if i in bad else sign(i, m) for i, m in enumerate(msgs)]
    return list(pks), msgs, sigs


@pytest.fixture
def shards(monkeypatch):
    """Port shard servers on the CPU, each recording the keys it was
    handed; stopped after."""
    monkeypatch.setattr(tendermint_tpu_torch, "DEFAULT_DEVICE", "cpu")
    monkeypatch.setattr(device_policy, "shared", device_policy.DeviceHealth())
    started = []

    def start(n, cls=VerifydServer, **kw):
        seen, addrs = [], []
        for sid in range(n):
            got = set()

            def fn(pks, msgs, sigs, got=got):
                got.update(bytes(p) for p in pks)
                return tbatch.host_verify_ed25519(pks, msgs, sigs)

            extra = {"device": "cpu"} if cls is VerifydServer else {}
            srv = cls(verify_fn=fn, max_batch=64, max_delay=0.002, shard_id=sid, **extra, **kw)
            srv.start()
            started.append(srv)
            seen.append(got)
            h, p = srv.address
            addrs.append(f"{h}:{p}")
        return started[-n:], addrs, seen

    yield start
    for srv in started:
        srv.stop()
    federation.reset_federation()
    vclient.reset_remote()
    tbatch.shutdown_shared_scheduler()


# --- the ring and the digest --------------------------------------------------------


@pytest.mark.parametrize("n_shards", [1, 2, 3, 4])
def test_preference_and_route_equal_the_references(n_shards):
    ids = list(range(n_shards))
    ring, jring = HashRing(ids), jfed.HashRing(ids)
    assert ring._points == jring._points
    keys = make_keys(256, tag=b"ring%d" % n_shards)
    for k in keys:
        assert ring.preference(k) == jring.preference(k)
        assert sorted(ring.preference(k)) == ids
        for dead in ({0}, {n_shards - 1}, set(ids)):
            assert ring.route(k, dead=dead) == jring.route(k, dead=dead)
    counts = np.bincount([ring.route(k) for k in keys], minlength=n_shards)
    assert counts.min() > 256 / n_shards / 3  # a near-even split


def test_losing_a_shard_moves_only_its_keys():
    ring = HashRing([0, 1, 2])
    keys = make_keys(300, tag=b"remap")
    for k in keys:
        before = ring.route(k)
        after = ring.route(k, dead={1})
        assert after == before if before != 1 else after == ring.preference(k)[1]


def test_the_committee_digest_equals_the_references():
    pks, _ = seeded_committee(16, seed=1)
    d = digest_validator_set(pks)
    assert d == jfed.digest_validator_set(pks) == digest_validator_set(list(reversed(pks)))
    assert d == hashlib.sha256(b"".join(sorted(pks))).digest()


# --- routing -----------------------------------------------------------------------


def test_two_shards_take_disjoint_slices_and_stamp_their_id(shards):
    servers, addrs, seen = shards(2)
    fed = FederationClient(addrs)
    jf = jfed.FederationClient(addrs)
    try:
        committees = [seeded_committee(4, seed=10 + c) for c in range(6)]
        for pks, _ in committees:
            assert fed.note_validator_set(pks) == jf.note_validator_set(pks)
        for pks, _ in committees:
            assert fed.shard_for(pks[0]) == jf.shard_for(pks[0])
        lanes = [lanes_of(pks, sign, b"c%d" % c) for c, (pks, sign) in enumerate(committees)]
        all_pks = [p for ln in lanes for p in ln[0]]
        all_msgs = [m for ln in lanes for m in ln[1]]
        all_sigs = [s for ln in lanes for s in ln[2]]
        # consensus class: placement is the test, not the admission
        # controller, which sheds rpc-class lanes once a loaded host's
        # flushes make its service-time estimate pass its budget (and the
        # ladder then moves them; see the test after this one)
        consensus = protocol.CLASS_CONSENSUS
        assert fed.verify(all_pks, all_msgs, all_sigs, klass=consensus) == [True] * len(all_pks)
        first = [set(s) for s in seen]
        assert fed.verify(all_pks, all_msgs, all_sigs, klass=consensus) == [True] * len(all_pks)
        assert [set(s) for s in seen] == first  # stable placement
        assert fed.failovers == 0 and fed.rerouted_lanes == 0
        assert seen[0] and seen[1] and not (seen[0] & seen[1])  # disjoint slices
        for pks, _ in committees:
            assert len({sid for sid in range(2) if set(pks) & seen[sid]}) == 1
        for sid, srv in enumerate(servers):
            st = srv.stats()
            assert st["shard_id"] == sid and st["misroutes"] == 0
            assert st["route_epoch_seen"] == fed.route_epoch
        for sid, c in enumerate(fed._clients):
            snap = c.server_stats()
            assert snap["shard_id"] == sid
    finally:
        fed.close()
        jf.close()


def test_a_loaded_shard_sheds_rpc_lanes_to_the_next_rung_and_keeps_consensus_lanes(shards):
    """What moved placement in the disjoint-slices test under a loaded
    host: once a shard's learned per-lane flush cost puts a group past
    its service-time budget, it sheds rpc-class lanes, and the ladder
    verifies them on the next shard; consensus-class lanes are never
    shed, so they stay on their own shard."""
    servers, addrs, seen = shards(2)
    fed = FederationClient(addrs)
    try:
        pks, sign = seeded_committee(4, seed=30)
        lanes = lanes_of(pks, sign, b"shed")
        fed.note_validator_set(pks)  # the committee routes as one group
        home = fed.shard_for(pks[0])
        other = 1 - home
        # the host's flushes as a loaded test machine makes them: 0.2 s a lane
        servers[home].admission.observe_flush(1, 0.2)
        assert fed.verify(*lanes, klass=protocol.CLASS_RPC) == [True] * 4
        assert set(pks) <= seen[other] and not set(pks) & seen[home]
        assert fed.failovers == 1 and fed.rerouted_lanes == 4
        assert fed.verify(*lanes, klass=protocol.CLASS_CONSENSUS) == [True] * 4
        assert set(pks) <= seen[home] and fed.failovers == 1
    finally:
        fed.close()


def test_every_response_carries_the_shards_id_and_a_misroute_is_counted(shards):
    servers, addrs, _ = shards(2)
    pks, sign = seeded_committee(3, seed=20)
    lanes = lanes_of(pks, sign, b"mis")
    for sid in (0, 1):
        c = VerifydClient(addrs[sid], shard_id=1 - sid, shm="off")
        try:
            req = protocol.VerifyRequest(pks=lanes[0], msgs=lanes[1], sigs=lanes[2],
                                         klass=protocol.CLASS_CONSENSUS, shard_id=1 - sid)
            resp = c.call(req)
            assert resp.status == protocol.STATUS_OK and resp.shard_id == sid
        finally:
            c.close()
        assert servers[sid].stats()["misroutes"] == 1  # served all the same


def test_refresh_and_the_memstats_rows_show_each_shards_pinned_slice(shards):
    servers, addrs, _ = shards(2)
    fed = FederationClient(addrs)
    try:
        snaps = fed.refresh()
        assert sorted(snaps) == [0, 1]
        for sid, snap in snaps.items():
            assert snap["shard_id"] == sid and "pinned_keys" in snap
        rows = fed.memstats_rows()
        assert sorted(rows) == ["shard0", "shard1"]
        assert set(rows["shard0"]) >= {"addr", "device_bytes", "pinned_keys", "host_staged_bytes",
                                       "requests_served", "misroutes"}
        introspect.set_fleet_provider(lambda: rows)
        try:
            fleet = introspect.memstats()["fleet"]
            assert sorted(fleet["shards"]) == ["shard0", "shard1"]
            assert fleet["aggregate_total"] == sum(fleet["aggregate_bytes"].values())
        finally:
            introspect.set_fleet_provider(None)
        assert "fleet" not in introspect.memstats()
    finally:
        fed.close()


def test_the_pinned_slice_is_mirrored_as_host_staged_bytes():
    precompute.reset()
    resident.reset()
    try:
        pks, _ = seeded_committee(4, seed=30)
        for _ in range(resident.HOT_PIN_THRESHOLD):
            resident.note_hot_keys(pks, tenant="t", quota=16)
        assert len(resident.pinned_keys()) == 4
        want = 4 * resident.TABLE_BYTES_PER_KEY
        assert resident.stats()["host_staged_bytes"] == want
        assert introspect.accountant.bytes_for("resident_tables_host") == want
        resident.store.invalidate(pks[:1])
        assert introspect.accountant.bytes_for("resident_tables_host") == want - resident.TABLE_BYTES_PER_KEY
    finally:
        precompute.reset()
        resident.reset()
    assert introspect.accountant.bytes_for("resident_tables_host") == 0


# --- the failover ladder ---------------------------------------------------------


def test_a_dead_shard_fails_over_with_the_epoch_bumped(shards):
    servers, addrs, _ = shards(2)
    fed = FederationClient(addrs, dead_retry_s=60.0, failover_backoff_s=0.001)
    try:
        pks, sign = seeded_committee(4, seed=40)
        fed.note_validator_set(pks)
        victim = fed.shard_for(pks[0])
        epoch0 = fed.route_epoch
        servers[victim].stop()
        lanes = lanes_of(pks, sign, b"dead", bad={2})
        assert fed.verify(*lanes) == [True, True, False, True]
        st = fed.stats()
        assert st["failovers"] >= 1 and st["rerouted_lanes"] >= 4
        assert st["host_fallback_lanes"] == 0 and st["unanswered_lanes"] == 0
        assert fed.alive_shards() == [1 - victim] and fed.route_epoch > epoch0
        assert all(c.route_epoch == fed.route_epoch for c in fed._clients)
        assert fed.shard_for(pks[0]) == 1 - victim
    finally:
        fed.close()


def test_a_shedding_shard_walks_the_ladder_and_stays_alive(shards):
    servers, addrs, _ = shards(2)
    fed = FederationClient(addrs, failover_backoff_s=0.001)
    try:
        pks, sign = seeded_committee(4, seed=41)
        fed.note_validator_set(pks)
        victim = fed.shard_for(pks[0])

        def always_shed(*a, **kw):
            raise VerifydRejectedError(protocol.STATUS_RESOURCE_EXHAUSTED, "brownout")

        fed._clients[victim].verify = always_shed
        assert fed.verify(*lanes_of(pks, sign, b"shed")) == [True] * 4
        assert fed.stats()["failovers"] >= 1 and victim in fed.alive_shards()
    finally:
        fed.close()


def test_the_last_rung_raises_with_host_fallback_off_where_the_reference_answers(shards):
    servers, addrs, _ = shards(2)
    for s in servers:
        s.stop()
    pks, sign = seeded_committee(5, seed=42)
    lanes = lanes_of(pks, sign, b"last", bad={2})
    want = [True, True, False, True, True]
    jf = jfed.FederationClient(addrs, failover_backoff_s=0.001, timeout=5.0)
    try:
        assert jf.verify(*lanes) == want  # the reference answers on the host
        assert jf.stats()["host_fallback_lanes"] == 5
    finally:
        jf.close()
    fed = FederationClient(addrs, failover_backoff_s=0.001, timeout=5.0)
    try:
        with pytest.raises(VerifydUnavailableError, match="host fallback off"):
            fed.verify(*lanes)
        st = fed.stats()
        assert (st["unanswered_lanes"], st["host_fallback_lanes"]) == (5, 0)
        assert fed.alive_shards() == []
        device_policy.shared.host_fallback = True  # the health machine's opt-in
        assert fed.verify(*lanes) == want
        assert fed.stats()["host_fallback_lanes"] == 5
    finally:
        device_policy.shared.host_fallback = False
        fed.close()
    fed = FederationClient(addrs, failover_backoff_s=0.001, timeout=5.0, fallback=True)
    try:
        assert fed.verify(*lanes) == want  # the client's opt-in
    finally:
        fed.close()


def test_a_mixed_batch_merges_back_in_order_and_a_group_error_reaches_the_caller(shards):
    servers, addrs, _ = shards(2)
    fed = FederationClient(addrs, failover_backoff_s=0.001, timeout=5.0)
    try:
        a_pks, a_sign = seeded_committee(3, seed=43)
        b_pks, b_sign = seeded_committee(3, seed=44)
        fed.note_validator_set(a_pks)
        fed.note_validator_set(b_pks)
        a, b = lanes_of(a_pks, a_sign, b"a", bad={1}), lanes_of(b_pks, b_sign, b"b")
        order = [(a, 0), (b, 0), (a, 1), (b, 1), (a, 2)]
        mixed = [[ln[k][i] for ln, i in order] for k in range(3)]
        assert fed.verify(*mixed) == [True, True, False, True, True]
        for s in servers:
            s.stop()
        with pytest.raises(VerifydUnavailableError):
            fed.verify(*mixed)
    finally:
        fed.close()


def test_a_port_router_routes_to_jax_shards_as_the_jax_router_does(shards):
    servers, addrs, seen = shards(2, cls=JServer)
    pks, sign = seeded_committee(4, seed=45)
    fed, jf = FederationClient(addrs, shm="off"), jfed.FederationClient(addrs, shm="off")
    try:
        fed.note_validator_set(pks)
        jf.note_validator_set(pks)
        lanes = lanes_of(pks, sign, b"x", bad={3})
        assert fed.verify(*lanes) == jf.verify(*lanes) == [True, True, True, False]
        owner = fed.shard_for(pks[0])
        assert owner == jf.shard_for(pks[0]) and set(pks) <= seen[owner] and not seen[1 - owner]
    finally:
        fed.close()
        jf.close()


# --- crypto/batch wiring ----------------------------------------------------------


def test_the_federation_outranks_a_single_remote_and_gets_the_committee(shards):
    servers, addrs, seen = shards(2)
    assert federation.federation_backend() is None
    federation.set_federation(addrs[0])  # one address is not a federation
    assert federation.federation_client() is None
    vclient.set_remote_addr(addrs[0])
    assert tbatch.remote_verify_backend() == vclient.remote_client().verify
    federation.set_federation(",".join(addrs))
    fed = federation.federation_client()
    assert fed is not None and tbatch.remote_verify_backend() == fed.verify
    privs = [JPrivKey.generate() for _ in range(4)]
    jvset = JValidatorSet([JValidator(p.pub_key(), 10) for p in privs])
    vset = carry.validator_set(jvset)
    tbatch.note_validator_set(vset)
    keys = sorted(v.pub_key.bytes() for v in vset.validators)
    digest = digest_validator_set(keys)
    assert all(fed.routing_key(k) == digest for k in keys)
    federation.reset_federation()
    assert tbatch.remote_verify_backend() == vclient.remote_client().verify

"""The port's verify service (``verifyd/``) against the JAX package's, on
the CPU: the twin of ``tests/test_verifyd.py`` on ``device="cpu"``.

The 24-validator remote ``verify_commit`` gives the in-process verdicts
and the same bad-lane message in both packages; lanes from 4 concurrent
connections share flushes; admission sheds light while consensus
verifies; an expired deadline, a retry across a restart, tenant budgets
and bounded label cardinality; sr25519 lanes over the wire; the
``tendermint_verifyd_*`` exposition equals the JAX ``VerifydMetrics``';
each package's client works against the other's server; the remote
tenant; and the four places where the port differs from the reference,
each shown beside the reference's behaviour on the JAX server or client.
Every wait is bounded.
"""

import threading
import time

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import tendermint_tpu_torch
from tendermint_tpu.crypto import batch as jbatch
from tendermint_tpu.crypto.ed25519_ref import verify_zip215 as jverify
from tendermint_tpu.libs.metrics import Registry as JRegistry, VerifydMetrics as JVerifydMetrics
from tendermint_tpu.ops import device_policy as jdevice_policy, resident as jresident
from tendermint_tpu.types import validation as jval
from tendermint_tpu.verifyd import client as jclient
from tendermint_tpu.verifyd.server import VerifydServer as JServer
from tendermint_tpu_torch.crypto import batch as tbatch, ed25519_ref as ref
from tendermint_tpu_torch.libs.metrics import Registry, VerifydMetrics
from tendermint_tpu_torch.ops import device_policy, precompute, resident
from tendermint_tpu_torch.types import carry, validation as tval
from tendermint_tpu_torch.verifyd import client as vclient, protocol
from tendermint_tpu_torch.verifyd.client import (
    VerifydClient,
    VerifydRejectedError,
    VerifydUnavailableError,
    classify,
    current_class,
)
from tendermint_tpu_torch.verifyd.server import (
    LEVEL_HOST_CONSENSUS,
    VerifydServer,
    sanitize_tenant_label,
)
from tests import helpers


def host_verify(pks, msgs, sigs):
    return [ref.verify_zip215(p, m, s) for p, m, s in zip(pks, msgs, sigs)]


def make_lanes(n, seed=0, bad=()):
    """n signed (pk, msg, sig) lanes; indices in ``bad`` get zero sigs."""
    priv, pub = ref.keypair_from_seed(bytes([seed]) * 32)
    msgs = [b"lane-%d-%d" % (seed, i) for i in range(n)]
    sigs = [bytes(64) if i in bad else ref.sign(priv, m) for i, m in enumerate(msgs)]
    return [pub] * n, msgs, sigs


@pytest.fixture(autouse=True)
def _cpu_and_clean_state(monkeypatch):
    monkeypatch.setattr(tendermint_tpu_torch, "DEFAULT_DEVICE", "cpu")
    monkeypatch.setattr(device_policy, "shared", device_policy.DeviceHealth())
    monkeypatch.delenv(jclient.REMOTE_ENV, raising=False)
    precompute.reset()
    resident.reset()
    vclient.reset_remote()
    jclient.reset_remote()
    servers = []
    yield servers
    vclient.reset_remote()
    jclient.reset_remote()
    for srv in servers:
        srv.stop()
    tbatch.shutdown_shared_scheduler()
    precompute.reset()
    resident.reset()


def _serve(servers, cls=VerifydServer, **kw):
    srv = cls(**kw)
    srv.start()
    servers.append(srv)
    h, p = srv.address
    return srv, f"{h}:{p}"


def _gated():
    gate, in_flight = threading.Event(), threading.Event()

    def verify(pks, msgs, sigs):
        in_flight.set()
        gate.wait(10)
        return host_verify(pks, msgs, sigs)

    return gate, in_flight, verify


def test_classify_outermost_wins():
    assert current_class() is None
    with classify(protocol.CLASS_LIGHT):
        with classify(protocol.CLASS_BLOCKSYNC):
            assert current_class() == protocol.CLASS_LIGHT
    assert current_class() is None


def test_single_client_roundtrip_with_bad_lane_on_the_port_s_engine(_cpu_and_clean_state):
    """The default flush target: the tiered engine on the server's
    device (the plain kernels on the CPU)."""
    srv, addr = _serve(_cpu_and_clean_state, max_batch=64, max_delay=0.01)
    assert srv.device == torch.device("cpu")
    c = VerifydClient(addr)
    try:
        pks, msgs, sigs = make_lanes(20, bad={2, 17})
        assert c.verify(pks, msgs, sigs) == [i not in (2, 17) for i in range(20)]
        assert srv.stats()["requests_served"] == 1
        assert srv.scheduler.stats()["fallback_flushes"] == 0
        assert c.stats()["stage_calls"] == 1 and c.stats()["fallback_calls"] == 0
    finally:
        c.close()


def test_verify_commit_remote_parity_24_validators(_cpu_and_clean_state):
    """verify_commit through the remote gives the in-process verdicts
    and the same bad-signature message, in the port as in the JAX
    package."""
    privs, jvset = helpers.make_validators(24)
    jbid = helpers.make_block_id()
    jgood = helpers.make_commit(jbid, 5, 0, jvset, privs)
    jbad = helpers.make_commit(jbid, 5, 0, jvset, privs)
    jbad.signatures[3].signature = bytes(64)
    vset, bid = carry.validator_set(jvset), carry.block_id(jbid)
    good, bad = carry.commit(jgood), carry.commit(jbad)
    chain = helpers.CHAIN_ID

    tval.verify_commit(chain, vset, bid, 5, good)
    with pytest.raises(tval.InvalidCommitError) as inproc:
        tval.verify_commit(chain, vset, bid, 5, bad)

    srv, addr = _serve(_cpu_and_clean_state, max_batch=64, max_delay=0.01)
    vclient.set_remote_addr(addr)
    assert vclient.remote_transport() == "shm"  # co-located: the slab ring, by default
    tval.verify_commit(chain, vset, bid, 5, good)
    assert srv.stats()["requests_served"] == 1  # the wire served it
    with pytest.raises(tval.InvalidCommitError) as remote:
        tval.verify_commit(chain, vset, bid, 5, bad)
    assert str(remote.value) == str(inproc.value)
    assert "wrong signature (#3)" in str(remote.value)
    assert srv.stats()["requests_served"] == 2
    reasons = srv.scheduler.stats()["flush_reasons"]
    assert reasons["size"] + reasons["deadline"] >= 2
    # consensus classification rode the wire: never shed, lanes counted
    assert srv.tenant_stats()["default"]["lanes"] == 48

    jsrv, jaddr = _serve(_cpu_and_clean_state, cls=JServer,
                         verify_fn=lambda p, m, s: [jverify(*x) for x in zip(p, m, s)],
                         max_batch=64, max_delay=0.01)
    jclient.set_remote_addr(jaddr)
    jval.verify_commit(chain, jvset, jbid, 5, jgood)
    with pytest.raises(jval.InvalidCommitError) as jremote:
        jval.verify_commit(chain, jvset, jbid, 5, jbad)
    assert str(jremote.value) == str(remote.value)


def test_shared_scheduler_flushes_ride_the_remote(_cpu_and_clean_state):
    srv, addr = _serve(_cpu_and_clean_state, verify_fn=host_verify, max_batch=8, max_delay=0.01)
    vclient.set_remote_addr(addr)
    sched = tbatch.get_shared_scheduler()
    pks, msgs, sigs = make_lanes(3, seed=5, bad={1})
    entries = sched.submit_many(list(zip(pks, msgs, sigs)))
    assert sched.wait_many(entries, timeout=10) == [True, False, True]
    assert srv.stats()["requests_served"] >= 1


def test_remote_tenant_names_the_node_s_traffic(_cpu_and_clean_state):
    """set_remote_tenant puts the remote backend's lanes under that tenant
    on the server, in the port as in the JAX package; reset_remote puts
    the default back."""
    lanes = make_lanes(3, seed=6, bad={2})
    srv, addr = _serve(_cpu_and_clean_state, verify_fn=host_verify, max_batch=8, max_delay=0.01)
    jsrv, jaddr = _serve(_cpu_and_clean_state, cls=JServer,
                         verify_fn=lambda p, m, s: [jverify(*x) for x in zip(p, m, s)],
                         max_batch=8, max_delay=0.01)
    for client_mod, server, a in ((vclient, srv, addr), (jclient, jsrv, jaddr)):
        client_mod.set_remote_addr(a)
        client_mod.set_remote_tenant("chain-a")
        assert client_mod.remote_backend()(*lanes) == [True, True, False]
        client_mod.set_remote_tenant("")  # empty is the default tenant
        assert client_mod.remote_backend()(*lanes) == [True, True, False]
        assert {t: s["lanes"] for t, s in server.tenant_stats().items()} == {
            "chain-a": 3, "default": 3}
    assert vclient.remote_client().tenant == protocol.DEFAULT_TENANT
    vclient.set_remote_tenant("chain-b")
    vclient.reset_remote()
    assert vclient.remote_client() is None
    vclient.set_remote_addr(addr)
    assert vclient.remote_client().tenant == protocol.DEFAULT_TENANT


def test_cross_client_batching_four_connections(_cpu_and_clean_state):
    per, n_clients = 4, 4
    srv, addr = _serve(_cpu_and_clean_state, verify_fn=host_verify,
                       max_batch=per * n_clients, max_delay=2.0)
    results, errors = {}, []
    barrier = threading.Barrier(n_clients)

    def run(i):
        try:
            c = VerifydClient(addr)
            pks, msgs, sigs = make_lanes(per, seed=i, bad={i % per})
            barrier.wait(timeout=5)
            results[i] = c.verify(pks, msgs, sigs)
            c.close()
        except Exception as exc:  # surfaced below
            errors.append(exc)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert not errors
    assert all(results[i] == [j != i % per for j in range(per)] for i in range(n_clients))
    assert srv.scheduler.stats()["flush_reasons"]["size"] >= 1
    assert srv.stats()["cross_client_flushes"]["size"] >= 1


def test_admission_rejects_light_while_consensus_verifies(_cpu_and_clean_state):
    gate, in_flight, gated = _gated()
    srv, addr = _serve(_cpu_and_clean_state, verify_fn=gated, admission_cap=4, max_batch=64,
                       max_delay=0.02)
    results, errors = {}, []

    def consensus_call(i):
        try:
            c = VerifydClient(addr)
            results[i] = c.verify(*make_lanes(6, seed=i), klass=protocol.CLASS_CONSENSUS)
            c.close()
        except Exception as exc:
            errors.append(exc)

    try:
        t1 = threading.Thread(target=consensus_call, args=(1,))
        t1.start()
        assert in_flight.wait(timeout=5)
        t2 = threading.Thread(target=consensus_call, args=(2,))
        t2.start()
        deadline = time.monotonic() + 5
        while srv.scheduler.load_depth() < 12 and time.monotonic() < deadline:
            time.sleep(0.002)
        assert srv.scheduler.load_depth() >= 12  # consensus is never shed
        c3 = VerifydClient(addr, shed_retries=0)
        with pytest.raises(VerifydRejectedError) as ei:
            c3.verify(*make_lanes(2, seed=3), klass=protocol.CLASS_LIGHT)
        assert ei.value.status == protocol.STATUS_RESOURCE_EXHAUSTED
        c3.close()
        assert srv.stats()["admission_rejections"] == 1
    finally:
        gate.set()
    t1.join(timeout=10)
    t2.join(timeout=10)
    assert not errors
    assert results == {1: [True] * 6, 2: [True] * 6}


def test_deadline_expired_response(_cpu_and_clean_state):
    gate, in_flight, gated = _gated()
    srv, addr = _serve(_cpu_and_clean_state, verify_fn=gated, max_batch=64, max_delay=0.01)
    warm = VerifydClient(addr)
    wt = threading.Thread(target=lambda: warm.verify(*make_lanes(1, seed=9)))
    wt.start()
    try:
        assert in_flight.wait(timeout=5)
        c = VerifydClient(addr)
        with pytest.raises(VerifydRejectedError) as ei:
            c.verify(*make_lanes(2, seed=4), deadline=0.2)
        assert ei.value.status == protocol.STATUS_DEADLINE_EXCEEDED
        assert "expired awaiting flush" in str(ei.value)
        assert srv.stats()["deadline_expired"] == 1
        c.close()
    finally:
        gate.set()
        wt.join(timeout=10)
        warm.close()


def test_client_retries_after_server_restart(_cpu_and_clean_state):
    srv = VerifydServer(verify_fn=host_verify, max_batch=8, max_delay=0.01)
    srv.start()
    h, p = srv.address
    c = VerifydClient(f"{h}:{p}", retries=6, backoff=0.1)
    pks, msgs, sigs = make_lanes(3)
    assert c.verify(pks, msgs, sigs) == [True] * 3
    srv.stop()

    def restart():
        time.sleep(0.3)
        _serve(_cpu_and_clean_state, verify_fn=host_verify, host=h, port=p, max_batch=8,
               max_delay=0.01)

    t = threading.Thread(target=restart)
    t.start()
    try:
        assert c.verify(pks, msgs, sigs) == [True] * 3  # fallback is off: the wire answered
        assert c.stats()["transport_retries"] >= 1
    finally:
        t.join(timeout=5)
        c.close()


def test_tenant_budget_all_or_nothing_with_isolation(_cpu_and_clean_state):
    gate, in_flight, gated = _gated()
    srv, addr = _serve(_cpu_and_clean_state, verify_fn=gated, max_batch=64, max_delay=0.01,
                       tenant_cap=4)
    results, errors = {}, []

    def call(key, tenant, n, seed):
        try:
            c = VerifydClient(addr, tenant=tenant, shed_retries=0)
            results[key] = c.verify(*make_lanes(n, seed=seed))
            c.close()
        except Exception as exc:
            errors.append((key, exc))

    try:
        t1 = threading.Thread(target=call, args=("a1", "chain-a", 3, 1))
        t1.start()
        assert in_flight.wait(timeout=5)
        deadline = time.monotonic() + 5
        while (srv.tenant_stats().get("chain-a", {}).get("depth", 0) < 3
               and time.monotonic() < deadline):
            time.sleep(0.002)
        c2 = VerifydClient(addr, tenant="chain-a", shed_retries=0)
        with pytest.raises(VerifydRejectedError) as ei:
            c2.verify(*make_lanes(3, seed=2))
        assert ei.value.status == protocol.STATUS_RESOURCE_EXHAUSTED and "tenant" in str(ei.value)
        c2.close()
        t3 = threading.Thread(target=call, args=("b1", "chain-b", 3, 3))
        t3.start()
        time.sleep(0.05)
    finally:
        gate.set()
    t1.join(timeout=10)
    t3.join(timeout=10)
    assert not errors, errors
    assert results == {"a1": [True] * 3, "b1": [True] * 3}
    stats = srv.tenant_stats()
    assert (stats["chain-a"]["sheds"], stats["chain-b"]["sheds"], stats["chain-a"]["lanes"]) == (1, 0, 3)


def test_tenant_metrics_bounded_cardinality(_cpu_and_clean_state):
    reg = Registry()
    srv, addr = _serve(_cpu_and_clean_state, verify_fn=host_verify, max_batch=8, max_delay=0.01,
                       metrics=VerifydMetrics(reg), max_tenants=2)
    for i, tenant in enumerate(["chain-a", "bad name!{}", "chain-c", "chain-d"]):
        c = VerifydClient(addr, tenant=tenant)
        assert c.verify(*make_lanes(2, seed=i)) == [True, True]
        c.close()
    text = reg.expose()
    assert 'tendermint_verifyd_tenant_lanes_total{tenant="chain-a"} 2' in text
    safe = sanitize_tenant_label("bad name!{}")
    assert safe.startswith("t") and f'tenant="{safe}"' in text
    assert 'tendermint_verifyd_tenant_lanes_total{tenant="other"} 4' in text
    assert 'tenant="chain-c"' not in text
    assert srv.tenant_stats()["other"]["lanes"] == 4
    assert "tendermint_verifyd_brownout_level 0" in text
    from tendermint_tpu.verifyd.server import sanitize_tenant_label as jsanitize

    for name in ("chain-a", "bad name!{}", "x" * 40, ""):
        assert sanitize_tenant_label(name) == jsanitize(name)


def test_sr25519_lanes_over_the_wire(_cpu_and_clean_state):
    from tendermint_tpu_torch.crypto.sr25519 import Sr25519PrivKey

    srv, addr = _serve(_cpu_and_clean_state, max_batch=8, max_delay=0.01)
    c = VerifydClient(addr)
    try:
        priv = Sr25519PrivKey.from_secret(b"verifyd-sr-lane")
        msgs = [b"sr-lane-%d" % i for i in range(3)]
        sigs = [priv.sign(m, entropy=bytes([i]) * 32) for i, m in enumerate(msgs)]
        sigs[1] = bytes(64)
        pks = [priv.pub_key().bytes()] * 3
        assert c.verify(pks, msgs, sigs, algo=protocol.ALGO_SR25519) == [True, False, True]
        assert srv.scheduler_stats()["sr25519"]["entries_verified"] == 3
    finally:
        c.close()


def test_verifyd_exposition_equals_the_reference_s(_cpu_and_clean_state):
    """Families, help texts and label sets of the port's VerifydMetrics
    are the reference's: both registries render the same text, empty and
    after the same observations."""
    jreg, treg = JRegistry(), Registry()
    jm, tm = JVerifydMetrics(jreg), VerifydMetrics(treg)
    assert treg.expose() == jreg.expose()
    for m in (jm, tm):
        m.requests.labels(kind="commit", status="ok").inc()
        m.lanes.labels(klass="consensus").inc(24)
        m.batch_occupancy.observe(24)
        m.tenant_queue_depth.labels(tenant="default").set(3)
        m.e2e_stage_seconds.labels(stage="device").observe(0.004)
    assert treg.expose() == jreg.expose()
    # a served request lands in the port's families
    reg = Registry()
    srv, addr = _serve(_cpu_and_clean_state, verify_fn=host_verify, max_batch=8, max_delay=0.01,
                       metrics=VerifydMetrics(reg))
    c = VerifydClient(addr)
    assert c.verify(*make_lanes(3)) == [True] * 3
    c.close()
    text = reg.expose()
    assert 'tendermint_verifyd_requests_total{kind="raw",status="ok"} 1' in text
    assert 'tendermint_verifyd_lanes_total{klass="rpc"} 3' in text
    assert "tendermint_verifyd_flushes_total" in text


@pytest.mark.parametrize("direction", ["jax-client-to-port-server", "port-client-to-jax-server"])
def test_each_client_works_against_the_other_package_s_server(_cpu_and_clean_state, direction):
    if direction.startswith("jax"):
        srv, addr = _serve(_cpu_and_clean_state, verify_fn=host_verify, max_batch=8, max_delay=0.01)
        c = jclient.VerifydClient(addr, fallback=False)
    else:
        srv, addr = _serve(_cpu_and_clean_state, cls=JServer,
                           verify_fn=lambda p, m, s: [jverify(*x) for x in zip(p, m, s)],
                           max_batch=8, max_delay=0.01)
        c = VerifydClient(addr)
    try:
        pks, msgs, sigs = make_lanes(5, seed=11, bad={0, 3})
        want = host_verify(pks, msgs, sigs)
        assert c.verify(pks, msgs, sigs, klass=protocol.CLASS_CONSENSUS) == want == [
            False, True, True, False, True]
        assert c.server_stats()["stats"]["requests_served"] == 1
        assert c.fallback_calls == 0
    finally:
        c.close()


def test_server_stats_snapshot_over_the_wire(_cpu_and_clean_state):
    srv, addr = _serve(_cpu_and_clean_state, verify_fn=host_verify, max_batch=8, max_delay=0.01)
    c = VerifydClient(addr)
    try:
        c.verify(*make_lanes(2))
        snap = c.server_stats()
        assert snap["stats"]["requests_served"] == 1 and snap["shard_id"] == -1
        assert set(snap) >= {"tenants", "brownout", "resident", "pinned_keys", "schedulers",
                             "health", "launches"}
        assert snap["schedulers"]["ed25519"]["entries_verified"] == 2
        assert snap["health"]["state"] == "healthy"
    finally:
        c.close()


# --- the four divergences from the reference ---------------------------------


def test_divergence_client_host_fallback_is_opt_in(_cpu_and_clean_state):
    pks, msgs, sigs = make_lanes(3, bad={1})
    jc = jclient.VerifydClient("127.0.0.1:1", retries=1, backoff=0.01)  # the reference's default
    assert jc.verify(pks, msgs, sigs) == [True, False, True] and jc.fallback_calls == 1
    jc.close()
    c = VerifydClient("127.0.0.1:1", retries=1, backoff=0.01)
    with pytest.raises(VerifydUnavailableError):
        c.verify(pks, msgs, sigs)
    assert c.fallback_calls == 0
    c.close()
    c = VerifydClient("127.0.0.1:1", retries=1, backoff=0.01, fallback=True)
    assert c.verify(pks, msgs, sigs) == [True, False, True] and c.fallback_calls == 1
    c.close()


def test_divergence_exhausted_shed_budget_raises_by_default(_cpu_and_clean_state):
    srv, addr = _serve(_cpu_and_clean_state, verify_fn=host_verify, max_batch=8, max_delay=0.01)
    srv.brownout.force(1)  # shed_rpc
    lanes = make_lanes(3, seed=8, bad={1})
    c = VerifydClient(addr, shed_retries=2, shed_backoff=0.01)
    with pytest.raises(VerifydRejectedError) as ei:
        c.verify(*lanes)
    assert ei.value.status == protocol.STATUS_RESOURCE_EXHAUSTED
    assert c.stats()["shed_retries_used"] == 2 and c.fallback_calls == 0
    c.close()
    c = VerifydClient(addr, shed_retries=2, shed_backoff=0.01, fallback=True)
    assert c.verify(*lanes) == [True, False, True] and c.fallback_calls == 1
    c.close()
    # a shed that lifts inside the budget is retried on the wire
    c = VerifydClient(addr, shed_retries=4, shed_backoff=0.05)
    releaser = threading.Timer(0.1, srv.brownout.force, args=(None,))
    releaser.start()
    try:
        assert c.verify(*make_lanes(3, seed=7)) == [True] * 3
    finally:
        releaser.cancel()
    assert c.stats()["shed_retries_used"] >= 1 and c.fallback_calls == 0
    c.close()


def _raising(pks, msgs, sigs):
    raise RuntimeError("injected device fault")


def test_divergence_a_failed_flush_is_an_error_not_bad_signatures(_cpu_and_clean_state, monkeypatch):
    lanes = make_lanes(4, seed=12)
    # the reference: verify and its host fallback both raise -> the flush
    # fails closed and the request is answered OK with every verdict False
    monkeypatch.setattr(jbatch, "host_verify_ed25519", _raising)
    jsrv, jaddr = _serve(_cpu_and_clean_state, cls=JServer, verify_fn=_raising, max_batch=8,
                         max_delay=0.01)
    jc = jclient.VerifydClient(jaddr, fallback=False)
    assert jc.verify(*lanes) == [False] * 4
    jc.close()
    # the port: host fallback off (the default) -> STATUS_INTERNAL with the
    # error's text, and no verdict list
    srv, addr = _serve(_cpu_and_clean_state, verify_fn=_raising, max_batch=8, max_delay=0.01)
    c = VerifydClient(addr)
    with pytest.raises(VerifydRejectedError) as ei:
        c.verify(*lanes)
    assert ei.value.status == protocol.STATUS_INTERNAL
    assert "injected device fault" in str(ei.value)
    assert srv.stats()["failed_closed"] == 1
    assert srv.scheduler.stats()["flush_errors"] == 1
    # with host fallback on, the flush is answered on the host and counted
    device_policy.shared.host_fallback = True
    assert c.verify(*make_lanes(4, seed=13, bad={2})) == [True, True, False, True]
    assert device_policy.shared.snapshot()["fallback_lanes"]["ed25519"] == 4
    assert srv.scheduler.stats()["fallback_flushes"] == 1
    c.close()


def test_divergence_the_hot_key_hook_counts_its_errors(_cpu_and_clean_state, monkeypatch):
    lanes = make_lanes(3, seed=14)

    def broken(*args, **kwargs):
        raise RuntimeError("pin path broken")

    monkeypatch.setattr(jresident, "note_hot_keys", broken)
    jsrv, jaddr = _serve(_cpu_and_clean_state, cls=JServer,
                         verify_fn=lambda p, m, s: [jverify(*x) for x in zip(p, m, s)],
                         max_batch=8, max_delay=0.01)
    jc = jclient.VerifydClient(jaddr, fallback=False)
    assert jc.verify(*lanes) == [True] * 3
    assert "pin_errors" not in jsrv.stats()  # the reference swallows it
    jc.close()
    monkeypatch.setattr(resident, "note_hot_keys", broken)
    srv, addr = _serve(_cpu_and_clean_state, verify_fn=host_verify, max_batch=8, max_delay=0.01)
    c = VerifydClient(addr)
    assert c.verify(*lanes) == [True] * 3
    assert srv.stats()["pin_errors"] == 1
    c.close()


def test_divergence_a_cooling_card_refuses_consensus_without_host_fallback(
        _cpu_and_clean_state, monkeypatch):
    lanes = make_lanes(4, seed=19, bad={3})
    # the reference: its health machine in COOLDOWN pins host_consensus and
    # the host answers consensus, whatever its fallback setting
    jhealth = jdevice_policy.DeviceHealth()
    jhealth._state = jdevice_policy.COOLDOWN
    monkeypatch.setattr(jdevice_policy, "shared", jhealth)
    jsrv, jaddr = _serve(_cpu_and_clean_state, cls=JServer,
                         verify_fn=lambda p, m, s: [jverify(*x) for x in zip(p, m, s)],
                         max_batch=8, max_delay=0.01)
    jc = jclient.VerifydClient(jaddr, fallback=False)
    assert jc.verify(*lanes, klass=protocol.CLASS_CONSENSUS) == [True, True, True, False]
    assert jsrv.stats()["host_direct_lanes"] == 4
    jc.close()
    # the port: the same pin, but with host fallback off (the default) the
    # request is refused as the in-process engines refuse it
    device_policy.shared._state = device_policy.COOLDOWN
    srv, addr = _serve(_cpu_and_clean_state, verify_fn=host_verify, max_batch=8, max_delay=0.01)
    assert srv.brownout.effective() == LEVEL_HOST_CONSENSUS
    c = VerifydClient(addr)
    with pytest.raises(VerifydRejectedError) as ei:
        c.verify(*lanes, klass=protocol.CLASS_CONSENSUS)
    assert ei.value.status == protocol.STATUS_INTERNAL
    assert "not admitted to the device (state=cooldown)" in str(ei.value)
    assert "host fallback is off" in str(ei.value)
    stats = srv.stats()
    assert stats["device_refused"] == 1 and stats["host_direct_lanes"] == 0
    assert device_policy.shared.snapshot()["fallback_lanes"]["ed25519"] == 0
    # with host fallback on, the host answers and the lanes are counted once
    device_policy.shared.host_fallback = True
    assert c.verify(*lanes, klass=protocol.CLASS_CONSENSUS) == [True, True, True, False]
    assert srv.stats()["host_direct_lanes"] == 4
    assert device_policy.shared.snapshot()["fallback_lanes"]["ed25519"] == 4
    assert srv.scheduler.stats()["entries_verified"] == 0
    c.close()


def test_host_direct_rungs_are_counted(_cpu_and_clean_state):
    srv, addr = _serve(_cpu_and_clean_state, verify_fn=host_verify, max_batch=8, max_delay=0.01)
    c = VerifydClient(addr, shed_retries=0)
    srv.brownout.force(5)
    assert c.verify(*make_lanes(4, seed=15, bad={0}), klass=protocol.CLASS_CONSENSUS) == [
        False, True, True, True]
    with pytest.raises(VerifydRejectedError):
        c.verify(*make_lanes(2, seed=16), klass=protocol.CLASS_BLOCKSYNC)
    assert srv.stats()["host_direct_lanes"] == 4
    assert device_policy.shared.snapshot()["fallback_lanes"]["ed25519"] == 4
    assert srv.scheduler.stats()["entries_verified"] == 0
    srv.brownout.force(None)
    assert c.verify(*make_lanes(2, seed=17), klass=protocol.CLASS_CONSENSUS) == [True, True]
    assert srv.scheduler.stats()["entries_verified"] == 2
    c.close()


def test_shm_other_than_off_is_refused(_cpu_and_clean_state):
    """Since item 12 the server serves ``"auto"`` and ``"on"`` beside
    ``"off"``; another mode is refused, by the server and the client."""
    with pytest.raises(ValueError, match="bad shm mode"):
        VerifydServer(shm="sometimes", device="cpu")
    with pytest.raises(ValueError, match="bad shm mode"):
        VerifydClient("127.0.0.1:1", shm="sometimes")
    for mode, want in (("auto", "shm"), ("on", "shm"), ("off", "tcp")):
        srv, addr = _serve(_cpu_and_clean_state, shm=mode, verify_fn=host_verify, max_delay=0.005)
        c = VerifydClient(addr)
        try:
            assert c.verify(*make_lanes(3, seed=21, bad={1}), klass=protocol.CLASS_CONSENSUS) == [
                True, False, True]
            assert c.transport == want, mode
            assert srv.stats()["shm_lanes"] == (3 if want == "shm" else 0)
        finally:
            c.close()


def test_large_requests_split_at_max_lanes(_cpu_and_clean_state, monkeypatch):
    monkeypatch.setattr(protocol, "MAX_LANES", 4)
    srv, addr = _serve(_cpu_and_clean_state, verify_fn=host_verify, max_batch=8, max_delay=0.01)
    c = VerifydClient(addr, shm="off")  # the TCP codec's cap; the slab ring cuts by slab size
    pks, msgs, sigs = make_lanes(10, seed=18, bad={5, 9})
    assert c.verify(pks, msgs, sigs) == [i not in (5, 9) for i in range(10)]
    assert srv.stats()["requests_served"] == 3
    c.close()

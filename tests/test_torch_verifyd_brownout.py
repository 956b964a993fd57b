"""The port's brownout ladder, SLO gate and admission control against
the JAX package's, on the CPU and on a fake clock.

One seeded ``observe()`` sequence walks both ``BrownoutController``s
through the same levels and transitions, with consensus never shed at
any rung; a tenant's SLO breach, shed and recovery run the same in both
servers; ``AdmissionController`` decides alike; and the shed order is
the reference's. The card's cooling state pins the ladder at
host_consensus in both.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

import tendermint_tpu_torch
from tendermint_tpu.verifyd import server as jserver
from tendermint_tpu_torch.ops import device_policy
from tendermint_tpu_torch.verifyd import protocol, server as tserver

SEED = 20261017


def _walk(mod, samples, cooling=lambda: False, forced=()):
    ctl = mod.BrownoutController(escalate_after=0.25, recover_after=1.0, cooldown_fn=cooling)
    out = []
    for i, (now, pressure) in enumerate(samples):
        for at, level in forced:
            if at == i:
                ctl.force(level)
        level, delta = ctl.observe(pressure, now=now)
        out.append((level, delta, ctl.level))
    return out, ctl.snapshot()


def _samples(seed, n=400):
    rng = np.random.default_rng(seed)
    t, out = 0.0, []
    pressure = True
    for _ in range(n):
        t += float(rng.exponential(0.05))
        if rng.random() < 0.03:
            pressure = not pressure
        out.append((t, pressure))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_the_ladder_walks_as_the_reference_s(seed):
    samples = _samples(SEED + seed)
    forced = [(100, 3), (150, None)] if seed % 2 else []
    got, snap = _walk(tserver, samples, forced=forced)
    want, jsnap = _walk(jserver, samples, forced=forced)
    assert got == want
    assert snap == jsnap
    assert max(lvl for lvl, _, _ in got) >= 1  # the sequence climbs


def test_consensus_is_never_shed_and_the_order_is_the_reference_s():
    for level in range(6):
        for klass in protocol.CLASS_NAMES:
            assert tserver.level_sheds_class(level, klass) == jserver.level_sheds_class(level, klass)
        assert not tserver.level_sheds_class(level, protocol.CLASS_CONSENSUS)
    order = [min(lvl for lvl in range(6) if tserver.level_sheds_class(lvl, k))
             for k in (protocol.CLASS_RPC, protocol.CLASS_LIGHT, protocol.CLASS_BLOCKSYNC)]
    assert order == [1, 2, 3]
    assert tserver.LEVEL_NAMES == jserver.LEVEL_NAMES


def test_a_cooling_card_pins_host_consensus(monkeypatch):
    samples = [(0.1 * i, False) for i in range(10)]
    got, _ = _walk(tserver, samples, cooling=lambda: True)
    want, _ = _walk(jserver, samples, cooling=lambda: True)
    assert got == want and all(lvl == tserver.LEVEL_HOST_CONSENSUS for lvl, _, _ in got)
    # the default probe reads the port's shared health machine
    health = device_policy.DeviceHealth()
    monkeypatch.setattr(device_policy, "shared", health)
    ctl = tserver.BrownoutController()
    assert ctl.effective() == tserver.LEVEL_NORMAL
    health._state = device_policy.COOLDOWN
    assert ctl.effective() == tserver.LEVEL_HOST_CONSENSUS


def test_admission_decides_as_the_reference_s():
    rng = np.random.default_rng(SEED)
    t = tserver.AdmissionController(cap=64, service_budget=0.05)
    j = jserver.AdmissionController(cap=64, service_budget=0.05)
    for _ in range(300):
        lanes, secs = int(rng.integers(0, 40)), float(rng.exponential(0.002))
        t.observe_flush(lanes, secs)
        j.observe_flush(lanes, secs)
        depth, n = int(rng.integers(0, 100)), int(rng.integers(1, 30))
        klass = int(rng.integers(0, 4))
        assert t.admit(klass, n, depth) == j.admit(klass, n, depth)
        assert t.pressure(depth) == j.pressure(depth)
        assert t.estimated_service_time(depth) == pytest.approx(j.estimated_service_time(depth),
                                                                rel=0, abs=0)


def _slo_trajectory(mod, monkeypatch):
    """Feed one tenant's latencies past its 10 ms target on a fake clock;
    return the gate's answers and the tenant's stats along the way."""
    kwargs = dict(verify_fn=lambda p, m, s: [True] * len(p), tenant_slos={"chain-a": 10})
    if mod is tserver:
        kwargs["device"] = "cpu"
    srv = mod.VerifydServer(**kwargs)
    try:
        ts = srv._tenant_for("chain-a")
        srv._tenant_declare_slo(ts, 50)  # pinned by the operator: the wire cannot loosen it
        trail = []
        now = 100.0
        for i in range(60):
            now += 0.01
            srv._tenant_observe_latency(ts, 0.02 if i < 40 else 0.001, now)
            trail.append(srv._tenant_slo_gate(ts, now))
        now += srv.slo_recover_after  # the dwell passes: released, ring reset
        trail.append(srv._tenant_slo_gate(ts, now))
        return trail, srv.tenant_stats()
    finally:
        srv._grpc.stop()


def test_the_slo_gate_breaches_sheds_and_recovers_as_the_reference_s(monkeypatch):
    monkeypatch.setattr(tendermint_tpu_torch, "DEFAULT_DEVICE", "cpu")
    got, got_stats = _slo_trajectory(tserver, monkeypatch)
    want, want_stats = _slo_trajectory(jserver, monkeypatch)
    assert got == want
    assert got_stats == want_stats
    assert True in got and got[-1] is False  # shed, then released
    assert got_stats["chain-a"]["slo_ms"] == 10 and got_stats["chain-a"]["slo_sheds"] > 0


def test_a_breaching_tenant_is_shed_over_the_wire_and_recovers(monkeypatch):
    """The SLO gate on a live server: light traffic of a tenant whose
    p99 is past its target gets RESOURCE_EXHAUSTED with the SLO reason;
    consensus of the same tenant still verifies; after the dwell the
    tenant is admitted again."""
    from tendermint_tpu_torch.verifyd.client import VerifydClient, VerifydRejectedError

    monkeypatch.setattr(tendermint_tpu_torch, "DEFAULT_DEVICE", "cpu")
    srv = tserver.VerifydServer(verify_fn=lambda p, m, s: [True] * len(p), max_batch=8,
                                max_delay=0.01, tenant_slos={"chain-a": 5},
                                slo_breach_after=0.0, slo_recover_after=0.3)
    srv.start()
    c = VerifydClient("%s:%d" % srv.address, tenant="chain-a", shed_retries=0)
    lanes = ([b"\x01" * 32] * 2, [b"m0", b"m1"], [b"\x02" * 64] * 2)
    try:
        ts = srv._tenant_for("chain-a")
        for _ in range(25):
            srv._tenant_observe_latency(ts, 0.05)
        with pytest.raises(VerifydRejectedError, match="over SLO budget") as ei:
            c.verify(*lanes, klass=protocol.CLASS_LIGHT)
        assert ei.value.status == protocol.STATUS_RESOURCE_EXHAUSTED
        assert c.verify(*lanes, klass=protocol.CLASS_CONSENSUS) == [True, True]
        import time

        time.sleep(0.35)
        assert c.verify(*lanes, klass=protocol.CLASS_LIGHT) == [True, True]
        assert srv.tenant_stats()["chain-a"]["slo_sheds"] == 1
    finally:
        c.close()
        srv.stop()

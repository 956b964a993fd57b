"""The port's ``OpsMetrics`` (libs/metrics.py) and its bindings against
the JAX package's, on the CPU.

One sequence goes through both packages, each with one ``OpsMetrics``
bound to its health machine, caches, resident store, challenge hash and
byte ledger, and the stage histogram fed by its tracer: activate a
16-validator set, verify a batch of its signatures twice (the verdict
cache answers the second), retire the set so that one key's table is
invalidated, and inject one transient fault at ``ed25519.chunk`` with
host fallback on. Both ``/metrics`` texts then have the same
``tendermint_ops_*`` families with the same ``HELP`` and ``TYPE``
lines, the same series label sets, and the same counter values for the
caches, the health machine and the fallback lanes.

Left out of the series comparison, with the reason: the JAX package's
``compile_events_total`` counts its first graph compile in a process
(the port compiles nothing on the CPU) and its ledger's
``resident_tables_host`` owner (pinned keys, which wait for the port's
verifyd). Every binding and both tracers are put back as found.
"""

import re

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import tendermint_tpu_torch
from tendermint_tpu.crypto.keys import Ed25519PrivKey as JPrivKey
from tendermint_tpu.libs import tracing as jtracing
from tendermint_tpu.libs.metrics import OpsMetrics as JOpsMetrics, Registry as JRegistry
from tendermint_tpu.ops import device_policy as jdp, ed25519_batch as jeb, fault_injection as jfi
from tendermint_tpu.ops import hash512 as jhash, introspect as jintro, precompute as jpc
from tendermint_tpu.ops import resident as jres
from tendermint_tpu_torch import ops as tops
from tendermint_tpu_torch.libs import tracing
from tendermint_tpu_torch.libs.metrics import Counter, Gauge, Histogram, OpsMetrics, Registry
from tendermint_tpu_torch.ops import device_policy, ed25519_batch as teb, fault_injection
from tendermint_tpu_torch.ops import precompute as tpc
from tendermint_tpu_torch.types import carry
from tests import helpers

N_SET = 16
LANES = 20
SKIP_SERIES = {"tendermint_ops_compile_events_total"}
SKIP_OWNERS = {"resident_tables_host"}
COMPARED = (
    "precompute_hits_total", "precompute_misses_total", "precompute_builds_total",
    "precompute_evictions_total", "precompute_invalidations_total",
    "result_cache_hits_total", "result_cache_misses_total",
    "table_resident_hits_total", "table_resident_misses_total", "table_h2d_bytes_total",
    "hash_device_lanes_total", "device_health_state", "device_health_transitions_total",
    "device_failures_total", "device_fallbacks_total", "device_fallback_lanes_total",
    "inflight_lanes",
)


def _jax_bindings():
    return (jdp.shared._metrics, jpc.tables._metrics, jpc.results._metrics, jres.store._metrics,
            jhash._metrics, jintro.accountant._metrics, jintro.profiler._metrics)


def _bind_jax(metrics, saved=None):
    saved = saved or (metrics,) * 7
    jdp.shared.bind_metrics(saved[0])
    jpc.tables.bind_metrics(saved[1])
    jpc.results.bind_metrics(saved[2])
    jres.store.bind_metrics(saved[3])
    jhash.bind_metrics(saved[4])
    jintro.accountant._metrics = saved[5]
    jintro.profiler.bind_metrics(saved[6])


@pytest.fixture
def bound(monkeypatch):
    """One OpsMetrics bound in each package, stage histograms fed by the
    tracers; everything put back after."""
    monkeypatch.setattr(tendermint_tpu_torch, "DEFAULT_DEVICE", "cpu")
    monkeypatch.setenv(jpc._RESULT_ENV, "1")  # tests/conftest.py turns it off
    monkeypatch.setattr(device_policy.shared, "host_fallback", True)
    jsaved = _jax_bindings()
    with jintro.accountant._lock:
        jledger = (dict(jintro.accountant._bytes), dict(jintro.accountant._compiles),
                   dict(jintro.accountant._exec_entries))
    jobs, tobs = jtracing.tracer._observer, tracing.tracer._observer
    # the JAX profiler may be installed by an earlier test; the port's is
    # off until installed, so neither feeds kernel_bucket_seconds here
    jprofile, tprofile = jtracing.tracer._profile, tracing.tracer._profile
    jtracing.tracer.set_profile_sink(None)
    tracing.tracer.set_profile_sink(None)
    for reset in (jpc.reset, tpc.reset, jdp.shared.reset, device_policy.shared.reset,
                  jintro.accountant.clear):
        reset()
    jreg, treg = JRegistry(), Registry()
    jm, tm = JOpsMetrics(jreg), OpsMetrics(treg)
    _bind_jax(jm)
    tops.bind_metrics(tm)
    jtracing.tracer.set_metrics_observer(jtracing.metrics_observer(ops=jm))
    tracing.tracer.set_metrics_observer(tracing.metrics_observer(ops=tm))
    yield jreg, treg, jm, tm
    jtracing.tracer.set_metrics_observer(jobs)
    tracing.tracer.set_metrics_observer(tobs)
    jtracing.tracer.set_profile_sink(jprofile)
    tracing.tracer.set_profile_sink(tprofile)
    tops.bind_metrics(None)
    _bind_jax(None, jsaved)
    jfi.uninstall()
    fault_injection.uninstall()
    for reset in (jpc.reset, tpc.reset, jdp.shared.reset, device_policy.shared.reset):
        reset()
    with jintro.accountant._lock:
        jintro.accountant._bytes, jintro.accountant._compiles, jintro.accountant._exec_entries = (
            jledger)


def _lanes():
    privs, vset = helpers.make_validators(N_SET)
    pks, msgs, sigs = [], [], []
    for i in range(LANES):
        priv = privs[i % N_SET]
        msg = b"ops metrics lane %d" % i
        pks.append(priv.pub_key().bytes())
        msgs.append(msg)
        sigs.append(priv.sign(msg))
    sigs[3] = bytes(64)  # one bad lane
    return vset, pks, msgs, sigs


def _retiring_sets(vset):
    """Eight newer sets that retire ``vset`` and keep all its keys live
    but one: the first holds the rest of it, the others one new key each."""
    rest = type(vset)(vset.validators[1:])
    others = [
        helpers.make_validators(1, key_factory=lambda _, i=i: JPrivKey.from_seed(bytes([200 + i]) * 32))[1]
        for i in range(7)
    ]
    return [rest] + others


def _sequence(activate, verify, clear_results, inject):
    vset, pks, msgs, sigs = _lanes()
    activate(vset)
    want = [i != 3 for i in range(LANES)]
    assert verify(pks, msgs, sigs) == want
    assert verify(pks, msgs, sigs) == want  # the verdict cache answers
    for s in _retiring_sets(vset):
        activate(s)
    clear_results()
    with inject(site="ed25519.chunk", fail_calls=(1,)):
        # the retired key's 2 lanes take the legacy kernel; the injected
        # fault takes the first chunk, the other 18 lanes', to the host
        assert verify(pks, msgs, sigs) == want


def _families(text):
    """{family: (HELP line, TYPE line, {series key without its value})}
    of the tendermint_ops_* families, and {series: value}."""
    fams, values = {}, {}
    for line in text.splitlines():
        m = re.match(r"# (HELP|TYPE) (tendermint_ops_\w+) ", line)
        if m:
            fams.setdefault(m.group(2), ["", "", set()])[0 if m.group(1) == "HELP" else 1] = line
            continue
        if not line.startswith("tendermint_ops_"):
            continue
        series, value = line.rsplit(" ", 1)
        name = re.match(r"(tendermint_ops_\w+?)(_bucket|_sum|_count)?(\{|$)", series).group(1)
        if name not in fams:
            name = re.match(r"tendermint_ops_\w+", series).group(0)
        labels = dict(re.findall(r'(\w+)="([^"]*)"', series))
        if name in SKIP_SERIES or labels.get("owner") in SKIP_OWNERS:
            continue
        labels.pop("le", None)
        fams[name][2].add((series.split("{")[0], tuple(sorted(labels))))
        values[series] = float(value)
    return {k: (h, t, frozenset(s)) for k, (h, t, s) in fams.items()}, values


def test_one_sequence_gives_the_same_ops_exposition(bound):
    jreg, treg, jm, tm = bound
    _sequence(jpc.activate_validator_set,
              lambda p, m, s: jeb.verify_batch(p, m, s),
              jpc.results.clear, jfi.inject)
    _sequence(lambda v: tpc.activate_validator_set(carry.validator_set(v)),
              lambda p, m, s: teb.verify_batch(p, m, s, device="cpu"),
              tpc.results.clear, fault_injection.inject)
    jfams, jvals = _families(jreg.expose())
    tfams, tvals = _families(treg.expose())
    assert set(tfams) == set(jfams) and len(tfams) == 29
    for fam in jfams:
        assert tfams[fam] == jfams[fam], fam
    compared = {s: v for s, v in jvals.items()
                if any(s.startswith("tendermint_ops_" + c) for c in COMPARED)}
    assert compared and {s: tvals.get(s) for s in compared} == compared
    tabled = LANES - 2
    assert tvals['tendermint_ops_device_fallback_lanes_total{engine="ed25519"}'] == tabled
    assert tvals["tendermint_ops_precompute_invalidations_total"] == 1
    assert tvals["tendermint_ops_precompute_builds_total"] == N_SET
    assert tvals["tendermint_ops_result_cache_hits_total"] == LANES
    # degraded by the fault, healthy again once the legacy chunk came back
    assert tvals["tendermint_ops_device_health_state"] == 0
    snap = device_policy.shared.snapshot()
    assert snap["fallback_lanes"]["ed25519"] == tabled and snap["transitions"] == [
        ("healthy", "degraded"), ("degraded", "healthy")]
    for edge in snap["transitions"]:
        series = 'tendermint_ops_device_health_transitions_total{from_state="%s",to_state="%s"}'
        assert tvals[series % edge] == 1
    # the stage histogram counted every stage span, in both packages alike
    stage = {s: v for s, v in tvals.items() if "verify_stage_seconds_count" in s}
    assert stage == {s: v for s, v in jvals.items() if "verify_stage_seconds_count" in s}
    assert stage['tendermint_ops_verify_stage_seconds_count{engine="ed25519",stage="fallback"}'] == 1


def test_unbound_families_read_zero_and_label_sets_are_the_references():
    """The autotune and mesh families have no feeder in the port: they
    read zero (or expose no series when labelled). Every family has the
    reference's kind and label names."""
    treg, jreg = Registry(), JRegistry()
    tm, jm = OpsMetrics(treg), JOpsMetrics(jreg)
    text = treg.expose()
    assert "tendermint_ops_mesh_devices 0" in text
    assert "tendermint_ops_autotune_selections_total{" not in text
    assert text == jreg.expose()
    for name, metric in vars(tm).items():
        twin = getattr(jm, name)
        assert (type(metric).__name__, metric.name, metric.help, metric.label_names) == (
            type(twin).__name__, twin.name, twin.help, twin.label_names)


def test_instruments_match_the_references_text():
    """Counter, Gauge and Histogram render as the reference's, with and
    without exemplars."""
    from tendermint_tpu.libs import metrics as jmetrics

    texts = []
    for reg_cls, c_cls, g_cls, h_cls in (
        (jmetrics.Registry, jmetrics.Counter, jmetrics.Gauge, jmetrics.Histogram),
        (Registry, Counter, Gauge, Histogram),
    ):
        reg = reg_cls()
        c = reg.register(c_cls("c_total", "a counter", ("code",)))
        g = reg.register(g_cls("g", "a gauge", ("engine",)))
        h = reg.register(h_cls("h_seconds", "a histogram", ("stage",), buckets=(0.1, 1.0)))
        c.labels(code='quote " back \\ nl \n').inc(2)
        g.labels(engine="ed25519").set(5)
        g.labels(engine="ed25519").dec(2)
        h.labels(stage="prep").observe(0.05, exemplar={"trace_id": "ab"})
        h.labels(stage="prep").observe(3.0)
        plain = reg.expose()
        rich = reg.expose(exemplars=True)
        # the exemplar's unix time differs between the two calls
        texts.append((plain, re.sub(r" \d+(\.\d+)?$", " T", rich, flags=re.M)))
        assert h.has_exemplars() and ' # {trace_id="ab"} 0.05 ' in rich
    assert texts[0] == texts[1]
    assert Gauge("x", "h").collect() == ["x 0"] and Gauge("y", "h", ("a",)).collect() == []


@pytest.mark.parametrize("site", ["ed25519.chunk", "ed25519.collect"])
def test_an_escaping_fault_leaves_no_lane_in_flight(site, monkeypatch):
    """Host fallback off: a fault escapes ``verify_batch`` with two chunks
    launched, and the in-flight gauge still comes back to 0."""
    monkeypatch.setattr(tendermint_tpu_torch, "DEFAULT_DEVICE", "cpu")
    tpc.reset()
    device_policy.shared.reset()
    tm = OpsMetrics(Registry())
    tops.bind_metrics(tm)
    try:
        vset, pks, msgs, sigs = _lanes()
        tpc.activate_validator_set(carry.validator_set(vset))
        extra = helpers.make_validators(1, key_factory=lambda _: JPrivKey.from_seed(b"\x09" * 32))[0][0]
        pks.append(extra.pub_key().bytes())
        msgs.append(b"no table")
        sigs.append(extra.sign(b"no table"))  # a legacy chunk beside the tables chunk
        with fault_injection.inject(site=site, fail_calls=(2,) if site.endswith("chunk") else (1,)):
            with pytest.raises(fault_injection.DeviceFault):
                teb.verify_batch(pks, msgs, sigs, device="cpu")
        assert tm.inflight_lanes.value(engine="ed25519") == 0
        assert tm.device_failures.value(kind="transient") == 1
    finally:
        tops.bind_metrics(None)
        fault_injection.uninstall()
        device_policy.shared.reset()
        tpc.reset()

"""The port's span tracer (libs/tracing.py) against the JAX package's, on
the CPU.

The 24-validator ``verify_commit`` of ``tests/test_tracing.py`` goes
through both packages, cold then warm (the port on its plain versions):
the same span names, parents and ``stage``/``engine``/``kind``/``hits``
tags, and in each package the stage histogram counts equal its stage
spans. The JAX package also records the ``kernel_compile`` of its
64-lane graph on its first call in a process; the port compiles nothing
on the CPU, so that span is left out of the comparison. Then the twins
of the tracer-only tests (nesting, instants, bounded export, clear, the
ring bound, the off mode, a broken sink, the summary, the file mode)
and one merge of a port export with a JAX export by
``scripts/trace_merge.py``.

Both tracers are process-wide: the fixture puts each back as it found
it (mode, ring size, observer, profile sink, ring contents).
"""

import json
import threading
from collections import deque

import pytest

torch = pytest.importorskip("torch")
# The plain versions run thousands of tiny tensor ops: one intra-op thread
# is fastest, and keeps parallel test workers from oversubscribing cores.
torch.set_num_threads(1)

import tendermint_tpu_torch
from scripts import trace_merge
from tendermint_tpu.libs import tracing as jtracing
from tendermint_tpu.libs.metrics import OpsMetrics as JOpsMetrics, Registry as JRegistry
from tendermint_tpu.ops import precompute as jpc
from tendermint_tpu.types import validation as jval
from tendermint_tpu_torch.crypto import scheduler as tscheduler
from tendermint_tpu_torch.libs import tracing
from tendermint_tpu_torch.libs.metrics import ConsensusMetrics, OpsMetrics, Registry
from tendermint_tpu_torch.ops import ed25519_batch as teb, precompute as tpc
from tendermint_tpu_torch.types import carry, validation as tval
from tests import helpers

N_VALS = 24
HEIGHT, ROUND = 5, 1
TAGS = ("stage", "engine", "kind", "hits", "lanes", "height", "round", "sigs")


def _save(tr):
    return (tr.mode, tr._ring.maxlen, tr._observer, tr._profile, list(tr._ring), tr.dropped)


def _restore(tr, state):
    mode, maxlen, observer, profile, ring, dropped = state
    tr.configure(mode)
    tr.set_metrics_observer(observer)
    tr.set_profile_sink(profile)
    with tr._lock:
        tr._ring = deque(ring, maxlen=maxlen)
        tr.dropped = dropped


@pytest.fixture
def ring():
    """The port's tracer in ring mode with no sink, put back after."""
    saved = _save(tracing.tracer)
    tracing.configure("ring", cap=tracing.DEFAULT_CAP)
    tracing.tracer.clear()
    tracing.tracer.set_metrics_observer(None)
    tracing.tracer.set_profile_sink(None)
    yield tracing.tracer
    _restore(tracing.tracer, saved)


@pytest.fixture
def both_rings(ring, monkeypatch):
    """Both tracers in ring mode; the JAX one put back exactly."""
    saved = _save(jtracing.tracer)
    monkeypatch.delenv(jtracing.CAP_ENV, raising=False)
    jtracing.configure("ring")
    jtracing.tracer.clear()
    jtracing.tracer.set_metrics_observer(None)
    yield jtracing.tracer, ring
    _restore(jtracing.tracer, saved)


@pytest.fixture
def cpu(monkeypatch):
    monkeypatch.setattr(tendermint_tpu_torch, "DEFAULT_DEVICE", "cpu")
    tpc.reset()
    jpc.reset()
    yield
    tpc.reset()
    jpc.reset()


def _spans(events):
    return [e for e in events if e.get("ph") == "X"]


def _tree(events):
    """(name, parent, tags) of each completed span, in completion order;
    the JAX package's kernel_compile (its first graph compile) left out."""
    return [
        (e["name"], e["args"].get("parent"), {k: e["args"][k] for k in TAGS if k in e["args"]})
        for e in _spans(events) if e["name"] != "kernel_compile"
    ]


def _stage_counts(events):
    counts = {}
    for e in _spans(events):
        stage, engine = e["args"].get("stage"), e["args"].get("engine")
        if stage and engine:
            counts[(stage, engine)] = counts.get((stage, engine), 0) + 1
    return counts


def _histogram_counts(ops):
    hist = ops.verify_stage_seconds
    with hist._lock:
        return {(dict(k)["stage"], dict(k)["engine"]): n for k, (_, _, n) in hist._values.items()}


# --- the commit through both packages ---------------------------------------


def test_verify_commit_span_tree_equals_the_jax_packages(both_rings, cpu, monkeypatch):
    jring, tring = both_rings
    monkeypatch.setenv(jpc._RESULT_ENV, "1")  # tests/conftest.py turns it off
    jops, tops = JOpsMetrics(JRegistry()), OpsMetrics(Registry())
    jring.set_metrics_observer(jtracing.metrics_observer(ops=jops))
    tring.set_metrics_observer(tracing.metrics_observer(ops=tops))

    privs, vset = helpers.make_validators(N_VALS)
    block_id = helpers.make_block_id()
    commit = helpers.make_commit(block_id, HEIGHT, ROUND, vset, privs)
    tv, tb, tc = carry.validator_set(vset), carry.block_id(block_id), carry.commit(commit)
    for _ in range(2):  # cold, then every lane answered by the verdict cache
        jval.verify_commit(helpers.CHAIN_ID, vset, block_id, HEIGHT, commit)
        tval.verify_commit(helpers.CHAIN_ID, tv, tb, HEIGHT, tc)
    jevents, tevents = jring.export()["traceEvents"], tring.events()

    assert _tree(tevents) == _tree(jevents)
    names = [name for name, _, _ in _tree(tevents)]
    assert names.count("verify_commit") == 2 and names.count("dispatch_chunk") == 1
    lookups = [tags for name, _, tags in _tree(tevents) if name == "cache_lookup"]
    assert [t["hits"] for t in lookups] == [0, N_VALS]
    # one trace a commit: every span of a pass shares its verify_commit's trace
    by_id = {e["span_id"]: e for e in _spans(tevents)}
    for e in _spans(tevents):
        if e["name"] != "verify_commit":
            assert by_id[e["parent_span_id"]]["trace_id"] == e["trace_id"]
    # one clock, one count, in each package
    assert _histogram_counts(tops) == _stage_counts(tevents)
    assert _histogram_counts(jops) == _stage_counts(jevents)
    assert _stage_counts(tevents) == _stage_counts(jevents)


def test_light_commit_span_is_tagged_light(ring, cpu):
    privs, vset = helpers.make_validators(N_VALS)
    block_id = helpers.make_block_id(b"light")
    commit = helpers.make_commit(block_id, HEIGHT, 0, vset, privs)
    tval.verify_commit_light(helpers.CHAIN_ID, carry.validator_set(vset), carry.block_id(block_id),
                             HEIGHT, carry.commit(commit))
    (vc,) = [e for e in _spans(ring.events()) if e["name"] == "verify_commit"]
    assert vc["args"] == {"mode": "light", "height": HEIGHT, "round": 0, "sigs": N_VALS}


def test_tracing_off_changes_no_verdicts(cpu):
    privs, vset = helpers.make_validators(8)
    block_id = helpers.make_block_id(b"off-mode")
    commit = helpers.make_commit(block_id, 3, 0, vset, privs)
    args = (helpers.CHAIN_ID, carry.validator_set(vset), carry.block_id(block_id), 3,
            carry.commit(commit))
    saved = _save(tracing.tracer)
    try:
        tracing.configure("off")
        tracing.tracer.set_metrics_observer(None)
        tracing.tracer.set_profile_sink(None)
        tracing.tracer.clear()
        tval.verify_commit(*args)  # no raise
        assert len(tracing.tracer) == 0
        tracing.configure("ring")
        tval.verify_commit(*args)
        assert len(tracing.tracer) > 0
    finally:
        _restore(tracing.tracer, saved)


# --- the tracer alone: twins of tests/test_tracing.py -------------------------


def test_nested_spans_record_parent_and_args(ring):
    with tracing.span("outer", height=7):
        with tracing.span("inner", stage="prep", engine="ed25519") as sp:
            sp.set(lanes=42)
    out = ring.export()
    events = {e["name"]: e for e in _spans(out["traceEvents"])}
    assert set(events) == {"outer", "inner"}
    assert events["outer"]["args"]["height"] == 7 and "parent" not in events["outer"]["args"]
    assert events["inner"]["args"]["parent"] == "outer" and events["inner"]["args"]["lanes"] == 42
    inner, outer = events["inner"], events["outer"]
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 1e-3
    assert out["displayTimeUnit"] == "ms" and out["otherData"]["mode"] == "ring"
    assert out["otherData"]["epoch_unix_us"] > 0


def test_instant_events(ring):
    tracing.instant("device_health_transition", from_state="healthy")
    (ev,) = ring.export()["traceEvents"][-1:]
    assert ev["ph"] == "i" and ev["s"] == "p" and ev["args"]["from_state"] == "healthy"


def test_export_is_valid_bounded_json(ring):
    for i in range(10):
        with tracing.span("s", i=i):
            pass
    out = ring.export(limit=4)
    assert [e["args"]["i"] for e in _spans(out["traceEvents"])] == [6, 7, 8, 9]
    assert json.loads(json.dumps(out)) == out
    streamed = json.loads(b"".join(ring.export_chunks(limit=4)))
    assert _spans(streamed["traceEvents"]) == _spans(out["traceEvents"])
    chrome = json.loads(b"".join(ring.export_chunks(fmt="chrome")))
    assert set(chrome["otherData"]) == {"epoch_unix_us"}
    assert len(_spans(chrome["traceEvents"])) == 10


def test_export_clear_drains_ring(ring):
    with tracing.span("s"):
        pass
    assert len(ring) == 1
    ring.export(clear=True)
    assert len(ring) == 0


def test_concurrent_threads_yield_well_nested_untorn_output(ring):
    n_threads, n_iters = 6, 25
    barrier = threading.Barrier(n_threads)
    errors = []

    def work(t):
        try:
            barrier.wait(timeout=10)
            for i in range(n_iters):
                with tracing.span(f"outer-{t}", t=t, i=i):
                    with tracing.span(f"inner-{t}", t=t, i=i):
                        pass
        except Exception as exc:  # pragma: no cover
            errors.append(exc)

    threads = [threading.Thread(target=work, args=(t,)) for t in range(n_threads)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=30)
    assert not errors
    out = ring.export()
    events = _spans(out["traceEvents"])
    assert len(events) == n_threads * n_iters * 2
    assert json.loads(json.dumps(out)) == out
    for ev in events:
        t = ev["args"]["t"]
        if ev["name"].startswith("inner"):
            assert ev["args"]["parent"] == f"outer-{t}"
        else:
            assert "parent" not in ev["args"]
    by_tid = {}
    for ev in events:
        by_tid.setdefault(ev["tid"], set()).add(ev["args"]["t"])
    assert all(len(owners) == 1 for owners in by_tid.values())


def test_ring_bound_enforced(ring):
    tracing.configure("ring", cap=8)
    for i in range(20):
        with tracing.span("s", i=i):
            pass
    assert len(tracing.tracer) == 8 and tracing.tracer.cap == 8
    out = tracing.tracer.export()
    assert [e["args"]["i"] for e in _spans(out["traceEvents"])] == list(range(12, 20))
    assert out["otherData"]["dropped"] == 12


def test_nop_tracer_adds_no_spans():
    saved = _save(tracing.tracer)
    try:
        tracing.tracer.set_metrics_observer(None)
        tracing.tracer.set_profile_sink(None)
        tracing.configure("off")
        tracing.tracer.clear()
        before = tracing.tracer.recorded
        for _ in range(100):
            with tracing.span("hot", lanes=1) as sp:
                sp.set(x=1)
            tracing.instant("tick")
        assert tracing.tracer.recorded == before and len(tracing.tracer) == 0
        assert tracing.span("hot") is tracing.NOP_SPAN
    finally:
        _restore(tracing.tracer, saved)


@pytest.mark.parametrize("slot", ["set_metrics_observer", "set_profile_sink"])
def test_off_mode_with_a_sink_times_spans_without_storing(slot):
    seen = []
    saved = _save(tracing.tracer)
    try:
        tracing.configure("off")
        tracing.tracer.clear()
        getattr(tracing.tracer, slot)(lambda name, args, sec: seen.append((name, dict(args), sec)))
        with tracing.span("stage_span", stage="prep", engine="ed25519"):
            pass
        assert len(tracing.tracer) == 0
        ((name, args, sec),) = seen
        assert name == "stage_span" and args["stage"] == "prep" and sec >= 0.0
    finally:
        _restore(tracing.tracer, saved)


@pytest.mark.parametrize("slot", ["set_metrics_observer", "set_profile_sink"])
def test_broken_sink_never_fails_the_traced_op(ring, slot):
    def boom(name, args, sec):
        raise RuntimeError("broken sink")

    getattr(ring, slot)(boom)
    with tracing.span("s"):
        pass
    assert len(ring) == 1


def test_summary_groups_by_stage_tag(ring):
    for _ in range(3):
        with tracing.span("prep_chunk", stage="prep", engine="ed25519"):
            pass
    with tracing.span("verify_batch", engine="ed25519"):
        pass
    s = ring.summary()
    assert s["prep"]["count"] == 3 and s["verify_batch"]["count"] == 1
    for row in s.values():
        assert row["total_ms"] >= row["p50_ms"] >= 0


def test_metrics_observer_feeds_the_stage_histogram_and_refuses_consensus():
    reg = Registry()
    ops = OpsMetrics(reg)
    obs = tracing.metrics_observer(ops=ops)
    obs("prep_chunk", {"stage": "prep", "engine": "ed25519"}, 0.001)
    obs("verify_batch", {"engine": "ed25519"}, 0.003)  # no stage: not observed
    assert 'tendermint_ops_verify_stage_seconds_count{engine="ed25519",stage="prep"} 1' in reg.expose()
    assert ops.verify_stage_seconds.count(stage="prep", engine="ed25519") == 1
    # the consensus half, once refused, is ported: spans tagged "step"
    # feed the step histogram, as in the JAX package
    cons = ConsensusMetrics(reg)
    obs = tracing.metrics_observer(ops=ops, consensus=cons)
    obs("prevote", {"step": "prevote", "height": 1}, 0.002)
    obs("prep_chunk", {"stage": "prep", "engine": "ed25519"}, 0.001)
    assert cons.step_duration_seconds.count(step="prevote") == 1
    assert ops.verify_stage_seconds.count(stage="prep", engine="ed25519") == 2
    assert 'tendermint_consensus_step_duration_seconds_count{step="prevote"} 1' in reg.expose()


def test_file_mode_flush_writes_chrome_trace(tmp_path):
    path = tmp_path / "trace.json"
    saved = _save(tracing.tracer)
    tracing.configure(str(path))
    try:
        assert tracing.tracer.mode == str(path) and tracing.tracer.enabled
        with tracing.span("flushed", k="v"):
            pass
        assert tracing.tracer.flush() == str(path)
        doc = json.loads(path.read_text())
        assert any(e.get("name") == "flushed" for e in doc["traceEvents"])
    finally:
        _restore(tracing.tracer, saved)


def test_trace_context_wire_forms_equal_the_jax_packages():
    ctx = tracing.TraceContext("0123456789abcdef", "fedcba9876543210", 1)
    jctx = jtracing.TraceContext(*ctx)
    assert ctx.to_header() == jctx.to_header() and ctx.to_bytes() == jctx.to_bytes()
    assert tracing.TraceContext.from_header(ctx.to_header()) == ctx
    assert tracing.TraceContext.from_bytes(ctx.to_bytes()) == ctx
    for junk in (None, 7, "", "a-b-c", "0123456789abcdef-zz23456789abcdef-01",
                 "0123456789abcdef-fedcba9876543210-xy"):
        assert tracing.TraceContext.from_header(junk) is None
        assert jtracing.TraceContext.from_header(junk) is None
    assert tracing.TraceContext.from_bytes(b"\x00" * 17) is None
    assert tracing.TraceContext.from_bytes(b"short") is None


def test_attach_links_a_remote_parent(ring):
    ctx = tracing.TraceContext("00000000000000aa", "00000000000000bb", 1)
    with tracing.attach(ctx):
        with tracing.span("child"):
            assert tracing.current_context().trace_id == ctx.trace_id
    (ev,) = _spans(ring.events())
    assert ev["trace_id"] == ctx.trace_id and ev["parent_span_id"] == ctx.span_id
    assert ev["args"]["parent"] == "remote"


def test_a_port_export_and_a_jax_export_merge_into_one_timeline(both_rings, cpu):
    """A caller in the JAX package and a server in the port: the port's
    spans opened under the caller's context land after it on one
    merged timeline. The JAX package's own chrome export carries no
    epoch anchor, so the merge skips it."""
    jring, tring = both_rings
    with jtracing.span("client_call") as call:
        ctx = tracing.TraceContext.from_header(call.context().to_header())
    with tracing.attach(ctx):
        with tracing.span("rpc_dispatch", method="light_header"):
            teb.verify_batch(*_lanes(4), device="cpu")
    port_doc = json.loads(b"".join(tring.export_chunks(fmt="chrome")))
    jax_doc = jring.export()
    merged = trace_merge.merge([jax_doc, port_doc])
    assert merged["otherData"]["merged_from"] == 2 and merged["otherData"]["skipped"] == 0
    (client,) = trace_merge.spans_named(merged, "client_call")
    (dispatch,) = trace_merge.spans_named(merged, "rpc_dispatch")
    (vb,) = trace_merge.spans_named(merged, "verify_batch")
    assert trace_merge.is_ancestor(merged, client["span_id"], vb["span_id"])
    assert dispatch["trace_id"] == vb["trace_id"] == client["trace_id"]
    assert dispatch["ts"] >= client["ts"]
    jax_chrome = json.loads(b"".join(jring.export_chunks(fmt="chrome")))
    assert trace_merge.merge([jax_chrome, port_doc])["otherData"]["skipped"] == 1


def _lanes(n):
    from tendermint_tpu_torch.crypto import ed25519_ref as ref

    priv, pub = ref.keypair_from_seed(b"\x05" * 32)
    msgs = [b"merge %d" % i for i in range(n)]
    return [pub] * n, msgs, [ref.sign(priv, m) for m in msgs]


def test_scheduler_flush_carries_the_submitters_trace(ring, cpu):
    sched = tscheduler.VerifyScheduler(
        lambda pks, ms, sgs: teb.verify_batch(pks, ms, sgs, device="cpu"), max_delay=0.01
    )
    sched.start()
    try:
        with tracing.span("caller") as call:
            pks, msgs, sigs = _lanes(1)
            assert sched.verify(pks[0], msgs[0], sigs[0])
    finally:
        sched.stop()
    events = _spans(ring.events())
    (vb,) = [e for e in events if e["name"] == "verify_batch"]
    assert vb["args"]["parent"] == "sched_flush" and vb["trace_id"] == call.trace_id

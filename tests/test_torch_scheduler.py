"""The port's verify scheduler (``crypto/scheduler.py``) and its dynamic
batch controller (``crypto/adaptive.py``) against the JAX package's.

Both schedulers get the same submissions and the same host
``verify_fn``; the flush boundaries are made deterministic by firing
flushes by size from one atomic ``submit_many`` (or by a wire deadline
well inside the tests' waits), so each case compares what does not
depend on thread timing: the verdicts, the verify calls' lanes, the
coalesced counts, the flush reasons and the order within one flush. The
controllers get one ``observe_flush`` sequence under a fake clock. The
shared scheduler's host fallback is held to the port's rule: off unless
``device_policy.shared.host_fallback`` is set, and counted when on.
"""

import threading
import time

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import tendermint_tpu_torch
from tendermint_tpu.crypto import adaptive as jadaptive
from tendermint_tpu.crypto import scheduler as jsched
from tendermint_tpu.libs import tracing as jtracing
from tendermint_tpu_torch.crypto import adaptive as tadaptive
from tendermint_tpu_torch.crypto import batch as tbatch
from tendermint_tpu_torch.crypto import ed25519_ref as tref
from tendermint_tpu_torch.crypto import scheduler as tsched
from tendermint_tpu_torch.libs import tracing as ttracing
from tendermint_tpu_torch.ops import device_policy, fault_injection
from tendermint_tpu_torch.ops import precompute as tpc

PACKAGES = {"jax": jsched, "port": tsched}
WAIT = 5.0  # every verdict here arrives in well under a second
# a flush of 16 lanes through the port's engine on the CPU takes about a
# second on an idle runner
SHARED_WAIT = 10.0


class Recorder:
    """A host ``verify_fn``: a lane is valid when its signature is the
    reverse of its message; every call's lanes are kept."""

    def __init__(self):
        self.calls = []
        self._mtx = threading.Lock()

    def __call__(self, pks, msgs, sigs):
        with self._mtx:
            self.calls.append(list(zip(pks, msgs, sigs)))
        return [s == m[::-1] for m, s in zip(msgs, sigs)]


def _lane(i, good=True):
    msg = b"msg-%03d" % i
    return (b"pk-%03d" % (i % 5), msg, msg[::-1] if good else b"bad")


def _lanes(n, bad=(), dup_of=None):
    """``n`` lanes; lanes in ``bad`` carry a wrong signature and each
    ``j: i`` of ``dup_of`` makes lane j a copy of lane i."""
    out = [_lane(i, good=i not in bad) for i in range(n)]
    for j, i in (dup_of or {}).items():
        out[j] = out[i]
    return out


def _outcome(mod, lanes, groups=None, **kw):
    """Submit ``lanes`` in one ``submit_many`` (or one call per group of
    ``(lanes, priority)``) and wait; returns the verdicts, the verify
    calls and the counters."""
    rec = Recorder()
    s = mod.VerifyScheduler(rec, **kw)
    s.start()
    try:
        if groups is None:
            entries = s.submit_many(lanes)
        else:
            entries = []
            for group, prio in groups:
                entries += s.submit_many(group, priority=prio)
        oks = s.wait_many(entries, timeout=WAIT)
        assert all(e.done.is_set() for e in entries)
        stats = s.stats()
    finally:
        s.stop()
    return oks, rec.calls, stats


@pytest.mark.parametrize("continuous", [False, True], ids=["barrier", "continuous"])
def test_verdicts_coalescing_and_size_flushes_match(continuous):
    # 20 lanes, max_batch 8: two size flushes of 8 and a deadline flush
    # of 4. Lanes 3 and 11 coalesce with 1 and 9 (same flush); lane 17
    # copies lane 2 in another flush, so it is a lane of its own there.
    lanes = _lanes(20, bad={5, 9, 14}, dup_of={3: 1, 11: 9, 17: 2})
    got = {name: _outcome(mod, lanes, max_batch=8, max_delay=0.05, continuous=continuous)
           for name, mod in PACKAGES.items()}
    oks, calls, stats = got["port"]
    assert got["jax"][0] == oks
    assert oks == [m[::-1] == s for _, m, s in lanes]
    # the workers of the continuous path may run the two size flushes in
    # either order; their lanes may not differ
    assert sorted(got["jax"][1]) == sorted(calls)
    assert sorted(len(c) for c in calls) == [4, 7, 7]
    for key in ("flushes", "entries_verified", "entries_coalesced", "flush_errors",
                "fallback_flushes", "flush_reasons"):
        assert got["jax"][2][key] == stats[key], key
    assert stats["entries_coalesced"] == 2
    assert stats["flush_reasons"] == {"size": 2, "deadline": 1, "shutdown": 0}


def test_priority_order_within_one_flush_matches():
    # 6 rpc-class lanes, then 6 consensus-class ones: 12 pending against
    # max_batch 8, so the first flush takes the 6 consensus lanes first
    # (lower value first), then the 2 oldest rpc lanes.
    rpc = [_lane(i) for i in range(6)]
    consensus = [_lane(100 + i) for i in range(6)]
    got = {name: _outcome(mod, None, groups=[(rpc, 3), (consensus, 0)], max_batch=8,
                          max_delay=0.05, continuous=False)
           for name, mod in PACKAGES.items()}
    calls = got["port"][1]
    assert got["jax"][1] == calls
    assert calls[0] == consensus + rpc[:2]
    assert calls[1] == rpc[2:]
    assert got["jax"][0] == got["port"][0] == [True] * 12


def test_flush_by_pulls_the_deadline_in_both():
    got = {}
    for name, mod in PACKAGES.items():
        rec = Recorder()
        s = mod.VerifyScheduler(rec, max_batch=64, max_delay=30.0)
        s.start()
        try:
            t0 = time.monotonic()
            entry = s.submit(*_lane(1), flush_by=t0 + 0.05)
            assert s.wait(entry, timeout=WAIT)
            got[name] = (time.monotonic() - t0 < WAIT, s.stats()["flush_reasons"])
        finally:
            s.stop()
    assert got["jax"] == got["port"] == (True, {"size": 0, "deadline": 1, "shutdown": 0})


def test_saturation_past_max_pending_matches():
    got = {}
    for name, mod in PACKAGES.items():
        s = mod.VerifyScheduler(Recorder(), max_batch=64, max_delay=30.0, max_pending=4)
        s.start()
        errors = []
        try:
            entries = [s.submit(*_lane(i)) for i in range(4)]
            with pytest.raises(mod.SchedulerSaturatedError) as one:
                s.submit(*_lane(4))
            with pytest.raises(mod.SchedulerSaturatedError) as group:
                s.submit_many([_lane(5), _lane(6)])
            errors = [str(one.value), str(group.value)]
        finally:
            s.stop()
        # stop() fails the pending lanes closed rather than hanging them
        got[name] = (errors, s.wait_many(entries, timeout=WAIT), s.stats())
    assert got["jax"][:2] == got["port"][:2]
    assert got["port"][0] == ["verify queue full (4 pending)"] * 2
    assert got["port"][1] == [False] * 4
    for key in ("submit_rejections", "flush_reasons", "flushes"):
        assert got["jax"][2][key] == got["port"][2][key], key
    assert got["port"][2]["submit_rejections"] == 2


@pytest.mark.parametrize("with_fallback", [False, True], ids=["closed", "fallback"])
def test_a_raising_verify_fn_fails_closed_or_falls_back_alike(with_fallback):
    def boom(pks, msgs, sigs):
        raise RuntimeError("device gone")

    lanes = _lanes(6, bad={2})
    got = {}
    for name, mod in PACKAGES.items():
        kw = {"fallback_fn": Recorder()} if with_fallback else {}
        s = mod.VerifyScheduler(boom, max_batch=6, max_delay=30.0, **kw)
        s.start()
        try:
            entries = s.submit_many(lanes)
            oks = s.wait_many(entries, timeout=WAIT)
            stats = s.stats()
        finally:
            s.stop()
        got[name] = (oks, stats["flush_errors"], stats["fallback_flushes"])
    want = ([True, True, False, True, True, True], 1, 1) if with_fallback else ([False] * 6, 1, 0)
    assert got["jax"] == got["port"] == want
    # only the port's handles say why a lane reads False: the verifier's
    # exception where the flush failed closed, nothing where the
    # fallback answered it
    errors = {str(e.error) if e.error is not None else None for e in entries}
    assert errors == ({None} if with_fallback else {"device gone"})


def test_a_misbehaving_verifier_and_a_stop_leave_the_error_on_the_lanes():
    s = tsched.VerifyScheduler(lambda p, m, g: [True], max_batch=3, max_delay=30.0)
    s.start()
    try:
        short = s.submit_many(_lanes(3))
        assert s.wait_many(short, timeout=WAIT) == [False] * 3
        assert {str(e.error) for e in short} == {"verifier returned 1 verdicts for 3 lanes"}
        stranded = s.submit_many(_lanes(2))  # under max_batch and a 30 s deadline
    finally:
        s.stop()
    assert s.wait_many(stranded, timeout=WAIT) == [False] * 2
    assert {str(e.error) for e in stranded} == {"scheduler stopped before the lane was verified"}


@pytest.mark.parametrize("continuous", [False, True], ids=["barrier", "continuous"])
def test_a_one_flush_group_is_never_split_at_max_batch(continuous):
    """The port's ``one_flush`` group: a size flush that takes part of
    it takes all of it, past ``max_batch``; lanes outside the group
    still flush in ``max_batch`` cuts, and without the option the port
    cuts a group as the reference does."""
    lanes = _lanes(20, bad={7}, dup_of={19: 3})
    cut = _outcome(tsched, lanes, max_batch=8, max_delay=0.05, continuous=continuous)
    jcut = _outcome(jsched, lanes, max_batch=8, max_delay=0.05, continuous=continuous)
    assert sorted(len(c) for c in cut[1]) == sorted(len(c) for c in jcut[1]) == [4, 8, 8]
    rec = Recorder()
    s = tsched.VerifyScheduler(rec, max_batch=8, max_delay=30.0, continuous=continuous)
    s.start()
    try:
        oks = s.wait_many(s.submit_many(lanes, one_flush=True), timeout=WAIT)
        stats = s.stats()
    finally:
        s.stop()
    assert oks == [i != 7 for i in range(20)]
    assert [len(c) for c in rec.calls] == [19]  # one flush, lane 19 coalesced into lane 3's
    assert (stats["flushes"], stats["entries_coalesced"], stats["flush_reasons"]["size"]) == (1, 1, 1)


def test_resolved_knobs_match_for_static_and_dynamic():
    for kw in ({}, {"max_batch": 32, "max_delay": 0.01, "pipeline_depth": 3},
               {"dyn_batch": True, "continuous": False}):
        j, t = jsched.VerifyScheduler(Recorder(), **kw), tsched.VerifyScheduler(Recorder(), **kw)
        jk, tk = j.resolved_knobs(), t.resolved_knobs()
        assert jk == tk, kw
    assert tsched.default_max_batch() == tsched.DEFAULT_MAX_BATCH == 256


class FakeClock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


# (lanes, residency s, device s, slack s or None, static delay s, advance s)
FLUSHES = (
    [(64, 0.001, 0.002, 0.05, 0.002, 0.1)] * 4  # cold buckets: no grow vote yet
    + [(64, 0.001, 0.002, 0.05, 0.002, 0.3)] * 6  # warm: grow votes, steps past the dwell
    + [(128, 0.001, 0.004, 0.05, 0.002, 0.05)] * 4  # dwell gates the next step
    + [(128, 0.002, 0.004, -0.01, 0.002, 0.3)] * 7  # blown slack: shrink votes
    + [(32, 0.0005, 0.001, None, 0.002, 0.3)] * 5  # no wire deadline: max_delay is the slack
)


def test_controller_trajectory_matches():
    trajectories = {}
    for name, mod in (("jax", jadaptive), ("port", tadaptive)):
        clock = FakeClock()
        ctl = mod.DynBatchController(clock=clock)
        steps = []
        for i, (lanes, res, dev, slack, delay, adv) in enumerate(FLUSHES):
            clock.t += adv
            if i == 18:
                ctl.note_queue_wait(0.004)  # the shrink signal from the caller
            ctl.observe_flush(lanes, res, dev, slack, delay)
            steps.append((ctl.snapshot(), ctl.limits(256, 0.002)))
        trajectories[name] = steps
    assert trajectories["jax"] == trajectories["port"]
    snaps = [s for s, _ in trajectories["port"]]
    assert snaps[-1]["steps_up"] >= 1 and snaps[-1]["steps_down"] >= 1


@pytest.fixture()
def ring_tracers():
    jmode, tmode = jtracing.tracer.mode, ttracing.tracer.mode
    jtracing.configure("ring")
    ttracing.configure("ring")
    jtracing.tracer.clear()
    ttracing.tracer.clear()
    yield
    jtracing.tracer.clear()
    ttracing.tracer.clear()
    jtracing.configure(jmode)
    ttracing.configure(tmode)


def _span_shape(events):
    """The scheduler's spans, by name, with the tags that do not depend
    on timing, in completion order."""
    names = ("scheduler_dispatch", "sched_assemble", "sched_flush")
    return [(e["name"], {k: v for k, v in e["args"].items() if k != "depth"})
            for e in events if e.get("ph") == "X" and e["name"] in names]


def test_ring_mode_records_the_same_scheduler_spans(ring_tracers):
    lanes = _lanes(8, dup_of={7: 0})
    for mod in PACKAGES.values():
        _outcome(mod, lanes, max_batch=8, max_delay=30.0, continuous=False)
    jevents = jtracing.tracer.export()["traceEvents"]
    tevents = ttracing.tracer.events()
    assert _span_shape(jevents) == _span_shape(tevents) == [
        ("sched_assemble", {"lanes": 8, "unique": 7, "coalesced": 1, "parent": "scheduler_dispatch"}),
        ("sched_flush", {"lanes": 7, "reason": "size", "parent": "scheduler_dispatch"}),
        ("scheduler_dispatch", {"lanes": 8, "reason": "size"}),
    ]
    # the port's spans nest by trace and span id, as the reference's do
    by_name = {e["name"]: e for e in tevents if e.get("ph") == "X"}
    root = by_name["scheduler_dispatch"]
    for child in ("sched_assemble", "sched_flush"):
        assert by_name[child]["trace_id"] == root["trace_id"]
        assert by_name[child]["parent_span_id"] == root["span_id"]


def test_off_mode_hands_out_the_shared_no_op_span():
    assert ttracing.tracer.mode == "off"
    with ttracing.span("x", lanes=1) as sp:
        sp.set(y=2)
    assert sp is ttracing.NOP_SPAN and ttracing.current_context() is None
    assert len(ttracing.tracer) == 0


# --- the shared scheduler's host fallback -----------------------------------


@pytest.fixture()
def shared(monkeypatch):
    """A fresh shared scheduler on the CPU, a pristine health machine,
    and 16 valid lanes of two keys (a device-tier flush)."""
    monkeypatch.setattr(tendermint_tpu_torch, "DEFAULT_DEVICE", "cpu")
    monkeypatch.setattr(tbatch, "_shared_scheduler", None)
    health = device_policy.DeviceHealth()
    monkeypatch.setattr(device_policy, "shared", health)
    tpc.reset()
    keys = [tref.keypair_from_seed(bytes([i + 1]) * 32) for i in range(2)]
    msgs = [b"shared-%02d" % i for i in range(16)]
    lanes = [(keys[i % 2][1], m, tref.sign(keys[i % 2][0], m)) for i, m in enumerate(msgs)]
    sched = tbatch.get_shared_scheduler()
    yield sched, health, lanes
    sched.stop()
    fault_injection.uninstall()
    tpc.reset()


def test_shared_scheduler_defaults_and_a_healthy_flush(shared):
    sched, health, lanes = shared
    assert tbatch.get_shared_scheduler() is sched
    assert sched.resolved_knobs() == {
        "max_batch": 256, "max_delay": 0.002, "static_max_batch": 256,
        "static_max_delay": 0.002, "pipeline_depth": 2, "continuous": True, "dyn_batch": False}
    assert sched.wait_many(sched.submit_many(lanes), timeout=SHARED_WAIT) == [True] * 16
    assert sched.stats()["flush_errors"] == 0
    assert health.snapshot()["fallback_batches"] == 0


def test_shared_scheduler_fails_closed_on_a_device_fault_with_fallback_off(shared):
    sched, health, lanes = shared
    assert health.host_fallback is False
    with fault_injection.inject(site="ed25519.chunk", fail_calls=(1,)):
        entries = sched.submit_many(lanes)
        oks = sched.wait_many(entries, timeout=SHARED_WAIT)
    stats = sched.stats()
    assert oks == [False] * 16
    assert all(isinstance(e.error, fault_injection.DeviceFault) for e in entries)
    assert (stats["flush_errors"], stats["fallback_flushes"]) == (1, 0)
    snap = health.snapshot()
    # the engine recorded the fault; nothing was answered on the host
    assert snap["failures"]["transient"] == 1 and snap["fallback_batches"] == 0


def test_shared_scheduler_answers_on_the_host_only_when_allowed_and_counts_it(shared, monkeypatch):
    sched, health, lanes = shared
    from tendermint_tpu_torch import ops

    def escaped(pks, msgs, sigs, device=None):
        raise RuntimeError("a fault outside the engine's chunk handling")

    monkeypatch.setattr(ops, "verify_batch", escaped)
    assert sched.wait_many(sched.submit_many(lanes), timeout=SHARED_WAIT) == [False] * 16
    health.host_fallback = True
    lanes[3] = (lanes[3][0], lanes[3][1], lanes[4][2])  # one bad signature
    oks = sched.wait_many(sched.submit_many(lanes), timeout=SHARED_WAIT)
    assert oks == [i != 3 for i in range(16)]
    stats = sched.stats()
    assert (stats["flush_errors"], stats["fallback_flushes"]) == (2, 1)
    assert health.snapshot()["fallback_lanes"]["ed25519"] == 16


def test_host_tier_shares_the_verdict_cache(shared):
    sched, health, lanes = shared
    small = lanes[:3]
    before = dict(tbatch.tier_lanes)
    assert sched.wait_many(sched.submit_many(small), timeout=SHARED_WAIT) == [True] * 3
    assert sched.wait_many(sched.submit_many(small), timeout=SHARED_WAIT) == [True] * 3
    got = {k: tbatch.tier_lanes[k] - before[k] for k in before}
    # the second delivery of the same lanes is answered by the cache
    assert got == {"host": 6, "host_cached": 3, "device": 0}
    assert tpc.results.stats()["entries"] == 3


def test_shared_scheduler_without_cuda_fails_closed(monkeypatch):
    """The flush target resolves the package's device at flush time:
    without CUDA it raises, and the flush fails closed instead of
    running on the CPU."""
    monkeypatch.setattr(tendermint_tpu_torch, "DEFAULT_DEVICE", "cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(tbatch, "_shared_scheduler", None)
    sched = tbatch.get_shared_scheduler()
    try:
        assert sched.wait_many(sched.submit_many([_lane(1)]), timeout=WAIT) == [False]
        assert sched.stats()["flush_errors"] == 1
    finally:
        tbatch.shutdown_shared_scheduler()
    assert tbatch._shared_scheduler is None

"""The port's device health machine (ops/device_policy.py) and fault
injection (ops/fault_injection.py): the twin of tests/test_device_policy.py.

Covers the states, the retry budget, the cooldown and its capped
backoff, the single half-open probe under concurrency; the CUDA failure
classes (sticky errors permanent, out of memory transient, a kernel that
does not build re-raised and never counted); fault plans; transient and
permanent faults through both engines on the CPU, with every verdict
right and the host-fallback lanes counted per engine when host fallback
is on; and, with it off (the default), every device failure raised
after the machine recorded it.
"""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import tendermint_tpu_torch
from tendermint_tpu_torch.crypto import ed25519_ref as ref, sr25519 as tsr
from tendermint_tpu_torch.ops import _build, cuda_verify, device_policy, fault_injection
from tendermint_tpu_torch.ops import ed25519_batch as teb, precompute as tpc, sr25519_batch as tsb
from tendermint_tpu_torch.ops.device_policy import (
    COOLDOWN,
    DEGRADED,
    DISABLED,
    HEALTHY,
    PERMANENT,
    TRANSIENT,
    DeviceHealth,
    classify_failure,
)


class FakeClock:
    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


@pytest.fixture(autouse=True)
def _pristine(monkeypatch):
    monkeypatch.setattr(tendermint_tpu_torch, "DEFAULT_DEVICE", "cpu")
    fault_injection.uninstall()
    device_policy.shared.reset()
    tpc.reset()
    yield
    fault_injection.uninstall()
    device_policy.shared.reset()
    tpc.reset()


# --- classification ---------------------------------------------------------------


@pytest.mark.parametrize("code", sorted(_build.STICKY_CODES))
def test_sticky_cuda_codes_are_permanent(code):
    err = _build.CudaError("ed25519_verify_launch", code)
    assert err.code == code and err.permanent
    assert f"CUDA error {code}" in str(err)
    assert classify_failure(err) == PERMANENT


@pytest.mark.parametrize("code", [1, 2, 98, 209, 701, 999])
def test_other_cuda_codes_are_transient(code):
    """Out of memory (2), an invalid value, a refused launch (701: too
    many resources) and the rest leave the context usable."""
    assert classify_failure(_build.CudaError("sr25519_verify_launch", code)) == TRANSIENT


@pytest.mark.parametrize("msg", [
    "CUDA error: an illegal memory access was encountered\nCUDA kernel errors might be "
    "asynchronously reported at some other API call",
    "CUDA error: the launch timed out and was terminated",
    "CUDA error: device-side assert triggered",
    "CUDA error: hardware stack error",
    "CUDA error: an illegal instruction was encountered",
    "CUDA error: misaligned address",
    "CUDA error: invalid program counter",
    "CUDA error: unspecified launch failure",
    "No CUDA GPUs are available",
    "Found no NVIDIA driver on your system. Please check that you have an NVIDIA GPU",
    "CUDA driver version is insufficient for CUDA runtime version",
])
def test_torch_texts_of_sticky_and_no_device_errors_are_permanent(msg):
    assert classify_failure(RuntimeError(msg)) == PERMANENT
    assert device_policy.classify_failure_text(msg) == PERMANENT


@pytest.mark.parametrize("msg", [
    "CUDA out of memory. Tried to allocate 2.00 GiB",
    "CUDA error: out of memory",
    "a launch of the cuda kernel was slow",
    "illegal value in argument 3 of the launcher",
    "device timed out waiting for the host",
    "",
])
def test_other_errors_stay_transient(msg):
    assert classify_failure(RuntimeError(msg)) == TRANSIENT


def test_oom_import_error_and_explicit_attribute():
    assert classify_failure(torch.cuda.OutOfMemoryError("CUDA out of memory")) == TRANSIENT
    assert classify_failure(ImportError("no module named torch")) == PERMANENT
    assert classify_failure(ValueError("shape mismatch")) == TRANSIENT
    assert classify_failure(fault_injection.DeviceFault("x", permanent=True)) == PERMANENT
    err = RuntimeError("CUDA error: misaligned address")
    err.permanent = False  # an explicit attribute wins over the text
    assert classify_failure(err) == TRANSIENT


# --- the state machine (fake clock, no device) -------------------------------------


def test_transient_failures_ride_degraded_until_budget():
    h = DeviceHealth(retry_budget=3, cooldown_base=1.0, clock=FakeClock())
    for _ in range(2):
        assert h.begin_attempt() is not None
        h.record_failure(RuntimeError("flaky launch"))
        assert h.state == DEGRADED
    a = h.begin_attempt()
    assert a is not None and not a.probe
    h.record_failure(RuntimeError("flaky launch"), a)  # budget spent
    assert h.state == COOLDOWN
    assert h.transitions == [(HEALTHY, DEGRADED), (DEGRADED, COOLDOWN)]


def test_cooldown_answers_at_once_then_admits_one_probe():
    clk = FakeClock()
    h = DeviceHealth(retry_budget=1, cooldown_base=2.0, clock=clk)
    h.record_failure(RuntimeError("boom"), h.begin_attempt())
    assert h.state == COOLDOWN and h.begin_attempt() is None
    clk.advance(1.0)
    assert h.begin_attempt() is None
    clk.advance(1.5)
    probe = h.begin_attempt()
    assert probe is not None and probe.probe
    assert h.begin_attempt() is None  # a second caller: still open
    h.record_success(probe)
    assert h.state == HEALTHY and h.begin_attempt() is not None


def test_probe_failure_rearms_with_doubled_backoff_and_release():
    clk = FakeClock()
    h = DeviceHealth(retry_budget=1, cooldown_base=1.0, cooldown_max=3.0, clock=clk)
    h.record_failure(RuntimeError("boom"), h.begin_attempt())
    clk.advance(1.1)
    probe = h.begin_attempt()
    h.record_failure(RuntimeError("boom again"), probe)
    assert h.state == COOLDOWN
    clk.advance(1.5)
    assert h.begin_attempt() is None  # the re-arm waits the doubled 2.0
    clk.advance(0.6)
    probe2 = h.begin_attempt()
    assert probe2 is not None and probe2.probe
    h.release_probe(probe2)  # never dispatched: the slot is free again
    probe3 = h.begin_attempt()
    assert probe3 is not None and probe3.probe
    h.record_success(probe3)
    snap = h.snapshot()
    assert snap["state"] == HEALTHY and snap["next_cooldown"] == 1.0


def test_backoff_is_capped():
    clk = FakeClock()
    h = DeviceHealth(retry_budget=1, cooldown_base=1.0, cooldown_max=4.0, clock=clk)
    for _ in range(6):
        a = h.begin_attempt()
        if a is None:
            clk.advance(100.0)
            a = h.begin_attempt()
        h.record_failure(RuntimeError("boom"), a)
    assert h.snapshot()["next_cooldown"] == 4.0


def test_permanent_failure_disables_terminally():
    clk = FakeClock()
    h = DeviceHealth(clock=clk)
    h.record_failure(_build.CudaError("ed25519_verify_launch", 700), h.begin_attempt())
    assert h.state == DISABLED and h.begin_attempt() is None
    clk.advance(10_000.0)
    assert h.begin_attempt() is None
    h.record_success()
    assert h.state == DISABLED
    assert h.snapshot()["failures"] == {TRANSIENT: 0, PERMANENT: 1}


def test_success_resets_consecutive_failures_and_reset_clears_counts():
    h = DeviceHealth(retry_budget=3, clock=FakeClock())
    h.record_failure(RuntimeError("a"))
    h.record_failure(RuntimeError("b"))
    h.record_success(h.begin_attempt())
    assert h.state == HEALTHY
    h.record_failure(RuntimeError("c"))
    h.record_failure(RuntimeError("d"))
    assert h.state == DEGRADED
    h.count_fallback("sr25519", 7)
    assert h.snapshot()["fallback_lanes"] == {"ed25519": 0, "sr25519": 7}
    h.reset()
    snap = h.snapshot()
    assert snap["state"] == HEALTHY and snap["transitions"] == [] and snap["fallback_batches"] == 0
    assert snap["fallback_lanes"] == {"ed25519": 0, "sr25519": 0}


def test_only_one_probe_under_concurrency():
    clk = FakeClock()
    h = DeviceHealth(retry_budget=1, cooldown_base=1.0, clock=clk)
    h.record_failure(RuntimeError("boom"), h.begin_attempt())
    clk.advance(2.0)
    admitted = []
    barrier = threading.Barrier(16)

    def contend():
        barrier.wait(timeout=10)
        a = h.begin_attempt()
        if a is not None:
            admitted.append(a)

    threads = [threading.Thread(target=contend) for _ in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    assert len(admitted) == 1 and admitted[0].probe


# --- fault plans -------------------------------------------------------------------


def test_fault_plan_raise_on_nth_call_and_site_filter():
    plan = fault_injection.FaultPlan(site="x", fail_calls=(2,))
    plan.on_call("x.a")
    with pytest.raises(fault_injection.DeviceFault):
        plan.on_call("x.b")
    plan.on_call("x.c")
    assert plan.calls == 3 and plan.faults_raised == 1
    plan.on_call("other.site")  # filtered out: not counted
    assert plan.calls == 3


def test_fault_plan_window_and_factory():
    plan = fault_injection.FaultPlan(fail_from=2, fail_count=2)
    plan.on_call("s")
    for _ in range(2):
        with pytest.raises(fault_injection.DeviceFault):
            plan.on_call("s")
    plan.on_call("s")
    assert plan.calls == 4 and plan.faults_raised == 2
    plan = fault_injection.FaultPlan(fail_calls=(1,), error_factory=lambda: _build.CudaError("k", 2))
    with pytest.raises(_build.CudaError):
        plan.on_call("s")
    with fault_injection.inject(site="y", fail_calls=(1,), permanent=True) as p:
        assert fault_injection.active() is p
        with pytest.raises(fault_injection.DeviceFault) as info:
            fault_injection.fire("y.z")
        assert info.value.permanent
    assert fault_injection.active() is None
    fault_injection.fire("y.z")  # no plan: a no-op


# --- both engines under injected faults (CPU) --------------------------------------

N_ED = 20  # one 64-lane legacy chunk


@pytest.fixture(scope="module")
def ed_lanes():
    """N_ED ed25519 lanes; lanes 3 and 7 carry bad signatures."""
    pks, msgs, sigs = [], [], []
    for i in range(N_ED):
        priv, pub = ref.keypair_from_seed(bytes([i + 1]) * 32)
        m = b"vote-%d" % i
        sig = ref.sign(priv, m)
        if i in (3, 7):
            sig = sig[:40] + bytes([sig[40] ^ 1]) + sig[41:]
        pks.append(pub)
        msgs.append(m)
        sigs.append(sig)
    want = [i not in (3, 7) for i in range(N_ED)]
    return pks, msgs, sigs, want


@pytest.fixture(scope="module")
def sr_lanes():
    from tests.test_torch_sr25519_batch import fault_lanes

    pks, msgs, sigs, _ = fault_lanes(n=16, seed=8)
    return pks, msgs, sigs, [tsr.verify(p, m, s) for p, m, s in zip(pks, msgs, sigs)]


def _ed(lanes):
    pks, msgs, sigs, _ = lanes
    tpc.results.clear()  # a fresh batch: no verdict from the cache
    return teb.verify_batch(pks, msgs, sigs, device="cpu")


def _sr(lanes):
    pks, msgs, sigs, _ = lanes
    return tsb.verify_batch_sr(pks, msgs, sigs, device="cpu")


ENGINES = {
    "ed25519.chunk": ("ed25519", "ed_lanes", _ed),
    "ed25519.collect": ("ed25519", "ed_lanes", _ed),
    "sr25519.chunk": ("sr25519", "sr_lanes", _sr),
}


@pytest.mark.parametrize("site", sorted(ENGINES))
def test_transient_fault_keeps_verdicts_counts_lanes_and_recovers(request, monkeypatch, site):
    engine, fixture, run = ENGINES[site]
    lanes = request.getfixturevalue(fixture)
    clk = FakeClock()
    h = DeviceHealth(retry_budget=1, cooldown_base=1.0, clock=clk, host_fallback=True)
    monkeypatch.setattr(device_policy, "shared", h)
    with fault_injection.inject(site=site, fail_calls=(1,)) as plan:
        with pytest.warns(UserWarning, match="host fallback"):
            assert run(lanes) == lanes[3]  # planted bad lanes stay rejected
    assert plan.faults_raised == 1
    snap = h.snapshot()
    assert snap["fallback_lanes"][engine] == len(lanes[0])  # the chunk's lanes, pad lanes not
    assert snap["state"] == COOLDOWN and snap["failures"][TRANSIENT] == 1
    # In cooldown the whole batch is answered on the host at once.
    assert run(lanes) == lanes[3]
    assert h.snapshot()["fallback_lanes"][engine] == 2 * len(lanes[0])
    # The backoff expires: the next batch is the probe, and its success
    # brings the card back.
    clk.advance(1.5)
    assert run(lanes) == lanes[3]
    assert h.state == HEALTHY
    assert h.transitions == [(HEALTHY, COOLDOWN), (COOLDOWN, HEALTHY)]
    assert h.snapshot()["fallback_lanes"][engine] == 2 * len(lanes[0])


@pytest.mark.parametrize("engine", ["ed25519", "sr25519"])
def test_permanent_fault_disables_both_engines_and_completes_on_the_host(
        request, monkeypatch, ed_lanes, sr_lanes, engine):
    h = DeviceHealth(clock=FakeClock(), host_fallback=True)
    monkeypatch.setattr(device_policy, "shared", h)
    first, other = (_ed, _sr) if engine == "ed25519" else (_sr, _ed)
    lanes, other_lanes = (ed_lanes, sr_lanes) if engine == "ed25519" else (sr_lanes, ed_lanes)
    with fault_injection.inject(site=engine, fail_calls=(1,), permanent=True):
        with pytest.warns(UserWarning):
            assert first(lanes) == lanes[3]
    assert h.state == DISABLED
    # The other engine finds the card disabled and never tries it.
    with fault_injection.inject(fail_from=1, fail_count=100) as plan:
        assert other(other_lanes) == other_lanes[3]
        assert first(lanes) == lanes[3]
    assert plan.calls == 0
    lanes_counted = h.snapshot()["fallback_lanes"]
    assert lanes_counted[engine] == 2 * len(lanes[0])
    assert lanes_counted["sr25519" if engine == "ed25519" else "ed25519"] == len(other_lanes[0])


def test_typed_cuda_error_at_launch_is_classified(monkeypatch, ed_lanes, sr_lanes):
    """A launcher's CudaError reaches the machine with its class: 2 (out
    of memory) degrades, 700 (illegal address) disables."""
    monkeypatch.setattr(device_policy, "shared",
                        DeviceHealth(retry_budget=5, clock=FakeClock(), host_fallback=True))
    with fault_injection.inject(site="sr25519", fail_calls=(1,),
                                error_factory=lambda: _build.CudaError("sr25519_verify_launch", 2)):
        with pytest.warns(UserWarning, match="CUDA error 2"):
            assert _sr(sr_lanes) == sr_lanes[3]
    assert device_policy.shared.state == DEGRADED
    with fault_injection.inject(site="ed25519.collect", fail_calls=(1,),
                                error_factory=lambda: _build.CudaError("ed25519_verify_launch", 700)):
        with pytest.warns(UserWarning, match="CUDA error 700"):
            assert _ed(ed_lanes) == ed_lanes[3]
    assert device_policy.shared.state == DISABLED


def test_prep_failure_falls_back_for_its_chunk(monkeypatch, ed_lanes):
    monkeypatch.setattr(device_policy, "shared",
                        DeviceHealth(retry_budget=5, clock=FakeClock(), host_fallback=True))

    def broken(*args, **kwargs):
        raise RuntimeError("host prep broke")

    monkeypatch.setattr(teb, "prepare_batch", broken)
    with pytest.warns(UserWarning, match="prepare failed"):
        assert _ed(ed_lanes) == ed_lanes[3]
    snap = device_policy.shared.snapshot()
    assert snap["fallback_lanes"]["ed25519"] == N_ED and snap["state"] == DEGRADED


@pytest.mark.parametrize("engine", ["ed25519", "sr25519"])
def test_kernel_build_error_raises_and_is_never_answered_on_the_host(
        monkeypatch, ed_lanes, sr_lanes, engine):
    """A tree whose kernel does not build is not a device fault: the
    engine raises, counts nothing and leaves the machine healthy (a
    probe slot it held is given back)."""
    def failed_build(*args):
        raise _build.KernelBuildError("nvcc failed for ed25519_verify.cu")

    monkeypatch.setattr(cuda_verify, "verify" if engine == "ed25519" else "verify_sr", failed_build)
    clk = FakeClock()
    h = DeviceHealth(retry_budget=1, cooldown_base=1.0, clock=clk)
    monkeypatch.setattr(device_policy, "shared", h)
    run, lanes = (_ed, ed_lanes) if engine == "ed25519" else (_sr, sr_lanes)
    with pytest.raises(_build.KernelBuildError, match="nvcc failed"):
        run(lanes)
    snap = h.snapshot()
    assert snap["state"] == HEALTHY and snap["failures"] == {TRANSIENT: 0, PERMANENT: 0}
    assert snap["fallback_lanes"] == {"ed25519": 0, "sr25519": 0}
    # As the half-open probe: the slot is released, so the next caller
    # may probe.
    h.record_failure(RuntimeError("boom"), h.begin_attempt())
    clk.advance(1.5)
    with pytest.raises(_build.KernelBuildError):
        run(lanes)
    assert h.begin_attempt() is not None


@pytest.mark.parametrize("site", sorted(ENGINES))
def test_without_host_fallback_a_fault_is_recorded_then_raised(request, monkeypatch, site):
    """The default: the failure reaches the machine (classified,
    counted, state moved), then escapes the engine; no lane is answered
    on the host. The next batch uses the device again."""
    engine, fixture, run = ENGINES[site]
    lanes = request.getfixturevalue(fixture)
    h = DeviceHealth(clock=FakeClock())
    monkeypatch.setattr(device_policy, "shared", h)
    assert not h.host_fallback and h.snapshot()["host_fallback"] is False
    with fault_injection.inject(site=site, fail_calls=(1,)) as plan:
        with pytest.raises(fault_injection.DeviceFault, match=site):
            run(lanes)
        assert plan.faults_raised == 1
        assert run(lanes) == lanes[3]
    snap = h.snapshot()
    assert snap["failures"] == {TRANSIENT: 1, PERMANENT: 0}
    assert snap["fallback_lanes"] == {"ed25519": 0, "sr25519": 0} and snap["fallback_batches"] == 0
    assert snap["state"] == HEALTHY and h.transitions == [(HEALTHY, DEGRADED), (DEGRADED, HEALTHY)]


@pytest.mark.parametrize("engine", ["ed25519", "sr25519"])
def test_without_host_fallback_a_disabled_device_refuses_both_engines(
        monkeypatch, ed_lanes, sr_lanes, engine):
    h = DeviceHealth(clock=FakeClock())
    monkeypatch.setattr(device_policy, "shared", h)
    first, other = (_ed, _sr) if engine == "ed25519" else (_sr, _ed)
    lanes, other_lanes = (ed_lanes, sr_lanes) if engine == "ed25519" else (sr_lanes, ed_lanes)
    with fault_injection.inject(site=engine, fail_calls=(1,),
                                error_factory=lambda: _build.CudaError(f"{engine}_launch", 719)):
        with pytest.raises(_build.CudaError, match="CUDA error 719"):
            first(lanes)
    assert h.state == DISABLED
    with fault_injection.inject() as plan:
        for run, batch in ((other, other_lanes), (first, lanes)):
            with pytest.raises(device_policy.DeviceRefused, match="state=disabled"):
                run(batch)
    assert plan.calls == 0  # never tried the device
    assert h.snapshot()["fallback_lanes"] == {"ed25519": 0, "sr25519": 0}


def test_without_host_fallback_a_prep_failure_raises(monkeypatch, ed_lanes):
    monkeypatch.setattr(device_policy, "shared", DeviceHealth(retry_budget=5, clock=FakeClock()))

    def broken(*args, **kwargs):
        raise RuntimeError("host prep broke")

    monkeypatch.setattr(teb, "prepare_batch", broken)
    with pytest.raises(RuntimeError, match="host prep broke"):
        _ed(ed_lanes)
    snap = device_policy.shared.snapshot()
    assert snap["fallback_lanes"]["ed25519"] == 0 and snap["state"] == DEGRADED


def test_reset_keeps_the_host_fallback_setting():
    h = DeviceHealth(host_fallback=True)
    h.record_failure(RuntimeError("boom"), h.begin_attempt())
    h.reset()
    assert h.host_fallback and h.state == HEALTHY and h.transitions == []
    with pytest.raises(device_policy.DeviceRefused):
        DeviceHealth().refuse("sr25519", 3)


def _observer_fails_gather(monkeypatch, pks):
    """A table cache of two columns over an activated set of ``pks``, and
    an observer (as the resident store is one) that raises on the
    eviction the third table build causes inside ``tables.gather``."""
    from tendermint_tpu_torch.crypto.keys import Ed25519PubKey
    from tendermint_tpu_torch.types.validator import Validator
    from tendermint_tpu_torch.types.validator_set import ValidatorSet

    def observer(kind, payload):
        if kind == "evict":
            raise RuntimeError("observer failed on evict")

    monkeypatch.setattr(tpc, "_observers", [observer])
    monkeypatch.setattr(tpc, "tables", tpc.PrecomputeCache(cap=2))
    tpc.tables.activate_validator_set(ValidatorSet([Validator(Ed25519PubKey(pk), 10) for pk in pks]))


def test_a_table_gather_error_propagates_and_releases_the_probe(monkeypatch, ed_lanes):
    """Deliberate divergence: the reference swallows an error of
    ``precompute.tables.gather`` and sends every lane to the legacy
    kernel (``tendermint_tpu/ops/ed25519_batch.py:1121-1124``); the port
    re-raises it out of ``verify_batch``, counts no device failure and
    answers nothing on the host. A probe slot the batch held is given
    back (``_verify_uncached``'s ``release_probe``)."""
    _observer_fails_gather(monkeypatch, ed_lanes[0])
    clk = FakeClock()
    h = DeviceHealth(retry_budget=1, cooldown_base=1.0, clock=clk)
    monkeypatch.setattr(device_policy, "shared", h)
    with pytest.raises(RuntimeError, match="observer failed on evict"):
        _ed(ed_lanes)
    snap = h.snapshot()
    assert snap["state"] == HEALTHY and snap["failures"] == {TRANSIENT: 0, PERMANENT: 0}
    assert snap["fallback_lanes"] == {"ed25519": 0, "sr25519": 0}
    # As the half-open probe: the error still escapes, and the slot is
    # free for the next caller.
    h.record_failure(RuntimeError("boom"), h.begin_attempt())
    clk.advance(1.5)
    assert h.snapshot()["probe_inflight"] is False
    _observer_fails_gather(monkeypatch, ed_lanes[0])  # a fresh cache: the builds again
    with pytest.raises(RuntimeError, match="observer failed on evict"):
        _ed(ed_lanes)
    assert h.snapshot()["probe_inflight"] is False and h.state == COOLDOWN
    probe = h.begin_attempt()
    assert probe is not None and probe.probe
    assert h.snapshot()["fallback_lanes"] == {"ed25519": 0, "sr25519": 0}

"""The port's device-tier introspection (ops/introspect.py), on the CPU.

``bucket_label`` equals the JAX package's over a sweep of inputs, junk
included. The byte ledger follows the resident store exactly (forced on,
so the store is a CPU tensor) across an upload, a rotation, a re-upload,
an LRU eviction and a clear, and the bound gauge mirrors it. The
profiler's digests come from ``dispatch_chunk`` spans only, and compile
events from a kernel's first launch (a stub launcher stands in for the
card). ``memstats_json`` keeps to its size bound. A broken sink never
fails ``verify_batch``, and a raising kernel wrapper still raises.
"""

import contextlib
import json
import types

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import tendermint_tpu_torch
from tendermint_tpu.ops import introspect as jintro
from tendermint_tpu_torch import ops as tops
from tendermint_tpu_torch.crypto import ed25519_ref as ref
from tendermint_tpu_torch.crypto.keys import Ed25519PubKey
from tendermint_tpu_torch.libs import tracing
from tendermint_tpu_torch.libs.metrics import OpsMetrics, Registry
from tendermint_tpu_torch.ops import _build, cuda_hash, cuda_verify, device_policy, introspect
from tendermint_tpu_torch.ops import ed25519_batch as teb, precompute as tpc, resident
from tendermint_tpu_torch.types.validator import Validator
from tendermint_tpu_torch.types.validator_set import ValidatorSet

TABLE_BYTES = 8 * 4 * 32


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    """The store on (a CPU tensor), a fresh ledger and profiler, no
    binding and no sink; all of it put back after."""
    monkeypatch.setattr(tendermint_tpu_torch, "DEFAULT_DEVICE", "cpu")
    saved = (tracing.tracer.mode, tracing.tracer._observer, tracing.tracer._profile,
             introspect.profiler.enabled)
    resident.configure("on")
    tpc.reset()
    resident.reset()
    introspect.accountant.clear()
    introspect.profiler.clear()
    yield
    tops.bind_metrics(None)
    introspect.profiler.configure("on" if saved[3] else "off")
    tracing.tracer.configure(saved[0])
    tracing.tracer.set_metrics_observer(saved[1])
    tracing.tracer.set_profile_sink(saved[2])
    resident.configure(None)
    tpc.reset()
    resident.reset()
    introspect.accountant.clear()
    introspect.profiler.clear()
    device_policy.shared.reset()


def _keys(n, seed):
    return [ref.keypair_from_seed(bytes([seed + i]) * 32) for i in range(n)]


def _batch(keys, tag=b"lane"):
    pks, msgs, sigs = [], [], []
    for i, (sk, pk) in enumerate(keys):
        m = tag + b" %d" % i
        pks.append(pk)
        msgs.append(m)
        sigs.append(ref.sign(sk, m))
    return pks, msgs, sigs


def _activate(keys):
    tpc.activate_validator_set(ValidatorSet([Validator(Ed25519PubKey(pk), 10) for _, pk in keys]))


def _verify(batch):
    tpc.results.clear()
    return teb.verify_batch(*batch, device="cpu")


# --- the bucket labeller ------------------------------------------------------


@pytest.mark.parametrize("lanes", [
    -5, 0, 1, 2, 3, 4, 5, 63, 64, 65, 1000, 4096, 4097, 8192, 16383, 16384, 16385, 1 << 20,
    "64", "x", None, 2.5, [], b"7",
])
def test_bucket_label_equals_the_jax_packages(lanes):
    assert introspect.bucket_label(lanes) == jintro.bucket_label(lanes)


# --- the byte ledger ------------------------------------------------------------


def test_ledger_follows_the_store_across_upload_rotation_eviction_and_clear():
    reg = Registry()
    ops = OpsMetrics(reg)
    tops.bind_metrics(ops)

    def check(want_cols):
        nbytes = want_cols * TABLE_BYTES
        assert resident.store.device_nbytes() == nbytes
        assert introspect.accountant.bytes_for("resident_tables") == nbytes
        assert introspect.memstats()["device_bytes"].get("resident_tables", 0) == nbytes
        assert ops.device_bytes.value(owner="resident_tables") == nbytes

    check(0)
    a = _keys(6, 10)
    _activate(a)
    assert all(_verify(_batch(a)))
    check(len(a) + 1)  # the pad column and one a key
    assert resident.stats()["uploads"] == 1
    # a rotation that retires one of the keys drops the store...
    _activate(a[1:])
    for i in range(7):
        _activate(_keys(1, 100 + i))
    check(0)
    # ...and the next batch uploads the live keys afresh
    assert all(_verify(_batch(a[1:], b"again")))
    check(len(a))
    # an LRU eviction of a stored key drops it
    new_pk = _keys(1, 100)[0][1]  # eligible: its one-key set is live
    cap = tpc.tables.cap
    try:
        tpc.tables.cap = len(a) - 1
        tpc.tables.insert(new_pk, *tpc.build_table(new_pk))
        check(0)
    finally:
        tpc.tables.cap = cap
    assert all(_verify(_batch(a[2:], b"third")))
    check(len(a) - 2 + 1 + 1)  # a[2:], the new key, the pad column
    tpc.reset()
    check(0)
    assert introspect.memstats()["device_bytes_total"] == 0
    # a late binding starts true
    _activate(a)
    assert all(_verify(_batch(a, b"late")))
    late = OpsMetrics(Registry())
    tops.bind_metrics(late)
    assert late.device_bytes.value(owner="resident_tables") == resident.store.device_nbytes() > 0


# --- the profiler ----------------------------------------------------------------


def test_digests_come_from_dispatch_chunk_spans_only():
    seen = []
    introspect.install()
    tracing.tracer.set_metrics_observer(lambda name, args, sec: seen.append((name, dict(args))))
    ops = OpsMetrics(Registry())
    introspect.bind_metrics(ops)
    a = _keys(5, 30)
    _activate(a)
    batch = _batch(a * 4)  # 20 lanes, one resident chunk
    assert all(_verify(batch))
    assert all(_verify(batch))
    dispatches = [args for name, args in seen if name == "dispatch_chunk"]
    assert len(dispatches) == 2 and {d["lanes"] for d in dispatches} == {20}
    snap = introspect.profiler.snapshot()
    assert snap["enabled"] and set(snap["kernel"]) == {"ed25519/b32"}
    assert snap["kernel"]["ed25519/b32"]["count"] == 2 and snap["compile"] == {}
    assert ops.kernel_bucket_seconds.count(engine="ed25519", bucket="32") == 2
    introspect.profiler.sink("prep_chunk", {"engine": "ed25519", "lanes": 20}, 1.0)
    assert introspect.profiler.snapshot()["kernel"]["ed25519/b32"]["count"] == 2
    introspect.uninstall()
    assert tracing.tracer.profile_sink is None and not introspect.profiler.enabled


def test_the_profiler_is_off_until_installed_and_refuses_other_modes():
    assert not introspect.KernelProfiler().enabled
    introspect.uninstall()
    assert tracing.tracer.profile_sink is None
    introspect.profiler.configure("on")
    assert tracing.tracer.profile_sink == introspect.profiler.sink
    with pytest.raises(ValueError):
        introspect.profiler.configure("auto")


@contextlib.contextmanager
def _stub_card(monkeypatch, rc=0):
    """Launchers that return ``rc`` without a card."""
    monkeypatch.setattr(cuda_verify, "_launcher", lambda name: (lambda *args: rc))
    monkeypatch.setattr(cuda_hash, "_launcher", lambda name: (lambda *args: rc))
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(
        torch.cuda, "current_stream", lambda dev: types.SimpleNamespace(cuda_stream=0)
    )
    monkeypatch.setattr(cuda_verify, "_launched", set())
    yield


def test_a_kernels_first_launch_is_a_compile_event(monkeypatch):
    ops = OpsMetrics(Registry())
    introspect.bind_metrics(ops)
    introspect.install()
    tracing.configure("ring")
    tracing.tracer.clear()
    rows = torch.zeros((4, 32), dtype=torch.uint8)
    cpu = torch.device("cpu")
    with _stub_card(monkeypatch):
        for _ in range(2):
            cuda_verify._launch("ed25519_verify_launch", "verify", (rows,) * 4, 4, cpu)
            cuda_verify._launch("sr25519_verify_launch", "verify_sr", (rows,) * 4, 4, cpu)
            cuda_hash._run("sha512_challenge_launch", "challenge", (0, 1, 4, None, 0, 4), cpu)
    assert introspect.accountant.snapshot()["compile_events"] == {
        "ed25519": 2, "pallas": 1, "sr25519": 1}
    assert ops.compile_events.value(engine="pallas") == 1
    compiles = [e for e in tracing.tracer.events() if e["name"] == "kernel_compile"]
    assert [(e["args"]["engine"], e["args"]["kernel"]) for e in compiles] == [
        ("pallas", "verify"), ("ed25519", "verify"), ("sr25519", "verify_sr"),
        ("ed25519", "challenge")]
    assert compiles[0]["args"]["parent"] == "kernel_compile" and compiles[0]["args"]["impl"] == "pallas"
    assert set(introspect.profiler.snapshot()["compile"]) == {
        "ed25519/b4", "pallas/b4", "sr25519/b4"}


def test_a_refused_first_launch_still_raises_and_is_not_counted(monkeypatch):
    rows = torch.zeros((4, 32), dtype=torch.uint8)
    before = dict(cuda_verify.LAUNCHES)
    with _stub_card(monkeypatch, rc=2):
        with pytest.raises(_build.CudaError, match="CUDA error 2"):
            cuda_verify._launch("ed25519_verify_launch", "verify", (rows,) * 4, 4, torch.device("cpu"))
    assert cuda_verify.LAUNCHES == before
    assert introspect.accountant.snapshot()["compile_events"] == {"ed25519": 1, "pallas": 1}


# --- memstats ---------------------------------------------------------------------


def test_memstats_carries_the_ledger_store_libraries_and_digests(monkeypatch):
    monkeypatch.setattr(_build, "_libs", {"ed25519_verify": object(), "sha512_challenge": object()})
    a = _keys(3, 50)
    _activate(a)
    _verify(_batch(a))
    doc = json.loads(introspect.memstats_json())
    assert doc["device_bytes"] == {"resident_tables": 4 * TABLE_BYTES}
    assert doc["resident"] == resident.stats()
    assert doc["exec_cache_entries"] == {"ed25519": 2, "pallas": 1, "sr25519": 1}
    assert set(doc) >= {"builds", "profile", "compile_events", "device_bytes_total"}


def test_memstats_json_keeps_to_its_size_bound():
    introspect.install()
    for i in range(40):
        introspect.profiler.sink("dispatch_chunk", {"engine": "e%d" % i, "lanes": 64}, 0.001)
    full = introspect.memstats_json()
    no_profile = json.loads(full)
    no_profile.pop("profile")
    cut = len(json.dumps(no_profile, sort_keys=True, separators=(",", ":")))
    assert "profile" in json.loads(full)
    mid = json.loads(introspect.memstats_json(limit_bytes=cut))
    assert "profile" not in mid and "device_bytes" in mid
    slim = introspect.memstats_json(limit_bytes=10)
    assert json.loads(slim) == {"device_bytes_total": 0, "truncated": True}


# --- sinks never fail the op; kernels always raise -----------------------------------


def test_a_broken_sink_never_fails_verify_batch_and_a_raising_wrapper_still_raises(monkeypatch):
    def boom(*args):
        raise RuntimeError("broken sink")

    class BrokenMetrics:
        def __getattr__(self, name):
            raise RuntimeError("broken metrics")

    tracing.configure("ring")
    tracing.tracer.set_metrics_observer(boom)
    introspect.install()
    tops.bind_metrics(None)
    introspect.bind_metrics(BrokenMetrics())
    a = _keys(4, 70)
    _activate(a)
    batch = _batch(a * 5)
    assert all(_verify(batch))
    assert introspect.accountant.bytes_for("resident_tables") == 5 * TABLE_BYTES
    assert introspect.profiler.snapshot()["kernel"]["ed25519/b32"]["count"] == 1
    tracing.tracer.set_profile_sink(boom)
    assert all(_verify(batch))

    def kernel_error(*args):
        raise _build.CudaError("ed25519_verify_resident_launch", 719)

    monkeypatch.setattr(cuda_verify, "verify_resident", kernel_error)
    with pytest.raises(_build.CudaError, match="CUDA error 719"):
        _verify(batch)
    assert device_policy.shared.state == device_policy.DISABLED

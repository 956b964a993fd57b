"""The port's flight recorder (``libs/flightrec.py``) against the JAX
package's, on the CPU.

The same events go into a recorder of each package: the packed records
decode to the same rows and a dump carries the same keys under the
schema ``tendermint-tpu-flightrec/1``. The ring stays inside its byte
bound; a ``device_health_transition`` to cooldown, raised by the port's
own health machine through its tracer, dumps with the reference's
reason; and SIGTERM and an unhandled exception dump from a real
process, each chained to the handler before it. The port reads no
environment variable: the dump directory is an argument. Every wait
is bounded.
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest

pytest.importorskip("torch")

from tendermint_tpu.libs import flightrec as jflightrec
from tendermint_tpu_torch.libs import flightrec, metrics, tracing
from tendermint_tpu_torch.libs.flightrec import KIND_INSTANT, KIND_MARK, KIND_METRIC, KIND_SPAN
from tendermint_tpu_torch.ops import device_policy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

EVENTS = [
    (KIND_SPAN, "verifyd_enqueue", {"lanes": 64, "klass": "consensus"}, 0.00125),
    (KIND_INSTANT, "verifyd_brownout", {"level": "shed_rpc", "direction": "up"}, 0.0),
    (KIND_METRIC, "tendermint_verifyd_shm_lanes_total", {"v": 64.0}, 0.0),
    (KIND_MARK, "sigterm", {}, 0.0),
    (KIND_MARK, "odd", {"obj": object()}, 0.0),
    (KIND_MARK, "big", {"blob": "y" * 4096}, 0.0),
]


@pytest.fixture
def pair(tmp_path, monkeypatch):
    monkeypatch.setenv(jflightrec.DIR_ENV, str(tmp_path / "jax"))
    monkeypatch.delenv(jflightrec.ENABLE_ENV, raising=False)
    j = jflightrec.FlightRecorder(cap_bytes=8192, window_s=30.0)
    t = flightrec.FlightRecorder(cap_bytes=8192, window_s=30.0, dump_dir=str(tmp_path / "port"))
    return j, t


def _without_ts(rows):
    return [{k: v for k, v in r.items() if k != "ts"} for r in rows]


def test_the_record_layout_and_constants_are_the_references():
    assert flightrec._REC_HDR.format == jflightrec._REC_HDR.format
    for name in ("KIND_SPAN", "KIND_INSTANT", "KIND_METRIC", "KIND_MARK", "KIND_NAMES",
                 "DUMP_SCHEMA", "DEFAULT_CAP_BYTES", "DEFAULT_WINDOW_S", "MAX_PAYLOAD_BYTES",
                 "MAX_DUMPS", "AUTO_DUMP_INSTANTS", "AUTO_DUMP_HEALTH_STATES"):
        assert getattr(flightrec, name) == getattr(jflightrec, name), name


@pytest.mark.parametrize("i", range(len(EVENTS)))
def test_one_event_decodes_to_the_references_row(pair, i):
    j, t = pair
    kind, name, fields, dur = EVENTS[i]
    for rec in pair:
        rec.record(kind, name, fields, dur)
    assert _without_ts(t.snapshot()) == _without_ts(j.snapshot())
    assert t.stats() == {**j.stats(), "installed": False}


def test_sinks_give_the_references_records(pair):
    j, t = pair
    for rec in pair:
        rec.flight_sink("span", "verifyd_wait", {"lanes": 3}, 0.0, 0.5)
        rec.flight_sink("instant", "verifyd_shed", {"klass": "rpc"}, 0.0, 0.0)
        rec.metric_sink("tendermint_verifyd_shm_torn_slabs_total", (("a", "b"),), 1.0)
        rec.mark("about_to_die", step=7)
    rows = _without_ts(t.snapshot())
    assert rows == _without_ts(j.snapshot())
    assert rows[0] == {"kind": "span", "name": "verifyd_wait", "dur_us": 500000, "fields": {"lanes": 3}}


def test_a_dump_has_the_references_keys(pair):
    j, t = pair
    for rec in pair:
        rec.mark("before_fault", step=7)
    jdoc = json.load(open(j.dump("unit_test")))
    tdoc = json.load(open(t.dump("unit_test")))
    assert sorted(tdoc) == sorted(jdoc)
    assert tdoc["schema"] == jdoc["schema"] == "tendermint-tpu-flightrec/1"
    assert (tdoc["reason"], tdoc["pid"], tdoc["window_s"]) == (jdoc["reason"], jdoc["pid"], jdoc["window_s"])
    assert _without_ts(tdoc["records"]) == _without_ts(jdoc["records"])
    assert "device_bytes" in tdoc["memstats"]
    assert os.path.basename(t.last_dump_path()).startswith("flightrec-%d-unit_test-" % os.getpid())


def test_the_ring_stays_inside_its_bound_and_keeps_the_newest(pair):
    for rec in pair:
        for i in range(500):
            rec.record(KIND_MARK, "m%d" % i, {"pad": "x" * 100})
    j, t = pair
    assert t.stats()["bytes"] <= t.cap_bytes
    assert t.stats() == {**j.stats(), "installed": False}
    names = [r["name"] for r in t.snapshot()]
    assert names[-1] == "m499" and "m0" not in names
    assert names == [r["name"] for r in j.snapshot()]
    assert t.snapshot(window_s=1e-9) == []


def test_the_dump_budget_caps_disk_spam(pair):
    _, t = pair
    paths = [t.dump("spam%d" % i) for i in range(flightrec.MAX_DUMPS + 3)]
    assert all(p is not None for p in paths[: flightrec.MAX_DUMPS])
    assert all(p is None for p in paths[flightrec.MAX_DUMPS:])


def test_the_port_health_machine_escalation_dumps(pair, monkeypatch):
    """A forced escalation of the port's health machine to cooldown
    goes through the tracer's flight sink and dumps with the
    reference's reason; a healthy transition does not dump."""
    j, t = pair
    monkeypatch.setattr(device_policy, "shared", device_policy.DeviceHealth())
    saved = tracing.tracer.flight_sink
    assert t.install(signals=False)
    try:
        for _ in range(device_policy.shared.retry_budget):
            device_policy.shared.record_failure(RuntimeError("injected transient fault"))
        assert device_policy.shared.state == device_policy.COOLDOWN
        assert t.stats()["dumps"] == 1  # degraded did not dump, cooldown did
        path = t.last_dump_path()
        assert path is not None
        doc = json.load(open(path))
        assert doc["reason"] == "device_cooldown"
        assert any(r["name"] == "device_health_transition" for r in doc["records"])
        dumps = t.stats()["dumps"]
        device_policy.shared.record_success()
        assert device_policy.shared.state == device_policy.HEALTHY
        assert t.stats()["dumps"] == dumps
    finally:
        t.uninstall()
        tracing.tracer.set_flight_sink(saved)
    j.flight_sink("instant", "device_health_transition", {"to_state": "cooldown"}, 0.0, 0.0)
    assert json.load(open(j.last_dump_path()))["reason"] == doc["reason"]


def test_install_wires_both_sinks_and_uninstall_detaches(pair):
    _, t = pair
    saved = (tracing.tracer.flight_sink, metrics._flight_sink)
    assert t.install(signals=False) and t.install(signals=False)
    try:
        with tracing.span("flightrec_probe", n=1):
            pass
        tracing.instant("flightrec_probe_instant", k=2)
        reg = metrics.Registry()
        metrics.VerifydMetrics(reg).shm_lanes.inc(5)
        rows = t.snapshot()
        names = [r["name"] for r in rows]
        assert "flightrec_probe" in names and "flightrec_probe_instant" in names
        metric = [r for r in rows if r["name"] == "tendermint_verifyd_shm_lanes_total"]
        assert metric and metric[0]["fields"]["v"] == 5.0
    finally:
        t.uninstall()
    assert not t.stats()["installed"]
    assert tracing.tracer.flight_sink is None and metrics._flight_sink is None
    before = len(t)
    with tracing.span("flightrec_after"):
        pass
    assert len(t) == before
    tracing.tracer.set_flight_sink(saved[0])
    metrics.set_flight_sink(saved[1])


def _run(code, tmp_path):
    return subprocess.run(
        [sys.executable, "-c", textwrap.dedent(code) % {"dir": str(tmp_path)}],
        env=dict(os.environ, PYTHONPATH=REPO),
        cwd=REPO,
        capture_output=True,
        text=True,
        timeout=60,
    )


def test_sigterm_dumps_from_a_real_process_and_chains(tmp_path):
    proc = _run(
        """
        import os, signal, time
        from tendermint_tpu_torch.libs import flightrec
        stopped = []
        signal.signal(signal.SIGTERM, lambda *_: stopped.append(1))
        assert flightrec.install(dump_dir=%(dir)r)
        flightrec.mark("about_to_die", step=1)
        os.kill(os.getpid(), signal.SIGTERM)
        deadline = time.monotonic() + 10
        while not stopped and time.monotonic() < deadline:
            time.sleep(0.01)
        print("chained" if stopped else "lost")
        """,
        tmp_path,
    )
    assert proc.returncode == 0 and proc.stdout.strip() == "chained", proc.stderr
    dumps = sorted(tmp_path.glob("flightrec-*-sigterm-*.json"))
    assert len(dumps) == 1, list(tmp_path.iterdir())
    doc = json.load(open(dumps[0]))
    assert doc["schema"] == flightrec.DUMP_SCHEMA
    names = [r["name"] for r in doc["records"]]
    assert "about_to_die" in names and "sigterm" in names


def test_an_unhandled_exception_dumps_from_a_real_process(tmp_path):
    proc = _run(
        """
        from tendermint_tpu_torch.libs import flightrec
        assert flightrec.install(dump_dir=%(dir)r, signals=False)
        flightrec.mark("last_good_step")
        raise RuntimeError("injected crash")
        """,
        tmp_path,
    )
    assert proc.returncode != 0
    assert "injected crash" in proc.stderr  # the chained hook still ran
    dumps = sorted(tmp_path.glob("flightrec-*-unhandled_exception-*.json"))
    assert len(dumps) == 1, list(tmp_path.iterdir())
    names = [r["name"] for r in json.load(open(dumps[0]))["records"]]
    assert "last_good_step" in names and "unhandled_exception" in names

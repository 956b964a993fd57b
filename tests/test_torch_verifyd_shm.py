"""The port's zero-copy shm ingress (``verifyd/shm.py``) against the JAX
package's, on the CPU: the twin of ``tests/test_verifyd_shm.py`` and of
the shm half of ``tests/test_verifyd_chaos.py``.

Slab headers, lane tables and control blocks that one package packs
unpack in the other, byte for byte. A torn or zeroed slab is answered
``STATUS_INVALID`` and counted; a spoofed advert (a foreign-owned or
group-readable file, a symlink, a runtime dir of another owner, a
doorbell peer of another uid) is refused; the janitor, ``_unbook`` and
the bounded ``unpack_lanes`` behave as the reference's. 64 seeded lanes
with planted bad signatures get the same verdicts over shm, over TCP
and from the JAX package's ``verify_batch``. The port reads no
environment variable: the runtime dir follows the temp dir. Every wait
is bounded.
"""

import json
import os
import struct
import tempfile
import threading
import time

import numpy as np
import pytest

pytest.importorskip("torch")

from tendermint_tpu.ops import ed25519_batch as jeb
from tendermint_tpu.verifyd import shm as jshm
from tendermint_tpu_torch.crypto import batch as tbatch, ed25519_ref as ref
from tendermint_tpu_torch.ops import introspect
from tendermint_tpu_torch.verifyd import protocol, shm
from tendermint_tpu_torch.verifyd.client import VerifydClient
from tendermint_tpu_torch.verifyd.server import VerifydServer

PACKAGES = {"port": shm, "jax": jshm}
HEADERS = [
    dict(gen=2, kind=protocol.KIND_COMMIT, klass=protocol.CLASS_CONSENSUS, deadline_ms=250,
         algo=protocol.ALGO_ED25519, lanes=3, tenant="chain-a", trace=bytes(range(1, 18)),
         slo_ms=40, shard_id=0, route_epoch=7),
    dict(gen=4, kind=protocol.KIND_HEADER, klass=protocol.CLASS_LIGHT, deadline_ms=0,
         algo=protocol.ALGO_SR25519, lanes=0),
    dict(gen=6, kind=protocol.KIND_RAW, klass=protocol.CLASS_RPC, deadline_ms=600_000,
         algo=protocol.ALGO_ED25519, lanes=2, tenant=protocol.DEFAULT_TENANT, shard_id=4095,
         route_epoch=1 << 31),
]


def seeded_lanes(n, seed, bad=()):
    """n ed25519 lanes from a numpy seed: 8 signers, messages of mixed
    lengths; lanes in ``bad`` get a flipped signature byte."""
    rng = np.random.default_rng(seed)
    keys = [ref.keypair_from_seed(rng.bytes(32)) for _ in range(8)]
    pks, msgs, sigs = [], [], []
    for i in range(n):
        priv, pub = keys[i % 8]
        m = rng.bytes(int(rng.integers(0, 200)))
        s = bytearray(ref.sign(priv, m))
        if i in bad:
            s[int(rng.integers(0, 64))] ^= 1 << int(rng.integers(0, 8))
        pks.append(pub)
        msgs.append(m)
        sigs.append(bytes(s))
    return pks, msgs, sigs


def noop_verify(pks, msgs, sigs):
    return [True] * len(pks)


def junk_request(n, seed=0, **kw):
    return protocol.VerifyRequest(
        pks=[bytes([seed % 251 + 1]) * 32] * n,
        msgs=[b"ring-%d-%d" % (seed, i) for i in range(n)],
        sigs=[b"\x09" * 64] * n,
        **kw,
    )


@pytest.fixture
def servers():
    started = []

    def start(**kw):
        kw.setdefault("verify_fn", noop_verify)
        kw.setdefault("max_batch", 64)
        kw.setdefault("max_delay", 0.001)
        kw.setdefault("shm", "on")
        kw.setdefault("device", "cpu")
        srv = VerifydServer(**kw)
        srv.start()
        started.append(srv)
        return srv

    yield start
    for srv in started:
        srv.stop()
    tbatch.shutdown_shared_scheduler()


# --- the slab layout, across packages ----------------------------------------


def test_the_layout_constants_are_the_references():
    for name in ("SHM_VERSION", "SHM_MAGIC", "SHM_MAX_LANES", "DEFAULT_NSLABS", "DEFAULT_SLAB_BYTES",
                 "MAX_NSLABS", "MAX_SLAB_BYTES", "MAX_SEGMENT_BYTES", "CTRL_BYTES", "SLAB_HEADER_BYTES",
                 "SLAB_OFF_GEN", "SLAB_OFF_TENANT", "SLAB_OFF_TRACE", "SLAB_OFF_SLO_MS",
                 "SLAB_OFF_SHARD_ID", "SLAB_OFF_ROUTE_EPOCH", "SLAB_OFF_GEN2", "MSG_ATTACH",
                 "MSG_COMMIT", "MSG_RESP", "MSG_FREE", "_MAX_FRAME"):
        assert getattr(shm, name) == getattr(jshm, name), name
    for name in ("_FRAME_HDR", "_COMMIT_BODY", "_RESP_HEAD", "_FREE_BODY"):
        assert getattr(shm, name).format == getattr(jshm, name).format, name


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("h", range(len(HEADERS)))
def test_a_slab_packed_in_one_package_unpacks_in_the_other(writer, h):
    hdr = HEADERS[h]
    pks, msgs, sigs = seeded_lanes(hdr["lanes"], seed=h)
    size = shm.SLAB_HEADER_BYTES + 64 + sum(100 + len(m) for m in msgs)
    bufs = {}
    for name, pkg in PACKAGES.items():
        buf = bytearray(b"\xa5" * size)  # garbage from an earlier generation
        pkg.stamp_begin(buf, 0, hdr["gen"])
        pkg.pack_lanes(buf, 0, pks, msgs, sigs)
        pkg.pack_header(buf, 0, **hdr)
        bufs[name] = buf
    assert bufs["port"] == bufs["jax"]
    reader = PACKAGES["jax" if writer == "port" else "port"]
    buf = bufs[writer]
    got = reader.unpack_header(buf, 0)
    assert got == PACKAGES[writer].unpack_header(buf, 0)
    assert got["klass"] == hdr["klass"] and got["shard_id"] == hdr.get("shard_id", -1)
    assert got["tenant"] == (hdr.get("tenant") or protocol.DEFAULT_TENANT)
    g_pks, g_msgs, g_sigs = reader.unpack_lanes(memoryview(buf), 0, hdr["lanes"], size)
    assert (g_pks, [bytes(m) for m in g_msgs], g_sigs) == (pks, msgs, sigs)
    assert all(type(m) is memoryview for m in g_msgs)  # zero-copy hand-off


def test_the_control_block_is_the_references():
    nslabs, slab_bytes = 4, 4096
    bufs = {n: bytearray(shm.CTRL_BYTES + nslabs * slab_bytes) for n in PACKAGES}
    for name, pkg in PACKAGES.items():
        ring = pkg.SlabRing.create(bufs[name], nslabs, slab_bytes)
        ring.set_head(5)
        ring.set_tail(3)
    assert bufs["port"] == bufs["jax"]
    ring = shm.SlabRing.attach(bufs["jax"], nslabs, slab_bytes)
    assert (ring.head(), ring.tail(), ring.slab_base(2)) == (5, 3, shm.CTRL_BYTES + 2 * slab_bytes)
    for pkg in PACKAGES.values():
        with pytest.raises(ValueError, match="geometry"):
            pkg.SlabRing.attach(bufs["port"], nslabs + 1, slab_bytes)


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_torn_and_malformed_headers_raise_the_same_errors(pkg):
    mod = PACKAGES[pkg]
    buf = bytearray(shm.SLAB_HEADER_BYTES + 64)
    mod.pack_header(buf, 0, **HEADERS[0])
    mod.stamp_begin(buf, 0, 8)  # odd generation: a write in progress
    with pytest.raises(ValueError, match="torn"):
        mod.unpack_header(buf, 0)
    mod.pack_header(buf, 0, **HEADERS[0])
    struct.pack_into("<I", buf, shm.SLAB_OFF_GEN2, 4)  # the stamps disagree
    with pytest.raises(ValueError, match="torn"):
        mod.unpack_header(buf, 0)
    with pytest.raises(ValueError, match="unknown kind"):
        mod.unpack_header(bytearray(shm.SLAB_HEADER_BYTES), 0)  # a zeroed slab
    with pytest.raises(ValueError, match="truncated"):
        mod.unpack_header(bytearray(10), 0)


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_unpack_lanes_is_bounded_by_the_slab(pkg):
    mod = PACKAGES[pkg]
    slab = shm.SLAB_HEADER_BYTES + 256
    buf = bytearray(slab)
    with pytest.raises(ValueError, match="exceeds slab"):
        mod.unpack_lanes(buf, 0, 10_000, slab)  # a garbage lane count
    struct.pack_into("<I", buf, shm.SLAB_HEADER_BYTES, 200)  # one lane, 200-byte msg
    with pytest.raises(ValueError, match="exceeds slab"):
        mod.unpack_lanes(buf, 0, 1, slab)


# --- the ring against a port server ----------------------------------------------


def test_a_torn_slab_is_answered_invalid_counted_and_its_slot_reused(servers):
    srv = servers()
    t = shm.connect(srv.address[1])
    try:
        seq, slot, gen = t._acquire(time.monotonic() + 5)
        shm.stamp_begin(t._ring.buf, t._ring.slab_base(slot), gen)
        t._send_commit(seq, slot, 1)  # the writer "died" before publishing
        resp = t._wait(seq, time.monotonic() + 10)
        assert resp.status == protocol.STATUS_INVALID and "torn" in resp.message
        # a zeroed slab: its generation is not newer than the slot's last
        seq, slot, gen = t._acquire(time.monotonic() + 5)
        base = t._ring.slab_base(slot)
        t._ring.buf[base:base + shm.SLAB_HEADER_BYTES] = bytes(shm.SLAB_HEADER_BYTES)
        t._send_commit(seq, slot, 1)
        resp = t._wait(seq, time.monotonic() + 10)
        assert resp.status == protocol.STATUS_INVALID
        assert srv.stats()["shm_torn_slabs"] == 2
        for i in range(shm.DEFAULT_NSLABS + 1):  # every slot cycles after the retire
            assert t.call(junk_request(2, seed=i), timeout=10.0).status == protocol.STATUS_OK
    finally:
        t.close()
    assert srv.stats()["shm_torn_slabs"] == 2


def test_an_invalid_slab_releases_its_backlog_lanes(servers):
    """``_unbook``: a STATUS_INVALID answer releases the lanes its COMMIT
    booked, so the pressure signal returns to 0 with the session up."""
    srv = servers()
    t = shm.connect(srv.address[1])
    try:
        for _ in range(3):
            seq, slot, gen = t._acquire(time.monotonic() + 5)
            shm.stamp_begin(t._ring.buf, t._ring.slab_base(slot), gen)
            t._send_commit(seq, slot, 5)
            assert t._wait(seq, time.monotonic() + 10).status == protocol.STATUS_INVALID
        assert srv.stats()["shm_torn_slabs"] == 3 and srv.shm_backlog() == 0
        assert t.call(junk_request(2, seed=9), timeout=10.0).status == protocol.STATUS_OK
        assert srv.shm_backlog() == 0 and srv.stats()["shm_lanes"] == 2
    finally:
        t.close()


def test_a_stale_generation_replay_is_torn(servers):
    srv = servers()
    t = shm.connect(srv.address[1])
    try:
        for i in range(t._ring.nslabs):
            assert t.call(junk_request(1, seed=i), timeout=10.0).status == protocol.STATUS_OK
        with t._mtx:  # slot 0 again, never refilled
            seq = t._head
            t._head = seq + 1
            t._ring.set_head(t._head)
            t._waiting.add(seq)
        t._send_commit(seq, 0, 1)
        resp = t._wait(seq, time.monotonic() + 10)
        assert resp.status == protocol.STATUS_INVALID and "stale" in resp.message
        assert srv.stats()["shm_torn_slabs"] == 1
    finally:
        t.close()


def test_the_janitor_frees_a_held_slab_once_its_flush_resolves(servers):
    release = threading.Event()

    def gated(pks, msgs, sigs):
        release.wait(10)
        return [True] * len(pks)

    srv = servers(verify_fn=gated)
    t = shm.connect(srv.address[1])
    try:
        resp = t.call(junk_request(2, seed=1, deadline_ms=80), timeout=10.0)
        assert resp.status == protocol.STATUS_DEADLINE_EXCEEDED
        release.set()
        for i in range(shm.DEFAULT_NSLABS + 2):
            assert t.call(junk_request(1, seed=10 + i), timeout=10.0).status == protocol.STATUS_OK
    finally:
        release.set()
        t.close()


def test_the_janitor_fails_loud_and_never_hands_a_held_slab_back(servers, monkeypatch):
    monkeypatch.setattr(shm, "_JANITOR_GRACE_S", 0.3)
    release = threading.Event()

    def gated(pks, msgs, sigs):
        release.wait(10)
        return [True] * len(pks)

    srv = servers(verify_fn=gated)
    t = shm.connect(srv.address[1])
    try:
        resp = t.call(junk_request(2, seed=1, deadline_ms=80), timeout=10.0)
        assert resp.status == protocol.STATUS_DEADLINE_EXCEEDED
        deadline = time.monotonic() + 5
        while t.alive and time.monotonic() < deadline:
            time.sleep(0.01)
        assert not t.alive and t._ring.tail() == 0
        assert srv.stats()["shm_fallbacks"] >= 1
    finally:
        release.set()
        t.close()


def test_sessions_are_in_the_device_byte_ledger(servers):
    srv = servers()
    before = introspect.accountant.bytes_for("shm_slabs")
    t = shm.connect(srv.address[1])
    try:
        size = shm.CTRL_BYTES + shm.DEFAULT_NSLABS * shm.DEFAULT_SLAB_BYTES
        assert introspect.accountant.bytes_for("shm_slabs/client") >= size
        deadline = time.monotonic() + 5
        while srv.stats()["shm_sessions"] < 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert introspect.accountant.bytes_for("shm_slabs") == before + size
    finally:
        t.close()
    srv.stop()
    assert introspect.accountant.bytes_for("shm_slabs") == before


# --- the advert and the doorbell --------------------------------------------------


@pytest.fixture
def private_tmp(tmp_path, monkeypatch):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    return tmp_path


def test_the_advert_lives_in_a_private_runtime_dir(private_tmp):
    port = 59901
    path = shm.advertise(port, "/tmp/sock-x", "tok")
    try:
        d = os.path.dirname(path)
        assert d == str(private_tmp / f"tendermint-tpu-{os.geteuid()}")
        assert (os.stat(d).st_mode & 0o077) == 0 and (os.stat(path).st_mode & 0o777) == 0o600
        assert shm.read_endpoint(port)["token"] == "tok"
        shm.advertise(port, "/tmp/sock-y", "tok2")  # a restarted server's advert
        shm.retract(port, "tok")  # the old one's retract leaves it
        assert shm.read_endpoint(port)["token"] == "tok2"
    finally:
        shm.retract(port, "tok2")
    assert shm.read_endpoint(port) is None


def test_a_spoofed_advert_is_refused(private_tmp, monkeypatch):
    port = 59902
    path = shm.advertise(port, "/tmp/sock-y", "tok")
    os.chmod(path, 0o644)  # group/other readable: not trusted
    assert shm.read_endpoint(port) is None
    os.chmod(path, 0o600)
    assert shm.read_endpoint(port)["token"] == "tok"
    runtime_dir = os.path.dirname(path)
    euid = os.geteuid()
    with monkeypatch.context() as m:  # the file's owner is another uid
        m.setattr(shm, "_runtime_dir", lambda: runtime_dir)
        m.setattr(os, "geteuid", lambda: euid + 1)
        assert shm.read_endpoint(port) is None
    with monkeypatch.context() as m:  # so is the runtime dir's
        m.setattr(os, "geteuid", lambda: euid + 1)
        os.mkdir(private_tmp / f"tendermint-tpu-{euid + 1}", 0o700)
        with pytest.raises(shm.ShmError, match="untrusted"):
            shm.endpoint_path(port)
    assert shm.read_endpoint(port)["token"] == "tok"
    os.unlink(path)
    real = private_tmp / "evil-endpoint"
    real.write_text(json.dumps({"v": shm.SHM_VERSION, "socket": "/tmp/evil", "token": "x"}))
    os.chmod(real, 0o600)
    os.symlink(real, path)  # a planted symlink is never followed
    assert shm.read_endpoint(port) is None
    os.unlink(path)


def test_a_runtime_dir_that_is_a_symlink_is_refused(private_tmp):
    target = private_tmp / "elsewhere"
    target.mkdir(mode=0o700)
    os.symlink(target, private_tmp / f"tendermint-tpu-{os.geteuid()}")
    with pytest.raises(shm.ShmError, match="untrusted"):
        shm.endpoint_path(1)


def test_a_doorbell_peer_of_another_uid_and_a_bad_token_are_refused(servers, monkeypatch):
    srv = servers()
    ep = shm.read_endpoint(srv.address[1])
    with pytest.raises(shm.ShmAttachError, match="token"):
        shm.ShmClientTransport(ep["socket"], "not-the-token")
    deadline = time.monotonic() + 5
    while srv.stats()["shm_fallbacks"] < 1 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert srv.stats()["shm_fallbacks"] == 1
    euid = os.geteuid()
    monkeypatch.setattr(os, "geteuid", lambda: euid + 1)  # SO_PEERCRED says our real uid
    with pytest.raises(shm.ShmAttachError, match="peer uid"):
        shm.ShmClientTransport(ep["socket"], ep["token"])


# --- negotiation and verdicts -----------------------------------------------------


def test_mode_resolution_has_no_environment_knob(monkeypatch):
    monkeypatch.setenv("TENDERMINT_TPU_SHM", "off")
    assert shm.shm_mode() == "auto"
    shm.set_shm_mode("off")
    try:
        assert shm.shm_mode() == "off"
    finally:
        shm.set_shm_mode("")
    assert shm.shm_mode() == "auto"
    with pytest.raises(ValueError):
        shm.set_shm_mode("sideways")


def test_negotiation_and_fallbacks_are_the_references(servers):
    srv = servers()
    h, p = srv.address
    c = VerifydClient(f"{h}:{p}", shm="auto")
    assert c.transport == "tcp"  # nothing attached yet
    assert c.verify(*seeded_lanes(3, seed=1)) == [True] * 3
    assert c.transport == "shm"
    st = c.stats()
    assert (st["shm_calls"], st["shm_lanes"], st["shm_fallbacks"]) == (1, 3, 0)
    assert st["shm_bytes_avoided"] > 0
    c.close()
    tcp_only = servers(shm="off")
    h, p = tcp_only.address
    assert tcp_only.shm_socket_path == ""
    c = VerifydClient(f"{h}:{p}", shm="auto")
    assert c.verify(*seeded_lanes(2, seed=2)) == [True] * 2
    assert (c.transport, c.stats()["shm_fallbacks"]) == ("tcp", 0)  # negotiation, not a fallback
    c.close()
    c = VerifydClient(f"{h}:{p}", shm="on")  # a demand: the missing endpoint counts
    assert c.verify(*seeded_lanes(2, seed=3)) == [True] * 2
    assert c.stats()["shm_fallbacks"] == 1
    c.close()


def test_a_lost_session_falls_back_to_tcp_counted_and_never_to_the_host(servers, monkeypatch):
    srv = servers(verify_fn=tbatch.host_verify_ed25519)
    h, p = srv.address
    c = VerifydClient(f"{h}:{p}", shm="on")
    try:
        lanes = seeded_lanes(4, seed=4, bad={2})
        want = [True, True, False, True]
        assert c.verify(*lanes, klass=protocol.CLASS_CONSENSUS) == want
        assert c.transport == "shm"
        t = c._shm

        def lost(req, timeout):
            t._fail(shm.ShmError("doorbell lost"))
            raise shm.ShmError("shm session died awaiting response")

        monkeypatch.setattr(t, "call", lost)
        served = srv.stats()["requests_served"]
        assert c.verify(*lanes, klass=protocol.CLASS_CONSENSUS) == want
        st = c.stats()
        assert (st["shm_fallbacks"], st["fallback_calls"], st["transport"]) == (1, 0, "tcp")
        assert srv.stats()["requests_served"] == served + 1  # the TCP retry was served
    finally:
        c.close()


def test_a_request_larger_than_a_slab_is_cut_into_slabs(servers):
    srv = servers(verify_fn=tbatch.host_verify_ed25519)
    h, p = srv.address
    c = VerifydClient(f"{h}:{p}", shm="on")
    try:
        ep = shm.read_endpoint(p)  # a ring of small slabs, 4 lanes of about 400 bytes each
        c._shm = shm.ShmClientTransport(ep["socket"], ep["token"], slab_bytes=shm.SLAB_HEADER_BYTES + 1600)
        c.verify(*seeded_lanes(1, seed=5))
        pks, msgs, sigs = seeded_lanes(24, seed=6, bad={0, 13, 23})
        want = [i not in (0, 13, 23) for i in range(24)]
        served = srv.stats()["requests_served"]
        assert c.verify(pks, msgs, sigs, klass=protocol.CLASS_CONSENSUS) == want
        assert srv.stats()["requests_served"] - served > 1
        assert c.stats()["shm_fallbacks"] == 0 and c.stats()["shm_lanes"] == 25
    finally:
        c.close()


def test_64_planted_lanes_get_the_same_verdicts_over_shm_tcp_and_from_jax(servers):
    bad = {0, 5, 17, 31, 32, 50, 63}
    pks, msgs, sigs = seeded_lanes(64, seed=64, bad=bad)
    want = [i not in bad for i in range(64)]
    srv = servers(verify_fn=tbatch.host_verify_ed25519)
    h, p = srv.address
    got = {}
    for mode in ("on", "off"):
        c = VerifydClient(f"{h}:{p}", shm=mode)
        try:
            verdicts = c.verify(pks, msgs, sigs, klass=protocol.CLASS_CONSENSUS)
            got[c.transport] = verdicts
        finally:
            c.close()
    assert set(got) == {"shm", "tcp"}
    assert got["shm"] == got["tcp"] == want
    assert [bool(v) for v in jeb.verify_batch(pks, msgs, sigs)] == want
    assert srv.stats()["shm_lanes"] == 64 and srv.stats()["shm_torn_slabs"] == 0


def test_a_request_over_max_lanes_is_cut_as_tcp_cuts_it(servers, monkeypatch):
    """A slab holds 8,192 lanes, but a server's default ``max_pending``
    admits 4,096 at once: the shm client cuts at ``protocol.MAX_LANES``
    too, so a 10,000-lane commit is three requests on either transport."""
    monkeypatch.setattr(protocol, "MAX_LANES", 4)
    srv = servers(verify_fn=tbatch.host_verify_ed25519)
    h, p = srv.address
    c = VerifydClient(f"{h}:{p}", shm="on")
    try:
        pks, msgs, sigs = seeded_lanes(10, seed=7, bad={5, 9})
        assert c.verify(pks, msgs, sigs, klass=protocol.CLASS_CONSENSUS) == [i not in (5, 9) for i in range(10)]
        assert c.transport == "shm" and srv.stats()["requests_served"] == 3
        assert srv.stats()["shm_lanes"] == 10 and c.stats()["shm_fallbacks"] == 0
    finally:
        c.close()


def test_concurrent_callers_share_one_ring_without_a_torn_slab(servers):
    """More caller threads than slabs race acquire, fill, commit and wait
    on one transport under a short switch interval: every call resolves
    with its verdict count or a ``ShmBusy`` (the caller's cue to ride
    TCP), no slab is read torn, and TAIL catches up with HEAD."""
    import sys

    srv = servers(max_batch=32)
    t = shm.connect(srv.address[1])
    errors, done, busy = [], [0], [0]
    mtx = threading.Lock()

    def caller(i):
        try:
            for j in range(6):
                n = 1 + (i + j) % 4
                try:
                    resp = t.call(junk_request(n, seed=i * 100 + j, klass=protocol.CLASS_CONSENSUS),
                                  timeout=30.0)
                except shm.ShmBusy:
                    with mtx:
                        busy[0] += 1
                    continue
                assert resp.status == protocol.STATUS_OK and len(resp.verdicts) == n, resp
                with mtx:
                    done[0] += 1
        except Exception as exc:  # recorded for the assertion below
            with mtx:
                errors.append((i, repr(exc)))

    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=caller, args=(i,)) for i in range(2 * shm.DEFAULT_NSLABS)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=30)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(saved)
    try:
        assert not errors, errors
        assert done[0] + busy[0] == 12 * shm.DEFAULT_NSLABS and done[0] > 0
        assert srv.stats()["shm_torn_slabs"] == 0
        deadline = time.monotonic() + 5
        while t._ring.tail() != t._ring.head() and time.monotonic() < deadline:
            time.sleep(0.01)
        assert t._ring.tail() == t._ring.head() == done[0]  # a busy call takes no slot
    finally:
        t.close()

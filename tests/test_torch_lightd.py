"""The port's light-client serving tier against the JAX package's, on
the CPU: the verified-header cache (``light/cache.py``), ``LightServer``
(``light/lightd.py``), ``RetryingProvider`` and the JSON-RPC envelope of
``rpc/server.py``.

Chains are built with the JAX package's types (``tests/test_light.py``)
and carried to the port. The JAX server fronts a JAX client on its
one-verify-per-pivot loop (its verifications stay on the host tier); the
port's fronts a port client in its batched mode on a fresh shared
scheduler on the CPU. Payloads, error codes and messages, status and the
metrics text must be equal. Two cold heights asked at once show a fault
of the JAX server (the lower one fails a valid header), which the port's
server does not have. Servers bind port 0 and are stopped after each
test; no wait is longer than 10 s.
"""

import http.client
import json
import re
import threading
import urllib.request

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import tendermint_tpu_torch
from bench.workload import build_header_chain
from tendermint_tpu.libs.metrics import LightMetrics as JLightMetrics
from tendermint_tpu.libs.metrics import Registry as JRegistry
from tendermint_tpu.light import LightClient as JLightClient
from tendermint_tpu.light import MemoryProvider as JMemoryProvider
from tendermint_tpu.light import TrustOptions as JTrustOptions
from tendermint_tpu.light.cache import HeaderCache as JHeaderCache
from tendermint_tpu.light.lightd import LightServer as JLightServer
from tendermint_tpu.ops import precompute as jpc
from tendermint_tpu.rpc import server as jrpc
from tendermint_tpu.types.light import LightBlock as JLightBlock
from tendermint_tpu_torch.crypto import batch as tbatch
from tendermint_tpu_torch.libs.metrics import LightMetrics, Registry
from tendermint_tpu_torch.light import LightClient, MemoryProvider, TrustOptions
from tendermint_tpu_torch.light.cache import CacheEntry, HeaderCache
from tendermint_tpu_torch.light.lightd import LightServer
from tendermint_tpu_torch.light.provider import (
    HeightTooHighError,
    LightBlockNotFoundError,
    ProviderBudgetExhaustedError,
    ProviderError,
    RetryingProvider,
)
from tendermint_tpu_torch.ops import device_policy, fault_injection
from tendermint_tpu_torch.ops import precompute as tpc
from tendermint_tpu_torch.rpc import server as trpc
from tendermint_tpu_torch.rpc.server import INTERNAL_ERROR, INVALID_PARAMS, RPCError
from tendermint_tpu_torch.types import carry
from tests.helpers import CHAIN_ID
from tests.test_light import build_light_chain, now_at

HOUR = 3600.0
WAIT = 10.0


@pytest.fixture()
def port(monkeypatch):
    monkeypatch.setattr(tendermint_tpu_torch, "DEFAULT_DEVICE", "cpu")
    monkeypatch.setattr(tbatch, "_shared_scheduler", None)
    monkeypatch.setattr(device_policy, "shared", device_policy.DeviceHealth())
    tpc.reset()
    jpc.reset()
    yield
    tbatch.shutdown_shared_scheduler()
    fault_injection.uninstall()
    tpc.reset()
    jpc.reset()


@pytest.fixture()
def servers():
    """Register a server (its socket is bound when it is made) to have it
    stopped after the test; returns the server."""
    made = []

    def register(srv):
        made.append(srv)
        return srv

    yield register
    for srv in made:
        srv.stop()


def jclient(blocks, witness_blocks=None, provider=None):
    witnesses = [] if witness_blocks is None else [JMemoryProvider(CHAIN_ID, witness_blocks)]
    return JLightClient(
        CHAIN_ID, JTrustOptions(period=10 * HOUR, height=1, hash=blocks[0].hash()),
        provider or JMemoryProvider(CHAIN_ID, blocks), witnesses, bisect_batching=False, now=now_at)


def tclient(jblocks, witness_jblocks=None, provider=None):
    blocks = [carry.light_block(b) for b in jblocks]
    witnesses = [] if witness_jblocks is None else [
        MemoryProvider(CHAIN_ID, [carry.light_block(b) for b in witness_jblocks])]
    return LightClient(
        CHAIN_ID, TrustOptions(period=10 * HOUR, height=1, hash=blocks[0].hash()),
        provider or MemoryProvider(CHAIN_ID, blocks), witnesses, now=lambda: carry.timestamp(now_at()))


def both(servers, jblocks, witness_jblocks=None):
    """A JAX server and a port server over the same chain."""
    return (servers(JLightServer(jclient(jblocks, witness_jblocks), evloop=False)),
            servers(LightServer(tclient(jblocks, witness_jblocks))))


def rpc_error(fn, *args, **kwargs):
    with pytest.raises((RPCError, jrpc.RPCError)) as exc:
        fn(*args, **kwargs)
    return exc.value.code, exc.value.message, exc.value.data


# --- the header cache ---------------------------------------------------------


@pytest.fixture(scope="module")
def chain3():
    blocks, _, _ = build_light_chain(3)
    return blocks, [carry.light_block(b) for b in blocks]


def test_lru_eviction_order(chain3):
    _, blocks = chain3
    cache = HeaderCache(capacity=2)
    cache.put(CHAIN_ID, blocks[0])
    cache.put(CHAIN_ID, blocks[1])
    assert cache.get(CHAIN_ID, 1) is not None  # refresh height 1
    cache.put(CHAIN_ID, blocks[2])  # evicts height 2 (LRU)
    assert cache.get(CHAIN_ID, 2) is None
    assert cache.get(CHAIN_ID, 1) is not None
    assert cache.get(CHAIN_ID, 3) is not None
    assert cache.evictions == 1
    with pytest.raises(ValueError, match="capacity must be positive"):
        HeaderCache(capacity=0)


def test_header_hash_pinned_get(chain3):
    _, blocks = chain3
    cache = HeaderCache()
    cache.put(CHAIN_ID, blocks[0])
    assert cache.get(CHAIN_ID, 1, header_hash=blocks[0].hash())
    assert cache.get(CHAIN_ID, 1, header_hash=b"\x01" * 32) is None


def test_invalidate_is_chain_scoped(chain3):
    _, blocks = chain3
    cache = HeaderCache()
    cache.put(CHAIN_ID, blocks[0])
    cache.put("other-chain", blocks[1])
    cache.put(CHAIN_ID, blocks[2])
    assert cache.invalidate(CHAIN_ID, 3) and not cache.invalidate(CHAIN_ID, 3)
    assert cache.invalidate_chain(CHAIN_ID) == 1
    assert cache.get(CHAIN_ID, 1) is None
    assert cache.get("other-chain", 2) is not None
    e = CacheEntry(CHAIN_ID, 1, blocks[0].hash(), blocks[0], trust_path=(1,), payload={"height": "1"})
    assert e.trust_path == (1,) and e.payload["height"] == "1"


def test_metrics_text_equals_the_reference(chain3):
    jblocks, blocks = chain3
    texts, stats = [], []
    for reg, metrics, cache, bl in (
        (JRegistry(), JLightMetrics, JHeaderCache, jblocks),
        (Registry(), LightMetrics, HeaderCache, blocks),
    ):
        m = metrics(reg)
        c = cache(capacity=1, metrics=m)
        c.get(CHAIN_ID, 1)  # miss
        c.put(CHAIN_ID, bl[0])
        c.get(CHAIN_ID, 1)  # hit
        c.put(CHAIN_ID, bl[1])  # evicts
        m.bisection_rounds.observe(3)
        m.serve_latency_seconds.labels(outcome="hit").observe(0.002)
        m.serve_latency_seconds.labels(outcome="miss").observe(0.7)
        texts.append(reg.expose())
        stats.append(c.stats())
    assert texts[1] == texts[0]
    assert stats[1] == stats[0]
    assert "tendermint_light_cache_hits_total 1" in texts[1]
    assert "tendermint_light_cache_evictions_total 1" in texts[1]
    assert 'tendermint_light_serve_latency_seconds_bucket{le="1",outcome="miss"} 1' in texts[1]


# --- the server ---------------------------------------------------------------


def test_miss_then_hit_same_payload_as_the_reference(port, servers):
    blocks, _, _ = build_light_chain(10)
    jsrv, srv = both(servers, blocks)
    first = srv.light_header(height=10)
    assert json.dumps(first, sort_keys=True) == json.dumps(jsrv.light_header(height=10), sort_keys=True)
    assert first["height"] == "10" and first["trust_path"] == ["10"]
    assert srv.light_header(height=10) is first  # the memoized dict
    jsrv.light_header(height=10)
    assert srv.cache.hits == 1 and srv.cache.misses == 1
    # a height below the latest goes down the hash chain; its path is
    # the headers it stored
    assert json.dumps(srv.light_header(height=7), sort_keys=True) == json.dumps(
        jsrv.light_header(height=7), sort_keys=True)
    assert srv.light_status() == jsrv.light_status()


def test_divergence_invalidates_the_cache(port, servers):
    blocks, _, _ = build_light_chain(10)
    forked, _, _ = build_light_chain(10, fork_at=6)
    jsrv, srv = both(servers, blocks, witness_jblocks=forked)
    for s in (jsrv, srv):
        s.light_header(height=3)  # below the fork: the witness agrees
        assert len(s.cache) == 1
    err = rpc_error(srv.light_header, height=10)
    assert err == rpc_error(jsrv.light_header, height=10)
    assert err[0] == INTERNAL_ERROR and "attack" in err[1] and err[2] == "invalidated 1 cached headers"
    assert len(srv.cache) == 0
    assert len(srv.client.primary.evidence) == 1


def test_bad_height_params_give_the_reference_codes(port, servers):
    blocks, _, _ = build_light_chain(3)
    jsrv, srv = both(servers, blocks)
    for bad in (None, "x", 0, -4, 4):
        err = rpc_error(srv.light_header, height=bad)
        assert err == rpc_error(jsrv.light_header, height=bad), bad
        assert err[0] == INVALID_PARAMS
    assert rpc_error(srv.light_header, height=4)[1] == "light verification failed: height 4 > latest 3"


def test_status_reports_the_cache(port, servers):
    blocks, _, _ = build_light_chain(5)
    jsrv, srv = both(servers, blocks)
    for s in (jsrv, srv):
        s.light_header(height=5)
        s.light_header(height=5)
    st = srv.light_status()
    assert st == jsrv.light_status()
    assert st["trusted_height"] == "5" and st["cache"]["entries"] == 1 and st["cache"]["hits"] == 1
    assert srv.health() == {}


def test_single_flight_does_one_verification(port, servers):
    blocks, _, _ = build_light_chain(12)
    srv = servers(LightServer(tclient(blocks)))
    calls = []
    calls_mtx = threading.Lock()
    inner = srv.client.verify_light_block_at_height

    def counting(height, now=None):
        with calls_mtx:
            calls.append(height)
        return inner(height, now)

    srv.client.verify_light_block_at_height = counting
    results = []
    threads = [threading.Thread(target=lambda: results.append(srv.light_header(height=12)))
               for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(WAIT)
    assert not any(t.is_alive() for t in threads)
    assert len(results) == 8 and all(r is results[0] for r in results)
    assert calls == [12]  # the herd collapsed to one verification


def test_concurrent_requests_stress(port, servers):
    """16 threads ask for heights 2-12 in seeded orders, with the
    interpreter switching threads every 10 µs: every answer is its
    height's block, and no height is verified twice."""
    import random
    import sys

    blocks, _, _ = build_light_chain(12)
    srv = servers(LightServer(tclient(blocks)))
    calls, calls_mtx = [], threading.Lock()
    inner = srv.client.verify_light_block_at_height

    def counting(height, now=None):
        with calls_mtx:
            calls.append(height)
        return inner(height, now)

    srv.client.verify_light_block_at_height = counting
    wrong, answered = [], []

    def ask(seed):
        heights = list(range(2, 13))
        random.Random(seed).shuffle(heights)
        for h in heights:
            got = srv.light_header(height=h)
            (answered if got["hash"] == blocks[h - 1].hash().hex().upper() else wrong).append(h)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=ask, args=(i,)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(WAIT)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not wrong and len(answered) == 16 * 11
    assert sorted(calls) == sorted(set(calls))  # one verification a height at most
    assert srv.cache.stats()["entries"] == 11


def _leader_fills_between_miss_and_claim(srv, height):
    """One request misses ``height`` in the cache; before it claims the
    height, a second request leads, verifies, fills the cache and
    leaves. Returns the first request's answer and the heights the
    client verified."""
    calls = []
    inner = srv.client.verify_light_block_at_height

    def counting(h, now=None):
        calls.append(h)
        return inner(h, now)

    srv.client.verify_light_block_at_height = counting
    real_get, first = srv.cache.get, []

    def get(chain_id, h, header_hash=None):
        entry = real_get(chain_id, h, header_hash)
        if not first:
            first.append(h)
            srv.light_header(height=h)  # the leader, start to end
        return entry

    srv.cache.get = get
    got = srv.light_header(height=height)
    return got, calls


def test_a_leader_that_left_before_the_claim_is_not_repeated(port, servers):
    """The port's new leader reads the cache once more after its claim:
    the height is verified once, and the cache counts two misses."""
    blocks, _, _ = build_light_chain(6)
    srv = servers(LightServer(tclient(blocks)))
    got, calls = _leader_fills_between_miss_and_claim(srv, 6)
    assert got["hash"] == blocks[5].hash().hex().upper() and calls == [6]
    assert (srv.cache.stats()["hits"], srv.cache.stats()["misses"]) == (0, 2)


def test_a_leader_that_left_before_the_claim_is_repeated_on_the_reference(servers):
    """The JAX server claims the height after its leader has filled the
    cache and left, and verifies it a second time."""
    blocks, _, _ = build_light_chain(6)
    srv = servers(JLightServer(jclient(blocks), evloop=False))
    got, calls = _leader_fills_between_miss_and_claim(srv, 6)
    assert got["hash"] == blocks[5].hash().hex().upper() and calls == [6, 6]


class HeldProvider:
    """A provider whose fetch of one height waits until it is released."""

    def __init__(self, inner, hold):
        self.inner = inner
        self.hold = hold
        self.started = threading.Event()
        self.release = threading.Event()

    def chain_id(self):
        return self.inner.chain_id()

    def light_block(self, height):
        if height == self.hold:
            self.started.set()
            assert self.release.wait(WAIT)
        return self.inner.light_block(height)

    def report_evidence(self, ev):
        self.inner.report_evidence(ev)


def _two_cold_heights(srv, provider, low, high):
    """Ask for ``low`` (its fetch held) and, meanwhile, for ``high``;
    then release ``low``. Returns each answer: the payload or the
    error's (code, message)."""
    out = {}

    def ask(h):
        try:
            out[h] = srv.light_header(height=h)
        except (RPCError, jrpc.RPCError) as e:
            out[h] = (e.code, e.message)

    ta = threading.Thread(target=ask, args=(low,))
    ta.start()
    assert provider.started.wait(WAIT)
    tb = threading.Thread(target=ask, args=(high,))
    tb.start()
    tb.join(0.5)  # the reference's leader for `high` finishes here
    provider.release.set()
    ta.join(WAIT)
    tb.join(WAIT)
    assert not ta.is_alive() and not tb.is_alive()
    return out


def test_two_cold_heights_at_once_fail_the_lower_one_on_the_reference(servers):
    """The JAX server runs one leader per height, over a client with no
    lock: the lower height's leader fetched its block with 1 trusted,
    then finds 9 trusted and fails a valid header."""
    blocks, _, _ = build_light_chain(10)
    held = HeldProvider(JMemoryProvider(CHAIN_ID, blocks), hold=5)
    srv = servers(JLightServer(jclient(blocks, provider=held), evloop=False))
    out = _two_cold_heights(srv, held, 5, 9)
    assert out[9]["height"] == "9"
    assert out[5] == (INVALID_PARAMS, "light verification failed: height 5 is not above trusted 9")


def test_two_cold_heights_at_once_are_both_served(port, servers):
    """The port's server verifies one height at a time: both valid
    headers are served, each with its own trust path."""
    blocks, _, _ = build_light_chain(10)
    held = HeldProvider(MemoryProvider(CHAIN_ID, [carry.light_block(b) for b in blocks]), hold=5)
    srv = servers(LightServer(tclient(blocks, provider=held)))
    out = _two_cold_heights(srv, held, 5, 9)
    assert (out[5]["height"], out[5]["trust_path"]) == ("5", ["5"])
    assert (out[9]["height"], out[9]["trust_path"]) == ("9", ["9"])
    assert srv.client.store.heights() == [1, 5, 9]


def _get(url):
    with urllib.request.urlopen(url, timeout=WAIT) as resp:
        return resp.status, resp.headers.get("Content-Type"), resp.read()


def _post(url, body: bytes):
    req = urllib.request.Request(url, data=body, headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=WAIT) as resp:
        return json.loads(resp.read())


def test_served_over_http_with_metrics(port, servers):
    blocks, _, _ = build_light_chain(6)
    reg = Registry()
    srv = servers(LightServer(tclient(blocks), metrics=LightMetrics(reg), registry=reg))
    srv.start()
    miss = json.loads(_get(srv.url + "/light_header?height=6")[2])
    hit = json.loads(_get(srv.url + "/light_header?height=6")[2])
    assert miss == hit and miss["result"]["height"] == "6"
    assert json.loads(_get(srv.url + "/light_header?height=0")[2])["error"]["code"] == INVALID_PARAMS
    assert json.loads(_get(srv.url + "/light_header?height=x")[2])["error"]["code"] == INVALID_PARAMS
    assert _post(srv.url, b'{"jsonrpc": "2.0", "id": 7, "method": "light_status"}')["result"][
        "trusted_height"] == "6"
    status, ctype, text = _get(srv.url + "/metrics")
    assert status == 200 and ctype.startswith("text/plain")
    text = text.decode()
    assert "tendermint_light_cache_hits_total 1" in text
    assert "tendermint_light_cache_misses_total 1" in text
    assert 'tendermint_light_serve_latency_seconds_count{outcome="miss"} 1' in text
    assert "# TYPE tendermint_light_bisection_rounds histogram" in text


def test_a_device_fault_is_an_internal_error_not_an_invalid_header(port, servers):
    """Host fallback is off: a fault in the round's flush reaches the
    client as the fault, and lightd answers INTERNAL_ERROR, caches
    nothing, and serves the header once the card answers."""
    jchain, jvset, _ = build_header_chain(6, 24)
    srv = servers(LightServer(tclient([JLightBlock(sh, jvset) for sh in jchain])))
    srv.start()
    with fault_injection.inject(site="ed25519.chunk", fail_calls=(1,)):
        err = json.loads(_get(srv.url + "/light_header?height=6")[2])["error"]
    assert err["code"] == INTERNAL_ERROR and "injected transient fault" in err["message"]
    assert len(srv.cache) == 0 and srv.client.store.heights() == [1]
    ok = json.loads(_get(srv.url + "/light_header?height=6")[2])["result"]
    assert ok["hash"] == jchain[5].hash().hex().upper()


# --- the JSON-RPC envelope ----------------------------------------------------


def _routes(rpc):
    def echo(x=None):
        return {"x": x}

    def boom():
        raise rpc.RPCError(-1, "bad", "why")

    return {"echo": echo, "boom": boom}


def test_rpc_envelope_equals_the_reference(servers):
    j = servers(jrpc.RPCServer(_routes(jrpc), evloop=False))
    t = servers(trpc.RPCServer(_routes(trpc)))
    for s in (j, t):
        s.start()
    posts = [
        b"{not json",  # parse error
        b"[]",  # empty batch: one invalid-request error
        b'"a string"',  # not an object
        b'{"jsonrpc": "2.0", "id": 3, "method": "nope"}',  # unknown method
        b'[{"jsonrpc": "2.0", "id": 1, "method": "echo", "params": {"x": 1}},'
        b' {"jsonrpc": "2.0", "id": 2, "method": "echo", "params": [2]}]',  # a batch of two
        b'{"jsonrpc": "2.0", "id": 4, "method": "echo", "params": {"y": 1}}',  # bad params
        b'{"jsonrpc": "2.0", "id": 5, "method": "echo", "params": 3}',  # params not object/array
        b'{"jsonrpc": "2.0", "id": 6, "method": "boom"}',  # the handler's RPCError
    ]
    for body in posts:
        assert _post(t.url, body) == _post(j.url, body), body
    assert _post(t.url, b"[]") == {"jsonrpc": "2.0", "id": None,
                                   "error": {"code": -32600, "message": "empty batch", "data": ""}}
    assert [r["result"] for r in _post(t.url, posts[4])] == [{"x": 1}, {"x": 2}]
    for path in ("/echo?x=5", '/echo?x="abc"', "/echo?x=true", "/echo?x=abc", "/nope", "/"):
        assert _get(t.url + path) == _get(j.url + path), path
    assert json.loads(_get(t.url + "/echo?x=5")[2])["result"] == {"x": 5}
    assert _get(t.url + "/")[2] == b"Available endpoints:\n  /boom\n  /echo"
    # the body bound: a declared length over 64 MiB is refused unread
    conn = http.client.HTTPConnection(*t.address, timeout=WAIT)
    try:
        conn.putrequest("POST", "/")
        conn.putheader("Content-Length", str((64 << 20) + 1))
        conn.endheaders()
        assert conn.getresponse().status == 413
    finally:
        conn.close()


def _after_a_refused_body(srv):
    """Send a POST declaring a body over 64 MiB whose first bytes are a
    request of their own; return every status line the server answers."""
    import socket

    sneaked = b"GET /echo?x=7 HTTP/1.1\r\nHost: x\r\n\r\n"
    head = b"POST / HTTP/1.1\r\nHost: x\r\nContent-Length: %d\r\n\r\n" % ((64 << 20) + 1)
    with socket.create_connection(srv.address, timeout=WAIT) as sock:
        sock.sendall(head + sneaked)
        sock.settimeout(1.0)
        data = b""
        try:
            while True:
                chunk = sock.recv(65536)
                if not chunk:
                    break
                data += chunk
        except (socket.timeout, ConnectionResetError):
            pass
    return re.findall(rb"HTTP/1\.1 \d{3} [^\r]*", data)


def test_a_refused_body_is_not_read_as_the_next_request(servers):
    """The reference answers 413 and reads the unread body as a request
    of its own; the port's server closes the connection after the 413."""
    j = servers(jrpc.RPCServer(_routes(jrpc), evloop=False))
    t = servers(trpc.RPCServer(_routes(trpc)))
    for s in (j, t):
        s.start()
    assert _after_a_refused_body(j) == [b"HTTP/1.1 413 Request Entity Too Large", b"HTTP/1.1 200 OK"]
    assert _after_a_refused_body(t) == [b"HTTP/1.1 413 Request Entity Too Large"]


def test_handler_error_is_an_internal_error(servers):
    def fail():
        raise RuntimeError("the card is gone")

    t = servers(trpc.RPCServer({"fail": fail}))
    t.start()
    err = _post(t.url, b'{"jsonrpc": "2.0", "id": 1, "method": "fail"}')["error"]
    assert (err["code"], err["message"]) == (INTERNAL_ERROR, "the card is gone")
    assert "RuntimeError" in err["data"]


# --- the retrying provider ----------------------------------------------------


class FlakyProvider(MemoryProvider):
    def __init__(self, chain_id, blocks, fail_times):
        super().__init__(chain_id, blocks)
        self.fail_times = fail_times
        self.calls = 0

    def light_block(self, height):
        self.calls += 1
        if self.calls <= self.fail_times:
            raise ProviderError("transient network flap")
        return super().light_block(height)


def test_retries_transient_then_succeeds(chain3):
    _, blocks = chain3
    slept = []
    p = RetryingProvider(FlakyProvider(CHAIN_ID, blocks, fail_times=2), retries=3, base_delay=0.05,
                         sleep=slept.append)
    assert p.light_block(2).height == 2
    assert slept == [0.05, 0.1]  # exponential backoff
    assert p.retries_total == 2
    assert p.chain_id() == CHAIN_ID


def test_exhausted_retries_raise_the_last_error(chain3):
    _, blocks = chain3
    slept = []
    p = RetryingProvider(FlakyProvider(CHAIN_ID, blocks, fail_times=99), retries=2, base_delay=1.5,
                         max_delay=2.0, sleep=slept.append)
    with pytest.raises(ProviderError, match="flap"):
        p.light_block(2)
    assert slept == [1.5, 2.0] and p.retries_total == 2
    with pytest.raises(ValueError, match="retries must be >= 0"):
        RetryingProvider(p, retries=-1)


def test_definitive_answers_are_not_retried(chain3):
    _, blocks = chain3
    inner = FlakyProvider(CHAIN_ID, blocks, fail_times=0)
    p = RetryingProvider(inner, retries=3, sleep=lambda s: None)
    with pytest.raises(HeightTooHighError):
        p.light_block(50)
    with pytest.raises(LightBlockNotFoundError):
        RetryingProvider(MemoryProvider(CHAIN_ID, []), sleep=lambda s: None).light_block(1)
    assert inner.calls == 1  # a single attempt, no retry burnt


def test_failure_budget_fails_fast_then_recovers(chain3):
    _, blocks = chain3
    clock = [0.0]
    p = RetryingProvider(FlakyProvider(CHAIN_ID, blocks, fail_times=4), retries=0, failure_budget=4,
                         budget_window=60.0, sleep=lambda s: None, clock=lambda: clock[0])
    for _ in range(4):
        with pytest.raises(ProviderError):
            p.light_block(2)
    with pytest.raises(ProviderBudgetExhaustedError, match="4 transient failures in 60s"):
        p.light_block(2)
    assert p.fast_fails_total == 1
    clock[0] = 61.0  # the window slides: the budget is back
    assert p.light_block(2).height == 2

"""The port's light-client proxy and the ``light`` and ``lightd``
commands beside the JAX package's: the twin of
``tests/test_light_proxy.py``.

A live port node (one validator, fast timeouts, ``device="cpu"``) serves
its RPC; a port ``LightProxy`` (``HTTPProvider`` primary and witness,
the port's client on the CPU) answers only what it verified, and its
answers are the bytes of the JAX package's proxy over the same node.
Its faults: a witness with a conflicting header (the client's evidence
reaches the node's pool, which verifies it, and the height is never
answered), a device error (an ``INTERNAL_ERROR`` that names it, where
the reference answers ``INVALID_PARAMS``). The ``light`` and ``lightd``
commands run in processes of their own against the node."""

import json
import os
import signal
import subprocess
import sys
import urllib.request

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from tendermint_tpu.light.client import LightClient as JLightClient, TrustOptions as JTrustOptions
from tendermint_tpu.light.provider import HTTPProvider as JHTTPProvider
from tendermint_tpu.light.proxy import LightProxy as JLightProxy
from tendermint_tpu_torch.abci import types as abci
from tendermint_tpu_torch.light.client import LightClient, TrustOptions
from tendermint_tpu_torch.light.provider import HTTPProvider, Provider
from tendermint_tpu_torch.light.proxy import LightProxy
from tendermint_tpu_torch.ops.fault_injection import DeviceFault
from tendermint_tpu_torch.rpc.server import INTERNAL_ERROR, INVALID_PARAMS
from tendermint_tpu_torch.types.block import BlockID
from tendermint_tpu_torch.types.evidence import LightClientAttackEvidence
from tendermint_tpu_torch.types.light import LightBlock, SignedHeader
from tests.test_torch_execution import make_commit
from tests.test_torch_node import CHAIN, wait_for
from tests.test_torch_rpc import serving_port_node

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PERIOD = 10 * 365 * 86400.0  # the chain's genesis is in 2023


@pytest.fixture(scope="module")
def full_node(tmp_path_factory):
    with serving_port_node(tmp_path_factory.mktemp("lightproxy")) as (node, pv):
        node.submit_tx(b"lightq=1")
        assert wait_for(lambda: node.height >= 6, timeout=60)
        yield node, pv


def _anchor(node, height=2):
    return node.block_store.load_block_meta(height).block_id.hash


def _proxy(node, witnesses=None, height=2):
    url = node.rpc_server.url
    client = LightClient(CHAIN, TrustOptions(period=PERIOD, height=height, hash=_anchor(node, height)),
                         HTTPProvider(CHAIN, url), witnesses if witnesses is not None else [HTTPProvider(CHAIN, url)],
                         device="cpu")
    p = LightProxy(client, url)
    p.start()
    return p


@pytest.fixture(scope="module")
def proxies(full_node):
    node, _ = full_node
    url = node.rpc_server.url
    jclient = JLightClient(CHAIN, JTrustOptions(period=PERIOD, height=2, hash=_anchor(node)),
                           JHTTPProvider(CHAIN, url), [JHTTPProvider(CHAIN, url)], bisect_batching=False)
    jproxy = JLightProxy(jclient, url)
    jproxy.start()
    proxy = _proxy(node)
    try:
        yield proxy, jproxy
    finally:
        proxy.stop()
        jproxy.stop()


def _call(url, path):
    with urllib.request.urlopen(f"{url}/{path}", timeout=30) as resp:
        return json.load(resp)


def _get(url, path):
    doc = _call(url, path)
    assert "error" not in doc, doc["error"]
    return doc["result"]


class TestLightProxy:
    def test_status(self, proxies):
        out = _get(proxies[0].url, "status")["light_client"]
        assert out["chain_id"] == CHAIN and int(out["trusted_height"]) >= 2 and out["num_witnesses"] == 1

    def test_verified_answers_are_the_reference_proxys_bytes(self, full_node, proxies):
        node, _ = full_node
        proxy, jproxy = proxies
        for h in (3, 5, 4):
            for route in ("header", "commit", "validators"):
                got = _get(proxy.url, f"{route}?height={h}")
                assert json.dumps(got, sort_keys=True) == json.dumps(_get(jproxy.url, f"{route}?height={h}"),
                                                                     sort_keys=True), (route, h)
            commit = _get(proxy.url, f"commit?height={h}")
            assert commit["canonical"] is True
            assert commit["signed_header"]["commit"]["block_id"]["hash"] == \
                node.block_store.load_block_meta(h).block_id.hash.hex().upper()
        assert _get(proxy.url, "validators?height=3")["count"] == "1"

    def test_bad_heights_are_invalid_params(self, proxies):
        for path in ("header", "commit?height=x", "header?height=0", "commit?height=100000"):
            doc = _call(proxies[0].url, path)
            assert doc["error"]["code"] == INVALID_PARAMS, (path, doc)
            assert doc["error"]["message"].startswith(("height required", "light verification failed")), doc

    def test_tampered_trust_anchor_fails(self, full_node):
        node, _ = full_node
        with pytest.raises(Exception, match="expected header's hash"):
            LightClient(CHAIN, TrustOptions(period=PERIOD, height=2, hash=b"\x11" * 32),
                        HTTPProvider(CHAIN, node.rpc_server.url), [], device="cpu")

    def test_abci_query_pinned_to_a_verified_height(self, full_node, proxies):
        node, _ = full_node
        assert node.app.query(abci.RequestQuery(data=b"lightq")).value == b"1"
        resp = _get(proxies[0].url, 'abci_query?data="0x6c6967687471"')["response"]
        assert resp["value"] == "MQ==" and int(resp["verified_height"]) >= 2
        resp = _get(proxies[0].url, 'abci_query?data="0x6c6967687471"&height=4')["response"]
        assert resp["verified_height"] == "4"
        assert _get(proxies[0].url, "abci_info")["response"]["last_block_height"]


def test_a_device_error_is_an_internal_error_never_an_answer(full_node, monkeypatch):
    """The port's proxy answers a device error ``INTERNAL_ERROR`` with
    its message and type; the reference's proxy reads every error as a
    failed verification (``INVALID_PARAMS``)."""
    node, _ = full_node
    url = node.rpc_server.url
    jproxy = JLightProxy(JLightClient(CHAIN, JTrustOptions(period=PERIOD, height=2, hash=_anchor(node)),
                                      JHTTPProvider(CHAIN, url), [], bisect_batching=False), url)
    proxy = _proxy(node, witnesses=[])
    jproxy.start()
    try:
        def fault(*args, **kwargs):
            raise DeviceFault("injected light fault")

        monkeypatch.setattr(proxy.client, "verify_light_block_at_height", fault)
        monkeypatch.setattr(jproxy.client, "verify_light_block_at_height", fault)
        doc = _call(proxy.url, "commit?height=5")
        assert "result" not in doc and doc["error"]["code"] == INTERNAL_ERROR
        assert doc["error"]["message"] == "injected light fault" and "DeviceFault" in doc["error"]["data"]
        jdoc = _call(jproxy.url, "commit?height=5")
        assert jdoc["error"]["code"] == INVALID_PARAMS
        assert jdoc["error"]["message"] == "light verification failed: injected light fault"
    finally:
        proxy.stop()
        jproxy.stop()


class ForkingWitness(Provider):
    """A witness that serves the node's chain, except at ``fork_at``: a
    header with another app hash, signed by the node's validator."""

    def __init__(self, url, priv_key, fork_at):
        self.inner = HTTPProvider(CHAIN, url)
        self.priv_key, self.fork_at, self.evidence = priv_key, fork_at, []

    def chain_id(self):
        return CHAIN

    def light_block(self, height):
        lb = self.inner.light_block(height)
        if height != self.fork_at:
            return lb
        header = lb.signed_header.header
        header.app_hash = bytes(32)
        header._hash = None
        commit = lb.signed_header.commit
        block_id = BlockID(header.hash(), commit.block_id.part_set_header)
        forged = make_commit(block_id, height, commit.round, lb.validator_set, [self.priv_key], chain_id=CHAIN,
                             time_ns=commit.signatures[0].timestamp.to_unix_ns())
        return LightBlock(SignedHeader(header, forged), lb.validator_set)

    def report_evidence(self, evidence):
        self.evidence.append(evidence)


def test_a_conflicting_witness_is_evidence_at_the_primary(full_node):
    node, pv = full_node
    witness = ForkingWitness(node.rpc_server.url, pv.priv_key, fork_at=5)
    proxy = _proxy(node, witnesses=[witness], height=3)
    try:
        assert _get(proxy.url, "commit?height=4")["signed_header"]["header"]["height"] == "4"
        doc = _call(proxy.url, "commit?height=5")
        assert "result" not in doc and doc["error"]["code"] == INVALID_PARAMS
        assert "conflicting headers detected" in doc["error"]["message"]
        assert proxy.client.trusted_light_block(5) is None
        pending, _ = node.evidence_pool.pending_evidence(1 << 20)
        assert len(pending) == 1 and isinstance(pending[0], LightClientAttackEvidence)
        ev = pending[0]
        assert ev.conflicting_block.signed_header.header.app_hash == bytes(32) and ev.common_height == 4
        assert witness.evidence == []  # reported to the others, not to the witness at fault
    finally:
        proxy.stop()


def _run_command(argv, path, timeout=120):
    """Start ``python -m tendermint_tpu_torch`` with ``argv``, read the URL
    from its banner, GET ``path``, then SIGTERM it; returns (result, rc)."""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen([sys.executable, "-m", "tendermint_tpu_torch", *argv], cwd=REPO, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        banner = proc.stdout.readline()
        assert " on http://" in banner, (banner, proc.stderr.read() if proc.poll() is not None else "")
        url = banner.split(" on ", 1)[1].split()[0]
        result = _get(url, path)
    finally:
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=30)
    return result, rc


@pytest.mark.parametrize("command, path", [("light", "commit?height=5"), ("lightd", "light_header?height=5")])
def test_the_light_commands_answer_a_verified_header(full_node, command, path):
    node, _ = full_node
    url = node.rpc_server.url
    argv = [command, url, "--chain-id", CHAIN, "--trust-height", "1", "--trust-hash", _anchor(node, 1).hex(),
            "--trust-period", str(PERIOD), "--witness", url, "--device", "cpu",
            "--laddr" if command == "light" else "--listen", "127.0.0.1:0"]
    result, rc = _run_command(argv, path)
    want = node.block_store.load_block_meta(5).block_id.hash.hex().upper()
    commit = result["signed_header"]["commit"] if command == "light" else result["commit"]
    assert commit["block_id"]["hash"] == want and rc == 0

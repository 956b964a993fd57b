"""The port's websocket endpoint beside the JAX package's: the twin of
``tests/test_websocket.py``.

- Frame parity: each package's ``RPCServer`` serves the seeded chain of
  ``tests/test_torch_rpc.py`` with its event bus; one websocket client
  each sends the same requests (a subscription, routes, errors), the
  same block and tx events are published on both buses, and every frame
  the servers send must be the same bytes.
- A live port node: subscribe to NewBlock and Tx, unsubscribe, the
  route table over the socket, a plain GET refused; and the routes the
  reference's test adds (``genesis_chunked``, ``tx`` with a proof,
  ``remove_tx``).
"""

import base64
import json
import struct
import time

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from tendermint_tpu import eventbus as jeb
from tendermint_tpu.state.execution import _unmarshal_finalize_response as _junmarshal
from tendermint_tpu_torch import eventbus as eb
from tendermint_tpu_torch.crypto.merkle import Proof
from tendermint_tpu_torch.rpc import websocket as ws
from tendermint_tpu_torch.rpc.client import HTTPClient
from tendermint_tpu_torch.rpc.server import RPCServer
from tendermint_tpu_torch.state.execution import _unmarshal_finalize_response
from tendermint_tpu_torch.types.block import tx_hash
from tests.test_torch_node import CHAIN, wait_for
from tests.test_torch_rpc import chain_envs, serving_port_node  # noqa: F401  (chain_envs: a fixture)
from tests.test_websocket import WSClient


def _recv_frame(client, timeout=10.0):
    """The next text frame's payload, as bytes."""
    client.sock.settimeout(timeout)
    while True:
        hdr = client._read_exact(2)
        opcode, length = hdr[0] & 0x0F, hdr[1] & 0x7F
        if length == 126:
            (length,) = struct.unpack(">H", client._read_exact(2))
        elif length == 127:
            (length,) = struct.unpack(">Q", client._read_exact(8))
        payload = client._read_exact(length)
        if opcode == 0x1:
            return payload
        if opcode == 0x8:
            return None


def test_handshake_helpers_match_the_reference():
    from tendermint_tpu.rpc import websocket as jws

    for key in ("dGhlIHNhbXBsZSBub25jZQ==", base64.b64encode(bytes(range(16))).decode()):
        assert ws.accept_key(key) == jws.accept_key(key)
    assert ws.accept_key("dGhlIHNhbXBsZSBub25jZQ==") == "s3pPLMBiTxaQ9kYGzzhZRbK+xOo="  # RFC 6455 1.3
    headers = {"Upgrade": "WebSocket", "Connection": "keep-alive, Upgrade", "Sec-WebSocket-Key": "x"}
    assert ws.is_upgrade_request(headers) and jws.is_upgrade_request(headers)
    assert not ws.is_upgrade_request({"Upgrade": "websocket", "Connection": "Upgrade"})


def test_every_frame_is_the_same_bytes(chain_envs):
    (env, _, executor), (jenv, _, jexecutor) = chain_envs
    frames = []
    for e, ex, bus_mod, server_of, unmarshal in (
        (env, executor, eb, lambda r, bus: RPCServer(r, event_bus=bus), _unmarshal_finalize_response),
        (jenv, jexecutor, jeb, lambda r, bus: __import__("tendermint_tpu.rpc.server", fromlist=["x"]).RPCServer(
            r, event_bus=bus, evloop=False), _junmarshal),
    ):
        bus = bus_mod.EventBus()
        server = server_of(e.routes(), bus)
        server.start()
        client = WSClient(*server.address)
        got = []
        try:
            reqs = [("subscribe", {"query": "tm.event = 'NewBlock'"}, 7),
                    ("subscribe", {"query": "tm.event = 'Tx' AND tx.height = 3"}, 8),
                    ("subscribe", {}, 9), ("status", {}, 10), ("block", {"height": 3}, 11),
                    ("validators", {"height": 4, "per_page": 2}, 12), ("nonsense", {}, 13),
                    ("block", {"height": 99}, 14), ("unsubscribe", {"query": "tm.event = 'Tx' AND tx.height = 3"}, 15),
                    ("subscribe", {"query": "tm.event = 'Tx'"}, 16)]
            for method, params, rid in reqs:
                client.send_text(json.dumps({"jsonrpc": "2.0", "id": rid, "method": method, "params": params}))
                got.append(_recv_frame(client))
            client.send_text('{"jsonrpc": "2.0", "id": 17, "method": "status", "params": [1]}')
            got.append(_recv_frame(client))
            client.send_text("not json")
            got.append(_recv_frame(client))
            block = ex.block_store.load_block(3)
            meta = ex.block_store.load_block_meta(3)
            fres = unmarshal(ex.state_store.load_finalize_block_response(3))
            bus.publish_event_new_block(bus_mod.EventDataNewBlock(block=block, block_id=meta.block_id,
                                                                  result_finalize_block=fres))
            got.append(_recv_frame(client))
            bus.publish_event_tx(bus_mod.EventDataTx(height=3, index=1, tx=block.data.txs[1],
                                                     result=fres.tx_results[1]))
            got.append(_recv_frame(client))
        finally:
            client.close()
            server.stop()
        frames.append(got)
    assert frames[0] == frames[1]
    push = json.loads(frames[0][-2])
    assert push["id"] == 7 and push["result"]["data"]["type"] == "new_block"
    assert push["result"]["data"]["height"] == "3" and push["result"]["events"]["tm.event"] == ["NewBlock"]
    assert json.loads(frames[0][-1])["id"] == 16


@pytest.fixture(scope="module")
def ws_node(tmp_path_factory):
    with serving_port_node(tmp_path_factory.mktemp("wsnode")) as (node, _):
        yield (node, *node.rpc_server.address)


class TestWebsocket:
    def test_subscribe_new_block_sees_each_height_once_in_order(self, ws_node):
        node, host, port = ws_node
        client = WSClient(host, port)
        try:
            ack = client.call("subscribe", {"query": "tm.event = 'NewBlock'"}, rid=7)
            assert ack["id"] == 7 and ack["result"] == {}
            heights = []
            for _ in range(3):
                push = client.recv_json(timeout=30)
                assert push["id"] == 7 and push["result"]["query"] == "tm.event = 'NewBlock'"
                assert push["result"]["data"]["type"] == "new_block" and "tm.event" in push["result"]["events"]
                heights.append(int(push["result"]["data"]["height"]))
            assert heights == list(range(heights[0], heights[0] + 3))
        finally:
            client.close()

    def test_subscribe_tx_event(self, ws_node):
        node, host, port = ws_node
        client = WSClient(host, port)
        try:
            client.call("subscribe", {"query": "tm.event = 'Tx'"}, rid=9)
            node.submit_tx(b"ws=push")
            push = client.recv_json(timeout=30)
            assert push["id"] == 9 and push["result"]["data"]["type"] == "tx"
            assert base64.b64decode(push["result"]["data"]["tx"]) == b"ws=push"
        finally:
            client.close()

    def test_unsubscribe_stops_pushes(self, ws_node):
        node, host, port = ws_node
        client = WSClient(host, port)
        try:
            client.call("subscribe", {"query": "tm.event = 'NewBlock'"}, rid=1)
            assert client.recv_json(timeout=30)["id"] == 1
            frame = client.call("unsubscribe", {"query": "tm.event = 'NewBlock'"}, rid=2)
            while frame["id"] == 1:  # a push already in flight
                frame = client.recv_json(timeout=10)
            assert frame == {"jsonrpc": "2.0", "id": 2, "result": {}}
            with pytest.raises(OSError):  # silence after the ack: the read times out
                client.recv_json(timeout=2.0)
            assert node.event_bus.num_subscriptions() == 0
        finally:
            client.close()

    def test_normal_routes_over_ws(self, ws_node):
        node, host, port = ws_node
        client = WSClient(host, port)
        try:
            assert int(client.call("status", rid=3)["result"]["sync_info"]["latest_block_height"]) >= 1
            assert "response" in client.call("abci_info", rid=4)["result"]
            assert client.call("no_such_method", rid=5)["error"]["code"] == -32601
        finally:
            client.close()

    def test_plain_get_on_websocket_path_rejected(self, ws_node):
        import urllib.error
        import urllib.request

        node, host, port = ws_node
        with pytest.raises(urllib.error.HTTPError) as info:
            urllib.request.urlopen(f"http://{host}:{port}/websocket", timeout=5)
        assert info.value.code == 400


class TestNewRoutes:
    def test_genesis_chunked(self, ws_node):
        node, _, _ = ws_node
        client = HTTPClient(node.rpc_server.url)
        out = client.call("genesis_chunked", {"chunk": 0})
        assert out["total"] == "1" and out["chunk"] == "0"
        assert json.loads(base64.b64decode(out["data"]))["chain_id"] == CHAIN
        with pytest.raises(Exception, match="cannot fetch chunk 99"):
            client.call("genesis_chunked", {"chunk": 99})

    def test_tx_with_proof(self, ws_node):
        node, _, _ = ws_node
        client = HTTPClient(node.rpc_server.url)
        tx = b"prove=me"
        node.submit_tx(tx)
        h = tx_hash(tx)
        assert wait_for(lambda: node.indexer.get_tx(h) is not None, timeout=30), "tx never indexed"
        out = client.call("tx", {"hash": "0x" + h.hex(), "prove": True})
        p = out["proof"]["proof"]
        proof = Proof(total=int(p["total"]), index=int(p["index"]), leaf_hash=base64.b64decode(p["leaf_hash"]),
                      aunts=[base64.b64decode(a) for a in p["aunts"]])
        root = bytes.fromhex(out["proof"]["root_hash"])
        assert proof.verify(root, h)
        assert client.call("block", {"height": int(out["height"])})["block"]["header"]["data_hash"] == root.hex().upper()

    def test_remove_tx(self, ws_node):
        node, _, _ = ws_node
        client = HTTPClient(node.rpc_server.url)
        tx = b"remove=me-%d" % time.time_ns()
        node.mempool.check_tx(tx)
        assert tx in node.mempool.tx_list()
        client.call("remove_tx", {"tx_key": "0x" + tx_hash(tx).hex()})
        assert tx not in node.mempool.tx_list()
        with pytest.raises(Exception, match="32 bytes"):
            client.call("remove_tx", {"tx_key": "0xdead"})

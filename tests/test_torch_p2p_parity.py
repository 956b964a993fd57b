"""The port's p2p wire against the JAX package's.

- The same inputs give the same bytes: every consensus, blocksync, PEX,
  mempool and evidence message, ``NodeInfo``'s JSON and MConnection's
  packets (one at a time, and in the port's batches).
- The port's ``SecretConnection`` and the JAX one talk over a
  ``socket.socketpair()``, each as initiator, messages of 0, 1, 1,024
  and 70,000 bytes both ways; a tampered frame is refused on each side.
- A mixed network over TCP: a port node and a JAX node are the two
  validators of one chain and commit blocks together, with equal block
  hashes and app hashes. The JAX node runs in a subprocess with
  ``JAX_PLATFORMS=cpu``, so its process-wide sinks never enter this
  worker; both sides verify 2-lane commits on the host tier, so JAX
  traces no kernel.
"""

import json
import os
import queue
import socket
import struct
import subprocess
import sys
import threading
import time
import types

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from tendermint_tpu.blocksync import reactor as jbs
from tendermint_tpu.consensus import reactor as jcr
from tendermint_tpu.evidence import reactor as jevr
from tendermint_tpu.libs.bits import BitArray as JBitArray
from tendermint_tpu.mempool import reactor as jmr
from tendermint_tpu.p2p import mconn as jmconn
from tendermint_tpu.p2p import pex as jpex
from tendermint_tpu.p2p.peermanager import PeerAddress as JPeerAddress, PeerManager as JPeerManager
from tendermint_tpu.p2p.router import Envelope as JEnvelope
from tendermint_tpu.p2p.transport import NodeInfo as JNodeInfo, _SocketStream as JStream
from tendermint_tpu.types.block import BLOCK_PART_SIZE_BYTES, Block as JBlock, Proposal as JProposal
from tendermint_tpu.types.evidence import DuplicateVoteEvidence as JDuplicateVoteEvidence
from tendermint_tpu.types.part_set import PartSet as JPartSet
from tendermint_tpu_torch.blocksync import reactor as bs
from tendermint_tpu_torch.consensus import reactor as cr
from tendermint_tpu_torch.crypto.keys import Ed25519PrivKey
from tendermint_tpu_torch.evidence import reactor as evr
from tendermint_tpu_torch.libs.bits import BitArray
from tendermint_tpu_torch.mempool import reactor as mr
from tendermint_tpu_torch.p2p import mconn, pex
from tendermint_tpu_torch.p2p.peermanager import PeerAddress, PeerManager
from tendermint_tpu_torch.p2p.router import Envelope
from tendermint_tpu_torch.p2p.secret_connection import SecretConnection, SecretConnectionError, _frames, _nonce
from tendermint_tpu_torch.p2p.transport import NodeInfo, _SocketStream
from tendermint_tpu_torch.types.block import Block, Proposal, Vote
from tendermint_tpu_torch.types.evidence import evidence_from_proto_bytes
from tendermint_tpu_torch.types.part_set import Part
from tests import helpers as jhelpers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _Channel:
    def __init__(self, cid, sent):
        self.channel_id, self.sent = cid, sent

    def send(self, env):
        self.sent.append((env.to_peer, env.message))

    def broadcast(self, msg):
        self.sent.append(("*", msg))


class _Router:
    """Records what a reactor sends, per channel."""

    def __init__(self):
        self.sent = []

    def open_channel(self, cid):
        return _Channel(cid, self.sent)


def _consensus_objects():
    privs, vset = jhelpers.make_validators(4)
    commit = jhelpers.make_commit(jhelpers.make_block_id(b"wire"), 5, 1, vset, privs)
    jvote = commit.get_vote(2)
    jprop = JProposal(height=5, round=1, pol_round=0, block_id=commit.block_id,
                      timestamp=jvote.timestamp, signature=b"\x07" * 64)
    jpart = JPartSet.from_data(bytes(range(256)) * 600, BLOCK_PART_SIZE_BYTES).get_part(1)
    return (jvote, jprop, jpart), (Vote.from_proto_bytes(jvote.to_proto_bytes()),
                                   Proposal.from_proto_bytes(jprop.to_proto_bytes()),
                                   Part.from_proto_bytes(jpart.to_proto_bytes())), (privs, vset, commit)


def test_a_proposal_with_pol_round_0_keeps_it_across_the_wire():
    """Proto3 omits a zero pol_round; the port decodes the absent field as
    0, so the proposal's sign-bytes and signature survive the trip. The
    JAX decoder gives -1 there (a fault the port does not copy)."""
    from tendermint_tpu.types.block import Proposal as JProposalType

    (_, jprop, _), (_, prop, _), _ = _consensus_objects()
    raw = jprop.to_proto_bytes()
    assert jprop.pol_round == 0 and prop.pol_round == 0
    assert prop.sign_bytes("c") == jprop.sign_bytes("c") and prop.to_proto_bytes() == raw
    assert JProposalType.from_proto_bytes(raw).pol_round == -1
    for pol in (-1, 1):
        jprop.pol_round = pol
        assert Proposal.from_proto_bytes(jprop.to_proto_bytes()).pol_round == pol


def test_consensus_messages_are_the_references_bytes():
    (jvote, jprop, jpart), (vote, prop, part), _ = _consensus_objects()
    ba, jba = BitArray(13), JBitArray(13)
    for i in (0, 4, 12):
        ba.set_index(i, True)
        jba.set_index(i, True)
    pairs = [
        (jcr.encode_new_round_step(7, 2, 4, 1), cr.encode_new_round_step(7, 2, 4, 1)),
        (jcr.encode_proposal(jprop), cr.encode_proposal(prop)),
        (jcr.encode_block_part(5, 1, jpart), cr.encode_block_part(5, 1, part)),
        (jcr.encode_vote(jvote), cr.encode_vote(vote)),
        (jcr.encode_has_vote(5, 1, 2, 9), cr.encode_has_vote(5, 1, 2, 9)),
        (jcr.encode_vote_set_bits(5, 1, 2, jba), cr.encode_vote_set_bits(5, 1, 2, ba)),
    ]
    for want, got in pairs:
        assert got == want
    for name in ("STATE_CHANNEL", "DATA_CHANNEL", "VOTE_CHANNEL", "VOTE_SET_BITS_CHANNEL", "TAG_NEW_ROUND_STEP",
                 "TAG_PROPOSAL", "TAG_BLOCK_PART", "TAG_VOTE", "TAG_HAS_VOTE", "TAG_VOTE_SET_BITS",
                 "MAX_WIRE_VALIDATORS"):
        assert getattr(cr, name) == getattr(jcr, name), name
    # each side decodes the other's vote-set bits alike
    h, r, t, got = cr.decode_vote_set_bits(jcr.encode_vote_set_bits(5, 1, 2, jba)[1:])
    assert (h, r, t, got.get_true_indices()) == (5, 1, 2, [0, 4, 12])


def _block():
    from tests.test_torch_execution import advance_one_height, make_chain_env
    from tendermint_tpu_torch.types.block import ExtendedCommit

    executor, state, privs, vset, _ = make_chain_env()
    advance_one_height(executor, state, privs, vset, [b"wire=1", b"k=v"], ExtendedCommit())
    return executor.block_store.load_block(1)


def test_blocksync_messages_are_the_references_bytes():
    block = _block()
    jblock = JBlock.from_proto_bytes(block.to_proto_bytes())
    out = []
    for mod, env_cls, blk in ((jbs, JEnvelope, jblock), (bs, Envelope, block)):
        store = types.SimpleNamespace(load_block=lambda h, b=blk: b if h == 1 else None,
                                      base=lambda: 1, height=lambda: 1)
        router = _Router()
        reactor = mod.BlockSyncReactor(None, store, router)
        reactor.request_block("p", 9)
        reactor.broadcast_status_request()
        for msg in (bytes([mod.TAG_BLOCK_REQUEST]) + struct.pack(">q", 1),
                    bytes([mod.TAG_BLOCK_REQUEST]) + struct.pack(">q", 2),
                    bytes([mod.TAG_STATUS_REQUEST])):
            reactor._handle(env_cls(mod.BLOCKSYNC_CHANNEL, msg, from_peer="p"))
        out.append(router.sent)
    assert out[1] == out[0] and len(out[0]) == 5
    assert Block.from_proto_bytes(out[1][2][1][1:]).hash() == block.hash()


def test_pex_mempool_and_evidence_messages_are_the_references_bytes():
    addrs = [("b" * 40, "127.0.0.1:26656"), ("c" * 40, "10.0.0.2:26656")]
    out = []
    for mod, pm_cls, addr_cls, env_cls in ((jpex, JPeerManager, JPeerAddress, JEnvelope),
                                           (pex, PeerManager, PeerAddress, Envelope)):
        pm = pm_cls("a" * 40)
        for node_id, addr in addrs:
            pm.add_address(addr_cls(node_id, addr))
        router = _Router()
        reactor = mod.PexReactor(pm, router)
        reactor._handle(env_cls(mod.PEX_CHANNEL, bytes([mod.TAG_PEX_REQUEST]), from_peer="p"))
        out.append(router.sent)
    assert out[1] == out[0] and out[0][0][1][0] == pex.TAG_PEX_RESPONSE
    # the mempool's message is the tx
    sent = []
    for mod in (jmr, mr):
        router = _Router()
        mod.MempoolReactor(None, router).broadcast_tx(b"acct-00001=beef")
        sent.append(router.sent)
    assert sent[1] == sent[0] == [("*", b"acct-00001=beef")]
    # the evidence's message is its proto
    (jvote, _, _), _, (privs, vset, commit) = _consensus_objects()
    other = jhelpers.make_commit(jhelpers.make_block_id(b"other"), 5, 1, vset, privs).get_vote(2)
    jev = JDuplicateVoteEvidence.new(jvote, other, jvote.timestamp, vset)
    ev = evidence_from_proto_bytes(jev.to_proto_bytes())
    sent = []
    for mod, e in ((jevr, jev), (evr, ev)):
        router = _Router()
        mod.EvidenceReactor(None, router).broadcast_evidence(e)
        sent.append(router.sent)
    assert sent[1] == sent[0] and sent[0][0][1] == jev.to_proto_bytes()
    assert (mr.MEMPOOL_CHANNEL, evr.EVIDENCE_CHANNEL, pex.PEX_CHANNEL, bs.BLOCKSYNC_CHANNEL) == (
        jmr.MEMPOOL_CHANNEL, jevr.EVIDENCE_CHANNEL, jpex.PEX_CHANNEL, jbs.BLOCKSYNC_CHANNEL)


def test_node_info_json_is_the_references():
    kw = dict(node_id="ab" * 20, network="chain-x", moniker="m", channels=[0x20, 0x40], listen_addr="1.2.3.4:5")
    raw = JNodeInfo(**kw).to_json_bytes()
    assert NodeInfo(**kw).to_json_bytes() == raw
    assert NodeInfo.from_json_bytes(raw) == NodeInfo(**kw)
    assert JNodeInfo.from_json_bytes(NodeInfo(**kw).to_json_bytes()) == JNodeInfo(**kw)


def _packets(mod, msgs, batched=False):
    """The packets an MConnection of ``mod`` writes for ``msgs``."""
    sent, batches, stuck = [], [], queue.Queue()
    conn = mod.MConnection(
        sent.append, stuck.get, lambda c, m: None, lambda e: None,
        config=mod.MConnConfig(),
        **({"send_frames": lambda pkts: (batches.append(len(pkts)), sent.extend(pkts))} if batched else {}),
    )
    for cid, msg in msgs:
        assert conn.send(cid, msg)
    conn.start()
    want = sum(max(1, -(-len(m) // 1400)) for _, m in msgs)
    deadline = time.monotonic() + 10
    while len(sent) < want and time.monotonic() < deadline:
        time.sleep(0.01)
    conn.stop()
    return sent, batches


def test_mconnection_packets_are_the_references():
    msgs = [(0x21, bytes(range(256)) * 20), (0x22, b"a vote"), (0x40, b""), (0x00, b"\x01")]
    want, _ = _packets(jmconn, msgs)
    got, _ = _packets(mconn, msgs)
    assert got == want and len(want) == 7
    got, batches = _packets(mconn, msgs, batched=True)
    assert got == want and batches and sum(batches) == len(want)
    assert (mconn._PKT_PING, mconn._PKT_PONG, mconn._PKT_MSG) == (jmconn._PKT_PING, jmconn._PKT_PONG, jmconn._PKT_MSG)


# --- SecretConnection against the JAX one --------------------------------------


def _mixed_pair(port_initiates):
    """(port side, JAX side, port socket, JAX socket)."""
    from tendermint_tpu.crypto.keys import Ed25519PrivKey as JEd25519PrivKey
    from tendermint_tpu.p2p.secret_connection import SecretConnection as JSecretConnection

    a, b = socket.socketpair()
    out = {}
    port_key = Ed25519PrivKey.from_seed(b"\x21" * 32)
    jax_key = JEd25519PrivKey.from_seed(b"\x22" * 32)
    make_port = lambda: out.update(port=SecretConnection(_SocketStream(a), port_key))
    make_jax = lambda: out.update(jax=JSecretConnection(JStream(b), jax_key))
    first, second = (make_jax, make_port) if port_initiates else (make_port, make_jax)
    t = threading.Thread(target=first)
    t.start()
    second()
    t.join(timeout=10)
    assert out["port"].remote_pubkey.bytes() == jax_key.pub_key().bytes()
    assert out["jax"].remote_pubkey.bytes() == port_key.pub_key().bytes()
    return out["port"], out["jax"], a, b


@pytest.mark.parametrize("port_initiates", [True, False], ids=["port-dials", "jax-dials"])
def test_secret_connection_talks_to_the_jax_one(port_initiates):
    pytest.importorskip("cryptography")
    port, jax, _, _ = _mixed_pair(port_initiates)
    for n in (0, 1, 1024, 70_000):
        msg = (bytes(range(256)) * (n // 256 + 1))[:n]
        port.send_msg(msg)
        assert jax.recv_msg() == msg
        jax.send_msg(msg[::-1])
        assert port.recv_msg() == msg[::-1]
    # several messages in one write: the port opens them in one pass
    port.send_msgs([b"x" * 3000, b"", b"y"])
    assert [jax.recv_msg() for _ in range(3)] == [b"x" * 3000, b"", b"y"]
    for m in (b"p" * 2000, b"q"):
        jax.send_msg(m)
    time.sleep(0.05)
    assert [port.recv_msg(), port.recv_msg()] == [b"p" * 2000, b"q"]


def test_a_tampered_frame_is_refused_on_each_side():
    pytest.importorskip("cryptography")
    from tendermint_tpu.p2p.secret_connection import SecretConnectionError as JSecretConnectionError

    port, jax, a, b = _mixed_pair(True)
    # the JAX side seals a frame, one byte is flipped: the port refuses it
    sealed = bytearray(jax._send_cipher.encrypt(jax._nonce(jax._send_nonce), _frames(b"\x00\x00\x00\x02hi")[0], None))
    sealed[100] ^= 0x40
    b.sendall(bytes(sealed))
    with pytest.raises(SecretConnectionError):
        port.recv_msg()
    # and the other way
    sealed = bytearray(port._send_cipher.encrypt(_nonce(port._send_nonce), _frames(b"\x00\x00\x00\x02hi")[0]))
    sealed[-3] ^= 0x01
    a.sendall(bytes(sealed))
    with pytest.raises(JSecretConnectionError):
        jax.recv_msg()


# --- a port node and a JAX node, one chain over TCP -----------------------------

MIXED_HEIGHTS = 3
MIXED_LIMIT_S = 85.0

# The JAX node: argv = genesis JSON path, key file, state file, the port
# node's address, heights. It commits with the port node until the block
# after ``heights`` is stored, prints the block and app hashes, and stops.
_JAX_NODE = r"""
import json, sys, time
from tendermint_tpu.abci.client import LocalClient
from tendermint_tpu.abci.kvstore import KVStoreApplication
from tendermint_tpu.node.node import Node, NodeConfig
from tendermint_tpu.privval import FilePV
from tendermint_tpu.types.genesis import GenesisDoc
genesis_path, key, state, peer, heights = sys.argv[1:6]
heights = int(heights)
with open(genesis_path) as f:
    genesis = GenesisDoc.from_json(f.read())
node = Node(NodeConfig(chain_id=genesis.chain_id, wal_enabled=False, persistent_peers=[peer], moniker="jax",
                       tx_index=False), genesis, LocalClient(KVStoreApplication()),
            priv_validator=FilePV.load(key, state))
node.start()
deadline = time.monotonic() + float(sys.argv[6])
while node.height < heights + 1 and time.monotonic() < deadline:
    time.sleep(0.05)
out = {}
for h in range(1, min(node.height, heights + 1) + 1):
    b = node.block_store.load_block(h)
    out[h] = [b.hash().hex(), b.header.app_hash.hex()]
node.stop()
print(json.dumps(out), flush=True)
"""


def test_a_port_node_and_a_jax_node_commit_one_chain_over_tcp(tmp_path):
    pytest.importorskip("cryptography")
    from tendermint_tpu_torch.privval import FilePV
    from tests.test_torch_node import fast_genesis, make_node, wait_for
    import tendermint_tpu_torch
    from tendermint_tpu_torch import ops as tops
    from tendermint_tpu_torch.crypto import batch as crypto_batch
    from tendermint_tpu_torch.libs import tracing
    from tendermint_tpu_torch.ops import introspect

    t0 = time.monotonic()
    privs = [FilePV.generate(str(tmp_path / f"k{i}.json"), str(tmp_path / f"s{i}.json")) for i in range(2)]
    genesis_path = tmp_path / "genesis.json"
    genesis_path.write_text(fast_genesis(privs).to_json())
    saved = (tendermint_tpu_torch.DEFAULT_DEVICE, crypto_batch._shared_scheduler, tracing.tracer._observer,
             tracing.tracer._profile, introspect.profiler._enabled)
    tendermint_tpu_torch.DEFAULT_DEVICE = "cpu"
    crypto_batch._shared_scheduler = None
    node, app = make_node("port", privs, index=0)
    proc = None
    try:
        node.start()
        peer = f"{node.node_key.node_id}@{node.node_info.listen_addr}"
        env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
        left = MIXED_LIMIT_S - (time.monotonic() - t0)
        proc = subprocess.Popen(
            [sys.executable, "-c", _JAX_NODE, str(genesis_path), str(tmp_path / "k1.json"),
             str(tmp_path / "s1-jax.json"), peer, str(MIXED_HEIGHTS), str(left - 10)],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        stdout, stderr = proc.communicate(timeout=left)
        assert proc.returncode == 0, stderr[-3000:]
        jax_chain = {int(h): v for h, v in json.loads(stdout.strip().splitlines()[-1]).items()}
        assert len(jax_chain) == MIXED_HEIGHTS + 1, (jax_chain, stderr[-2000:])
        assert wait_for(lambda: node.height >= MIXED_HEIGHTS + 1, timeout=5)
        for h, (block_hash, app_hash) in jax_chain.items():
            block = node.block_store.load_block(h)
            assert block.hash().hex() == block_hash, h
            assert block.header.app_hash.hex() == app_hash, h
        # both proposed: the chain's proposers alternate between the two keys
        proposers = {node.block_store.load_block(h).header.proposer_address for h in jax_chain}
        assert len(proposers) == 2
        assert node.failed is None
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait()
        try:
            node.stop()
        finally:
            crypto_batch.shutdown_shared_scheduler()
            (tendermint_tpu_torch.DEFAULT_DEVICE, crypto_batch._shared_scheduler, observer, profile, enabled) = saved
            introspect.profiler._enabled = enabled
            tracing.tracer.set_metrics_observer(observer)
            tracing.tracer.set_profile_sink(profile)
            tops.bind_metrics(None)
    assert time.monotonic() - t0 < 90

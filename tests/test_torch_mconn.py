"""The port's MConnection and per-peer send queues.

The twin of ``tests/test_mconn.py`` (multiplexing, priorities, flow
control, keepalive, TCP end to end) and of ``tests/test_p2p_queues.py``
(the three queue disciplines and the router's use of them) on
``tendermint_tpu_torch.p2p``, test for test. Over TCP the send routine
hands batches of packets to the SecretConnection (``send_frames``), so
the TCP test runs that path.
"""

import queue
import threading
import time

import pytest

torch = pytest.importorskip("torch")

from tendermint_tpu_torch.p2p.key import NodeKey
from tendermint_tpu_torch.p2p.mconn import (
    MConnConfig,
    MConnection,
    MConnectionError,
    _PKT_MSG,
    _PKT_PING,
    _PKT_PONG,
)
from tendermint_tpu_torch.p2p.transport import NodeInfo, TCPTransport


class FramePipe:
    """An in-memory frame stream pair."""

    def __init__(self):
        self.a_to_b: "queue.Queue[bytes]" = queue.Queue()
        self.b_to_a: "queue.Queue[bytes]" = queue.Queue()

    def ends(self):
        a = (self.a_to_b.put, lambda: self.b_to_a.get(timeout=10))
        b = (self.b_to_a.put, lambda: self.a_to_b.get(timeout=10))
        return a, b


def _mk_pair(config_a=None, config_b=None):
    pipe = FramePipe()
    (send_a, recv_a), (send_b, recv_b) = pipe.ends()
    recvd_a, recvd_b = queue.Queue(), queue.Queue()
    errs_a, errs_b = [], []
    a = MConnection(
        send_a, recv_a, lambda c, m: recvd_a.put((c, m)), errs_a.append,
        config=config_a,
    )
    b = MConnection(
        send_b, recv_b, lambda c, m: recvd_b.put((c, m)), errs_b.append,
        config=config_b,
    )
    a.start()
    b.start()
    return a, b, recvd_a, recvd_b, errs_a, errs_b


class TestMultiplexing:
    def test_roundtrip_small(self):
        a, b, _, recvd_b, _, _ = _mk_pair()
        try:
            assert a.send(0x22, b"vote!")
            cid, msg = recvd_b.get(timeout=5)
            assert (cid, msg) == (0x22, b"vote!")
        finally:
            a.stop(); b.stop()

    def test_large_message_packetized(self):
        cfg = MConnConfig(max_packet_payload=100)
        a, b, _, recvd_b, _, _ = _mk_pair(cfg, MConnConfig())
        try:
            big = bytes(range(256)) * 40  # 10240 bytes -> ~103 packets
            assert a.send(0x21, big)
            cid, msg = recvd_b.get(timeout=10)
            assert cid == 0x21 and msg == big
        finally:
            a.stop(); b.stop()

    def test_interleaved_channels_reassemble(self):
        cfg = MConnConfig(max_packet_payload=64)
        a, b, _, recvd_b, _, _ = _mk_pair(cfg, MConnConfig())
        try:
            m1 = b"A" * 500
            m2 = b"B" * 500
            a.send(0x21, m1)
            a.send(0x22, m2)
            got = {}
            for _ in range(2):
                cid, msg = recvd_b.get(timeout=10)
                got[cid] = msg
            assert got == {0x21: m1, 0x22: m2}
        finally:
            a.stop(); b.stop()

    def test_full_queue_reports_failure_after_timeout(self):
        cfg = MConnConfig(
            send_queue_capacity=2, send_rate=50, send_timeout=0.1
        )
        a, b, _, _, _, _ = _mk_pair(cfg, MConnConfig())
        try:
            # tiny send rate: the queue backs up; sends block up to
            # send_timeout then report False (connection.go Send)
            oks = [a.send(0x40, b"x" * 100) for _ in range(20)]
            assert not all(oks), "full channel queue must report failure"
        finally:
            a.stop(); b.stop()


class TestPriorities:
    def test_high_priority_channel_wins_bandwidth(self):
        """With both queues saturated and constrained bandwidth, the
        votes channel (priority 10) must land far more packets than pex
        (priority 1) — connection.go's recentlySent/priority rule."""
        cfg = MConnConfig(
            max_packet_payload=100,
            send_rate=5000,  # ~50 packets/sec + 1s burst: queues stay full
            send_queue_capacity=4096,
        )
        a, b, _, recvd_b, _, _ = _mk_pair(cfg, MConnConfig())
        try:
            for i in range(300):
                a.send(0x22, b"V" * 90)   # priority 10
                a.send(0x00, b"P" * 90)   # priority 1
            time.sleep(2.0)
            counts = {0x22: 0, 0x00: 0}
            while True:
                try:
                    cid, _ = recvd_b.get_nowait()
                    counts[cid] += 1
                except queue.Empty:
                    break
            assert counts[0x22] > 0
            # scheduled proportionally to priority: votes should get
            # several times pex's share (10:1 ideal; allow slack)
            assert counts[0x22] >= 3 * max(1, counts[0x00]), counts
        finally:
            a.stop(); b.stop()


class TestFlowControl:
    def test_send_rate_limited(self):
        cfg = MConnConfig(max_packet_payload=1000, send_rate=10000)
        a, b, _, recvd_b, _, _ = _mk_pair(cfg, MConnConfig())
        try:
            t0 = time.monotonic()
            n_msgs, msg_size = 20, 1000
            for _ in range(n_msgs):
                a.send(0x21, b"z" * msg_size)
            for _ in range(n_msgs):
                recvd_b.get(timeout=30)
            elapsed = time.monotonic() - t0
            # 20kB at 10kB/s with 10kB burst: >= ~1s (un-throttled this
            # finishes in milliseconds)
            assert elapsed >= 0.8, f"rate limiter too permissive: {elapsed:.2f}s"
        finally:
            a.stop(); b.stop()


class TestKeepalive:
    def test_ping_pong(self):
        cfg = MConnConfig(ping_interval=0.2, pong_timeout=5.0)
        a, b, _, _, errs_a, _ = _mk_pair(cfg, MConnConfig())
        try:
            time.sleep(1.0)
            assert not errs_a, errs_a  # pongs flowed; no timeout
        finally:
            a.stop(); b.stop()

    def test_pong_timeout_errors_connection(self):
        # peer that never answers pings: error surfaces via on_error
        pipe = FramePipe()
        (send_a, recv_a), (_, recv_b) = pipe.ends()
        errs = []
        a = MConnection(
            send_a,
            recv_a,
            lambda c, m: None,
            errs.append,
            config=MConnConfig(ping_interval=0.1, pong_timeout=0.3),
        )
        a.start()
        # a "peer" that swallows everything silently
        def _swallow():
            try:
                for _ in range(1000):
                    recv_b()
            except queue.Empty:
                pass  # test is over; nothing more to swallow

        swallower = threading.Thread(target=_swallow, daemon=True)
        swallower.start()
        deadline = time.monotonic() + 5
        while not errs and time.monotonic() < deadline:
            time.sleep(0.05)
        a.stop()
        assert errs and "pong timeout" in str(errs[0])

    def test_recv_capacity_enforced(self):
        cfg_small = MConnConfig(recv_message_capacity=1000)
        a, b, _, _, _, errs_b = _mk_pair(MConnConfig(), cfg_small)
        try:
            a.send(0x21, b"x" * 5000)
            deadline = time.monotonic() + 5
            while not errs_b and time.monotonic() < deadline:
                time.sleep(0.05)
            assert errs_b and "recv capacity" in str(errs_b[0])
        finally:
            a.stop(); b.stop()


class TestTCPEndToEnd:
    def test_multiplexed_over_real_sockets(self):
        """Two TCP transports: a large block-parts message and small
        votes cross the same connection, packetized and prioritized."""
        nk1, nk2 = NodeKey.generate(), NodeKey.generate()
        t1, t2 = TCPTransport(nk1), TCPTransport(nk2)
        t1.listen("127.0.0.1:0")
        accepted = {}

        def do_accept():
            accepted["conn"] = t1.accept(timeout=10)

        th = threading.Thread(target=do_accept, daemon=True)
        th.start()
        dialer = t2.dial(t1.listen_addr)
        th.join(timeout=10)
        listener = accepted["conn"]

        info1 = NodeInfo(node_id=nk1.node_id, network="net")
        info2 = NodeInfo(node_id=nk2.node_id, network="net")
        results = {}

        def hs_listener():
            results["l"] = listener.handshake(info1)

        th2 = threading.Thread(target=hs_listener, daemon=True)
        th2.start()
        results["d"] = dialer.handshake(info2)
        th2.join(timeout=10)
        assert results["l"].node_id == nk2.node_id
        assert results["d"].node_id == nk1.node_id

        big = b"\xab" * 200_000  # ~143 packets at 1400B
        dialer.send(0x21, big)
        dialer.send(0x22, b"small vote")
        got = {}
        for _ in range(2):
            cid, msg = listener.receive()
            got[cid] = msg
        assert got[0x21] == big
        assert got[0x22] == b"small vote"
        dialer.close()
        listener.close()
        t1.close()
        t2.close()


# --- the per-peer send queues (tests/test_p2p_queues.py) ---------------------

from tendermint_tpu_torch.p2p.pqueue import (  # noqa: E402
    DEFAULT_PRIORITIES,
    FIFOQueue,
    SimplePriorityQueue,
    WDRRQueue,
    make_send_queue,
)
from tendermint_tpu_torch.p2p.router import Envelope  # noqa: E402

BLOCKSYNC = 0x40  # priority 5
VOTE = 0x22  # priority 10
LIGHT_BLOCK = 0x62  # priority 2


def _env(ch, i=0):
    return Envelope(ch, b"m%d" % i)


# --- factory ----------------------------------------------------------------


def test_factory_selects_types():
    assert isinstance(make_send_queue("fifo", 4), FIFOQueue)
    assert isinstance(make_send_queue("priority", 4), WDRRQueue)
    assert isinstance(make_send_queue("simple-priority", 4), SimplePriorityQueue)
    with pytest.raises(ValueError):
        make_send_queue("wdrr", 4)


# --- FIFO -------------------------------------------------------------------


def test_fifo_drops_new_on_full():
    q = FIFOQueue(3)
    assert all(q.put(_env(BLOCKSYNC, i)) for i in range(3))
    assert not q.put(_env(VOTE, 99))  # fifo has no priority lane
    assert q.get().message == b"m0"


def test_fifo_close_wakes_getter():
    q = FIFOQueue(3)
    import threading

    got = []
    t = threading.Thread(target=lambda: got.append(q.get(timeout=5)))
    t.start()
    time.sleep(0.05)
    q.close()
    t.join(timeout=2)
    assert got == [None] and q.closed


# --- WDRR priority ----------------------------------------------------------


def test_wdrr_full_queue_protects_consensus_votes():
    """The stalled-peer scenario: a blocksync flood fills the queue;
    an arriving consensus vote evicts a blocksync envelope instead of
    being dropped, and queued votes are never cannibalised by more
    blocksync traffic."""
    q = WDRRQueue(8)
    for i in range(8):
        assert q.put(_env(BLOCKSYNC, i))
    assert len(q) == 8
    # vote outranks blocksync: admitted by evicting the OLDEST blocksync
    assert q.put(_env(VOTE, 100))
    assert len(q) == 8
    assert q.dropped.get(BLOCKSYNC) == 1
    # more blocksync at full with an equal-priority floor: dropped
    assert not q.put(_env(BLOCKSYNC, 9))
    assert q.dropped.get(BLOCKSYNC) == 2
    # lower-priority statesync traffic is dropped too, not the vote
    assert not q.put(_env(LIGHT_BLOCK, 0))
    # the vote is still queued and dequeues ahead of the flood
    first = q.get()
    assert first.channel_id == VOTE


def test_wdrr_low_priority_not_starved():
    """WRR (not strict priority): under a sustained high-priority
    stream, low-priority envelopes still dequeue — at most `priority`
    high envelopes per round."""
    q = WDRRQueue(100)
    for i in range(30):
        q.put(_env(VOTE, i))
    q.put(_env(LIGHT_BLOCK, 0))
    order = [q.get().channel_id for _ in range(31)]
    pos = order.index(LIGHT_BLOCK)
    # votes have priority 10: the light-block envelope must appear
    # within the first round (10 votes + lower lanes), not after all 30
    assert pos <= 12, f"light block starved until position {pos}"


def test_wdrr_incoming_lowest_is_dropped():
    q = WDRRQueue(4)
    for i in range(4):
        assert q.put(_env(VOTE, i))
    assert not q.put(_env(LIGHT_BLOCK, 0))  # nothing lower to evict
    assert len(q) == 4


# --- simple priority --------------------------------------------------------


def test_simple_priority_orders_strictly():
    q = SimplePriorityQueue(10)
    q.put(_env(BLOCKSYNC, 0))
    q.put(_env(VOTE, 1))
    q.put(_env(LIGHT_BLOCK, 2))
    q.put(_env(VOTE, 3))
    got = [q.get().channel_id for _ in range(4)]
    assert got == [VOTE, VOTE, BLOCKSYNC, LIGHT_BLOCK]


def test_simple_priority_fifo_within_class_and_eviction():
    q = SimplePriorityQueue(3)
    q.put(_env(VOTE, 0))
    q.put(_env(BLOCKSYNC, 1))
    q.put(_env(BLOCKSYNC, 2))
    # full; a vote evicts the newest lowest-priority envelope
    assert q.put(_env(VOTE, 3))
    assert q.dropped.get(BLOCKSYNC) == 1
    got = [q.get().message for _ in range(3)]
    assert got == [b"m0", b"m3", b"m1"]  # votes FIFO, then old blocksync
    # full of votes: lower-priority incoming is rejected
    q2 = SimplePriorityQueue(2)
    q2.put(_env(VOTE, 0))
    q2.put(_env(VOTE, 1))
    assert not q2.put(_env(BLOCKSYNC, 9))


# --- router integration -----------------------------------------------------


def test_router_uses_configured_discipline():
    from tests.test_torch_p2p import make_router
    from tendermint_tpu_torch.p2p.key import NodeKey
    from tendermint_tpu_torch.p2p.peermanager import PeerAddress, PeerManager
    from tendermint_tpu_torch.p2p.router import Router
    from tendermint_tpu_torch.p2p.transport import MemoryNetwork, NodeInfo

    net = MemoryNetwork()
    nk = NodeKey.generate()
    info = NodeInfo(node_id=nk.node_id, network="q-chain", listen_addr="nq1")
    pm = PeerManager(nk.node_id)
    r1 = Router(info, pm, net.transport("nq1"), queue_type="priority")
    r2, nk2, pm2 = make_router(net, "nq2", chain="q-chain")
    ch_vote = r1.open_channel(VOTE)
    ch_bs = r1.open_channel(BLOCKSYNC)
    r2.open_channel(VOTE)
    r2.open_channel(BLOCKSYNC)
    r1.start()
    r2.start()
    try:
        pm.add_address(PeerAddress(nk2.node_id, "nq2"))
        deadline = time.monotonic() + 5
        while not r1.connected_peers() and time.monotonic() < deadline:
            time.sleep(0.02)
        assert r1.connected_peers() == [nk2.node_id]
        sq = r1._peer_send_queues[nk2.node_id]
        assert isinstance(sq, WDRRQueue)
        ch_vote.broadcast(b"a vote")
        ch_bs.broadcast(b"a block")
    finally:
        r1.stop()
        r2.stop()


def test_router_rejects_unknown_queue_type():
    from tendermint_tpu_torch.p2p.key import NodeKey
    from tendermint_tpu_torch.p2p.peermanager import PeerManager
    from tendermint_tpu_torch.p2p.router import Router
    from tendermint_tpu_torch.p2p.transport import MemoryNetwork, NodeInfo

    net = MemoryNetwork()
    nk = NodeKey.generate()
    info = NodeInfo(node_id=nk.node_id, network="x", listen_addr="nx")
    with pytest.raises(ValueError):
        Router(info, PeerManager(nk.node_id), net.transport("nx"),
               queue_type="bogus")


# --- disconnect perturbation (router quarantine) ----------------------------


def test_disconnect_all_drops_and_reconnects():
    """unsafe_disconnect_peers' engine: all peers drop, dial/accept stay
    quarantined for the duration, then persistent-peer retry reconnects
    (the e2e 'disconnect' perturbation, perturb.go:42-72 analog)."""
    from tests.test_torch_p2p import make_router
    from tendermint_tpu_torch.p2p.peermanager import PeerAddress
    from tendermint_tpu_torch.p2p.transport import MemoryNetwork

    net = MemoryNetwork()
    r1, nk1, pm1 = make_router(net, "dq1")
    r2, nk2, pm2 = make_router(net, "dq2")
    r1.open_channel(0x7E)
    r2.open_channel(0x7E)
    r1.start()
    r2.start()
    try:
        pm1.add_address(PeerAddress(nk2.node_id, "dq2"), persistent=True)
        deadline = time.monotonic() + 5
        while not r1.connected_peers() and time.monotonic() < deadline:
            time.sleep(0.02)
        assert r1.connected_peers()

        dropped = r1.disconnect_all(duration=1.0)
        assert dropped == 1
        assert r1.connected_peers() == []
        # still quarantined shortly after: no reconnect yet
        time.sleep(0.3)
        assert r1.connected_peers() == []
        # after the quarantine lapses the persistent peer comes back
        deadline = time.monotonic() + 20
        while not r1.connected_peers() and time.monotonic() < deadline:
            time.sleep(0.05)
        assert r1.connected_peers() == [nk2.node_id], "no reconnect"
    finally:
        r1.stop()
        r2.stop()

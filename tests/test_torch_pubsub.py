"""The port's query language, pubsub and event bus beside the JAX
package's: the twin of the pubsub and event-log parts of
``tests/test_rpc.py``.

Queries and event maps are drawn from a numpy seed; both packages must
parse each query to the same conditions (or refuse it with the same
message) and give the same match on every event map. The event bus must
flatten the same event data to the same composite keys."""

import hashlib
import threading
import time

import numpy as np
import pytest

pytest.importorskip("torch")

from tendermint_tpu import eventbus as jeb
from tendermint_tpu.abci import types as jabci
from tendermint_tpu.libs import pubsub as jpubsub
from tendermint_tpu_torch import eventbus as eb
from tendermint_tpu_torch.abci import types as abci
from tendermint_tpu_torch.libs import pubsub

SEED = 20261018
KEYS = ("tm.event", "tx.height", "tx.hash", "app.key", "transfer.amount", "a_b-c.d")
VALUES = ("NewBlock", "Tx", "5", "12", "-3", "2.5", "AB01", "apple", "")
OPS = ("=", "<", "<=", ">", ">=", "CONTAINS", "EXISTS")


def _random_query(rng):
    conds = []
    for _ in range(int(rng.integers(1, 4))):
        key = KEYS[int(rng.integers(len(KEYS)))]
        op = OPS[int(rng.integers(len(OPS)))]
        if op == "EXISTS":
            conds.append(f"{key} EXISTS")
            continue
        value = VALUES[int(rng.integers(len(VALUES)))]
        numeric = value.lstrip("-").replace(".", "", 1).isdigit()
        text = value if numeric and rng.random() < 0.5 else f"'{value}'"
        conds.append(f"{key} {op} {text}")
    query = " AND ".join(conds)
    if rng.random() < 0.1:  # a malformed one now and then
        query = query.replace("AND", "OR", 1) if "AND" in query else query + " AND"
    return query


def _random_events(rng):
    events = {}
    for key in KEYS:
        if rng.random() < 0.6:
            n = int(rng.integers(1, 3))
            events[key] = [VALUES[int(rng.integers(len(VALUES)))] for _ in range(n)]
    return events


def test_seeded_queries_parse_and_match_alike():
    rng = np.random.default_rng(SEED)
    events = [_random_events(rng) for _ in range(40)]
    parsed = refused = 0
    for _ in range(300):
        text = _random_query(rng)
        try:
            jq = jpubsub.Query.parse(text)
        except jpubsub.QueryError as e:
            with pytest.raises(pubsub.QueryError) as info:
                pubsub.Query.parse(text)
            assert str(info.value) == str(e)
            refused += 1
            continue
        q = pubsub.Query.parse(text)
        assert [(c.key, c.op, c.value) for c in q.conditions] == [(c.key, c.op, c.value) for c in jq.conditions]
        assert str(q) == str(jq) == text
        assert [q.matches(ev) for ev in events] == [jq.matches(ev) for ev in events], text
        parsed += 1
    assert parsed > 200 and refused > 10


@pytest.mark.parametrize("bad", ["", "AND", "tm.event =", "= 'x'", "a = 'b' OR c = 'd'", "a = 'b' c = 'd'"])
def test_parse_errors(bad):
    with pytest.raises(pubsub.QueryError):
        pubsub.Query.parse(bad)


@pytest.mark.parametrize("text, events, want", [
    ("tm.event = 'NewBlock'", {"tm.event": ["NewBlock"]}, True),
    ("tm.event = 'NewBlock'", {"tm.event": ["Tx"]}, False),
    ("tm.event = 'Tx' AND tx.height = 5", {"tm.event": ["Tx"], "tx.height": ["5"]}, True),
    ("tx.height > 3 AND tx.height <= 10", {"tx.height": ["10"]}, True),
    ("tx.height > 3 AND tx.height <= 10", {"tx.height": ["3"]}, False),
    ("transfer.amount EXISTS", {"transfer.amount": ["7"]}, True),
    ("tx.hash CONTAINS 'AB'", {"tx.hash": ["00ABFF"]}, True),
    ("tx.hash CONTAINS 'AB'", {"tx.hash": ["0011"]}, False),
])
def test_query_matches_as_the_reference(text, events, want):
    assert pubsub.Query.parse(text).matches(events) is want
    assert jpubsub.Query.parse(text).matches(events) is want


def test_fanout_capacity_and_unsubscribe():
    srv = pubsub.PubSubServer()
    s1 = srv.subscribe("a", "tm.event = 'X'", capacity=2)
    s2 = srv.subscribe("b", "tm.event = 'Y'")
    with pytest.raises(ValueError, match="already subscribed"):
        srv.subscribe("a", "tm.event = 'X'")
    for i in range(3):
        srv.publish(f"m{i}", {"tm.event": ["X"]})
    srv.publish("y", {"tm.event": ["Y"]})
    # a full subscription drops, it does not block the publisher
    assert [m.data for m in s1.drain()] == ["m0", "m1"]
    assert s2.next(timeout=1).data == "y" and s2.next(timeout=0.05) is None
    assert srv.num_clients() == 2 and srv.num_subscriptions() == 2
    srv.unsubscribe_all("a")
    assert s1.cancelled.is_set() and srv.num_subscriptions() == 1


def _tx_result(pkg, i):
    return pkg.ExecTxResult(code=i % 2, events=[pkg.Event(type="app", attributes=[
        pkg.EventAttribute(key="key", value=f"k{i}", index=True),
        pkg.EventAttribute(key="creator", value="kvstore", index=i % 3 == 0)])])


def test_the_bus_flattens_events_alike():
    """The same tx and block data give the same composite-key maps."""
    got = []
    for bus_mod, pkg in ((eb, abci), (jeb, jabci)):
        bus = bus_mod.EventBus()
        sub = bus.subscribe("s", "tm.event EXISTS", capacity=64)
        for i in range(5):
            bus.publish_event_tx(bus_mod.EventDataTx(height=7, index=i, tx=b"k%d=v" % i, result=_tx_result(pkg, i)))
        fres = pkg.ResponseFinalizeBlock(events=[pkg.Event(type="block", attributes=[
            pkg.EventAttribute(key="round", value="0", index=True)])])
        bus.publish_event_new_block(bus_mod.EventDataNewBlock(block=None, block_id=None, result_finalize_block=fres))
        bus.publish_event_block_sync_status(bus_mod.EventDataBlockSyncStatus(complete=True, height=7))
        got.append([m.events for m in sub.drain()])
    assert got[0] == got[1] and len(got[0]) == 7
    assert got[0][0]["tx.hash"] == [hashlib.sha256(b"k0=v").hexdigest().upper()]
    assert eb.query_for_event(eb.EVENT_TX) == jeb.query_for_event(jeb.EVENT_TX) == eb.QUERY_TX


def test_eventlog_truncation_resume():
    """A truncated scan hands back a resume cursor that skips nothing."""
    bus = eb.EventBus()
    for i in range(10):
        bus.publish_event_tx(eb.EventDataTx(height=i, index=0, tx=b"x%d" % i, result=abci.ExecTxResult()))
    items, more, resume = bus.eventlog.scan(max_items=4)
    assert [it.data.height for it in items] == [0, 1, 2, 3] and more is True
    seen = [it.data.height for it in items]
    while more:
        items, more, resume = bus.eventlog.scan(after=resume, max_items=4)
        seen.extend(it.data.height for it in items)
    assert seen == list(range(10))
    small = eb.EventBus(eventlog_size=3)
    for i in range(5):
        small.publish_event_tx(eb.EventDataTx(height=i, index=0, tx=b"y", result=abci.ExecTxResult()))
    assert [it.cursor for it in small.eventlog.scan()[0]] == [3, 4, 5]


def test_eventlog_longpoll():
    bus = eb.EventBus()
    got = []

    def waiter():
        items, _, _ = bus.eventlog.scan(query=pubsub.Query.parse(eb.QUERY_TX), wait=5.0)
        got.extend(items)

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.1)
    bus.publish_event_new_round(eb.EventDataNewRound(height=1, round=0, step="NEW_ROUND"))
    bus.publish_event_tx(eb.EventDataTx(height=1, index=0, tx=b"k=v", result=abci.ExecTxResult()))
    t.join(timeout=5)
    assert len(got) == 1 and got[0].type == eb.EVENT_TX


def test_a_failing_publish_escapes_the_port_state_machine_where_the_reference_drops_it():
    """The held divergence: the reference's ``_publish_event`` drops any
    error of a publish; the port's lets it escape (a publish cannot fail
    for a slow subscriber, so nothing is expected to)."""
    import types

    from tendermint_tpu.consensus.state import ConsensusState as JConsensusState
    from tendermint_tpu_torch.consensus.state import ConsensusState

    class BrokenBus:
        def publish_event_vote(self, data):
            raise RuntimeError("bus down")

    JConsensusState._publish_event(types.SimpleNamespace(event_bus=BrokenBus()), "publish_event_vote",
                                   lambda jeb_mod: jeb_mod.EventDataVote(vote=None))
    with pytest.raises(RuntimeError, match="bus down"):
        ConsensusState._publish_event(types.SimpleNamespace(event_bus=BrokenBus()), "publish_event_vote",
                                      lambda: eb.EventDataVote(vote=None))
    got = []
    bus = types.SimpleNamespace(publish_event_vote=got.append)
    ConsensusState._publish_event(types.SimpleNamespace(event_bus=bus), "publish_event_vote",
                                  lambda: eb.EventDataVote(vote="v"))
    ConsensusState._publish_event(types.SimpleNamespace(event_bus=None), "publish_event_vote", lambda: 1 / 0)
    assert [d.vote for d in got] == ["v"]

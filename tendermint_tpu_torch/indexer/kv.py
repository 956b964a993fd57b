"""KV event sink: tx + block indexing for /tx_search and /block_search.

A copy of ``tendermint_tpu/indexer/kv.py``, whole. The reference indexes txs and block events into a KV store behind the
``EventSink`` interface (internal/state/indexer/sink/kv/kv.go,
indexer/tx/kv/): tx results keyed by hash, plus composite-key event
index entries ``<key>/<value>/<height>/<index>`` enabling query-driven
search. This implementation keeps the same key discipline over the
storage/kv.py abstraction so any backend (MemDB or persistent) works.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

from tendermint_tpu_torch.abci import types as abci
from tendermint_tpu_torch.libs.pubsub import Query
from tendermint_tpu_torch.storage.kv import KVStore

_TX_HASH_PREFIX = b"tx.hash/"
_TX_HEIGHT_PREFIX = b"tx.height/"
_TX_EVENT_PREFIX = b"txevt/"
_BLOCK_EVENT_PREFIX = b"blkevt/"
_BLOCK_HEIGHT_KEY = b"blk.height/"


@dataclass
class TxResult:
    """Indexed transaction (proto abci.TxResult analog)."""

    height: int
    index: int
    tx: bytes
    result: abci.ExecTxResult

    def hash(self) -> bytes:
        return hashlib.sha256(self.tx).digest()

    def to_json(self) -> bytes:
        return json.dumps(
            {
                "height": self.height,
                "index": self.index,
                "tx": self.tx.hex(),
                "code": self.result.code,
                "data": self.result.data.hex(),
                "log": self.result.log,
                "gas_wanted": self.result.gas_wanted,
                "gas_used": self.result.gas_used,
                "events": [
                    {
                        "type": e.type,
                        "attributes": [
                            {"key": a.key, "value": a.value, "index": a.index}
                            for a in e.attributes
                        ],
                    }
                    for e in (self.result.events or [])
                ],
            }
        ).encode()

    @staticmethod
    def from_json(raw: bytes) -> "TxResult":
        d = json.loads(raw.decode())
        return TxResult(
            height=d["height"],
            index=d["index"],
            tx=bytes.fromhex(d["tx"]),
            result=abci.ExecTxResult(
                code=d["code"],
                data=bytes.fromhex(d["data"]),
                log=d["log"],
                gas_wanted=d["gas_wanted"],
                gas_used=d["gas_used"],
                events=[
                    abci.Event(
                        type=e["type"],
                        attributes=[
                            abci.EventAttribute(
                                key=a["key"], value=a["value"], index=a["index"]
                            )
                            for a in e["attributes"]
                        ],
                    )
                    for e in d["events"]
                ],
            ),
        )


def _evt_key(prefix: bytes, key: str, value: str, height: int, index: int) -> bytes:
    return prefix + (
        f"{key}/{value}/{height:020d}/{index:010d}".encode()
    )


def _prefix_end(prefix: bytes) -> bytes:
    """Smallest byte string greater than every key with this prefix."""
    p = bytearray(prefix)
    while p and p[-1] == 0xFF:
        p.pop()
    if not p:
        return b"\xff" * (len(prefix) + 1)
    p[-1] += 1
    return bytes(p)


def _iter_prefix(db: KVStore, prefix: bytes):
    return db.iterator(prefix, _prefix_end(prefix))


def _num_cond_matches(cond, val: float) -> bool:
    try:
        bound = float(cond.value)
    except ValueError:
        return False
    return (
        (cond.op == "=" and val == bound)
        or (cond.op == "<" and val < bound)
        or (cond.op == "<=" and val <= bound)
        or (cond.op == ">" and val > bound)
        or (cond.op == ">=" and val >= bound)
    )


class KVIndexer:
    """Tx + block event index over a KV store."""

    def __init__(self, db: KVStore):
        self.db = db

    # -- indexing -------------------------------------------------------------

    def _put_block_events(self, batch, height: int, events) -> None:
        batch.set(
            _BLOCK_HEIGHT_KEY + f"{height:020d}".encode(), str(height).encode()
        )
        for ev in events or []:
            if not ev.type:
                continue
            for attr in ev.attributes or []:
                if not attr.index:
                    continue
                batch.set(
                    _evt_key(
                        _BLOCK_EVENT_PREFIX,
                        f"{ev.type}.{attr.key}",
                        attr.value,
                        height,
                        0,
                    ),
                    str(height).encode(),
                )

    def _put_tx(self, batch, tr: "TxResult") -> None:
        h = tr.hash()
        batch.set(_TX_HASH_PREFIX + h, tr.to_json())
        batch.set(
            _evt_key(
                _TX_EVENT_PREFIX, "tx.height", str(tr.height), tr.height, tr.index
            ),
            h,
        )
        for ev in tr.result.events or []:
            if not ev.type:
                continue
            for attr in ev.attributes or []:
                if not attr.index:
                    continue
                batch.set(
                    _evt_key(
                        _TX_EVENT_PREFIX,
                        f"{ev.type}.{attr.key}",
                        attr.value,
                        tr.height,
                        tr.index,
                    ),
                    h,
                )

    def index_block_events(self, height: int, events: List[abci.Event]) -> None:
        batch = self.db.new_batch()
        self._put_block_events(batch, height, events)
        batch.write()

    def index_txs(self, results: Iterable[TxResult]) -> None:
        batch = self.db.new_batch()
        for tr in results:
            self._put_tx(batch, tr)
        batch.write()

    def index_finalized_block(self, height: int, txs, fres) -> None:
        """Index one decided block — block events plus per-tx results —
        in a SINGLE batch (one durable write per height). The one shared
        entry point for the live node (node._fire_events) and the
        offline reindex-event rebuild, so the two paths cannot diverge.
        ``fres`` is the ABCI ResponseFinalizeBlock."""
        txs = list(txs)
        batch = self.db.new_batch()
        self._put_block_events(batch, height, fres.events)
        for i, r in enumerate(fres.tx_results):
            if i >= len(txs):
                break
            self._put_tx(
                batch, TxResult(height=height, index=i, tx=txs[i], result=r)
            )
        batch.write()

    # -- queries --------------------------------------------------------------

    def get_tx(self, tx_hash: bytes) -> Optional[TxResult]:
        raw = self.db.get(_TX_HASH_PREFIX + tx_hash)
        return TxResult.from_json(raw) if raw is not None else None

    def search_txs(self, query: Query, limit: int = 100) -> List[TxResult]:
        """AND-of-conditions search; full records decoded only for the
        first ``limit`` matches (see search_tx_keys)."""
        keys = self.search_tx_keys(query)
        out = []
        for _, _, h in keys[:limit]:
            tr = self.get_tx(h)
            if tr is not None:
                out.append(tr)
        return out

    def search_tx_keys(self, query: Query) -> List[tuple]:
        """AND-of-conditions search mirroring tx/kv/kv.go: each condition
        produces a hash set from its index range; results are the
        intersection as sorted (height, index, hash) triples. (height,
        index) come from the index keys themselves, so paginating callers
        can count and order ALL matches without decoding any record —
        only the requested page pays get_tx (the reference pushes
        pagination into the kv sink the same way, tx/kv/kv.go)."""
        positions: dict = {}

        def _note(h: bytes, k: bytes) -> None:
            if h not in positions:
                tail = k.rsplit(b"/", 2)
                if len(tail) == 3:
                    try:
                        positions[h] = (int(tail[1]), int(tail[2]))
                        return
                    except ValueError:
                        pass
                positions[h] = None

        hash_sets: List[set] = []
        for cond in query.conditions:
            hashes = set()
            # tm.event is implicit in this index: every indexed entry IS
            # a Tx event (reference kv indexer special-cases it, tx/kv).
            if cond.key == "tm.event":
                if cond.op == "=" and cond.value != "Tx":
                    return []
                continue
            if cond.key == "tx.hash" and cond.op == "=":
                try:
                    h = bytes.fromhex(cond.value)
                except ValueError:
                    return []
                tr = self.get_tx(h)
                if tr is not None:
                    positions[h] = (tr.height, tr.index)
                    hash_sets.append({h})
                else:
                    hash_sets.append(set())
                continue
            if cond.op == "=":
                prefix = _TX_EVENT_PREFIX + f"{cond.key}/{cond.value}/".encode()
                for k, v in _iter_prefix(self.db, prefix):
                    h = bytes(v)
                    hashes.add(h)
                    _note(h, k)
            elif cond.op in ("<", "<=", ">", ">="):
                prefix = _TX_EVENT_PREFIX + f"{cond.key}/".encode()
                bound = float(cond.value)
                for k, v in _iter_prefix(self.db, prefix):
                    parts = k[len(prefix) :].rsplit(b"/", 2)
                    if len(parts) != 3:
                        continue
                    try:
                        val = float(parts[0])
                    except ValueError:
                        continue
                    if (
                        (cond.op == "<" and val < bound)
                        or (cond.op == "<=" and val <= bound)
                        or (cond.op == ">" and val > bound)
                        or (cond.op == ">=" and val >= bound)
                    ):
                        h = bytes(v)
                        hashes.add(h)
                        _note(h, k)
            elif cond.op == "CONTAINS":
                prefix = _TX_EVENT_PREFIX + f"{cond.key}/".encode()
                for k, v in _iter_prefix(self.db, prefix):
                    parts = k[len(prefix) :].rsplit(b"/", 2)
                    if len(parts) == 3 and cond.value.encode() in parts[0]:
                        h = bytes(v)
                        hashes.add(h)
                        _note(h, k)
            elif cond.op == "EXISTS":
                prefix = _TX_EVENT_PREFIX + f"{cond.key}/".encode()
                for k, v in _iter_prefix(self.db, prefix):
                    h = bytes(v)
                    hashes.add(h)
                    _note(h, k)
            hash_sets.append(hashes)
        if not hash_sets:
            # query was only tm.event = 'Tx': all indexed txs
            common = set()
            for k, v in _iter_prefix(self.db, _TX_EVENT_PREFIX + b"tx.height/"):
                h = bytes(v)
                common.add(h)
                _note(h, k)
        else:
            common = set.intersection(*hash_sets)
        triples = []
        for h in common:
            pos = positions.get(h)
            if pos is None:
                tr = self.get_tx(h)  # rare: unparseable key tail
                if tr is None:
                    continue
                pos = (tr.height, tr.index)
            triples.append((pos[0], pos[1], h))
        triples.sort()
        return triples

    def search_block_heights(self, query: Query, limit: int = 100) -> List[int]:
        height_sets: List[set] = []
        for cond in query.conditions:
            heights = set()
            if cond.key == "tm.event":
                if cond.op == "=" and cond.value != "NewBlock":
                    return []
                continue
            if cond.key == "block.height":
                prefix = _BLOCK_HEIGHT_KEY
                for _, v in _iter_prefix(self.db, prefix):
                    hv = int(v.decode())
                    if _num_cond_matches(cond, hv):
                        heights.add(hv)
                height_sets.append(heights)
                continue
            if cond.op == "=":
                prefix = _BLOCK_EVENT_PREFIX + f"{cond.key}/{cond.value}/".encode()
                for _, v in _iter_prefix(self.db, prefix):
                    heights.add(int(v.decode()))
            else:
                prefix = _BLOCK_EVENT_PREFIX + f"{cond.key}/".encode()
                for k, v in _iter_prefix(self.db, prefix):
                    parts = k[len(prefix) :].rsplit(b"/", 2)
                    if len(parts) != 3:
                        continue
                    sval = parts[0].decode()
                    if cond.op == "EXISTS":
                        heights.add(int(v.decode()))
                        continue
                    if cond.op == "CONTAINS":
                        if cond.value in sval:
                            heights.add(int(v.decode()))
                        continue
                    try:
                        val = float(sval)
                        bound = float(cond.value)
                    except ValueError:
                        continue
                    if (
                        (cond.op == "<" and val < bound)
                        or (cond.op == "<=" and val <= bound)
                        or (cond.op == ">" and val > bound)
                        or (cond.op == ">=" and val >= bound)
                    ):
                        heights.add(int(v.decode()))
            height_sets.append(heights)
        if not height_sets:
            # query was only tm.event = 'NewBlock': every stored height
            heights = set()
            for _, v in _iter_prefix(self.db, _BLOCK_HEIGHT_KEY):
                heights.add(int(v.decode()))
            return sorted(heights)[:limit]
        return sorted(set.intersection(*height_sets))[:limit]

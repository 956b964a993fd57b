"""Event sinks: kv, null, and SQL (the psql sink's schema on DB-API).

A copy of ``tendermint_tpu/indexer/sink.py``, whole. The reference indexes through an EventSink interface with three
implementations selected by config (internal/state/indexer/sink/:
kv, psql, null; indexer_service.go fans out to all configured sinks).
Mirrored here:

- ``kv`` — the default, backed by :class:`tendermint_tpu_torch.indexer.kv
  .KVIndexer` (supports tx_search/block_search);
- ``null`` — accepts and discards everything (sink/null/null.go): for
  validators that serve no queries and want zero indexing cost;
- ``sql`` — the reference's PostgreSQL schema
  (sink/psql/schema.sql: blocks / tx_results / events / attributes
  tables + event_attributes views) executed over any PEP 249 DB-API
  connection. The image ships no PostgreSQL server or driver, so the
  bundled dialect targets sqlite3 (stdlib) — the schema, insert order,
  and NULL-vs-tx_id semantics match psql.go:1; point ``connect`` at a
  psycopg connection and swap the paramstyle for a real postgres
  deployment (divergence documented here rather than stubbed).

Sinks receive the same single call the live node and the offline
``reindex-event`` rebuild share: ``index_finalized_block(height, txs,
fres)`` with ``fres`` the ABCI ResponseFinalizeBlock.
"""

from __future__ import annotations

import hashlib
import time
import warnings
from typing import List, Optional

from tendermint_tpu_torch.indexer.kv import TxResult

# sqlite3 dialect of sink/psql/schema.sql (BIGSERIAL -> AUTOINCREMENT,
# TIMESTAMPTZ -> TEXT (UTC ISO-8601), BYTEA -> BLOB, "index" quoted).
SQL_SCHEMA = """
CREATE TABLE IF NOT EXISTS blocks (
  rowid      INTEGER PRIMARY KEY AUTOINCREMENT,
  height     BIGINT NOT NULL,
  chain_id   VARCHAR NOT NULL,
  created_at TEXT NOT NULL,
  UNIQUE (height, chain_id)
);
CREATE INDEX IF NOT EXISTS idx_blocks_height_chain ON blocks(height, chain_id);
CREATE TABLE IF NOT EXISTS tx_results (
  rowid      INTEGER PRIMARY KEY AUTOINCREMENT,
  block_id   BIGINT NOT NULL REFERENCES blocks(rowid),
  "index"    INTEGER NOT NULL,
  created_at TEXT NOT NULL,
  tx_hash    VARCHAR NOT NULL,
  tx_result  BLOB NOT NULL,
  UNIQUE (block_id, "index")
);
CREATE TABLE IF NOT EXISTS events (
  rowid    INTEGER PRIMARY KEY AUTOINCREMENT,
  block_id BIGINT NOT NULL REFERENCES blocks(rowid),
  tx_id    BIGINT NULL REFERENCES tx_results(rowid),
  type     VARCHAR NOT NULL
);
-- Divergence from schema.sql: no UNIQUE (event_id, key) — ABCI events
-- legally carry repeated attribute keys and indexing must not fail on
-- them (the reference constraint would abort such blocks).
CREATE TABLE IF NOT EXISTS attributes (
  event_id      BIGINT NOT NULL REFERENCES events(rowid),
  key           VARCHAR NOT NULL,
  composite_key VARCHAR NOT NULL,
  value         VARCHAR NULL
);
CREATE VIEW IF NOT EXISTS event_attributes AS
  SELECT block_id, tx_id, type, key, composite_key, value
  FROM events LEFT JOIN attributes ON (events.rowid = attributes.event_id);
CREATE VIEW IF NOT EXISTS block_events AS
  SELECT blocks.rowid as block_id, height, chain_id, type, key,
         composite_key, value
  FROM blocks JOIN event_attributes
       ON (blocks.rowid = event_attributes.block_id)
  WHERE event_attributes.tx_id IS NULL;
CREATE VIEW IF NOT EXISTS tx_events AS
  SELECT height, "index", chain_id, type, key, composite_key, value,
         tx_results.created_at
  FROM blocks JOIN tx_results ON (blocks.rowid = tx_results.block_id)
  JOIN event_attributes ON (tx_results.rowid = event_attributes.tx_id)
  WHERE event_attributes.tx_id IS NOT NULL;
"""


class EventSink:
    """indexer/event_sink.go EventSink (condensed to the one shared
    entry point this tree uses)."""

    def index_finalized_block(self, height: int, txs, fres) -> None:
        raise NotImplementedError

    def close(self) -> None:  # pragma: no cover - default no-op
        pass


class NullEventSink(EventSink):
    """sink/null/null.go: discard everything."""

    def index_finalized_block(self, height: int, txs, fres) -> None:
        pass


class KVEventSink(EventSink):
    """The kv sink: delegates to KVIndexer (which also serves
    tx_search/block_search queries)."""

    def __init__(self, indexer):
        self.indexer = indexer

    def index_finalized_block(self, height: int, txs, fres) -> None:
        self.indexer.index_finalized_block(height, txs, fres)


class SQLEventSink(EventSink):
    """The psql sink's schema over a DB-API connection (psql.go:1).

    ``conn`` is any PEP 249 connection; ``paramstyle`` is "qmark" for
    sqlite3, "format" for psycopg. The schema is installed idempotently
    at construction.
    """

    def __init__(self, conn, chain_id: str, paramstyle: str = "qmark"):
        self._conn = conn
        self._chain_id = chain_id
        self._ph = "?" if paramstyle == "qmark" else "%s"
        cur = self._conn.cursor()
        for stmt in SQL_SCHEMA.split(";"):
            if stmt.strip():
                cur.execute(stmt)
        self._conn.commit()

    def _now(self) -> str:
        return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())

    def _insert(self, cur, sql: str, params) -> int:
        cur.execute(sql.replace("?", self._ph), params)
        return cur.lastrowid

    def index_finalized_block(self, height: int, txs, fres) -> None:
        """One transaction per block: block row, block events, tx rows,
        tx events — psql.go IndexBlockEvents + IndexTxEvents fused, as
        in the kv sink. A failure mid-block ROLLS BACK, so a later
        block's commit can never publish this block's partial rows."""
        try:
            self._index_block(height, txs, fres)
        except Exception:
            try:
                self._conn.rollback()
            except Exception:
                pass
            raise

    def _index_block(self, height: int, txs, fres) -> None:
        cur = self._conn.cursor()
        block_rowid = self._insert(
            cur,
            "INSERT INTO blocks (height, chain_id, created_at) VALUES (?, ?, ?)",
            (height, self._chain_id, self._now()),
        )
        for ev in getattr(fres, "events", []) or []:
            self._put_event(cur, block_rowid, None, ev)
        txs = list(txs)
        for i, result in enumerate(getattr(fres, "tx_results", []) or []):
            if i >= len(txs):
                break
            tx_hash = hashlib.sha256(txs[i]).hexdigest().upper()
            record = TxResult(
                height=height, index=i, tx=txs[i], result=result
            ).to_json()
            tx_rowid = self._insert(
                cur,
                'INSERT INTO tx_results (block_id, "index", created_at, '
                "tx_hash, tx_result) VALUES (?, ?, ?, ?, ?)",
                (block_rowid, i, self._now(), tx_hash, record),
            )
            for ev in getattr(result, "events", []) or []:
                self._put_event(cur, block_rowid, tx_rowid, ev)
        self._conn.commit()

    def _put_event(self, cur, block_rowid: int, tx_rowid: Optional[int], ev):
        if not getattr(ev, "type", ""):
            return
        event_rowid = self._insert(
            cur,
            "INSERT INTO events (block_id, tx_id, type) VALUES (?, ?, ?)",
            (block_rowid, tx_rowid, ev.type),
        )
        for attr in getattr(ev, "attributes", []) or []:
            key = attr.key if isinstance(attr.key, str) else attr.key.decode()
            val = (
                attr.value
                if isinstance(attr.value, str)
                else attr.value.decode("utf-8", "replace")
            )
            self._insert(
                cur,
                "INSERT INTO attributes (event_id, key, composite_key, value) "
                "VALUES (?, ?, ?, ?)",
                (event_rowid, key, f"{ev.type}.{key}", val),
            )

    def close(self) -> None:
        try:
            self._conn.close()
        except Exception:
            pass


class MultiSink(EventSink):
    """indexer_service.go: every block goes to ALL configured sinks.

    A failing sink is logged and skipped — indexing is observability,
    and an I/O error (disk full, sqlite locked) must never propagate
    into the consensus commit path that calls this."""

    def __init__(self, sinks: List[EventSink]):
        self.sinks = list(sinks)

    def index_finalized_block(self, height: int, txs, fres) -> None:
        for s in self.sinks:
            try:
                s.index_finalized_block(height, txs, fres)
            except Exception as exc:
                warnings.warn(
                    f"event sink {type(s).__name__} failed at height "
                    f"{height}: {exc!r} (block NOT indexed by this sink)"
                )

    def close(self) -> None:
        for s in self.sinks:
            s.close()

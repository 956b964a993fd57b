"""TxMempool: the priority mempool, gated by ABCI CheckTx.

A copy of ``tendermint_tpu/mempool/mempool.py`` (internal/mempool/
mempool.go:36-770): admission through CheckTx behind an LRU seen-cache,
one tx a sender, priority order (priority descending, then arrival),
reaping bounded by bytes and gas, eviction of lower-priority txs when
full, and after a block ``update``: the committed txs out, the TTL
purge, and CheckTx run again on the rest (recheck).

The pool's ``RLock`` is held across ``update`` and the recheck's
CheckTx calls (the executor's ``_commit`` holds ``lock()`` around
``update``), so a client's ``check_tx`` waits for a commit to finish,
as in the reference. It runs on the host only. The reference's
``pre_check`` and ``post_check`` hooks are left out: nothing sets them.
"""

from __future__ import annotations

import threading
import time as _time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from tendermint_tpu_torch.abci import types as abci
from tendermint_tpu_torch.abci.client import AbciClient
from tendermint_tpu_torch.libs.metrics import MempoolMetrics
from tendermint_tpu_torch.mempool.cache import LRUTxCache, NopTxCache
from tendermint_tpu_torch.types.block import tx_hash


@dataclass
class MempoolConfig:
    """config/config.go MempoolConfig, the reference's defaults."""

    size: int = 5000
    max_txs_bytes: int = 1024 * 1024 * 1024
    cache_size: int = 10000
    max_tx_bytes: int = 1024 * 1024
    ttl_duration: float = 0.0  # seconds; 0: no TTL
    ttl_num_blocks: int = 0
    recheck: bool = True
    keep_invalid_txs_in_cache: bool = False


@dataclass
class WrappedTx:
    """internal/mempool/tx.go WrappedTx."""

    tx: bytes
    hash: bytes
    height: int
    timestamp: float
    gas_wanted: int = 0
    priority: int = 0
    sender: str = ""
    seq: int = 0  # arrival order, the tie-break

    def size(self) -> int:
        return len(self.tx)


class TxMempool:
    def __init__(
        self,
        config: MempoolConfig,
        app_client: AbciClient,
        height: int = 0,
        now: Optional[Callable[[], float]] = None,
        metrics=None,
    ):
        self.config = config
        self.app = app_client
        self.height = height
        self._now = now or _time.monotonic
        self.metrics = metrics or MempoolMetrics.nop()
        self._mtx = threading.RLock()
        self.cache = LRUTxCache(config.cache_size) if config.cache_size > 0 else NopTxCache()
        self._by_key: Dict[bytes, WrappedTx] = {}  # guarded-by: _mtx
        self._by_sender: Dict[str, WrappedTx] = {}  # guarded-by: _mtx
        self._txs_bytes = 0  # guarded-by: _mtx
        self._seq = 0  # guarded-by: _mtx
        self._txs_available_event = threading.Event()
        self._notify_available = False

    # --- locking (BlockExecutor's commit holds it around update) -------------

    def lock(self) -> None:
        self._mtx.acquire()

    def unlock(self) -> None:
        self._mtx.release()

    # --- size ----------------------------------------------------------------

    def __len__(self) -> int:
        with self._mtx:
            return len(self._by_key)

    def size(self) -> int:
        return len(self)

    def size_bytes(self) -> int:
        with self._mtx:
            return self._txs_bytes

    def enable_txs_available(self) -> None:
        self._notify_available = True

    def txs_available(self) -> threading.Event:
        return self._txs_available_event

    # --- admission ------------------------------------------------------------

    def check_tx(self, tx: bytes, sender: str = "") -> abci.ResponseCheckTx:
        """mempool.go:175-243: validate, dedupe, ABCI CheckTx, insert."""
        if len(tx) > self.config.max_tx_bytes:
            raise ValueError(f"tx size {len(tx)} exceeds max {self.config.max_tx_bytes}")
        key = tx_hash(tx)
        if not self.cache.push(key):
            raise KeyError(f"tx already exists in cache: {key.hex()}")
        with self._mtx:
            if key in self._by_key:
                raise KeyError(f"tx already in mempool: {key.hex()}")
        res = self.app.check_tx(abci.RequestCheckTx(tx=tx, type=abci.CHECK_TX_TYPE_NEW))
        if not res.is_ok():
            if not self.config.keep_invalid_txs_in_cache:
                self.cache.remove(key)
            self.metrics.failed_txs.inc()
            return res
        with self._mtx:
            self._add_new_transaction(tx, key, res, sender)
            self.metrics.size.set(len(self._by_key))
        self.metrics.tx_size_bytes.observe(len(tx))
        return res

    def _add_new_transaction(self, tx: bytes, key: bytes, res: abci.ResponseCheckTx, sender: str) -> None:
        """mempool.go:450-599: sender dedupe, eviction by priority, insert."""
        sender = res.sender or sender
        if sender and sender in self._by_sender:
            raise KeyError(f"tx from same sender already in mempool: {sender}")
        self._seq += 1
        wtx = WrappedTx(
            tx=tx,
            hash=key,
            height=self.height,
            timestamp=self._now(),
            gas_wanted=res.gas_wanted,
            priority=res.priority,
            sender=sender,
            seq=self._seq,
        )
        if not self._can_add(wtx):
            # evict enough lower-priority txs to fit, else refuse
            victims = sorted(
                (w for w in self._by_key.values() if w.priority < wtx.priority),
                key=lambda w: (w.priority, -w.timestamp),
            )
            freed_count = self.config.size - len(self._by_key)
            freed_bytes = self.config.max_txs_bytes - self._txs_bytes
            to_evict = []
            for v in victims:
                if freed_count >= 1 and freed_bytes >= wtx.size():
                    break
                to_evict.append(v)
                freed_count += 1
                freed_bytes += v.size()
            if freed_count < 1 or freed_bytes < wtx.size():
                self.cache.remove(key)
                raise OverflowError("mempool is full")
            for v in to_evict:
                self._remove(v.hash)
                self.cache.remove(v.hash)
            if to_evict:
                self.metrics.evicted_txs.inc(len(to_evict))
        self._by_key[key] = wtx
        if sender:
            self._by_sender[sender] = wtx
        self._txs_bytes += wtx.size()
        if self._notify_available and len(self._by_key) == 1:
            self._txs_available_event.set()

    def _can_add(self, wtx: WrappedTx) -> bool:
        """mempool.go:714-733."""
        return len(self._by_key) < self.config.size and wtx.size() + self._txs_bytes <= self.config.max_txs_bytes

    # --- removal --------------------------------------------------------------

    def remove_tx_by_key(self, key: bytes) -> None:
        with self._mtx:
            self._remove(key)
            self.cache.remove(key)

    def _remove(self, key: bytes) -> None:
        wtx = self._by_key.pop(key, None)
        if wtx is None:
            return
        if wtx.sender:
            self._by_sender.pop(wtx.sender, None)
        self._txs_bytes -= wtx.size()

    def flush(self) -> None:
        """Remove every tx; the cache stays (mempool.go:280-296)."""
        with self._mtx:
            self._by_key.clear()
            self._by_sender.clear()
            self._txs_bytes = 0

    # --- reaping --------------------------------------------------------------

    def _sorted_entries(self) -> List[WrappedTx]:
        """Priority descending, then arrival order (mempool.go:298-323)."""
        return sorted(self._by_key.values(), key=lambda w: (-w.priority, w.seq))

    def reap_max_bytes_max_gas(self, max_bytes: int, max_gas: int) -> List[bytes]:
        """mempool.go:325-341: stops at the FIRST tx over either budget,
        so a lower-priority tx never leapfrogs an over-budget one."""
        with self._mtx:
            out: List[bytes] = []
            total_bytes = total_gas = 0
            for wtx in self._sorted_entries():
                total_gas += wtx.gas_wanted
                total_bytes += wtx.size()
                if (max_gas >= 0 and total_gas > max_gas) or (max_bytes >= 0 and total_bytes > max_bytes):
                    break
                out.append(wtx.tx)
            return out

    def reap_max_txs(self, max_txs: int) -> List[bytes]:
        with self._mtx:
            entries = self._sorted_entries()
            if max_txs >= 0:
                entries = entries[:max_txs]
            return [w.tx for w in entries]

    def tx_list(self) -> List[bytes]:
        """The txs in gossip (arrival) order, the clist walk's."""
        with self._mtx:
            return [w.tx for w in sorted(self._by_key.values(), key=lambda w: w.seq)]

    # --- after a block ----------------------------------------------------------

    def update(
        self,
        height: int,
        txs: List[bytes],
        tx_results: List[abci.ExecTxResult],
        recheck: Optional[bool] = None,
    ) -> None:
        """mempool.go:381-448. CONTRACT: the caller holds ``lock()``
        (the executor's commit does)."""
        self.height = height
        if self._notify_available:
            self._txs_available_event.clear()
        for tx, res in zip(txs, tx_results):
            key = tx_hash(tx)
            if res.is_ok():
                self.cache.push(key)  # committed: kept in the cache to dedupe
            else:
                self.cache.remove(key)
            self._remove(key)
        self._purge_expired(height)
        do_recheck = self.config.recheck if recheck is None else recheck
        if do_recheck and self._by_key:
            self._recheck_transactions()
        if self._notify_available and self._by_key:
            self._txs_available_event.set()
        self.metrics.size.set(len(self._by_key))

    def _purge_expired(self, block_height: int) -> None:
        """mempool.go:735-759: the TTL by age and by blocks."""
        now = self._now()
        expired = [
            key
            for key, wtx in self._by_key.items()
            if (self.config.ttl_duration > 0 and now - wtx.timestamp > self.config.ttl_duration)
            or (self.config.ttl_num_blocks > 0 and block_height - wtx.height > self.config.ttl_num_blocks)
        ]
        for key in expired:
            self._remove(key)
            self.cache.remove(key)
        if expired:
            self.metrics.evicted_txs.inc(len(expired))

    def _recheck_transactions(self) -> None:
        """mempool.go:662-712: CheckTx again on the survivors of a block."""
        for wtx in self._sorted_entries():
            res = self.app.check_tx(abci.RequestCheckTx(tx=wtx.tx, type=abci.CHECK_TX_TYPE_RECHECK))
            if res.is_ok():
                wtx.priority = res.priority
            else:
                self._remove(wtx.hash)
                if not self.config.keep_invalid_txs_in_cache:
                    self.cache.remove(wtx.hash)

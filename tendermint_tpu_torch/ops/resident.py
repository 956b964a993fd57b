"""Device-resident table store for the verify path.

Counterpart of ``tendermint_tpu/ops/resident.py`` for one CUDA device,
without mesh keys.

The precompute cache (ops/precompute.py) keeps each live validator's
``(8, 4, 32)`` uint8 table column on the host. Without this store every
chunk stacks its lanes' columns into a fresh ``(8, 4, 32, N)`` tensor and
ships it to the device, about 1 KiB a lane, even when the same committee
signs every commit. The store uploads the live slice of the cache once,
as one ``(8, 4, 32, K)`` uint8 tensor on the verify device, and a chunk
then ships only its ``(N,)`` int32 column indices into it; the resident
kernel (K3, ``cuda_verify.verify_resident``) reads its lanes' columns
straight from the store.

Column 0 holds the pad key's table, so pad lanes index something valid;
real keys start at column 1. The store follows the host cache through
the precompute observer events: a rotation or eviction of a stored key,
or a cache clear, drops the device copy whole, and the next batch
uploads afresh. A version counter drops an upload that an invalidation
raced, so a stale tensor is never installed.

:func:`acquire` returns ``None`` only for policy: the store is off, no
lane has a table, or no lane's key is stored (each counted in
:func:`stats`). An upload error propagates: nothing here falls back.

The store serves batches verified on a CUDA device; :func:`configure`
forces it ``"on"`` (for any device) or ``"off"``, and ``None`` returns
to following the device.

An upload runs in a ``resident_upload`` span. The installed tensor's
``nbytes`` is set in the device-byte ledger of ``ops/introspect.py``
as ``resident_tables`` when it is installed, and 0 when it is dropped.
``bind_metrics`` mirrors the store's hits and misses and the table
bytes it ships (uploads and gathered chunks) into an ``OpsMetrics``.

Hot keys (:func:`note_hot_keys`): the verify service's traffic has no
validator set to activate, so it reports each flush's signers here. A
key seen :data:`HOT_PIN_THRESHOLD` times is pinned in the host cache
(``precompute.pin_pubkeys``) and joins the next upload. A tenant may
hold at most ``quota`` pins; past it a hot key is counted in
``pin_quota_denials`` instead. Each upload splits the store's bytes
among the tenants in proportion to their pins, as the ledger rows
``resident_tables/<tenant>`` (``introspect.set_tenant_bytes``).
"""

from __future__ import annotations

import threading
from typing import Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch

from tendermint_tpu_torch.libs import tracing
from tendermint_tpu_torch.ops import introspect, precompute

# What acquire hands the engine: the (N,) bool lane partition, the (N,)
# int32 store columns (0 outside the mask), the (K,) uint8 decompression
# verdicts by column, and the store tensor.
Acquired = Tuple[np.ndarray, np.ndarray, np.ndarray, torch.Tensor]

# Keys seen this many times through note_hot_keys are pinned in the host
# cache; at most HOT_TRACK_CAP keys are counted at once.
HOT_PIN_THRESHOLD = 2
HOT_TRACK_CAP = 4096


class ResidentTableStore:
    """Thread-safe device mirror of the host precompute cache."""

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._mode: Optional[str] = None  # guarded-by: _lock
        self._index: Dict[bytes, int] = {}  # guarded-by: _lock
        self._tab_dev: Optional[torch.Tensor] = None  # guarded-by: _lock; (8, 4, 32, K) uint8
        self._ok_host: Optional[np.ndarray] = None  # guarded-by: _lock
        self._device: Optional[torch.device] = None  # guarded-by: _lock
        self._version = 0  # guarded-by: _lock
        self._metrics = None  # guarded-by: _lock
        self._hot_counts: Dict[bytes, int] = {}  # guarded-by: _lock
        self._tenant_pins: Dict[str, int] = {}  # guarded-by: _lock
        self._pinned: set = set()  # keys this process pinned; guarded-by: _lock
        self._zero_counts()

    def _zero_counts(self) -> None:
        self.pin_quota_denials = 0  # guarded-by: _lock
        self.hits = 0  # guarded-by: _lock
        self.misses = 0  # guarded-by: _lock
        self.uploads = 0  # guarded-by: _lock
        self.h2d_bytes = 0  # guarded-by: _lock
        self.gathered_h2d_bytes = 0  # guarded-by: _lock
        self.invalidations = 0  # guarded-by: _lock
        self.declined = {"off": 0, "no_table": 0, "no_hit": 0}  # guarded-by: _lock

    # --- configuration ------------------------------------------------------

    def configure(self, mode: Optional[str]) -> None:
        """Force the store ``"on"`` or ``"off"``; None follows the device."""
        if mode not in (None, "on", "off"):
            raise ValueError(f"resident mode must be 'on', 'off' or None, got {mode!r}")
        with self._lock:
            self._mode = mode

    def enabled(self, device) -> bool:
        """On or off for batches verified on ``device``: unless configured,
        on for a CUDA device (the CPU path ships tables per chunk)."""
        with self._lock:
            mode = self._mode
        if mode is not None:
            return mode == "on"
        return torch.device(device).type == "cuda"

    def bind_metrics(self, metrics) -> None:
        with self._lock:
            self._metrics = metrics

    # --- upload / invalidate ------------------------------------------------

    def refresh(self, device) -> bool:
        """Upload the cache's live slice to ``device`` as one
        ``(8, 4, 32, K)`` tensor (column 0 the pad table) and install it,
        unless an invalidation raced the upload. Returns True when a store
        is installed."""
        from tendermint_tpu_torch.ops import ed25519_batch

        device = torch.device(device)
        with self._lock:
            version = self._version
        snap = precompute.tables.snapshot_eligible()
        if not snap:
            return False
        cols = [ed25519_batch._pad_table()]
        oks = [True]
        index: Dict[bytes, int] = {}
        for pk, table, ok in snap:
            index[pk] = len(cols)
            cols.append(table)
            oks.append(ok)
        host_tab = np.ascontiguousarray(np.stack(cols).transpose(1, 2, 3, 0))
        nbytes = int(host_tab.nbytes)
        with tracing.span("resident_upload", stage="resident_upload", engine="ed25519",
                          keys=len(index), bytes=nbytes):
            tab_dev = self._upload(host_tab, device)
        with self._lock:
            if self._version != version:
                return False
            self._index = index
            self._tab_dev = tab_dev
            self._ok_host = np.asarray(oks, dtype=np.uint8)
            self._device = device
            self.uploads += 1
            self.h2d_bytes += nbytes
            metrics = self._metrics
            # Set under the store's lock (the ledger's own lock is a
            # leaf), so a drop racing this install cannot leave the
            # ledger holding a store that is gone, or the reverse.
            introspect.set_bytes("resident_tables", tab_dev.nbytes)
            introspect.set_tenant_bytes(tab_dev.nbytes, self._tenant_pins)
        if metrics is not None:
            metrics.table_h2d_bytes.inc(nbytes)
        return True

    @staticmethod
    def _upload(host_tab: np.ndarray, device: torch.device) -> torch.Tensor:
        return torch.from_numpy(host_tab).to(device)

    def invalidate(self, pubkeys: Iterable[bytes]) -> None:
        """The host cache dropped these keys: the device copy goes with
        them. The version moves in any case, so an upload in flight whose
        snapshot may hold them is not installed."""
        keys = [bytes(pk) for pk in pubkeys]
        with self._lock:
            self._pinned.difference_update(keys)
            self._version += 1
            if self._tab_dev is not None and any(pk in self._index for pk in keys):
                self._drop_locked()

    def clear(self) -> None:
        """The host cache was cleared: the device copy, the hot-key
        counts and the pinned slice go with it."""
        with self._lock:
            self._drop_locked()
            self._hot_counts.clear()
            self._pinned.clear()

    def _drop_locked(self) -> None:
        if self._tab_dev is not None:
            self.invalidations += 1
        self._index = {}
        self._tab_dev = None
        self._ok_host = None
        self._device = None
        self._version += 1
        introspect.set_bytes("resident_tables", 0)
        introspect.set_tenant_bytes(0, {})

    # --- lookup -------------------------------------------------------------

    def acquire(self, pubkeys: Sequence[bytes], has_table: np.ndarray, device) -> Optional[Acquired]:
        """Resident routing for one batch verified on ``device``.

        Of the lanes with a host-cached table (``has_table``), those whose
        key is in the store ride the resident kernel. Returns ``(res_mask,
        idx, ok_by_column, store)``, or None when the store is off, no
        lane has a table, or no lane's key is stored. A key with a host
        table that the store lacks (committee growth), or a store on
        another device, refreshes the store once first.
        """
        if not self.enabled(device):
            return self._decline("off")
        if not has_table.any():
            return self._decline("no_table")
        device = torch.device(device)
        n = len(pubkeys)
        with self._lock:
            stale = self._tab_dev is None or self._device != device or any(
                has_table[i] and bytes(pubkeys[i]) not in self._index for i in range(n)
            )
        if stale:
            self.refresh(device)
        with self._lock:
            tab_dev, ok_host, index = self._tab_dev, self._ok_host, self._index
            if tab_dev is None or self._device != device:
                self.declined["no_hit"] += 1
                return None
            idx = np.zeros(n, dtype=np.int32)
            res_mask = np.zeros(n, dtype=bool)
            hits = misses = 0
            for i in range(n):
                if not has_table[i]:
                    continue
                col = index.get(bytes(pubkeys[i]))
                if col is None:
                    misses += 1
                    continue
                idx[i] = col
                res_mask[i] = True
                hits += 1
            self.hits += hits
            self.misses += misses
            metrics = self._metrics
            if not hits:
                self.declined["no_hit"] += 1
        if metrics is not None:
            if hits:
                metrics.table_resident_hits.inc(hits)
            if misses:
                metrics.table_resident_misses.inc(misses)
        if not hits:
            return None
        return res_mask, idx, ok_host, tab_dev

    def _decline(self, reason: str) -> None:
        with self._lock:
            self.declined[reason] += 1
        return None

    def note_hot_keys(self, pubkeys: Iterable[bytes], tenant: Optional[str] = None,
                      quota: int = 0) -> None:
        """Count repeat signers of set-less traffic: a key seen
        :data:`HOT_PIN_THRESHOLD` times is pinned in the host cache, so
        it joins the next upload. With ``tenant`` and ``quota`` > 0, a
        tenant holding ``quota`` pins has its further hot keys counted
        in ``pin_quota_denials`` instead."""
        to_pin = []
        with self._lock:
            for pk in pubkeys:
                pk = bytes(pk)
                if len(pk) != 32:
                    continue
                c = self._hot_counts.get(pk, 0) + 1
                if c >= HOT_PIN_THRESHOLD:
                    self._hot_counts.pop(pk, None)
                    if tenant is not None and quota > 0:
                        used = self._tenant_pins.get(tenant, 0)
                        if used >= quota:
                            self.pin_quota_denials += 1
                            continue
                        self._tenant_pins[tenant] = used + 1
                    to_pin.append(pk)
                elif len(self._hot_counts) < HOT_TRACK_CAP:
                    self._hot_counts[pk] = c
            self._pinned.update(to_pin)
        if to_pin:
            precompute.pin_pubkeys(to_pin)

    def pinned_keys(self) -> list:
        """Hex keys this process pinned through note_hot_keys, sorted."""
        with self._lock:
            return sorted(pk.hex() for pk in self._pinned)

    def tenant_pins(self) -> Dict[str, int]:
        """Pins held per tenant."""
        with self._lock:
            return dict(self._tenant_pins)

    def note_table_h2d(self, nbytes: int) -> None:
        """Count the bytes of a gathered (per-chunk) table tensor."""
        with self._lock:
            self.gathered_h2d_bytes += int(nbytes)
            metrics = self._metrics
        if metrics is not None:
            metrics.table_h2d_bytes.inc(int(nbytes))

    # --- introspection ------------------------------------------------------

    def device_nbytes(self) -> int:
        """The installed store tensor's bytes (0 when none is)."""
        with self._lock:
            return 0 if self._tab_dev is None else int(self._tab_dev.nbytes)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "resident_keys": len(self._index),
                "hits": self.hits,
                "misses": self.misses,
                "uploads": self.uploads,
                "h2d_bytes": self.h2d_bytes,
                "gathered_h2d_bytes": self.gathered_h2d_bytes,
                "invalidations": self.invalidations,
                "pin_quota_denials": self.pin_quota_denials,
                "pinned_keys": len(self._pinned),
                **{f"declined_{k}": v for k, v in self.declined.items()},
            }

    def reset(self) -> None:
        with self._lock:
            self._drop_locked()
            self._hot_counts.clear()
            self._tenant_pins.clear()
            self._pinned.clear()
            self._zero_counts()


# --- process-wide singleton --------------------------------------------------

store = ResidentTableStore()


def _on_cache_event(kind: str, payload: tuple) -> None:
    """precompute observer: a host invalidation drops the device copy."""
    if kind in ("rotation", "evict"):
        store.invalidate(payload)
    elif kind == "clear":
        store.clear()


precompute.register_observer(_on_cache_event)


def acquire(pubkeys: Sequence[bytes], has_table: np.ndarray, device) -> Optional[Acquired]:
    return store.acquire(pubkeys, has_table, device)


def enabled(device) -> bool:
    return store.enabled(device)


def configure(mode: Optional[str]) -> None:
    store.configure(mode)


def note_table_h2d(nbytes: int) -> None:
    store.note_table_h2d(nbytes)


def note_hot_keys(pubkeys: Iterable[bytes], tenant: Optional[str] = None, quota: int = 0) -> None:
    store.note_hot_keys(pubkeys, tenant=tenant, quota=quota)


def pinned_keys() -> list:
    return store.pinned_keys()


def tenant_pins() -> Dict[str, int]:
    return store.tenant_pins()


def stats() -> Dict[str, int]:
    return store.stats()


def bind_metrics(metrics) -> None:
    store.bind_metrics(metrics)


def reset() -> None:
    store.reset()

"""Batch-verifier dispatch (crypto/batch/batch.go:11-33).

Only key types with batch support (ed25519, sr25519) get a batch
verifier. The ed25519 one routes to the CUDA engine
(:func:`tendermint_tpu_torch.ops.verify_batch`) at or above
:data:`DEVICE_THRESHOLD` signatures and to the host oracle below it; the
sr25519 one (``crypto/sr25519.py``) to ``ops/sr25519_batch.py`` or its
host check. :class:`MultiBatchVerifier` splits a mixed validator set's
commit by key type. :func:`get_shared_scheduler` is the process-wide
accumulate-with-deadline scheduler (``crypto/scheduler.py``) in front of
:func:`tiered_verify_ed25519`. Counterpart of
``tendermint_tpu/crypto/batch.py`` with one verifyd remote and no
federation.

A verify service set with ``verifyd.client.set_remote_addr`` owns the
card for this process (:func:`remote_verify_backend`): the ed25519 batch
verifier sends batches at or above :data:`DEVICE_THRESHOLD` to it, and
the shared scheduler every flush, so ``types/validation.verify_commit``
rides the wire. sr25519 stays local, as in the reference.
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional, Tuple

from tendermint_tpu_torch import resolve_device
from tendermint_tpu_torch.crypto.keys import ED25519_KEY_TYPE, SR25519_KEY_TYPE, PubKey
from tendermint_tpu_torch.verifyd import client as vclient

# Host/device crossover: below this many signatures a device launch
# costs more than it saves, so batches stay on the host (the analog of
# the reference's batchVerifyThreshold, types/validation.go:12-16).
DEVICE_THRESHOLD = 16


def remote_verify_backend():
    """The verify function of the configured verifyd remote, or None."""
    return vclient.remote_backend()


def host_verify_ed25519(pks, msgs, sigs) -> List[bool]:
    """Host ZIP-215 oracle over raw lanes."""
    from tendermint_tpu_torch.crypto.ed25519_ref import verify_zip215

    return [verify_zip215(p, m, s) for p, m, s in zip(pks, msgs, sigs)]


_tier_mtx = threading.Lock()
# Lanes by tier of tiered_verify_ed25519: "host" lanes (of which
# "host_cached" the verdict cache answered) and "device" lanes, handed
# to verify_batch, which asks the cache itself; and the wall seconds of
# each tier's calls, summed over the threads that made them.
tier_lanes = {"host": 0, "host_cached": 0, "device": 0}  # guarded-by: _tier_mtx
tier_seconds = {"host": 0.0, "device": 0.0}  # guarded-by: _tier_mtx


def _count_tier(tier: str, seconds: float, **lanes: int) -> None:
    with _tier_mtx:
        tier_seconds[tier] += seconds
        for k, v in lanes.items():
            tier_lanes[k] += v


def _host_tier(pks, msgs, sigs) -> List[bool]:
    """The host oracle behind the engine's verdict cache: a lane
    verified before (on either tier) is not verified again, and what
    the host verifies is cached for both tiers."""
    from tendermint_tpu_torch.crypto.ed25519_ref import verify_zip215
    from tendermint_tpu_torch.ops import precompute

    t0 = time.perf_counter()
    out = []
    cached = 0
    for p, m, s in zip(pks, msgs, sigs):
        v = precompute.results.get(p, m, s)
        if v is None:
            v = verify_zip215(p, m, s)
            precompute.results.put(p, m, s, v)
        else:
            cached += 1
        out.append(bool(v))
    _count_tier("host", time.perf_counter() - t0, host=len(pks), host_cached=cached)
    return out


def tiered_verify_ed25519(pks, msgs, sigs, device=None) -> List[bool]:
    """The small-batch policy: below the device threshold a launch costs
    more than it saves, so those batches stay on the host oracle.

    The host tier reads and fills the engine's verdict cache, which the
    reference's host tier bypasses: a vote that several peers deliver in
    several small flushes is verified once, as it is on the device
    tier."""
    dev = resolve_device(device)
    if len(pks) < DEVICE_THRESHOLD:
        return _host_tier(pks, msgs, sigs)
    from tendermint_tpu_torch.ops import verify_batch

    t0 = time.perf_counter()
    try:
        return verify_batch(pks, msgs, sigs, device=dev)
    finally:
        _count_tier("device", time.perf_counter() - t0, device=len(pks))


def note_validator_set(vals) -> None:
    """Make the set's ed25519 keys eligible for per-validator table
    caching in the port's precompute cache (ops/precompute.py); keys of
    rotated-out sets are dropped. The reference also forwards the set's
    digest to a verifyd federation as a routing key; with one remote
    there is nothing to route, and the remote pins the set's keys from
    its traffic (``ops/resident.note_hot_keys``).

    Unlike the reference's (``tendermint_tpu/crypto/batch.py:69-97``),
    which swallows every error of the warm-up, this raises an error of
    the activation or of its observers (the resident store's drop or
    upload): on the card that is a device error, and the port does not
    hide one. Callers are ``verify_commit``, the blocksync pipeline, the
    bisection round, the executor's ``validate_block`` and the syncer."""
    from tendermint_tpu_torch.ops import precompute

    precompute.activate_validator_set(vals)


class Ed25519BatchVerifier:
    """crypto.BatchVerifier contract (crypto/crypto.go:58-76): add
    entries, then verify once; returns (all_valid, per-entry validity)."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._pks: List[bytes] = []
        self._msgs: List[bytes] = []
        self._sigs: List[bytes] = []

    def add(self, pub_key: PubKey, msg: bytes, sig: bytes) -> None:
        if pub_key.type != ED25519_KEY_TYPE:
            raise ValueError(f"ed25519 batch got {pub_key.type} key")
        pk = pub_key.bytes()
        if len(pk) != 32 or len(sig) != 64:
            raise ValueError("malformed ed25519 entry")
        self._pks.append(pk)
        self._msgs.append(msg)
        self._sigs.append(sig)

    def __len__(self) -> int:
        return len(self._pks)

    def verify(self) -> Tuple[bool, List[bool]]:
        if not self._pks:
            return False, []
        if len(self._pks) >= DEVICE_THRESHOLD:
            # a configured verifyd remote owns the card for this process
            remote = remote_verify_backend()
            if remote is not None:
                oks = remote(self._pks, self._msgs, self._sigs)
                return all(oks), list(oks)
            from tendermint_tpu_torch.ops import verify_batch

            oks = verify_batch(self._pks, self._msgs, self._sigs, device=self.device)
        else:
            oks = host_verify_ed25519(self._pks, self._msgs, self._sigs)
        return all(oks), list(oks)


def supports_batch_verifier(pub_key: Optional[PubKey]) -> bool:
    """crypto/batch/batch.go:26-33: ed25519 and sr25519 batch."""
    return pub_key is not None and pub_key.type in (ED25519_KEY_TYPE, SR25519_KEY_TYPE)


def create_batch_verifier(pub_key: PubKey, device=None):
    """crypto/batch/batch.go:11-22: the batch verifier of a key's type."""
    if pub_key.type == ED25519_KEY_TYPE:
        return Ed25519BatchVerifier(device=device)
    if pub_key.type == SR25519_KEY_TYPE:
        from tendermint_tpu_torch.crypto.sr25519 import Sr25519BatchVerifier

        return Sr25519BatchVerifier(device=device)
    raise ValueError(f"key type {pub_key.type} does not support batching")


class MultiBatchVerifier:
    """Per-key-type sub-batches for a mixed validator set.

    A commit signed by ed25519 and sr25519 validators (BASELINE config 5)
    splits into one sub-verifier per key type, each on its own kernel,
    and the verdicts merge back in the order entries were added. A key
    type without batch support raises on ``add``, which the caller
    answers with single verification (reference crypto/batch/batch.go
    dispatches on one key type; this is the mixed-set generalisation the
    JAX package makes).
    """

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._subs: dict = {}
        self._order: List[Tuple[str, int]] = []  # (key type, index in its sub-batch)

    def add(self, pub_key: PubKey, msg: bytes, sig: bytes) -> None:
        kt = pub_key.type
        sub = self._subs.get(kt)
        if sub is None:
            sub = self._subs[kt] = create_batch_verifier(pub_key, self.device)
        sub.add(pub_key, msg, sig)
        self._order.append((kt, len(sub) - 1))

    def __len__(self) -> int:
        return len(self._order)

    def verify(self) -> Tuple[bool, List[bool]]:
        if not self._order:
            return False, []  # the empty contract of every batch verifier
        results = {kt: sub.verify()[1] for kt, sub in self._subs.items()}
        merged = [bool(results[kt][i]) for kt, i in self._order]
        return all(merged), merged


_shared_scheduler = None
_shared_scheduler_lock = threading.Lock()


def _shared_verify(pks, msgs, sigs) -> List[bool]:
    """The shared scheduler's flush target: a configured verifyd remote
    gets every flush, even a tiny one (other clients' lanes coalesce
    there); else the small-batch policy on the package's device,
    resolved at flush time."""
    remote = remote_verify_backend()
    if remote is not None:
        return remote(pks, msgs, sigs)
    return tiered_verify_ed25519(pks, msgs, sigs)


def gated_host_verify(engine: str, host_fn, pks, msgs, sigs) -> List[bool]:
    """A scheduler fallback's answer for a flush whose verify raised.

    The port answers on the host only where the caller allows it
    (``device_policy.shared.host_fallback``), and counts those lanes in
    the health machine under ``engine`` as the engines count theirs.
    With fallback off it raises, and the scheduler fails the flush
    closed (every lane False, ``flush_errors`` counted, the error on each
    handle) as it does for a flush with no fallback; the engine has
    already recorded the device fault."""
    from tendermint_tpu_torch.ops import device_policy

    health = device_policy.shared
    if not health.host_fallback:
        raise RuntimeError("host fallback is off (device_policy.shared.host_fallback)")
    oks = host_fn(pks, msgs, sigs)
    health.count_fallback(engine, len(pks))
    return oks


def _shared_host_fallback(pks, msgs, sigs) -> List[bool]:
    """The shared scheduler's fallback (:func:`gated_host_verify`)."""
    return gated_host_verify("ed25519", host_verify_ed25519, pks, msgs, sigs)


def get_shared_scheduler():
    """Process-wide accumulate-with-deadline scheduler in front of the
    batch verifier (``crypto/scheduler.py``): the seam for callers that
    ingest signatures from many concurrent sources (per-peer vote
    floods, a light client's bisection round) and want device batching
    without a launch per signature. Started on first use; the reference
    scheduler's defaults (256 lanes, 2 ms, continuous, depth 2)."""
    global _shared_scheduler
    with _shared_scheduler_lock:
        if _shared_scheduler is None:
            from tendermint_tpu_torch.crypto.scheduler import VerifyScheduler

            _shared_scheduler = VerifyScheduler(_shared_verify, fallback_fn=_shared_host_fallback)
            _shared_scheduler.start()
        return _shared_scheduler


def shutdown_shared_scheduler() -> None:
    """Stop the shared scheduler's threads (pending lanes fail closed);
    the next :func:`get_shared_scheduler` starts a new one."""
    global _shared_scheduler
    with _shared_scheduler_lock:
        sched, _shared_scheduler = _shared_scheduler, None
    if sched is not None:
        sched.stop()

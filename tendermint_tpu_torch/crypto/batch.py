"""Batch-verifier dispatch (crypto/batch/batch.go:11-33).

Only key types with batch support (ed25519, sr25519) get a batch
verifier. The ed25519 one routes to the CUDA engine
(:func:`tendermint_tpu_torch.ops.verify_batch`) at or above
:data:`DEVICE_THRESHOLD` signatures and to the host oracle below it; the
sr25519 one (``crypto/sr25519.py``) to ``ops/sr25519_batch.py`` or its
host check. :class:`MultiBatchVerifier` splits a mixed validator set's
commit by key type. Counterpart of ``tendermint_tpu/crypto/batch.py``
without the verifyd remote and the scheduler.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from tendermint_tpu_torch import resolve_device
from tendermint_tpu_torch.crypto.keys import ED25519_KEY_TYPE, SR25519_KEY_TYPE, PubKey

# Host/device crossover: below this many signatures a device launch
# costs more than it saves, so batches stay on the host (the analog of
# the reference's batchVerifyThreshold, types/validation.go:12-16).
DEVICE_THRESHOLD = 16


def host_verify_ed25519(pks, msgs, sigs) -> List[bool]:
    """Host ZIP-215 oracle over raw lanes."""
    from tendermint_tpu_torch.crypto.ed25519_ref import verify_zip215

    return [verify_zip215(p, m, s) for p, m, s in zip(pks, msgs, sigs)]


def tiered_verify_ed25519(pks, msgs, sigs, device=None) -> List[bool]:
    """The small-batch policy: below the device threshold a launch costs
    more than it saves, so those batches stay on the host oracle."""
    dev = resolve_device(device)
    if len(pks) < DEVICE_THRESHOLD:
        return host_verify_ed25519(pks, msgs, sigs)
    from tendermint_tpu_torch.ops import verify_batch

    return verify_batch(pks, msgs, sigs, device=dev)


def note_validator_set(vals) -> None:
    """Make the set's ed25519 keys eligible for per-validator table
    caching in the port's precompute cache (ops/precompute.py); keys of
    rotated-out sets are dropped."""
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

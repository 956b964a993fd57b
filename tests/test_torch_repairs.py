"""Faults found in the port against the reference, and divergences the
port holds, each beside the JAX package's behaviour: observer delivery
of the table cache's events, ``note_validator_set``'s raise, and the
verifyd shm modes, which the port serves as the reference does."""

import numpy as np
import pytest

pytest.importorskip("torch")

from tendermint_tpu.crypto import batch as jbatch
from tendermint_tpu.crypto.keys import Ed25519PrivKey as JEd25519PrivKey
from tendermint_tpu.ops import precompute as jprecompute
from tendermint_tpu.types.validator import Validator as JValidator
from tendermint_tpu.types.validator_set import ValidatorSet as JValidatorSet
from tendermint_tpu_torch.crypto import batch as tbatch
from tendermint_tpu_torch.crypto.keys import Ed25519PrivKey
from tendermint_tpu_torch.ops import precompute as tprecompute
from tendermint_tpu_torch.types.validator import Validator
from tendermint_tpu_torch.types.validator_set import ValidatorSet


def _deliveries(pkg, monkeypatch):
    """Two queued events, an observer that raises on the first, and one
    that records: what each hears, and the error ``_flush_events``
    raises (None if it raises none)."""
    monkeypatch.setattr(pkg, "_observers", [])
    cache = pkg.PrecomputeCache()
    heard = {"first": [], "second": []}

    def first(kind, payload):
        heard["first"].append(kind)
        if kind == "rotation":
            raise RuntimeError("upload failed")

    pkg.register_observer(first)
    pkg.register_observer(lambda kind, payload: heard["second"].append(kind))
    cache._pending_events = [("rotation", (b"a" * 32,)), ("evict", (b"b" * 32,))]
    try:
        cache._flush_events()
        err = None
    except RuntimeError as e:
        err = str(e)
    assert cache._pending_events == []
    return heard, err


def test_every_observer_hears_every_event_and_the_port_raises_the_first_error(monkeypatch):
    jheard, jerr = _deliveries(jprecompute, monkeypatch)
    theard, terr = _deliveries(tprecompute, monkeypatch)
    assert theard == jheard == {"first": ["rotation", "evict"], "second": ["rotation", "evict"]}
    assert jerr is None  # the reference swallows it
    assert terr == "upload failed"  # the port raises it once all are delivered


def _rotating_sets(pkg_validator, pkg_set, priv_cls, n=9):
    """Nine one-validator sets: activating all retires the first, whose
    key then leaves the table cache (a "rotation" event)."""
    return [pkg_set([pkg_validator(priv_cls.from_seed(bytes([40 + i]) * 32).pub_key(), 10)])
            for i in range(n)]


def test_note_validator_set_raises_in_the_port_and_never_in_the_reference(monkeypatch):
    """The port's divergence, held: a failed activation or observer is a
    device error and escapes ``note_validator_set``; the reference's
    warm-up swallows it."""
    for pkg, batch, sets in (
        (jprecompute, jbatch, _rotating_sets(JValidator, JValidatorSet, JEd25519PrivKey)),
        (tprecompute, tbatch, _rotating_sets(Validator, ValidatorSet, Ed25519PrivKey)),
    ):
        monkeypatch.setattr(pkg, "_observers", [])
        monkeypatch.setattr(pkg, "tables", pkg.PrecomputeCache())
        heard = []

        def observer(kind, payload):
            heard.append(kind)
            raise RuntimeError("resident store upload failed")

        batch.note_validator_set(sets[0])
        first_key = sets[0].validators[0].pub_key.bytes()
        pkg.tables._insert_locked(first_key, np.zeros((8, 4, 32), np.uint8), True)
        pkg.register_observer(observer)
        for vs in sets[1:-1]:
            batch.note_validator_set(vs)
        if pkg is jprecompute:
            batch.note_validator_set(sets[-1])  # swallowed
        else:
            with pytest.raises(RuntimeError, match="upload failed"):
                batch.note_validator_set(sets[-1])
        assert heard == ["rotation"], pkg.__name__


def test_the_verifyd_shm_refusal_points_at_item_12():
    """Item 12 ported the shm ingress: ``shm="on"`` serves and publishes
    its doorbell, and only a mode outside auto/on/off is refused, as in
    the reference."""
    from tendermint_tpu.verifyd.server import VerifydServer as JServer
    from tendermint_tpu_torch.verifyd.server import VerifydServer

    srv = VerifydServer(shm="on", device="cpu")
    srv.start()
    try:
        assert srv.shm_socket_path and srv.stats()["shm_sessions"] == 0
    finally:
        srv.stop()
    assert srv.shm_socket_path == ""
    for cls in (JServer, VerifydServer):
        with pytest.raises(ValueError, match="bad shm mode"):
            cls(shm="sometimes")

"""Evidence reactor: gossip on channel 0x38 (internal/evidence/reactor.go).

A copy of ``tendermint_tpu/evidence/reactor.py``. Pending evidence is
broadcast as its proto bytes; received evidence is verified into the
pool and re-gossiped if new.

One divergence: the reference wraps ``add_evidence`` in
``except Exception: pass`` (``:42-49``), which hides a device error of
the pool's verification along with invalid evidence. The port drops
malformed or invalid evidence as before (decode errors,
``InvalidEvidenceError``, ``ValueError``, ``LookupError`` and anything
else the pool raises) but not the errors of
:data:`~tendermint_tpu_torch.consensus.state.DEVICE_ERRORS`: the first is
kept in :attr:`EvidenceReactor.error`, handed to ``on_error`` (a node's
``Node._fail``), and the reactor stops.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

from tendermint_tpu_torch.consensus.state import DEVICE_ERRORS
from tendermint_tpu_torch.evidence.pool import EvidencePool
from tendermint_tpu_torch.p2p.router import Router
from tendermint_tpu_torch.types.evidence import evidence_from_proto_bytes

EVIDENCE_CHANNEL = 0x38


class EvidenceReactor:
    def __init__(
        self,
        pool: EvidencePool,
        router: Router,
        on_error: Optional[Callable[[BaseException], None]] = None,
    ):
        self.pool = pool
        self.channel = router.open_channel(EVIDENCE_CHANNEL)
        self.on_error = on_error
        # The device error that stopped the reactor (module note).
        self.error: Optional[BaseException] = None
        self._stop_flag = threading.Event()
        self._thread = None

    def start(self) -> None:
        self._stop_flag.clear()
        self._thread = threading.Thread(target=self._recv_loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop_flag.set()
        if self._thread is not None:
            if self._thread is not threading.current_thread():
                self._thread.join(timeout=2)
            self._thread = None

    def broadcast_evidence(self, ev) -> None:
        self.channel.broadcast(ev.to_proto_bytes())

    def _recv_loop(self) -> None:
        while not self._stop_flag.is_set():
            env = self.channel.receive(timeout=0.2)
            if env is None:
                continue
            try:
                ev = evidence_from_proto_bytes(env.message)
                if not self.pool.is_pending(ev) and not self.pool.is_committed(ev):
                    self.pool.add_evidence(ev)
                    self.channel.broadcast(env.message)
            except DEVICE_ERRORS as exc:
                if self.error is None:
                    self.error = exc
                self._stop_flag.set()
                if self.on_error is not None:
                    self.on_error(exc)
                return
            except Exception:
                pass  # invalid evidence from peer: drop

"""Mempool reactor: tx gossip on channel 0x30 (internal/mempool/reactor.go).

A copy of ``tendermint_tpu/mempool/reactor.py``. Own CheckTx-accepted
txs are broadcast; received txs run through CheckTx before re-gossip
(the seen-cache on every node stops loops). The wire message is the tx's
bytes, as in the reference.

One divergence: the reference's receive loop calls
``check_tx(tx, sender=peer_id)``, and the mempool keeps one tx a sender
(``mempool.go:450-599``, keyed in Go on the app's ``ResponseCheckTx.Sender``,
the peer being only gossip bookkeeping there). So a peer has one gossiped
tx in a node's mempool at a time; the others are refused, stay in the
seen-cache, and a tx that a node which never proposes (a full node)
admits first never reaches a block. The port's loop gives the app's
sender alone.
"""

from __future__ import annotations

import threading

from tendermint_tpu_torch.mempool.mempool import TxMempool
from tendermint_tpu_torch.p2p.router import Router

MEMPOOL_CHANNEL = 0x30


class MempoolReactor:
    def __init__(self, mempool: TxMempool, router: Router):
        self.mempool = mempool
        self.channel = router.open_channel(MEMPOOL_CHANNEL)
        self._stop_flag = threading.Event()
        self._thread = None

    def start(self) -> None:
        self._stop_flag.clear()
        self._thread = threading.Thread(target=self._recv_loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop_flag.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None

    def broadcast_tx(self, tx: bytes) -> None:
        """Called after local CheckTx admission (reactor.go broadcast)."""
        self.channel.broadcast(tx)

    def check_and_broadcast_tx(self, tx: bytes, sender: str = "") -> None:
        res = self.mempool.check_tx(tx, sender)
        if res.is_ok():
            self.broadcast_tx(tx)

    def _recv_loop(self) -> None:
        while not self._stop_flag.is_set():
            env = self.channel.receive(timeout=0.2)
            if env is None:
                continue
            try:
                res = self.mempool.check_tx(env.message)
                if res.is_ok():
                    # Re-gossip so txs flood the network; the seen-cache on
                    # every node breaks cycles.
                    self.channel.broadcast(env.message)
            except (KeyError, ValueError, OverflowError):
                pass  # duplicate / invalid / full: drop

"""Blocksync reactor: channel 0x40 (internal/blocksync/reactor.go:27).

A copy of ``tendermint_tpu/blocksync/reactor.py``. Wire messages (1 tag
byte + payload, the reference's): BlockRequest{height},
BlockResponse{block proto}, StatusRequest{}, StatusResponse{base,height},
NoBlockResponse{height}. Serves blocks from the local store and feeds
fetched blocks into the syncer's pool; on catch-up the node switches to
consensus (reactor.go:507-529 via the syncer's ``on_caught_up``).

One divergence: the reference's receive loop drops every exception of
its handler (``:99-107``). The port's drops malformed peer input as
before, but not the errors of
:data:`~tendermint_tpu_torch.consensus.state.DEVICE_ERRORS`: the first
is kept in :attr:`BlockSyncReactor.error`, handed to ``on_error`` (a
node's ``Node._fail``), and the reactor stops.
"""

from __future__ import annotations

import struct
import threading
from typing import Callable, List, Optional

from tendermint_tpu_torch.blocksync.syncer import BlockSyncer, PeerTransport
from tendermint_tpu_torch.consensus.state import DEVICE_ERRORS
from tendermint_tpu_torch.p2p.router import Envelope, Router
from tendermint_tpu_torch.storage.blockstore import BlockStore
from tendermint_tpu_torch.types.block import Block

BLOCKSYNC_CHANNEL = 0x40

TAG_BLOCK_REQUEST = 1
TAG_BLOCK_RESPONSE = 2
TAG_NO_BLOCK_RESPONSE = 3
TAG_STATUS_REQUEST = 4
TAG_STATUS_RESPONSE = 5


class BlockSyncReactor(PeerTransport):
    def __init__(
        self,
        syncer: Optional[BlockSyncer],
        block_store: BlockStore,
        router: Router,
        on_error: Optional[Callable[[BaseException], None]] = None,
    ):
        self.syncer = syncer  # None on nodes that only serve
        self.block_store = block_store
        self.channel = router.open_channel(BLOCKSYNC_CHANNEL)
        self.on_error = on_error
        # The device error that stopped the reactor (module note).
        self.error: Optional[BaseException] = None
        self._stop_flag = threading.Event()
        self._threads: List[threading.Thread] = []
        if syncer is not None:
            syncer.transport = self

    # --- PeerTransport --------------------------------------------------------

    def request_block(self, peer_id: str, height: int) -> None:
        self.channel.send(
            Envelope(BLOCKSYNC_CHANNEL, bytes([TAG_BLOCK_REQUEST]) + struct.pack(">q", height), to_peer=peer_id)
        )

    def broadcast_status_request(self) -> None:
        self.channel.broadcast(bytes([TAG_STATUS_REQUEST]))

    # --- lifecycle ------------------------------------------------------------

    def start(self, start_syncer: bool = True) -> None:
        """Serving always starts; ``start_syncer=False`` delays the client
        side (node.go statesync -> bcReactor.SwitchToBlockSync)."""
        self._stop_flag.clear()
        self._spawn(self._recv_loop)
        if start_syncer:
            self.start_syncing()

    def _spawn(self, fn) -> None:
        t = threading.Thread(target=fn, daemon=True)
        t.start()
        self._threads.append(t)

    def start_syncing(self) -> None:
        if self.syncer is None:
            return
        self._spawn(self._status_loop)
        self.syncer.start()

    def stop(self) -> None:
        self._stop_flag.set()
        if self.syncer is not None:
            self.syncer.stop()
        for t in self._threads:
            if t is not threading.current_thread():
                t.join(timeout=2)
        self._threads.clear()

    def _status_loop(self) -> None:
        while not self._stop_flag.is_set():
            self.broadcast_status_request()
            self._stop_flag.wait(1.0)

    # --- inbound --------------------------------------------------------------

    def _recv_loop(self) -> None:
        while not self._stop_flag.is_set():
            env = self.channel.receive(timeout=0.2)
            if env is None:
                continue
            try:
                self._handle(env)
            except DEVICE_ERRORS as exc:
                if self.error is None:
                    self.error = exc
                self._stop_flag.set()
                if self.on_error is not None:
                    self.on_error(exc)
                return
            except Exception:
                pass  # malformed peer input must not kill the reactor

    def _handle(self, env: Envelope) -> None:
        tag = env.message[0]
        if tag == TAG_BLOCK_REQUEST:
            (height,) = struct.unpack_from(">q", env.message, 1)
            block = self.block_store.load_block(height)
            if block is not None:
                resp = bytes([TAG_BLOCK_RESPONSE]) + block.to_proto_bytes()
            else:
                resp = bytes([TAG_NO_BLOCK_RESPONSE]) + struct.pack(">q", height)
            self.channel.send(Envelope(BLOCKSYNC_CHANNEL, resp, to_peer=env.from_peer))
        elif tag == TAG_BLOCK_RESPONSE:
            if self.syncer is not None:
                block = Block.from_proto_bytes(env.message[1:])
                self.syncer.pool.add_block(env.from_peer, block)
        elif tag == TAG_STATUS_REQUEST:
            base, height = self.block_store.base(), self.block_store.height()
            resp = bytes([TAG_STATUS_RESPONSE]) + struct.pack(">qq", base, height)
            self.channel.send(Envelope(BLOCKSYNC_CHANNEL, resp, to_peer=env.from_peer))
        elif tag == TAG_STATUS_RESPONSE:
            if self.syncer is not None:
                base, height = struct.unpack_from(">qq", env.message, 1)
                self.syncer.pool.set_peer_range(env.from_peer, max(base, 1), height)

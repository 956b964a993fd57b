"""State-sync reactor: four channels, server + client plumbing.

A copy of ``tendermint_tpu/statesync/reactor.py``, the reference's
bytes on the wire, so a JAX node serves a port joiner and the reverse.
Channel layout from the reference (internal/statesync/reactor.go:36-45):
Snapshot(0x60) discovery/offers, Chunk(0x61) chunk fetch,
LightBlock(0x62) header+valset serving for the state provider and
backfill, Params(0x63) consensus params at height. The server side
answers every request from the local app/stores; the client side routes
responses into the syncer's queues (syncer.py owns the sync logic).

Wire format: 1 tag byte + struct-packed fields + proto payloads.

One divergence: the reference's receive loops drop every exception of
their handlers (``:147-153``). The port's drop malformed peer input as
before, but not the errors of
:data:`~tendermint_tpu_torch.consensus.state.DEVICE_ERRORS`: the first
is kept in :attr:`StateSyncReactor.error`, handed to ``on_error`` (a
node's ``Node._fail``), and the reactor stops.
"""

from __future__ import annotations

import struct
import threading
from typing import Callable, List, Optional

from tendermint_tpu_torch.abci import types as abci
from tendermint_tpu_torch.consensus.state import DEVICE_ERRORS
from tendermint_tpu_torch.p2p.router import Channel, Envelope, Router
from tendermint_tpu_torch.types.light import LightBlock, SignedHeader
from tendermint_tpu_torch.types.params import (
    consensus_params_from_proto_bytes,
    consensus_params_to_proto_bytes,
)

SNAPSHOT_CHANNEL = 0x60
CHUNK_CHANNEL = 0x61
LIGHT_BLOCK_CHANNEL = 0x62
PARAMS_CHANNEL = 0x63

TAG_SNAPSHOTS_REQUEST = 1
TAG_SNAPSHOTS_RESPONSE = 2
TAG_CHUNK_REQUEST = 3
TAG_CHUNK_RESPONSE = 4
TAG_LIGHT_BLOCK_REQUEST = 5
TAG_LIGHT_BLOCK_RESPONSE = 6
TAG_PARAMS_REQUEST = 7
TAG_PARAMS_RESPONSE = 8

# Cap served snapshots per request (reference recentSnapshots = 10).
RECENT_SNAPSHOTS = 10
# Cap chunk size accepted from the wire (16 MB, reference chunk limits).
MAX_CHUNK_BYTES = 16 << 20


def encode_snapshots_response(s: abci.Snapshot) -> bytes:
    return (
        bytes([TAG_SNAPSHOTS_RESPONSE])
        + struct.pack(">qiiB", s.height, s.format, s.chunks, len(s.hash))
        + s.hash
        + s.metadata
    )


def decode_snapshots_response(payload: bytes) -> abci.Snapshot:
    height, format_, chunks, hlen = struct.unpack_from(">qiiB", payload)
    off = struct.calcsize(">qiiB")
    return abci.Snapshot(
        height=height,
        format=format_,
        chunks=chunks,
        hash=payload[off : off + hlen],
        metadata=payload[off + hlen :],
    )


class StateSyncReactor:
    def __init__(
        self,
        router: Router,
        app_client,
        block_store=None,
        state_store=None,
        on_error: Optional[Callable[[BaseException], None]] = None,
    ):
        self.app = app_client
        self.on_error = on_error
        # The device error that stopped the reactor (module note).
        self.error: Optional[BaseException] = None
        self.block_store = block_store
        self.state_store = state_store
        self.snapshot_ch = router.open_channel(SNAPSHOT_CHANNEL)
        self.chunk_ch = router.open_channel(CHUNK_CHANNEL)
        self.light_ch = router.open_channel(LIGHT_BLOCK_CHANNEL)
        self.params_ch = router.open_channel(PARAMS_CHANNEL)
        self._stop_flag = threading.Event()
        self._threads: List[threading.Thread] = []
        # Client-side sinks, installed by the syncer while it runs.
        self.on_snapshot: Optional[Callable] = None  # (peer, Snapshot)
        self.on_chunk: Optional[Callable] = None  # (peer, h, fmt, idx, bytes)
        self.on_light_block: Optional[Callable] = None  # (peer, h, LightBlock|None)
        self.on_params: Optional[Callable] = None  # (peer, h, ConsensusParams)

    def start(self) -> None:
        self._stop_flag.clear()
        for ch, handler in (
            (self.snapshot_ch, self._handle_snapshot),
            (self.chunk_ch, self._handle_chunk),
            (self.light_ch, self._handle_light),
            (self.params_ch, self._handle_params),
        ):
            t = threading.Thread(
                target=self._recv_loop, args=(ch, handler), daemon=True
            )
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        self._stop_flag.set()
        for t in self._threads:
            if t is not threading.current_thread():
                t.join(timeout=2)
        self._threads.clear()

    # --- client-side requests -------------------------------------------------

    def request_snapshots(self) -> None:
        self.snapshot_ch.broadcast(bytes([TAG_SNAPSHOTS_REQUEST]))

    def request_chunk(self, peer: str, height: int, format_: int, index: int) -> None:
        self.chunk_ch.send(
            Envelope(
                CHUNK_CHANNEL,
                bytes([TAG_CHUNK_REQUEST]) + struct.pack(">qii", height, format_, index),
                to_peer=peer,
            )
        )

    def request_light_block(self, peer: str, height: int) -> None:
        self.light_ch.send(
            Envelope(
                LIGHT_BLOCK_CHANNEL,
                bytes([TAG_LIGHT_BLOCK_REQUEST]) + struct.pack(">q", height),
                to_peer=peer,
            )
        )

    def request_params(self, peer: str, height: int) -> None:
        self.params_ch.send(
            Envelope(
                PARAMS_CHANNEL,
                bytes([TAG_PARAMS_REQUEST]) + struct.pack(">q", height),
                to_peer=peer,
            )
        )

    # --- inbound --------------------------------------------------------------

    def _recv_loop(self, ch: Channel, handler) -> None:
        while not self._stop_flag.is_set():
            env = ch.receive(timeout=0.2)
            if env is None:
                continue
            try:
                handler(env)
            except DEVICE_ERRORS as exc:
                if self.error is None:
                    self.error = exc
                self._stop_flag.set()
                if self.on_error is not None:
                    self.on_error(exc)
                return
            except Exception:
                pass  # malformed peer input must not kill the reactor

    def _handle_snapshot(self, env: Envelope) -> None:
        tag = env.message[0] if env.message else 0
        if tag == TAG_SNAPSHOTS_REQUEST:
            res = self.app.list_snapshots(abci.RequestListSnapshots())
            recent = sorted(res.snapshots, key=lambda s: -s.height)[:RECENT_SNAPSHOTS]
            for s in recent:
                self.snapshot_ch.send(
                    Envelope(
                        SNAPSHOT_CHANNEL,
                        encode_snapshots_response(s),
                        to_peer=env.from_peer,
                    )
                )
        elif tag == TAG_SNAPSHOTS_RESPONSE and self.on_snapshot is not None:
            self.on_snapshot(env.from_peer, decode_snapshots_response(env.message[1:]))

    def _handle_chunk(self, env: Envelope) -> None:
        tag = env.message[0] if env.message else 0
        if tag == TAG_CHUNK_REQUEST:
            height, format_, index = struct.unpack_from(">qii", env.message, 1)
            res = self.app.load_snapshot_chunk(
                abci.RequestLoadSnapshotChunk(height=height, format=format_, chunk=index)
            )
            missing = 0 if res.chunk else 1
            self.chunk_ch.send(
                Envelope(
                    CHUNK_CHANNEL,
                    bytes([TAG_CHUNK_RESPONSE])
                    + struct.pack(">qiiB", height, format_, index, missing)
                    + res.chunk,
                    to_peer=env.from_peer,
                )
            )
        elif tag == TAG_CHUNK_RESPONSE and self.on_chunk is not None:
            height, format_, index, missing = struct.unpack_from(">qiiB", env.message, 1)
            body = env.message[1 + struct.calcsize(">qiiB") :]
            if len(body) > MAX_CHUNK_BYTES:
                return
            self.on_chunk(
                env.from_peer, height, format_, index, None if missing else body
            )

    def _serve_light_block(self, height: int) -> Optional[LightBlock]:
        if self.block_store is None or self.state_store is None:
            return None
        meta = self.block_store.load_block_meta(height)
        commit = self.block_store.load_block_commit(height)
        if commit is None:
            seen = self.block_store.load_seen_commit()
            if seen is not None and seen.height == height:
                commit = seen
        if meta is None or commit is None:
            return None
        try:
            vals = self.state_store.load_validators(height)
        except LookupError:
            return None
        return LightBlock(
            signed_header=SignedHeader(header=meta.header, commit=commit),
            validator_set=vals,
        )

    def _handle_light(self, env: Envelope) -> None:
        tag = env.message[0] if env.message else 0
        if tag == TAG_LIGHT_BLOCK_REQUEST:
            (height,) = struct.unpack_from(">q", env.message, 1)
            lb = self._serve_light_block(height)
            body = lb.to_proto_bytes() if lb is not None else b""
            self.light_ch.send(
                Envelope(
                    LIGHT_BLOCK_CHANNEL,
                    bytes([TAG_LIGHT_BLOCK_RESPONSE]) + struct.pack(">q", height) + body,
                    to_peer=env.from_peer,
                )
            )
        elif tag == TAG_LIGHT_BLOCK_RESPONSE and self.on_light_block is not None:
            (height,) = struct.unpack_from(">q", env.message, 1)
            body = env.message[1 + 8 :]
            lb = LightBlock.from_proto_bytes(body) if body else None
            self.on_light_block(env.from_peer, height, lb)

    def _handle_params(self, env: Envelope) -> None:
        tag = env.message[0] if env.message else 0
        if tag == TAG_PARAMS_REQUEST:
            (height,) = struct.unpack_from(">q", env.message, 1)
            if self.state_store is None:
                return
            try:
                params = self.state_store.load_consensus_params(height)
            except LookupError:
                return
            self.params_ch.send(
                Envelope(
                    PARAMS_CHANNEL,
                    bytes([TAG_PARAMS_RESPONSE])
                    + struct.pack(">q", height)
                    + consensus_params_to_proto_bytes(params),
                    to_peer=env.from_peer,
                )
            )
        elif tag == TAG_PARAMS_RESPONSE and self.on_params is not None:
            (height,) = struct.unpack_from(">q", env.message, 1)
            params = consensus_params_from_proto_bytes(env.message[1 + 8 :])
            self.on_params(env.from_peer, height, params)

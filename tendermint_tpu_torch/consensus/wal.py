"""Write-ahead log for consensus inputs (internal/consensus/wal.go).

A copy of ``tendermint_tpu/consensus/wal.py``: the two packages write
and read the same bytes.

Every message the state machine processes is logged BEFORE processing
(state.go:956-970); on crash, replay from the last height marker
reconstructs the exact step. Records are CRC-32C-checked and length-
prefixed like the reference's autofile encoding (wal.go:36-118):

    record := crc32(payload) u32-be | len(payload) u32-be | payload

Payloads are a one-byte type tag + body: proto bytes for votes/proposals/
block parts, JSON for timeouts and markers. A torn final record (crash
mid-write) is tolerated and truncated on open.
"""

from __future__ import annotations

import json
import os
import struct
import zlib
from dataclasses import dataclass
from typing import Iterator, Optional, Tuple, Union

from tendermint_tpu_torch.types.block import Proposal, Vote
from tendermint_tpu_torch.types.part_set import Part

MAX_MSG_SIZE_BYTES = 1024 * 1024  # wal.go maxMsgSizeBytes

TAG_VOTE = 1
TAG_PROPOSAL = 2
TAG_BLOCK_PART = 3
TAG_TIMEOUT = 4
TAG_END_HEIGHT = 5
TAG_ROUND_STATE = 6


@dataclass
class TimeoutInfo:
    duration: float
    height: int
    round: int
    step: int


@dataclass
class EndHeightMessage:
    """Marker written after a height commits (wal.go EndHeightMessage)."""

    height: int


@dataclass
class RoundStateEvent:
    """EventDataRoundState marker (step transitions) for replay fidelity."""

    height: int
    round: int
    step: str


@dataclass
class MsgInfo:
    """Peer or internal message wrapper (state.go msgInfo)."""

    msg: Union[Vote, Proposal, "BlockPartInfo"]
    peer_id: str = ""


@dataclass
class BlockPartInfo:
    height: int
    round: int
    part: Part


WALMessage = Union[MsgInfo, TimeoutInfo, EndHeightMessage, RoundStateEvent]


def _encode_payload(msg: WALMessage) -> bytes:
    if isinstance(msg, MsgInfo):
        peer = msg.peer_id.encode()
        inner = msg.msg
        if isinstance(inner, Vote):
            body = inner.to_proto_bytes()
            tag = TAG_VOTE
        elif isinstance(inner, Proposal):
            body = inner.to_proto_bytes()
            tag = TAG_PROPOSAL
        elif isinstance(inner, BlockPartInfo):
            head = struct.pack(">qi", inner.height, inner.round)
            body = head + inner.part.to_proto_bytes()
            tag = TAG_BLOCK_PART
        else:
            raise TypeError(f"cannot WAL-encode {type(inner)}")
        return bytes([tag, len(peer)]) + peer + body
    if isinstance(msg, TimeoutInfo):
        return bytes([TAG_TIMEOUT]) + json.dumps(
            {
                "duration": msg.duration,
                "height": msg.height,
                "round": msg.round,
                "step": msg.step,
            }
        ).encode()
    if isinstance(msg, EndHeightMessage):
        return bytes([TAG_END_HEIGHT]) + json.dumps({"height": msg.height}).encode()
    if isinstance(msg, RoundStateEvent):
        return bytes([TAG_ROUND_STATE]) + json.dumps(
            {"height": msg.height, "round": msg.round, "step": msg.step}
        ).encode()
    raise TypeError(f"cannot WAL-encode {type(msg)}")


def _decode_payload(payload: bytes) -> WALMessage:
    tag = payload[0]
    if tag in (TAG_VOTE, TAG_PROPOSAL, TAG_BLOCK_PART):
        peer_len = payload[1]
        peer = payload[2 : 2 + peer_len].decode()
        body = payload[2 + peer_len :]
        if tag == TAG_VOTE:
            return MsgInfo(Vote.from_proto_bytes(body), peer)
        if tag == TAG_PROPOSAL:
            return MsgInfo(Proposal.from_proto_bytes(body), peer)
        height, round_ = struct.unpack(">qi", body[:12])
        return MsgInfo(
            BlockPartInfo(height, round_, Part.from_proto_bytes(body[12:])), peer
        )
    doc = json.loads(payload[1:].decode())
    if tag == TAG_TIMEOUT:
        return TimeoutInfo(doc["duration"], doc["height"], doc["round"], doc["step"])
    if tag == TAG_END_HEIGHT:
        return EndHeightMessage(doc["height"])
    if tag == TAG_ROUND_STATE:
        return RoundStateEvent(doc["height"], doc["round"], doc["step"])
    raise ValueError(f"unknown WAL tag {tag}")


class WALCorruptionError(Exception):
    pass


class WAL:
    """File-backed WAL over a rotating autofile group (wal.go uses
    autofile.Group the same way): write() appends; write_sync()
    additionally fsyncs before returning — used for our own messages
    (state.go:964). Rotation happens at record boundaries so records
    never span chunks, and replay offsets are LOGICAL offsets — stable
    across rotation and pruning."""

    def __init__(
        self,
        path: str,
        head_size_limit: Optional[int] = None,
        total_size_limit: Optional[int] = None,
    ):
        from tendermint_tpu_torch.libs import autofile

        self.path = path
        kwargs = {}
        if head_size_limit is not None:
            kwargs["head_size_limit"] = head_size_limit
        if total_size_limit is not None:
            kwargs["total_size_limit"] = total_size_limit
        self._group = autofile.Group(path, **kwargs)
        self._started = False

    def start(self) -> None:
        self._group.start()
        self._truncate_torn_tail()
        self._started = True

    def stop(self) -> None:
        if self._started:
            self._group.stop()
            self._started = False

    def write(self, msg: WALMessage) -> None:
        if not self._started:
            raise RuntimeError("WAL not started")
        payload = _encode_payload(msg)
        if len(payload) > MAX_MSG_SIZE_BYTES:
            raise ValueError(f"msg is too big: {len(payload)} bytes")
        rec = struct.pack(">II", zlib.crc32(payload), len(payload)) + payload
        self._group.write(rec)
        self._group.maybe_rotate()

    def write_sync(self, msg: WALMessage) -> None:
        self.write(msg)
        self.flush_and_sync()

    def flush_and_sync(self) -> None:
        if self._started:
            self._group.flush(sync=True)

    # --- reading ------------------------------------------------------------

    def _truncate_torn_tail(self) -> None:
        """Drop a partial final record left by a crash mid-write. Only
        the head can be torn; sealed chunks were fsynced at rotation."""
        if not os.path.exists(self.path):
            return
        with open(self.path, "rb") as f:
            data = f.read()
        pos = 0
        good_end = 0
        while pos + 8 <= len(data):
            crc, length = struct.unpack_from(">II", data, pos)
            if pos + 8 + length > len(data):
                break  # torn record
            payload = data[pos + 8 : pos + 8 + length]
            if zlib.crc32(payload) != crc:
                break  # corrupt tail
            pos += 8 + length
            good_end = pos
        if good_end < len(data):
            self._group.truncate_head_tail(good_end)

    def first_offset(self) -> int:
        """Oldest retained logical offset (> 0 once pruning happened)."""
        return self._group.first_offset()

    def iter_messages(
        self, start_offset: int = 0
    ) -> Iterator[Tuple[int, WALMessage]]:
        """Yield (logical_offset_after_record, message) from
        start_offset; raises WALCorruptionError on a bad CRC in the
        interior. Offsets below the pruning horizon yield from the
        oldest retained record. Streams one segment at a time — records
        never span chunks (rotation happens at record boundaries), so
        each segment parses independently."""
        start = max(start_offset, self._group.first_offset())
        for base, data in self._group.iter_segments_from(start):
            pos = 0
            while pos + 8 <= len(data):
                crc, length = struct.unpack_from(">II", data, pos)
                if length > MAX_MSG_SIZE_BYTES:
                    raise WALCorruptionError(
                        f"record length {length} exceeds max"
                    )
                if pos + 8 + length > len(data):
                    return  # torn tail (head only): EOF, crash recovery
                payload = data[pos + 8 : pos + 8 + length]
                if zlib.crc32(payload) != crc:
                    raise WALCorruptionError(
                        f"CRC mismatch at offset {base + pos}"
                    )
                pos += 8 + length
                yield base + pos, _decode_payload(payload)

    def search_for_end_height(self, height: int) -> Optional[int]:
        """Offset just past #ENDHEIGHT for `height`, or None
        (wal.go SearchForEndHeight). Replay starts at that offset."""
        found = None
        for offset, msg in self.iter_messages():
            if isinstance(msg, EndHeightMessage) and msg.height == height:
                found = offset
        return found


class NilWAL(WAL):
    """No-op WAL for tests (internal/consensus/wal.go:424 nilWAL)."""

    def __init__(self):
        super().__init__(path=os.devnull)

    def start(self) -> None:
        pass

    def stop(self) -> None:
        pass

    def write(self, msg: WALMessage) -> None:
        pass

    def write_sync(self, msg: WALMessage) -> None:
        pass

    def flush_and_sync(self) -> None:
        pass

    def iter_messages(self, start_offset: int = 0):
        return iter(())

    def search_for_end_height(self, height: int):
        return None

"""Minimal protobuf wire-format codec.

The subset of ``tendermint_tpu/encoding/proto.py`` that canonical vote
sign-bytes and the stored blocks, states and params need: varint, sfixed64
and length-delimited fields, with proto3 zero-value omission
(reference: proto/tendermint/types/canonical.pb.go:590-640), and the
:class:`Reader` the decoders walk a buffer with.

Wire types: 0 = varint, 1 = fixed64, 2 = length-delimited, 5 = fixed32.
"""

from __future__ import annotations

import struct
from typing import Iterator, Tuple

WIRE_VARINT = 0
WIRE_FIXED64 = 1
WIRE_BYTES = 2
WIRE_FIXED32 = 5

_U64_MASK = (1 << 64) - 1


def encode_varint(n: int) -> bytes:
    """Unsigned LEB128; negative ints encode as two's-complement uint64."""
    n &= _U64_MASK
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def tag(field: int, wire: int) -> bytes:
    return encode_varint((field << 3) | wire)


def length_delimited(payload: bytes) -> bytes:
    return encode_varint(len(payload)) + payload


def encode_varint_field(field: int, n: int) -> bytes:
    """proto3 semantics: zero is omitted."""
    if n == 0:
        return b""
    return tag(field, WIRE_VARINT) + encode_varint(n)


def encode_bool_field(field: int, v: bool) -> bytes:
    """proto3 semantics: false omitted."""
    if not v:
        return b""
    return tag(field, WIRE_VARINT) + b"\x01"


def encode_sfixed64_field(field: int, n: int) -> bytes:
    """sfixed64; zero omitted (proto3)."""
    if n == 0:
        return b""
    return tag(field, WIRE_FIXED64) + struct.pack("<q", n)


def encode_bytes_field(field: int, payload: bytes) -> bytes:
    """proto3 semantics: empty bytes omitted."""
    if not payload:
        return b""
    return tag(field, WIRE_BYTES) + length_delimited(payload)


def encode_string_field(field: int, s: str) -> bytes:
    return encode_bytes_field(field, s.encode("utf-8"))


def encode_message_field(field: int, payload: bytes) -> bytes:
    """Embedded message, written even when empty. Every embedded message
    the port writes is gogoproto non-nullable (the canonical vote's,
    canonical.pb.go:602-609; the block, light-block and validator
    messages the reference writes with ``always=True``)."""
    return tag(field, WIRE_BYTES) + length_delimited(payload)


def encode_optional_message_field(field: int, payload: bytes) -> bytes:
    """Embedded message, omitted when empty: a nullable field, as the
    reference writes a message without ``always=True`` (the consensus
    params' durations)."""
    if not payload:
        return b""
    return encode_message_field(field, payload)


# --- decoding ---------------------------------------------------------------


class Reader:
    """Cursor over a protobuf-encoded buffer."""

    __slots__ = ("buf", "pos", "end")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0
        self.end = len(buf)

    def eof(self) -> bool:
        return self.pos >= self.end

    def read_varint(self) -> int:
        shift = 0
        result = 0
        while True:
            if self.pos >= self.end:
                raise ValueError("truncated varint")
            b = self.buf[self.pos]
            self.pos += 1
            result |= (b & 0x7F) << shift
            if not b & 0x80:
                break
            shift += 7
            if shift > 63:
                raise ValueError("varint too long")
        return result & _U64_MASK

    def read_svarint(self) -> int:
        """varint interpreted as signed int64."""
        n = self.read_varint()
        if n >= 1 << 63:
            n -= 1 << 64
        return n

    def read_tag(self) -> Tuple[int, int]:
        t = self.read_varint()
        return t >> 3, t & 0x07

    def read_fixed64(self) -> int:
        if self.pos + 8 > self.end:
            raise ValueError("truncated fixed64")
        (v,) = struct.unpack_from("<Q", self.buf, self.pos)
        self.pos += 8
        return v

    def read_fixed32(self) -> int:
        if self.pos + 4 > self.end:
            raise ValueError("truncated fixed32")
        (v,) = struct.unpack_from("<I", self.buf, self.pos)
        self.pos += 4
        return v

    def read_bytes(self) -> bytes:
        n = self.read_varint()
        if self.pos + n > self.end:
            raise ValueError("truncated bytes field")
        out = self.buf[self.pos : self.pos + n]
        self.pos += n
        return out

    def skip(self, wire: int) -> None:
        if wire == WIRE_VARINT:
            self.read_varint()
        elif wire == WIRE_FIXED64:
            self.read_fixed64()
        elif wire == WIRE_BYTES:
            self.read_bytes()
        elif wire == WIRE_FIXED32:
            self.read_fixed32()
        else:
            raise ValueError(f"unknown wire type {wire}")

    def fields(self) -> Iterator[Tuple[int, int]]:
        """Yield (field, wire) until EOF; caller must consume each value."""
        while not self.eof():
            yield self.read_tag()

"""Minimal protobuf wire-format encoders.

The subset of ``tendermint_tpu/encoding/proto.py`` that canonical vote
sign-bytes need: varint, sfixed64 and length-delimited fields, with
proto3 zero-value omission (reference:
proto/tendermint/types/canonical.pb.go:590-640).
"""

from __future__ import annotations

import struct

WIRE_VARINT = 0
WIRE_FIXED64 = 1
WIRE_BYTES = 2

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
    """Embedded message. The canonical vote's messages are gogoproto
    non-nullable, so they serialize even when empty
    (canonical.pb.go:602-609)."""
    return tag(field, WIRE_BYTES) + length_delimited(payload)

"""PartSet: a block split into parts for gossip (types/part_set.go).

A copy of ``tendermint_tpu/types/part_set.py``. Blocks are serialized and
cut into 65536-byte parts, each with a merkle inclusion proof against
the PartSetHeader hash, so peers can stream and verify parts
independently; the block store keeps a block as its parts.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from tendermint_tpu_torch.crypto import merkle
from tendermint_tpu_torch.encoding.proto import (
    Reader,
    encode_bytes_field,
    encode_message_field,
    encode_varint_field,
)
from tendermint_tpu_torch.libs.bits import BitArray
from tendermint_tpu_torch.types.block import BLOCK_PART_SIZE_BYTES, PartSetHeader


@dataclass
class Part:
    """types/part_set.go:23-28."""

    index: int
    bytes: bytes
    proof: merkle.Proof

    def validate_basic(self) -> None:
        """types/part_set.go:30-45."""
        if len(self.bytes) > BLOCK_PART_SIZE_BYTES:
            raise ValueError(
                f"part bytes exceed maximum size {BLOCK_PART_SIZE_BYTES}"
            )
        if self.proof.index != self.index:
            raise ValueError("part index mismatch with proof index")
        if len(self.proof.leaf_hash) != merkle.HASH_SIZE:
            raise ValueError("bad proof leaf hash")

    def to_proto_bytes(self) -> bytes:
        proof = (
            encode_varint_field(1, self.proof.total)
            + encode_varint_field(2, self.proof.index)
            + encode_bytes_field(3, self.proof.leaf_hash)
        )
        for aunt in self.proof.aunts:
            proof += encode_bytes_field(4, aunt)
        return (
            encode_varint_field(1, self.index)
            + encode_bytes_field(2, self.bytes)
            + encode_message_field(3, proof)
        )

    @classmethod
    def from_proto_bytes(cls, data: bytes) -> "Part":
        r = Reader(data)
        index = 0
        payload = b""
        proof = merkle.Proof(total=0, index=0, leaf_hash=b"")
        for f, w in r.fields():
            if f == 1 and w == 0:
                index = r.read_varint()
            elif f == 2 and w == 2:
                payload = r.read_bytes()
            elif f == 3 and w == 2:
                pr = Reader(r.read_bytes())
                total = pidx = 0
                leaf = b""
                aunts: List[bytes] = []
                for pf, pw in pr.fields():
                    if pf == 1 and pw == 0:
                        total = pr.read_svarint()
                    elif pf == 2 and pw == 0:
                        pidx = pr.read_svarint()
                    elif pf == 3 and pw == 2:
                        leaf = pr.read_bytes()
                    elif pf == 4 and pw == 2:
                        aunts.append(pr.read_bytes())
                    else:
                        pr.skip(pw)
                proof = merkle.Proof(total=total, index=pidx, leaf_hash=leaf, aunts=aunts)
            else:
                r.skip(w)
        return cls(index, payload, proof)


class PartSet:
    """types/part_set.go:156-380: complete (from data) or accumulating
    (from a header, parts arriving from peers)."""

    def __init__(self, header: PartSetHeader):
        self.total = header.total
        self.hash = header.hash
        self.parts: List[Optional[Part]] = [None] * header.total
        self.parts_bit_array = BitArray(header.total)
        self.count = 0
        self.byte_size = 0

    @classmethod
    def from_data(cls, data: bytes, part_size: int = BLOCK_PART_SIZE_BYTES) -> "PartSet":
        """types/part_set.go NewPartSetFromData: split + merkle proofs."""
        total = (len(data) + part_size - 1) // part_size
        chunks = [data[i * part_size : (i + 1) * part_size] for i in range(total)]
        root, proofs = merkle.proofs_from_byte_slices(chunks)
        ps = cls(PartSetHeader(total, root))
        for i, chunk in enumerate(chunks):
            part = Part(index=i, bytes=chunk, proof=proofs[i])
            ps.parts[i] = part
            ps.parts_bit_array.set_index(i, True)
        ps.count = total
        ps.byte_size = len(data)
        return ps

    def header(self) -> PartSetHeader:
        return PartSetHeader(self.total, self.hash)

    def has_header(self, header: PartSetHeader) -> bool:
        return self.header() == header

    def get_part(self, index: int) -> Optional[Part]:
        if 0 <= index < self.total:
            return self.parts[index]
        return None

    def is_complete(self) -> bool:
        return self.count == self.total

    def add_part(self, part: Part) -> bool:
        """types/part_set.go:272-304: False if present, raises on invalid."""
        if part.index >= self.total:
            raise ValueError("error part set unexpected index")
        if self.parts[part.index] is not None:
            return False
        part.validate_basic()
        if not part.proof.verify(self.hash, part.bytes):
            raise ValueError("error part set invalid proof")
        self.parts[part.index] = part
        self.parts_bit_array.set_index(part.index, True)
        self.count += 1
        self.byte_size += len(part.bytes)
        return True

    def get_reader(self) -> bytes:
        """Reassembled bytes; only valid when complete."""
        if not self.is_complete():
            raise ValueError("cannot read incomplete part set")
        return b"".join(p.bytes for p in self.parts)

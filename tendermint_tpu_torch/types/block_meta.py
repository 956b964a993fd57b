"""BlockMeta: header + sizing info stored per height (types/block_meta.go).

A copy of ``tendermint_tpu/types/block_meta.py``."""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field

from tendermint_tpu_torch.encoding.proto import (
    Reader,
    encode_message_field,
    encode_varint_field,
)
from tendermint_tpu_torch.types.block import Block, BlockID, Header


@dataclass
class BlockMeta:
    block_id: BlockID = dc_field(default_factory=BlockID)
    block_size: int = 0
    header: Header = dc_field(default_factory=Header)
    num_txs: int = 0

    @classmethod
    def from_block(cls, block: Block, block_size: int, block_id: BlockID) -> "BlockMeta":
        return cls(
            block_id=block_id,
            block_size=block_size,
            header=block.header,
            num_txs=len(block.data.txs),
        )

    def to_proto_bytes(self) -> bytes:
        return (
            encode_message_field(1, self.block_id.to_proto_bytes())
            + encode_varint_field(2, self.block_size)
            + encode_message_field(3, self.header.to_proto_bytes())
            + encode_varint_field(4, self.num_txs)
        )

    @classmethod
    def from_proto_bytes(cls, data: bytes) -> "BlockMeta":
        r = Reader(data)
        out = cls()
        for f, w in r.fields():
            if f == 1 and w == 2:
                out.block_id = BlockID.from_proto_bytes(r.read_bytes())
            elif f == 2 and w == 0:
                out.block_size = r.read_svarint()
            elif f == 3 and w == 2:
                out.header = Header.from_proto_bytes(r.read_bytes())
            elif f == 4 and w == 0:
                out.num_txs = r.read_svarint()
            else:
                r.skip(w)
        return out

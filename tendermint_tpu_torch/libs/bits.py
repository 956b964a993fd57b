"""BitArray (libs/bits/bit_array.go): fixed-size bit vector used for
part-set tracking and vote gossip (which parts/votes a peer has).

A copy of ``tendermint_tpu/libs/bits.py``, whole; the layout
(``_elems``, bit ``i`` in byte ``i // 8`` at ``1 << (i % 8)``) is the
reference's, and the consensus reactor puts it on the wire as it is.
"""

from __future__ import annotations

import random
from typing import List, Optional


class BitArray:
    __slots__ = ("bits", "_elems")

    def __init__(self, bits: int):
        if bits < 0:
            bits = 0
        self.bits = bits
        self._elems = bytearray((bits + 7) // 8)

    @classmethod
    def from_indices(cls, bits: int, indices) -> "BitArray":
        ba = cls(bits)
        for i in indices:
            ba.set_index(i, True)
        return ba

    def size(self) -> int:
        return self.bits

    def get_index(self, i: int) -> bool:
        if i < 0 or i >= self.bits:
            return False
        return bool(self._elems[i // 8] & (1 << (i % 8)))

    def set_index(self, i: int, v: bool) -> bool:
        if i < 0 or i >= self.bits:
            return False
        if v:
            self._elems[i // 8] |= 1 << (i % 8)
        else:
            self._elems[i // 8] &= ~(1 << (i % 8)) & 0xFF
        return True

    def copy(self) -> "BitArray":
        out = BitArray(self.bits)
        out._elems = bytearray(self._elems)
        return out

    def or_(self, other: "BitArray") -> "BitArray":
        """Union, sized to the larger operand (bit_array.go Or)."""
        out = BitArray(max(self.bits, other.bits))
        for i in range(len(out._elems)):
            a = self._elems[i] if i < len(self._elems) else 0
            b = other._elems[i] if i < len(other._elems) else 0
            out._elems[i] = a | b
        return out

    def and_(self, other: "BitArray") -> "BitArray":
        out = BitArray(min(self.bits, other.bits))
        for i in range(len(out._elems)):
            out._elems[i] = self._elems[i] & other._elems[i]
        out._mask_tail()
        return out

    def not_(self) -> "BitArray":
        out = BitArray(self.bits)
        for i in range(len(self._elems)):
            out._elems[i] = (~self._elems[i]) & 0xFF
        out._mask_tail()
        return out

    def sub(self, other: "BitArray") -> "BitArray":
        """Bits set in self but not in other (bit_array.go Sub)."""
        out = self.copy()
        for i in range(min(len(self._elems), len(other._elems))):
            out._elems[i] &= (~other._elems[i]) & 0xFF
        return out

    def _mask_tail(self) -> None:
        tail = self.bits % 8
        if tail and self._elems:
            self._elems[-1] &= (1 << tail) - 1

    def is_empty(self) -> bool:
        return not any(self._elems)

    def is_full(self) -> bool:
        if self.bits == 0:
            return True
        full = all(b == 0xFF for b in self._elems[:-1])
        tail = self.bits % 8
        last_mask = 0xFF if tail == 0 else (1 << tail) - 1
        return full and self._elems[-1] == last_mask

    def pick_random(self, rng: Optional[random.Random] = None):
        """(index, ok) of a random set bit (bit_array.go PickRandom)."""
        trues = self.get_true_indices()
        if not trues:
            return 0, False
        return (rng or random).choice(trues), True

    def get_true_indices(self) -> List[int]:
        return [i for i in range(self.bits) if self.get_index(i)]

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, BitArray)
            and self.bits == other.bits
            and self._elems == other._elems
        )

    def __str__(self) -> str:
        return "".join("x" if self.get_index(i) else "_" for i in range(self.bits))

    def __repr__(self) -> str:
        return f"BitArray{{{self}}}"

"""BitArray (libs/bits/bit_array.go): the fixed-size bit vector of a
vote set, one bit a validator.

The part of ``tendermint_tpu/libs/bits.py`` that ``types/vote_set.py``
uses; the layout (``_elems``, bit ``i`` in byte ``i // 8`` at
``1 << (i % 8)``) is the reference's.
"""

from __future__ import annotations

from typing import List


class BitArray:
    __slots__ = ("bits", "_elems")

    def __init__(self, bits: int):
        if bits < 0:
            bits = 0
        self.bits = bits
        self._elems = bytearray((bits + 7) // 8)

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

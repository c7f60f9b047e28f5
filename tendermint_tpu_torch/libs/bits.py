"""BitArray: vote/part presence tracking and gossip set-difference
(reference: libs/bits/bit_array.go).

Used by PartSet assembly tracking, consensus PeerState (which votes/parts a
peer has), and the gossip routines' pick-random-from-difference. asyncio is
single-threaded per loop, so no lock is needed (the reference's mutex guards
goroutine concurrency).

The port's copy of tendermint_tpu/libs/bits.py.
"""

from __future__ import annotations

import random
from typing import List, Optional


class BitArray:
    def __init__(self, bits: int):
        if bits < 0:
            raise ValueError("negative bits")
        self.bits = bits
        self._elems = bytearray((bits + 7) // 8)

    @classmethod
    def from_bools(cls, bools) -> "BitArray":
        ba = cls(len(bools))
        for i, b in enumerate(bools):
            if b:
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
        ba = BitArray(self.bits)
        ba._elems = bytearray(self._elems)
        return ba

    def or_(self, other: "BitArray") -> "BitArray":
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
        return out

    def not_(self) -> "BitArray":
        out = BitArray(self.bits)
        for i in range(len(out._elems)):
            out._elems[i] = ~self._elems[i] & 0xFF
        out._mask_tail()
        return out

    def _mask_tail(self) -> None:
        rem = self.bits % 8
        if rem and self._elems:
            self._elems[-1] &= (1 << rem) - 1

    def sub(self, other: "BitArray") -> "BitArray":
        """Bits set in self but not in other (reference: bit_array.go Sub)."""
        out = self.copy()
        for i in range(min(len(out._elems), len(other._elems))):
            out._elems[i] &= ~other._elems[i] & 0xFF
        return out

    def is_empty(self) -> bool:
        return all(b == 0 for b in self._elems)

    def is_full(self) -> bool:
        if self.bits == 0:
            return True
        full = self.bits // 8
        if any(self._elems[i] != 0xFF for i in range(full)):
            return False
        rem = self.bits % 8
        if rem:
            return self._elems[full] == (1 << rem) - 1
        return True

    def pick_random(self) -> Optional[int]:
        """Random set bit index, or None (reference: bit_array.go PickRandom)."""
        ones = self.get_true_indices()
        if not ones:
            return None
        return random.choice(ones)

    def get_true_indices(self) -> List[int]:
        return [i for i in range(self.bits) if self.get_index(i)]

    def update(self, other: "BitArray") -> None:
        """Copy other's bits into self (sizes should match)."""
        n = min(len(self._elems), len(other._elems))
        self._elems[:n] = other._elems[:n]
        self._mask_tail()

    def to_bytes(self) -> bytes:
        return bytes(self._elems)

    @classmethod
    def from_bytes(cls, bits: int, data: bytes) -> "BitArray":
        ba = cls(bits)
        n = min(len(ba._elems), len(data))
        ba._elems[:n] = data[:n]
        ba._mask_tail()
        return ba

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, BitArray)
            and self.bits == other.bits
            and self._elems == other._elems
        )

    def __repr__(self) -> str:
        return "BA{" + "".join("x" if self.get_index(i) else "_" for i in range(self.bits)) + "}"

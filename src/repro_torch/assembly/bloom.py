"""Bloom filter over packed k-mers (paper §IV-C: singleton elimination).

The port's copy of ``repro.assembly.bloom``, in torch.  The sort-based
counter (``counter.py``) does not need it — sorting gives exact counts —
but the paper's two-phase streaming design (insert, then count only the
repeated k-mers) matters when the k-mer stream does not fit memory.
``n_hashes`` murmur-style hashes over the (hi, lo) words; bits are a bool
tensor, so a duplicate-heavy insert is a plain ``|=`` scatter.

Torch has no uint32 arithmetic, so :func:`_hash` computes in int64 and
masks to 32 bits after every multiply and add: the same bits as the JAX
uint32 version.
"""

from __future__ import annotations

import dataclasses

import torch

_MASK = 0xFFFFFFFF
_MIX = (0x85EBCA6B, 0xC2B2AE35, 0x27D4EB2F, 0x165667B1)


def _hash(hi: torch.Tensor, lo: torch.Tensor, seed: int) -> torch.Tensor:
    """Murmur-style finalizer over the packed k-mer words: uint32 values
    held in an int64 tensor."""
    x = (hi.to(torch.int64) & _MASK) ^ (
        ((lo.to(torch.int64) & _MASK) * _MIX[seed % 4]) & _MASK)
    x ^= x >> 16
    x = (x * 0x7FEB352D) & _MASK
    x ^= x >> 15
    x = (x * 0x846CA68B) & _MASK
    x ^= x >> 16
    x = (x + ((seed * _MIX[(seed + 1) % 4]) & _MASK)) & _MASK
    return x


@dataclasses.dataclass
class BloomFilter:
    """Bits (n_bits,) bool and the number of hashes."""

    bits: torch.Tensor
    n_hashes: int

    @property
    def n_bits(self) -> int:
        """Length of the bit vector."""
        return self.bits.shape[0]

    @staticmethod
    def create(n_bits: int, n_hashes: int = 3, device="cuda") -> "BloomFilter":
        """An empty filter on ``device`` (the card unless the caller asks
        for the CPU); insert and query keys on the same device."""
        return BloomFilter(bits=torch.zeros(n_bits, dtype=torch.bool,
                                            device=device), n_hashes=n_hashes)

    def _slots(self, hi, lo):
        return [_hash(hi, lo, s) % self.n_bits for s in range(self.n_hashes)]

    def insert(self, hi, lo, valid) -> "BloomFilter":
        """A new filter with the ``valid`` (hi, lo) k-mers inserted."""
        bits = self.bits.clone()
        valid = torch.as_tensor(valid, dtype=torch.bool, device=bits.device)
        for slot in self._slots(hi, lo):
            bits[slot[valid]] = True
        return BloomFilter(bits=bits, n_hashes=self.n_hashes)

    def query(self, hi, lo) -> torch.Tensor:
        """True where every hash slot of (hi, lo) is set (no false
        negatives; false positives at the filter's rate)."""
        hit = torch.ones(torch.broadcast_shapes(hi.shape, lo.shape),
                         dtype=torch.bool, device=self.bits.device)
        for slot in self._slots(hi, lo):
            hit &= self.bits[slot]
        return hit

"""Plain PyTorch version of canonical k-mer packing (the ``kmer_pack`` op).

It gathers every window of k codes into an (n, P, k) int32 tensor, packs the
windows and their reverse complements (flipped, each code c replaced by
3 - c) with :func:`_pack`, and keeps the smaller of each pair.  This is the
port's CPU path and the ``reference`` backend's; the kernel
(``csrc/kmer_pack.cu``) computes the same words without the windows.
"""

from __future__ import annotations

import torch


def _pack(c: torch.Tensor, k: int):
    """Pack (..., k) int32 codes into (hi, lo) int32 words, 15 bases per
    word, big-endian and left aligned."""
    assert k <= 30, "k ≤ 30 supported (2×15 bases in int32)"
    k_hi = min(k, 15)
    hi = torch.zeros(c.shape[:-1], dtype=torch.int32, device=c.device)
    for t in range(k_hi):
        hi = hi * 4 + c[..., t]
    hi = hi * (4 ** (15 - k_hi))
    lo = torch.zeros(c.shape[:-1], dtype=torch.int32, device=c.device)
    for t in range(k_hi, k):
        lo = lo * 4 + c[..., t]
    lo = lo * (4 ** (15 - max(0, k - 15)))
    return hi, lo


def kmer_pack_ref(codes: torch.Tensor, lengths: torch.Tensor, *, k: int):
    """codes (n, L) uint8, lengths (n,) -> ``hi``, ``lo``, ``strand`` (n, P)
    int32 and ``valid`` (n, P) bool, P = L − k + 1: the canonical packed
    k-mer at every position, 1 where it is the reverse complement, and
    whether the k-mer lies inside the read."""
    p = codes.shape[1] - k + 1
    dev = codes.device
    pos = torch.arange(p, dtype=torch.int32, device=dev)
    win = pos[:, None] + torch.arange(k, dtype=torch.int32, device=dev)[None, :]
    w = codes[:, win.to(torch.int64)].to(torch.int32)  # (n, P, k)
    fwd_hi, fwd_lo = _pack(w, k)
    rc_hi, rc_lo = _pack(3 - torch.flip(w, dims=(-1,)), k)
    fwd_smaller = (fwd_hi < rc_hi) | ((fwd_hi == rc_hi) & (fwd_lo <= rc_lo))
    return (torch.where(fwd_smaller, fwd_hi, rc_hi),
            torch.where(fwd_smaller, fwd_lo, rc_lo),
            (~fwd_smaller).to(torch.int32),
            pos[None, :] < (lengths.to(torch.int32)[:, None] - k + 1))

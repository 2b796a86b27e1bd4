"""K-mer extraction and canonicalization (paper §IV-C), in torch.

The PyTorch counterpart of ``repro.assembly.kmers``.  Reads are (n, L_max)
uint8 code rows (A=0, C=1, G=2, T=3) with per-read lengths.  K-mers are
packed 2 bits/base into a (hi, lo) pair of int32 words (15 bases each, left
aligned, so (hi, lo) order is lexicographic; k ≤ 30).  The canonical form is
the smaller of the k-mer and its reverse complement; ``strand`` is 1 where
the reverse complement was taken.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.backend import dispatch, resolve_backend
from ..obs import span

COMPLEMENT = 3  # complement(code) = 3 - code
BASES = "ACGT"


def encode_seq(s: str) -> torch.Tensor:
    """``ACGT`` string → (len,) uint8 codes (case-insensitive; any other
    character codes as A)."""
    lut = {c: i for i, c in enumerate(BASES)}
    return torch.tensor([lut.get(c, 0) for c in s.upper()], dtype=torch.uint8)


def decode_seq(codes) -> str:
    """Codes (tensor or array) → ``ACGT`` string."""
    if isinstance(codes, torch.Tensor):
        codes = codes.detach().cpu().numpy()
    return "".join(BASES[int(c)] for c in np.asarray(codes))


def revcomp(codes: torch.Tensor, length) -> torch.Tensor:
    """Reverse complement of padded code rows (padding stays at the end).
    Batched: codes (..., L), length (...)."""
    lmax = codes.shape[-1]
    length = torch.as_tensor(length, device=codes.device)
    idx = length[..., None] - 1 - torch.arange(lmax, device=codes.device)
    safe = torch.clamp(idx, 0, lmax - 1).to(torch.int64).expand(codes.shape)
    out = COMPLEMENT - torch.gather(codes.to(torch.int32), -1, safe)
    return torch.where(idx >= 0, out, 0).to(torch.uint8)


def extract_kmers(codes: torch.Tensor, lengths: torch.Tensor, *, k: int,
                  backend: str = "auto"):
    """All canonical k-mer instances of each read: a dict of (n, P) tensors,
    P = L_max − k + 1 — ``hi``, ``lo`` (packed canonical k-mer), ``strand``,
    ``pos`` (start in the forward read) and ``valid``.  The packing is the
    ``kmer_pack`` op of ``backend`` (``kernels/kmer_pack``): one kernel
    launch for CUDA tensors on the ``cuda`` backend, the plain torch version
    otherwise; the step span's ``path`` says which ran."""
    n, lmax = codes.shape
    dev = codes.device
    p = lmax - k + 1
    b = resolve_backend(backend, dev)
    path = "kernel" if b == "cuda" and dev.type == "cuda" else "torch"
    with span("CountKmer.extract", kind="step", instances=n * p, path=path):
        hi, lo, strand, valid = dispatch("kmer_pack", b, dev)(codes, lengths,
                                                             k=k)
        pos = torch.arange(p, dtype=torch.int32, device=dev)
        return {"hi": hi, "lo": lo, "strand": strand,
                "pos": pos[None, :].expand(n, p), "valid": valid}

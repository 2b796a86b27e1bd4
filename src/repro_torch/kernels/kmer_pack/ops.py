"""Wrapper of the k-mer packing kernel (``csrc/kmer_pack.cu``) + dispatch
registration of the ``kmer_pack`` op.

``kmer_pack(codes, lengths, *, k)`` gives, at every position p < P = L −
k + 1 of every read (pad positions included), the canonical packed k-mer
(``hi``, ``lo``: 15 bases a word, 2 bits a base, big-endian and left
aligned), its ``strand`` (1 where the reverse complement is the smaller)
and ``valid`` (p < lengths − k + 1): three (n, P) int32 tensors and an
(n, P) bool tensor.  It launches the kernel for CUDA tensors (one launch a
call, none where n·P is 0) and runs the plain version (``ref.py``) for CPU
tensors.  The kernel is exact for every byte, codes past 3 included.
"""

from __future__ import annotations

import ctypes

import torch

from ...core.backend import register_op
from ...obs.trace import span
from ..build import CudaKernel, check_cuda, check_dtype, stream_handle
from .ref import kmer_pack_ref

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel("kmer_pack", [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P])
#: the longest k two int32 words hold (``csrc/kmer_pack.cu``)
MAX_K = 30


def kmer_pack(codes: torch.Tensor, lengths: torch.Tensor, *, k: int):
    """codes (n, L) uint8, lengths (n,) int32 -> (hi, lo, strand, valid),
    each (n, L − k + 1)."""
    if not 1 <= k <= MAX_K:
        raise ValueError(f"kmer_pack: k must lie in 1..{MAX_K}, got {k}")
    if codes.device.type == "cpu" and lengths.device.type == "cpu":
        return kmer_pack_ref(codes, lengths, k=k)
    dev = check_cuda("kmer_pack", codes=codes, lengths=lengths)
    check_dtype("kmer_pack", codes, torch.uint8, "codes")
    check_dtype("kmer_pack", lengths, torch.int32, "lengths")
    if codes.dim() != 2 or tuple(lengths.shape) != (codes.shape[0],):
        raise ValueError(f"kmer_pack: need codes (n, L) and lengths (n,); got "
                         f"{tuple(codes.shape)}, {tuple(lengths.shape)}")
    n, width = codes.shape
    p = width - k + 1
    if p < 0:
        raise ValueError(f"kmer_pack: reads of {width} columns hold no "
                         f"{k}-mer position")
    hi, lo, strand = (torch.empty((n, p), dtype=torch.int32, device=dev)
                      for _ in range(3))
    valid = torch.empty((n, p), dtype=torch.bool, device=dev)
    if n and p:
        with span("kernel_launch", kind="kernel", kernel="kmer_pack",
                  rows=n, width=width, k=k):
            KERNEL.launch(codes.data_ptr(), lengths.data_ptr(), hi.data_ptr(),
                          lo.data_ptr(), strand.data_ptr(), valid.data_ptr(),
                          n, width, k, stream_handle(codes))
    return hi, lo, strand, valid


def _kmer_pack_reference(codes, lengths, *, k):
    return kmer_pack_ref(codes, lengths, k=k)


register_op("kmer_pack", "cuda", kmer_pack)
register_op("kmer_pack", "reference", kmer_pack_ref)

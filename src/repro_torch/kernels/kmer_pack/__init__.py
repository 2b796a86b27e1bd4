"""Canonical k-mer packing from the read codes: CUDA kernel wrapper and its
plain version."""

from .ops import KERNEL, kmer_pack  # noqa: F401
from .ref import kmer_pack_ref  # noqa: F401

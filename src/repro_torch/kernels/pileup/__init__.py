"""Banded pileup + majority vote: CUDA kernel wrapper and its plain version."""

from .ops import KERNEL, pileup_vote  # noqa: F401
from .ref import pileup_vote_ref  # noqa: F401

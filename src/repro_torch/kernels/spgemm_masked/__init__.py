"""Sampled min-plus product at a mask's pattern: CUDA kernel wrapper and
its plain version."""

from .ops import KERNEL, spgemm_masked_minplus  # noqa: F401
from .ref import spgemm_masked_minplus_ref  # noqa: F401

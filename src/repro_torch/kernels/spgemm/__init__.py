"""Ring-SUMMA local SpGEMM stages: CUDA kernel wrapper and its plain version."""

from .ops import KERNEL, spgemm_ring_stages  # noqa: F401
from .ref import spgemm_ring_stages_ref  # noqa: F401

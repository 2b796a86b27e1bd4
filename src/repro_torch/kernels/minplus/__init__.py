"""Dense min-plus product: CUDA kernel wrapper and its plain version."""

from .ops import KERNEL, minplus_matmul  # noqa: F401
from .ref import minplus_matmul_ref  # noqa: F401

"""Banded x-drop extension: CUDA kernel wrapper and its plain version."""

from .ops import KERNEL, xdrop_extend_batch  # noqa: F401
from .ref import xdrop_extend_batch_ref  # noqa: F401
